"""The port's device primitives against the JAX package, on the CPU.

Tables, ``classify``, the segmented scans, ``dfa_states`` (packed <= 8
states and the > 8-state gather path), ``citation_spans`` and ``compact``
in both table forms (scatter and sort), and ``langid_scores`` — each fed
the same seeded numpy inputs on both sides, compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textblaster_tpu.models.langid import get_model as jax_get_model
from textblaster_tpu.ops import compact as jcompact
from textblaster_tpu.ops import device as jdev
from textblaster_tpu.ops import dfa as jdfa
from textblaster_tpu.ops import langid_tpu as jlangid
from textblaster_tpu_torch.ops import compact as tcompact
from textblaster_tpu_torch.ops import device as tdev
from textblaster_tpu_torch.ops import dfa as tdfa
from textblaster_tpu_torch.ops import langid_device as tlangid
from textblaster_tpu_torch.weights import own_tables, tables_from_numpy

from test_torch_pipeline import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.torch_port


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rows(texts, length):
    cps = np.zeros((len(texts), length), np.int32)
    lens = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        cp = [ord(c) for c in t][:length]
        cps[i, : len(cp)] = cp
        lens[i] = len(cp)
    return cps, lens


TEXTS = [
    "",
    "Det er en god dag [1], og vi skal ud [2, 3] at gå tur i skoven.",
    "The quick brown fox [12,  4] jumps over the lazy dog [x] twice.",
    "Ætt blåbærsyltetøy — grød på ærø, ÆØÅ æøå. [7]",
    "数据处理流水线的测试文本，包含中文。",
    "𝔘𝔫𝔦𝔠𝔬𝔡𝔢 𝕋𝕖𝕩𝕥 🚀 and café́ ascii",
    "a" * 200,
    "Line one.\n\nLine two [3] \r\n[4, 5, 6] ends",
]


def test_tables_equal_the_jax_tables():
    jt = tables_from_numpy(
        jdev._class_table_np(), jdev._lower_table_np(), jax_get_model().table_q
    )
    own = own_tables()
    for a, b in zip(jt, own):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_classify_and_widths():
    rng = np.random.default_rng(0)
    cps = rng.integers(0, 0x50000, size=(4, 300)).astype(np.int32)
    cps[0, :32] = np.arange(0xE0000, 0xE0020)  # plane-14 tags
    _eq(tdev.classify(_t(cps)), jdev.classify(jnp.asarray(cps)))
    _eq(tdev.utf8_width(_t(cps)), jdev.utf8_width(jnp.asarray(cps)))
    _eq(
        tdev.isin_sorted(_t(cps % 200), jdev.MID_ALL_CPS),
        jdev.isin_sorted(jnp.asarray(cps % 200), jdev.MID_ALL_CPS),
    )


@pytest.mark.parametrize(
    "name", ["seg_scan_add", "seg_scan_or", "seg_scan_max", "latch_scan"]
)
def test_segmented_scans(name):
    rng = np.random.default_rng(len(name))
    vals = rng.integers(-(2**31), 2**31, size=(5, 300), dtype=np.int64).astype(np.int32)
    reset = rng.random((5, 300)) < 0.1
    want = jax.jit(getattr(jdev, name))(jnp.asarray(vals), jnp.asarray(reset))
    _eq(getattr(tdev, name)(_t(vals), _t(reset)), want)


def test_word_mask():
    cps, _ = _rows(TEXTS, 256)
    cls = jdev.classify(jnp.asarray(cps))
    want = jax.jit(jdev.word_mask)(jnp.asarray(cps), cls)
    _eq(tdev.word_mask(_t(cps), tdev.classify(_t(cps))), want)


@pytest.mark.parametrize("n_states", [5, 10])
def test_dfa_states(n_states):
    rng = np.random.default_rng(n_states)
    n_sym = 6
    table = rng.integers(0, n_states, size=(n_sym, n_states)).astype(np.int32)
    sym = rng.integers(0, n_sym, size=(4, 300)).astype(np.int32)
    for start in (0, n_states - 1):
        want = jax.jit(lambda s: jdfa.dfa_states(s, table, start))(jnp.asarray(sym))
        _eq(tdfa.dfa_states(_t(sym), table, start), want)


@pytest.fixture(params=["scatter", "sort"])
def table_impl(request, monkeypatch):
    monkeypatch.setenv("TEXTBLAST_TABLE_IMPL", request.param)
    return request.param


def test_citation_spans(table_impl):
    cps, lens = _rows(TEXTS, 128)
    mask = np.arange(128)[None, :] < lens[:, None]
    cls = np.asarray(jdev.classify(jnp.asarray(cps)))
    digit = ((cls & jdev.DIGIT) != 0) & mask
    ws = ((cls & jdev.WS) != 0) & mask
    # A fresh lambda per call: the JAX side reads TEXTBLAST_TABLE_IMPL at
    # trace time, so a cached trace must not leak across table forms.
    want = jax.jit(lambda *a: jdfa.citation_spans(*a))(jnp.asarray(cps), digit, ws)
    got = tdfa.citation_spans(_t(cps), _t(digit), _t(ws))
    _eq(got, want)
    assert bool(got.any())


def test_compact(table_impl):
    rng = np.random.default_rng(3)
    cps = rng.integers(1, 0x11000, size=(6, 300)).astype(np.int32)
    keep = rng.random((6, 300)) < 0.4
    keep[0] = False
    keep[1] = True
    want_c, want_n = jax.jit(lambda *a: jcompact.compact(*a))(
        jnp.asarray(cps), jnp.asarray(keep)
    )
    got_c, got_n = tcompact.compact(_t(cps), _t(keep))
    _eq(got_c, want_c)
    _eq(got_n, want_n)


def test_langid_scores(table_impl):
    cps, lens = _rows(TEXTS, 256)
    want = jax.jit(lambda *a: jlangid.langid_scores(*a))(jnp.asarray(cps), jnp.asarray(lens))
    jt = tables_from_numpy(
        jdev._class_table_np(), jdev._lower_table_np(), jax_get_model().table_q
    )
    for table in (None, jt.table_q):  # the port's own table, then the JAX one
        got = tlangid.langid_scores(_t(cps), _t(lens), table=table)
        for g, w in zip(got, want):
            _eq(g, w)
