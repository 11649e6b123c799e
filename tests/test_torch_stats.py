"""The port's statistic functions against the JAX package, on the CPU.

``structure``, ``gopher_quality_stats``, ``gopher_rep_stats`` (with the
n-gram rarity gate fired and not fired), ``fineweb_stats``,
``sentence_counts`` and ``c4_stage`` (both segmentation modes) on an edge
corpus — CJK, astral, empty and maximum-length rows, repeated lines and
``[1]`` / ``[2, 3]`` citations — in both table forms.  The functions run
under the three schedules (the ``schedule`` fixture and the ``sched``
parameters): chain, against the JAX package's interpret-mode chain kernel;
fused, against its interpret-mode fused kernel under
``TEXTBLAST_DEPFUSE=off``; and staged, against its staged branch.  Every
value is an int32 or bool array and must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textblaster_tpu.ops import stats as js
from textblaster_tpu_torch.ops import stats as ts
from textblaster_tpu_torch.ops.pipeline import _table_sizes
from textblaster_tpu_torch.utils.text import DANISH_STOP_WORDS

from test_torch_pipeline import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.torch_port

L = 512
MAX_LINES, MAX_WORDS = _table_sizes(L)

DIRTY = [
    "",
    "Samme linje her igen og igen.\n" * 12,
    "Det er en god dag [1], og vi skal ud [2, 3] at gå tur i skoven.\n"
    "Solen skinner over byen... Der er mange mennesker på gaden!\n\n"
    "- punkt et\n• punkt to\nLorem ipsum dolor sit amet javascript …",
    "数据处理流水线的测试文本，包含中文。 Og lidt dansk tekst her.",
    "𝔘𝔫𝔦𝔠𝔬𝔡𝔢 𝕋𝕖𝕩𝕥 🚀 and café́ ascii. Terms of use apply {x}.",
    ("ord " * 200)[: L],  # a maximum-length row
    "en to tre fire fem seks en to tre fire fem seks en to tre fire fem",
    "Line one.\r\n\r\nLine two [3] ends here. Yes! \"Quoted.\" Done?",
]
CLEAN = [
    "Det er en god dag og vi skal ud at gå tur i skoven.",
    "Solen skinner over byen. Der er mange mennesker på gaden.",
    "",
    "kort",
]


def _batch(texts, rows=8):
    cps = np.zeros((rows, L), np.int32)
    lens = np.zeros(rows, np.int32)
    for i, t in enumerate(texts):
        cp = [ord(c) for c in t][:L]
        cps[i, : len(cp)] = cp
        lens[i] = len(cp)
    return cps, lens


def _eq(got, want, what):
    if got is None or want is None:
        assert got is None and want is None, what
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


def _eq_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _eq(got[k], want[k], k)


def _set_schedule(monkeypatch, sched):
    """Both packages read the switches.  Chain: the port's default, and the
    JAX package's chain branches, their kernel in interpret mode.  Fused:
    ``TEXTBLAST_DEPFUSE=off``, the JAX fused kernel in interpret mode.
    Staged: ``TEXTBLAST_FUSED=off`` on both sides."""
    for var in ("TEXTBLAST_PALLAS", "TEXTBLAST_NO_PALLAS", "TEXTBLAST_FUSED",
                "TEXTBLAST_DEPFUSE"):
        monkeypatch.delenv(var, raising=False)
    if sched in ("chain", "fused"):
        monkeypatch.setenv("TEXTBLAST_PALLAS_INTERPRET", "1")
    if sched == "fused":
        monkeypatch.setenv("TEXTBLAST_DEPFUSE", "off")
    elif sched == "staged":
        monkeypatch.setenv("TEXTBLAST_FUSED", "off")


@pytest.fixture(params=["fused", "staged", "chain"])
def schedule(request, monkeypatch):
    _set_schedule(monkeypatch, request.param)
    return request.param


def _both(texts):
    cps, lens = _batch(texts)
    return (jnp.asarray(cps), jnp.asarray(lens)), (torch.from_numpy(cps), torch.from_numpy(lens))


#: XLA's backend optimization off for the JAX side: its batches are a few
#: rows, and compiling its programs is most of this file's time.
_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0,
                     "xla_llvm_disable_expensive_passes": True}


def _jit(fn):
    # A fresh wrapper per call: the JAX side reads TEXTBLAST_TABLE_IMPL at
    # trace time.
    def run(*args):
        return jax.jit(fn).lower(*args).compile(compiler_options=_COMPILER_OPTIONS)(*args)

    return run


@pytest.mark.parametrize("with_hashes", [True, False])
def test_structure(schedule, with_hashes):
    (jc, jl), (tc, tl) = _both(DIRTY)
    want = _jit(lambda c, n: js.structure(c, n, with_hashes=with_hashes))(jc, jl)
    got = ts.structure(tc, tl, with_hashes=with_hashes)
    for name in ts.TextStructure._fields:
        _eq(getattr(got, name), getattr(want, name), name)


def test_structure_unpacked_fused_branch(schedule):
    """At 16384 lanes (above the packed-field limit of 8192) the fused
    branch takes the four-accumulator group; 8 short rows."""
    length = 16384
    cps = np.zeros((8, length), np.int32)
    lens = np.zeros(8, np.int32)
    for i, t in enumerate(DIRTY):
        cp = [ord(c) for c in t]
        cps[i, : len(cp)] = cp
        lens[i] = len(cp)
    cps[5, :length] = [ord(c) for c in ("ord " * 4096)]  # a maximum-length row
    lens[5] = length
    want = _jit(lambda c, n: js.structure(c, n, with_hashes=True))(
        jnp.asarray(cps), jnp.asarray(lens)
    )
    got = ts.structure(torch.from_numpy(cps), torch.from_numpy(lens), with_hashes=True)
    for name in ts.TextStructure._fields:
        _eq(getattr(got, name), getattr(want, name), name)


def test_gopher_quality_stats(schedule):
    (jc, jl), (tc, tl) = _both(DIRTY)
    hashes = tuple(sorted({js.hash_string(w) for w in DANISH_STOP_WORDS}))
    want = _jit(lambda c, n: js.gopher_quality_stats(js.structure(c, n), hashes))(jc, jl)
    _eq_dict(ts.gopher_quality_stats(ts.structure(tc, tl), hashes), want)


@pytest.mark.parametrize(
    "impl,texts,fires",
    [("scatter", DIRTY, True), ("sort", DIRTY, True), ("scatter", CLEAN, False)],
)
def test_gopher_rep_stats(monkeypatch, impl, texts, fires):
    monkeypatch.setenv("TEXTBLAST_TABLE_IMPL", impl)
    (jc, jl), (tc, tl) = _both(texts)
    top, dup = (2, 3, 4), (5, 6, 7, 8, 9, 10)

    def jfn(c, n):
        return js.gopher_rep_stats(js.structure(c, n), top, dup, MAX_LINES, MAX_WORDS)

    want = _jit(jfn)(jc, jl)
    got = ts.gopher_rep_stats(ts.structure(tc, tl), top, dup, MAX_LINES, MAX_WORDS)
    _eq_dict(got, want)
    assert bool(got["dup_5"].any()) == fires


@pytest.mark.parametrize("impl", ["scatter", "sort"])
def test_gopher_rep_stats_chain(monkeypatch, impl):
    """The chain schedule against the JAX chain branches (the segment scans
    and the sorted-table run scans), the rarity gate fired."""
    monkeypatch.setenv("TEXTBLAST_TABLE_IMPL", impl)
    _set_schedule(monkeypatch, "chain")
    (jc, jl), (tc, tl) = _both(DIRTY)
    top, dup = (2, 3, 4), (5, 6, 7, 8, 9, 10)

    def jfn(c, n):
        return js.gopher_rep_stats(js.structure(c, n), top, dup, MAX_LINES, MAX_WORDS)

    got = ts.gopher_rep_stats(ts.structure(tc, tl), top, dup, MAX_LINES, MAX_WORDS)
    _eq_dict(got, _jit(jfn)(jc, jl))
    assert bool(got["dup_5"].any())


@pytest.mark.parametrize(
    "impl,sched",
    [("scatter", "fused"), ("scatter", "staged"), ("sort", "staged"), ("scatter", "chain")],
)
def test_fineweb_stats(monkeypatch, impl, sched):
    monkeypatch.setenv("TEXTBLAST_TABLE_IMPL", impl)
    _set_schedule(monkeypatch, sched)
    (jc, jl), (tc, tl) = _both(DIRTY)
    stop = tuple(sorted(".!?\"'"))

    def jfn(c, n):
        return js.fineweb_stats(js.structure(c, n, with_hashes=False), stop, MAX_LINES, 30)

    want = _jit(jfn)(jc, jl)
    _eq_dict(ts.fineweb_stats(ts.structure(tc, tl, with_hashes=False), stop, MAX_LINES, 30), want)


def test_sentence_counts():
    (jc, jl), (tc, tl) = _both(DIRTY)
    _eq(ts.sentence_counts(tc, tl), _jit(js.sentence_counts)(jc, jl), "n_sentences")


@pytest.mark.parametrize("sched", ["chain", "staged"])
def test_sentence_counts_schedules(monkeypatch, sched):
    _set_schedule(monkeypatch, sched)
    (jc, jl), (tc, tl) = _both(DIRTY)
    _eq(ts.sentence_counts(tc, tl), _jit(js.sentence_counts)(jc, jl), "n_sentences")


@pytest.mark.parametrize(
    "impl,split_paragraph,sched",
    [
        ("scatter", True, "fused"),
        ("scatter", True, "staged"),
        ("sort", True, "staged"),
        ("scatter", False, "staged"),
        ("scatter", True, "chain"),
        ("sort", True, "chain"),
        ("scatter", False, "chain"),
        ("sort", False, "chain"),
    ],
)
def test_c4_stage(monkeypatch, impl, split_paragraph, sched):
    monkeypatch.setenv("TEXTBLAST_TABLE_IMPL", impl)
    _set_schedule(monkeypatch, sched)
    (jc, jl), (tc, tl) = _both(DIRTY)
    kw = dict(
        split_paragraph=split_paragraph,
        remove_citations=True,
        filter_no_terminal_punct=True,
        min_num_sentences=5,
        min_words_per_line=3,
        max_word_length=1000,
        filter_lorem_ipsum=True,
        filter_javascript=True,
        filter_curly_bracket=True,
        filter_policy=True,
    )
    want_s, want_c, want_n = _jit(
        lambda c, n: js.c4_stage(c, n, js.C4Params(**kw), MAX_LINES)
    )(jc, jl)
    got_s, got_c, got_n = ts.c4_stage(tc, tl, ts.C4Params(**kw), MAX_LINES)
    _eq_dict(got_s, want_s)
    _eq(got_c, want_c, "new_cps")
    _eq(got_n, want_n, "new_lengths")
