"""The port's row scans against the JAX package's per-scan Pallas kernel.

``affine_hash_scan_plain`` and ``dfa_compose_scan_plain`` (the CPU path of
``textblaster_tpu_torch.ops.scan``) must equal, exactly, the JAX kernel
``_pallas_scan_tuple`` run in interpret mode and its lax twin
(``jax.lax.associative_scan``) on the same int32 inputs.  The CUDA kernels
themselves are compared with these plain versions on the card by
``tests/test_torch_card.py`` and ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textblaster_tpu.ops import pallas_scan as psc
from textblaster_tpu_torch.ops import scan

pytestmark = pytest.mark.torch_port


def _full_range(rng, shape):
    return rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)


def _packed_maps(rng, shape, n_states):
    """Random valid nibble-packed maps: every nibble a state < n_states."""
    out = np.zeros(shape, dtype=np.int64)
    for s in range(n_states):
        out |= rng.integers(0, n_states, size=shape, dtype=np.int64) << (4 * s)
    return out.astype(np.uint32).view(np.int32)


def _lax_scan(op, xs):
    """The lax twin, jitted (eager associative_scan dispatches op by op)."""
    return jax.jit(functools.partial(jax.lax.associative_scan, op, axis=1))(xs)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


SHAPES = [(8, 128), (16, 512), (8, 1024)]


@pytest.mark.parametrize("shape", SHAPES)
def test_affine_plain_matches_pallas_interpret_and_lax(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    m, a1, a2 = (_full_range(rng, shape) for _ in range(3))  # overflow-heavy
    xs = tuple(jnp.asarray(x) for x in (m, a1, a2))
    kernel = psc._pallas_scan_tuple(psc._affine_op, (1, 0, 0), xs, interpret=True)
    lax = _lax_scan(psc._affine_op, xs)
    # k = 2 and k = 1: each accumulator's scan depends only on (m, itself).
    for accs, want_k, want_l in (((a1, a2), kernel[1:], lax[1:]),
                                 ((a1,), kernel[1:2], lax[1:2])):
        got = scan.affine_hash_scan_plain(_t(m), tuple(_t(a) for a in accs))
        assert len(got) == len(accs)
        for g, wk, wl in zip(got, want_k, want_l):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wk))
            np.testing.assert_array_equal(g.numpy(), np.asarray(wl))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_states", [4, 5, 8])
def test_dfa_plain_matches_pallas_interpret_and_lax(shape, n_states):
    rng = np.random.default_rng(shape[1] * 10 + n_states)
    fns = _packed_maps(rng, shape, n_states)
    op = psc._dfa_op(n_states)
    xs = (jnp.asarray(fns),)
    (kernel,) = psc._pallas_scan_tuple(op, (psc._dfa_ident(n_states),), xs, interpret=True)
    (lax,) = _lax_scan(op, xs)
    got = scan.dfa_compose_scan_plain(_t(fns), n_states).numpy()
    np.testing.assert_array_equal(got, np.asarray(kernel))
    np.testing.assert_array_equal(got, np.asarray(lax))


@pytest.mark.parametrize("shape", [(5, 300), (3, 1), (1, 777)])
def test_odd_shapes_match_lax(shape):
    rng = np.random.default_rng(shape[1])
    m, a1, a2 = (_full_range(rng, shape) for _ in range(3))
    xs = tuple(jnp.asarray(x) for x in (m, a1, a2))
    lax = _lax_scan(psc._affine_op, xs)
    got = scan.affine_hash_scan(_t(m), (_t(a1), _t(a2)))
    for g, w in zip(got, lax[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    fns = _packed_maps(rng, shape, 5)
    (lax_d,) = _lax_scan(psc._dfa_op(5), (jnp.asarray(fns),))
    np.testing.assert_array_equal(
        scan.dfa_compose_scan(_t(fns), 5).numpy(), np.asarray(lax_d)
    )


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    before = dict(scan.LAUNCHES)
    rng = np.random.default_rng(0)
    m, a = _full_range(rng, (2, 9)), _full_range(rng, (2, 9))
    got = scan.affine_hash_scan(_t(m), (_t(a),))[0]
    want = scan.affine_hash_scan_plain(_t(m), (_t(a),))[0]
    assert torch.equal(got, want)
    assert scan.LAUNCHES == before


# --- fused multi-group scan ---------------------------------------------------


@pytest.fixture
def interp(monkeypatch):
    """The JAX fused kernel in interpret mode (as tests/test_fused_scan.py
    runs it); the port reads TEXTBLAST_FUSED too, so it is cleared."""
    monkeypatch.delenv("TEXTBLAST_PALLAS", raising=False)
    monkeypatch.delenv("TEXTBLAST_NO_PALLAS", raising=False)
    monkeypatch.delenv("TEXTBLAST_FUSED", raising=False)
    monkeypatch.setenv("TEXTBLAST_PALLAS_INTERPRET", "1")


def _group_lists(rng, shape):
    """name -> builder(module) of one group list over fixed numpy inputs;
    the builder takes ``psc`` (JAX arrays) or ``scan`` (torch tensors)."""
    m, a1, a2, a3, a4, v = (_full_range(rng, shape) for _ in range(6))
    f6, f8 = _packed_maps(rng, shape, 6), _packed_maps(rng, shape, 8)

    def lists(mod, conv):
        m_, a1_, a2_, a3_, a4_, v_, f6_, f8_ = map(conv, (m, a1, a2, a3, a4, v, f6, f8))
        return {
            "affine_k1_to_k4": [
                mod.affine_group(m_, (a1_,)),
                mod.affine_group(m_, (a1_, a2_)),
                mod.affine_group(m_, (a1_, a2_, a3_)),
                mod.affine_group(v_, (a1_, a2_, a3_, a4_)),
            ],
            "add_scan_and_last": [
                mod.add_group((v_, a1_)),
                mod.add_group((v_, a1_, a2_), emit="last"),
            ],
            "dfa": [mod.dfa_group(f6_, 6), mod.dfa_group(f8_, 8, emit="last")],
            # tests/test_fused_scan.py's mixed list.
            "mixed": [
                mod.affine_group(m_, (a1_, a2_)),
                mod.add_group((v_,)),
                mod.dfa_group(f6_, 6),
                mod.add_group((v_, a1_), emit="last"),
            ],
        }

    return lists


LIST_NAMES = ["affine_k1_to_k4", "add_scan_and_last", "dfa", "mixed"]


def _assert_same(got, want, shape):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for gs, ws in zip(g, w):
            ws = np.asarray(ws)
            assert gs.dtype == torch.int32 and tuple(gs.shape) == ws.shape
            assert ws.shape in ((shape[0], shape[1]), (shape[0], 1))
            np.testing.assert_array_equal(gs.numpy(), ws)


@pytest.mark.parametrize("shape", [(8, 128), (16, 512), (8, 1280)])
def test_fused_plain_matches_pallas_interpret(interp, shape):
    """Every list's groups in one interpret-mode kernel (the JAX kernel has
    no group limit; the groups are independent, so this checks each)."""
    lists = _group_lists(np.random.default_rng(shape[1]), shape)
    assert psc.fused_scan_ok(*shape) and scan.fused_scan_ok(*shape)
    want = psc.fused_scan([g for n in LIST_NAMES for g in lists(psc, jnp.asarray)[n]])
    got = scan.fused_scan_plain([g for n in LIST_NAMES for g in lists(scan, _t)[n]])
    _assert_same(got, want, shape)


@pytest.mark.parametrize("name", LIST_NAMES)
def test_fused_odd_shape_matches_lax(name):
    """[5, 300] (no TPU tiling) against each group's own lax scan."""
    shape = (5, 300)
    lists = _group_lists(np.random.default_rng(len(name)), shape)
    groups = lists(psc, jnp.asarray)[name]
    want = []
    for g in groups:
        op, identities, _, emit_idx, emit_last = psc._group_spec(g)
        scanned = _lax_scan(op, tuple(g["xs"]))
        want.append(tuple(scanned[i][:, -1:] if emit_last else scanned[i] for i in emit_idx))
    _assert_same(scan.fused_scan(lists(scan, _t)[name]), want, shape)


def test_fused_gate_and_cpu_wrapper(monkeypatch):
    """The gate keeps the JAX lane cap and drops the TPU tiling rules;
    ``TEXTBLAST_FUSED=off`` selects the staged schedule; the CPU wrapper
    runs the plain version and counts no launch."""
    monkeypatch.delenv("TEXTBLAST_FUSED", raising=False)
    assert scan.fused_scan_ok(37, 1000) and scan.fused_scan_ok(64, 16384)
    assert not scan.fused_scan_ok(64, 32768)
    monkeypatch.setenv("TEXTBLAST_FUSED", "off")
    assert not scan.fused_scan_ok(64, 512)
    before = dict(scan.LAUNCHES)
    rng = np.random.default_rng(3)
    m, a = _t(_full_range(rng, (3, 9))), _t(_full_range(rng, (3, 9)))
    groups = [scan.affine_group(m, (a,)), scan.add_group((a,), emit="last")]
    got, want = scan.fused_scan(groups), scan.fused_scan_plain(groups)
    assert all(torch.equal(g, w) for gg, ww in zip(got, want) for g, w in zip(gg, ww))
    assert got[1][0].shape == (3, 1)
    assert scan.LAUNCHES == before
    with pytest.raises(ValueError):
        scan.fused_scan([{"kind": "segmax", "xs": (m, a)}])
