"""The port's row scans against the JAX package's per-scan Pallas kernel.

``affine_hash_scan_plain`` and ``dfa_compose_scan_plain`` (the CPU path of
``textblaster_tpu_torch.ops.scan``) must equal, exactly, the JAX kernel
``_pallas_scan_tuple`` run in interpret mode and its lax twin
(``jax.lax.associative_scan``) on the same int32 inputs.  The CUDA kernels
themselves are compared with these plain versions on the card by
``tests/test_torch_card.py`` and ``chip_smoke.py``; here a numpy model of
their schedule (``csrc/scan_ops.cuh``'s row scan under ``scan_geometry``,
and ``csrc/fused.cu``'s scan units under ``fused_geometry``) is held to
the plain versions at every edge of the geometry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textblaster_tpu.ops import pallas_scan as psc
from textblaster_tpu_torch.ops import scan

from test_torch_pipeline import one_torch_thread  # noqa: F401  (autouse fixture)

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


# --- the schedule of csrc/scan.cu, modelled in numpy ---------------------------
#
# The kernels themselves run only on the card.  These tests walk
# ``scan.scan_geometry`` at every edge of its paths with a numpy model of
# what each thread does -- its consecutive lanes, the warp scan, the fold of
# the warp totals, the fold of the cluster's chunk aggregates in rank order
# and the carry across segments -- with the DFA combine as the kernel's
# __byte_perm form, and hold the model to the plain versions and the JAX
# twins.  Folding in the wrong order must fail the model.

EDGE_WIDTHS = [1, 31, 32, 511, 512, 513, 2047, 2048, 8192, 8193, 16384, 32768, 65536, 70000]
_U32 = np.uint32


def _u32(a):
    return np.asarray(a, dtype=np.int64).astype(_U32) if np.ndim(a) == 0 else np.asarray(a).astype(_U32)


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)``: byte i of the result is byte
    ``s<4i+2:4i>`` of the eight bytes y:x (x the low four)."""
    x, y, s = np.broadcast_arrays(_u32(x), _u32(y), _u32(s))
    src = np.stack([(x >> _U32(8 * i)) & _U32(0xFF) for i in range(4)]
                   + [(y >> _U32(8 * i)) & _U32(0xFF) for i in range(4)], axis=-1)
    out = np.zeros(x.shape, dtype=_U32)
    for i in range(4):
        idx = ((s >> _U32(4 * i)) & _U32(7)).astype(np.intp)
        out |= np.take_along_axis(src, idx[..., None], -1)[..., 0] << _U32(8 * i)
    return out


class _Affine:
    """``Affine<K>`` of scan_ops.cuh: states and elements are (m, a1..aK)."""

    name = "affine"

    def __init__(self, k):
        self.k = k
        self.raw_identity = (1,) + (0,) * k

    def identity(self, shape):
        return tuple(np.full(shape, v, dtype=_U32) for v in self.raw_identity)

    def combine(self, x, y):
        return (x[0] * y[0],) + tuple(ya + y[0] * xa for xa, ya in zip(x[1:], y[1:]))

    def elem(self, raw):
        return raw

    step = combine

    def outs(self, s):
        return s[1:]

    def raw_outs(self, raw):
        return raw[1:]


class _Dfa:
    """``Dfa<NS>`` of scan_ops.cuh: a state is the nibble-packed map, an element
    the map spread to eight bytes; the combine is __byte_perm's lookup."""

    name = "dfa"

    def __init__(self, ns):
        self.ns = ns
        self.mask = _U32(0xFFFFFFFF if ns == 8 else (1 << (4 * ns)) - 1)
        self.raw_identity = (scan.dfa_ident(ns),)

    def identity(self, shape):
        return (np.full(shape, self.raw_identity[0], dtype=_U32),)

    @staticmethod
    def _spread(f, sel):
        d = _byte_perm(f, 0, sel)
        return (d & _U32(0x000F000F)) | ((d >> _U32(4)) & _U32(0x0F000F00))

    def elem(self, raw):
        return (self._spread(raw[0], 0x1100), self._spread(raw[0], 0x3322))

    def step(self, s, e):
        lo, hi = e
        r = _byte_perm(lo, hi, s[0])
        t = r | (r >> _U32(4))
        if self.ns > 4:
            r2 = _byte_perm(lo, hi, s[0] >> _U32(16))
            out = _byte_perm(t, r2 | (r2 >> _U32(4)), 0x6420)
        else:
            out = _byte_perm(t, 0, 0x4420)
        return (out & self.mask,)

    def combine(self, x, y):
        return self.step(x, self.elem(y))

    def outs(self, s):
        return s

    def raw_outs(self, raw):
        return raw


def _sel(cond, a, b):
    return tuple(np.where(cond, x, y) for x, y in zip(a, b))


def _take(s, idx, axis):
    return tuple(np.take(x, idx, axis=axis) for x in s)


def _hs_inclusive(op, x, axis, n, swap=False):
    """Inclusive __shfl_up_sync scan over the first ``n`` positions of
    ``axis`` (the rest hold the identity): at each offset, position i takes
    combine(x[i - off], x[i]) -- with ``swap`` the later one on the left."""
    size = x[0].shape[axis]
    pos = np.arange(size).reshape([-1 if a == axis % x[0].ndim else 1 for a in range(x[0].ndim)])
    off = 1
    while off < n:
        up = tuple(np.roll(v, off, axis=axis) for v in x)
        new = op.combine(x, up) if swap else op.combine(up, x)
        x = _sel(pos >= off, new, x)
        off <<= 1
    return x


def _exclusive(op, inc, axis):
    """The exclusive prefix from an inclusive scan: shift up one, identity
    at position 0."""
    shape = inc[0].shape
    pos = np.arange(shape[axis]).reshape([-1 if a == axis % len(shape) else 1
                                          for a in range(len(shape))])
    up = tuple(np.roll(v, 1, axis=axis) for v in inc)
    return _sel(pos == 0, op.identity(shape), up)


def _walk(op, e, run, items_axis=-1):
    """Re-walk: the inclusive outputs of each thread's consecutive items
    from its prefix ``run``."""
    outs = []
    for j in range(e[0].shape[items_axis]):
        run = op.step(run, _take(e, j, items_axis))
        outs.append(op.outs(run))
    return tuple(np.stack([o[k] for o in outs], axis=-1) for k in range(len(outs[0])))


def _fold(op, e):
    agg = op.identity(e[0].shape[:-1])
    for j in range(e[0].shape[-1]):
        agg = op.step(agg, _take(e, j, -1))
    return agg


def _model_scan(op, raw, swap=None, geo=None, last=False):
    """``scan_ops.cuh``'s row scan on the rows of ``raw`` (uint32 ``[R, L]``
    streams) under the geometry ``geo`` (``(cluster, threads, segments)``;
    ``csrc/scan.cu``'s ``scan_geometry(L, op)`` by default): each thread's
    consecutive lanes, the warp scan, the warps' fold, the cluster's fold in
    rank order and the carry across segments; with ``last`` only the row's
    total, ``[R, 1]``.  ``swap`` names a fold done with the later operand
    on the left (``"lanes"``, ``"warps"``, ``"chunks"``, ``"carry"``)."""
    rows, length = raw[0].shape
    if length == 1:
        return op.raw_outs(raw)
    c, t, segs = geo or scan.scan_geometry(length, op.name)
    it = scan.SCAN_ITEMS[op.name]
    n_warps, total = t // 32, segs * c * t * it
    pad = tuple(np.concatenate([r, np.full((rows, total - length), i, _U32)], 1)
                for r, i in zip(raw, op.raw_identity))
    carry = op.identity((rows, 1, 1, 1))
    out_segs = []
    for s in range(segs):
        seg = tuple(p[:, s * c * t * it:(s + 1) * c * t * it].reshape(rows, c, n_warps, 32, it)
                    for p in pad)
        e = op.elem(seg)
        inc = _hs_inclusive(op, _fold(op, e), 3, 32, swap == "lanes")       # [R, C, Wn, 32]
        excl = _exclusive(op, inc, 3)
        wi = _hs_inclusive(op, _take(inc, [31], 3), 2, n_warps, swap == "warps")  # [R, C, Wn, 1]
        warp_pref = _exclusive(op, wi, 2)
        chunk_tot = _take(wi, [n_warps - 1], 2)                             # [R, C, 1, 1]
        ci = _hs_inclusive(op, chunk_tot, 1, c, swap == "chunks")
        chunk_pref = _exclusive(op, ci, 1)
        seg_total = _take(ci, [c - 1], 1)                                   # [R, 1, 1, 1]
        pre = op.combine(op.combine(op.combine(carry, chunk_pref), warp_pref), excl)
        out_segs.append(tuple(o.reshape(rows, -1) for o in _walk(op, e, pre)))
        carry = op.combine(seg_total, carry) if swap == "carry" else op.combine(carry, seg_total)
    if last:
        return tuple(o.reshape(rows, 1) for o in op.outs(carry))
    return tuple(np.concatenate([o[k] for o in out_segs], 1)[:, :length]
                 for k in range(len(out_segs[0])))


def _maps_with_stray_nibbles(rng, shape, n_states):
    """Packed maps whose nibbles below ``n_states`` hold states and whose
    nibbles at or above it hold anything (the op clears those)."""
    out = rng.integers(0, 2**32, size=shape, dtype=np.int64)
    for s in range(n_states):
        out &= ~(15 << (4 * s))
        out |= rng.integers(0, n_states, size=shape, dtype=np.int64) << (4 * s)
    return out.astype(np.uint32).view(np.int32)


def _geometry_accepted(geo, length, op):
    """The geometry checks of scan.cu's launch()."""
    chunk = geo.threads * scan.SCAN_ITEMS[op]
    return (32 <= geo.threads <= 1024 and geo.threads % 32 == 0 and 1 <= geo.cluster <= 8
            and geo.segments >= 1 and chunk * geo.cluster * geo.segments >= length
            and chunk * geo.cluster * (geo.segments - 1) < length)


def test_scan_geometry_covers_each_row_at_its_edges():
    for op in ("affine", "dfa"):
        for length in EDGE_WIDTHS + [3, 600, 4096, 100000, 2**20]:
            geo = scan.scan_geometry(length, op)
            assert _geometry_accepted(geo, length, op), (op, length, geo)
    g = scan.scan_geometry
    assert g(1, "affine") == (1, 32, 1) and g(512, "affine") == (1, 128, 1)
    assert g(2048, "affine") == (1, 512, 1) and g(8192, "affine") == (1, 512, 4)
    assert g(8193, "affine") == (2, 1024, 2) and g(65536, "affine") == (2, 1024, 8)
    assert g(70000, "affine") == (2, 1024, 9)
    assert g(512, "dfa") == (1, 32, 1) and g(2048, "dfa") == (1, 128, 1)
    assert g(2049, "dfa") == (3, 64, 1) and g(8192, "dfa") == (8, 64, 1)
    assert g(8193, "dfa") == (5, 128, 1) and g(32768, "dfa") == (8, 128, 2)
    assert g(65536, "dfa") == (8, 128, 4) and g(70000, "dfa") == (8, 128, 5)


@pytest.mark.parametrize("n_states", range(1, 9))
def test_byte_perm_combine_matches_the_dfa_op(n_states):
    """The kernel's __byte_perm combine equals ``_dfa_op`` (the port's and
    the JAX package's) on maps with stray nibbles above ``n_states``, as
    the earlier or the later operand, and clears those nibbles."""
    rng = np.random.default_rng(100 + n_states)
    x = _maps_with_stray_nibbles(rng, (4096,), n_states)
    y = _maps_with_stray_nibbles(rng, (4096,), n_states)
    (got,) = _Dfa(n_states).combine((_u32(x),), (_u32(y),))
    (want,) = scan._dfa_op(n_states)((torch.from_numpy(x),), (torch.from_numpy(y),))
    (want_jax,) = psc._dfa_op(n_states)((jnp.asarray(x),), (jnp.asarray(y),))
    np.testing.assert_array_equal(got.view(np.int32), want.numpy())
    np.testing.assert_array_equal(got.view(np.int32), np.asarray(want_jax))
    assert not (got & ~_Dfa(n_states).mask).any()


def _edge_inputs(rng, shape):
    m, a1, a2 = (_full_range(rng, shape) for _ in range(3))
    return m, a1, a2


@pytest.mark.parametrize("width", EDGE_WIDTHS)
def test_scan_model_matches_plain_at_geometry_edges(width):
    """The modelled kernel equals the plain versions at every edge of the
    geometry: k = 1 and 2, and every ``n_states`` on maps with stray upper
    nibbles (at width 1 the plain version returns them unchanged)."""
    rng = np.random.default_rng(width)
    shape = (2, width)
    m, a1, a2 = _edge_inputs(rng, shape)
    for accs in ((a1,), (a1, a2)):
        want = scan.affine_hash_scan_plain(_t(m), tuple(_t(a) for a in accs))
        got = _model_scan(_Affine(len(accs)), tuple(_u32(x) for x in (m,) + accs))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(np.int32), w.numpy())
    for ns in (range(1, 9) if width in (1, 513, 8193) else (4, 5, 8)):
        fns = _maps_with_stray_nibbles(rng, shape, ns)
        (got,) = _model_scan(_Dfa(ns), (_u32(fns),))
        np.testing.assert_array_equal(got.view(np.int32),
                                      scan.dfa_compose_scan_plain(_t(fns), ns).numpy())


@pytest.mark.parametrize("width", [31, 8193])
def test_scan_model_matches_lax(width):
    """The model against the JAX package's lax twins (its ops under
    ``jax.lax.associative_scan``) on valid maps: ``associative_scan``
    leaves lane 0 as it is, so on stray nibbles it differs from the plain
    shift schedule, which the kernel follows."""
    rng = np.random.default_rng(width + 7)
    shape = (2, width)
    m, a1, a2 = _edge_inputs(rng, shape)
    xs = tuple(jnp.asarray(x) for x in (m, a1, a2))
    lax = _lax_scan(psc._affine_op, xs)
    got = _model_scan(_Affine(2), tuple(_u32(x) for x in (m, a1, a2)))
    for g, w in zip(got, lax[1:]):
        np.testing.assert_array_equal(g.view(np.int32), np.asarray(w))
    fns = _packed_maps(rng, shape, 5)
    (lax_d,) = _lax_scan(psc._dfa_op(5), (jnp.asarray(fns),))
    (got,) = _model_scan(_Dfa(5), (_u32(fns),))
    np.testing.assert_array_equal(got.view(np.int32), np.asarray(lax_d))


@pytest.mark.parametrize("swap,width", [("lanes", 512), ("lanes", 2048), ("warps", 2048),
                                        ("chunks", 16384), ("carry", 70000)])
def test_scan_model_fails_with_a_swapped_fold(swap, width):
    """Every fold of the schedule is order-sensitive: done with the later
    operand on the left, the model no longer equals the plain version."""
    rng = np.random.default_rng(width)
    shape = (2, width)
    m, a1, _ = _edge_inputs(rng, shape)
    (want,) = scan.affine_hash_scan_plain(_t(m), (_t(a1),))
    (got,) = _model_scan(_Affine(1), (_u32(m), _u32(a1)), swap=swap)
    assert not np.array_equal(got.view(np.int32), want.numpy())
    fns = _maps_with_stray_nibbles(rng, shape, 5)
    (got,) = _model_scan(_Dfa(5), (_u32(fns),), swap=swap)
    assert not np.array_equal(got.view(np.int32), scan.dfa_compose_scan_plain(_t(fns), 5).numpy())


# --- the schedule of csrc/fused.cu, modelled in numpy ----------------------------
#
# fused.cu splits a group list into scan units (an affine group into units of
# the multiplier and up to four accumulators, an add group into one unit per
# stream, a dfa group into one unit) and runs scan_ops.cuh's row scan for
# each (row, unit) with fused_geometry's threads, no cluster, and
# ceil(len / (threads * ITEMS)) segments.  The model below does the same on
# numpy inputs and is held to fused_scan_plain at every width where a unit's
# segment count changes, and at one and zero lanes.


class _Add:
    """``Add<1>`` of scan_ops.cuh: one running sum."""

    name = "add"
    raw_identity = (0,)

    def identity(self, shape):
        return (np.zeros(shape, dtype=_U32),)

    def combine(self, x, y):
        return (x[0] + y[0],)

    def elem(self, raw):
        return raw

    step = combine

    def outs(self, s):
        return s

    def raw_outs(self, raw):
        return raw


def _fused_units(groups):
    """The unit split of fused.cu's entry: ``(op, inputs, outputs, last)``
    per unit, where ``outputs`` index the flat list of emitted streams."""
    units, out_i = [], 0
    for kind, xs, last, ns in groups:
        if kind == "affine":
            for a in range(1, len(xs), 4):
                k = min(4, len(xs) - a)
                units.append((_Affine(k), (xs[0],) + xs[a:a + k],
                              list(range(out_i + a - 1, out_i + a - 1 + k)), last))
            out_i += len(xs) - 1
        elif kind == "add":
            units += [(_Add(), (x,), [out_i + s], last) for s, x in enumerate(xs)]
            out_i += len(xs)
        else:
            units.append((_Dfa(ns), xs, [out_i], last))
            out_i += 1
    return units, out_i


def _model_fused(groups, swap=None):
    """fused.cu on ``groups`` (``(kind, numpy streams, emit_last, n_states)``):
    every unit's row scan, the flat emitted streams in group order."""
    rows, length = groups[0][1][0].shape
    threads = scan.fused_geometry(length)
    units, n_out = _fused_units(groups)
    flat = [None] * n_out
    for op, xs, outs, last in units:
        items = scan.SCAN_ITEMS[op.name]
        geo = (1, threads, -(-length // (threads * items)))
        if length == 0 and not last:
            got = tuple(np.zeros((rows, 0), _U32) for _ in outs)
        else:
            got = _model_scan(op, tuple(_u32(x) for x in xs), swap=swap, geo=geo, last=last)
        for i, g in zip(outs, got):
            flat[i] = g.view(np.int32)
    return flat


def _fused_plain_flat(groups):
    torch_groups = []
    for kind, xs, last, ns in groups:
        emit = "last" if last else "scan"
        ts = tuple(_t(x) for x in xs)
        if kind == "affine":
            torch_groups.append(scan.affine_group(ts[0], ts[1:], emit=emit))
        elif kind == "add":
            torch_groups.append(scan.add_group(ts, emit=emit))
        else:
            torch_groups.append(scan.dfa_group(ts[0], ns, emit=emit))
    return [x.numpy() for g in scan.fused_scan_plain(torch_groups) for x in g]


def _fused_edge_groups(rng, shape, dfa_states):
    """Affine k = 1 and 5 (two units), add scan and last, dfa groups with
    stray nibbles at ``dfa_states``, scan and last."""
    r = [_full_range(rng, shape) for _ in range(7)]
    groups = [("affine", (r[0], r[1]), False, 0),
              ("affine", tuple(r[1:7]), True, 0),
              ("add", (r[2], r[3]), False, 0),
              ("add", (r[4],), True, 0)]
    for i, ns in enumerate(dfa_states):
        groups.append(("dfa", (_maps_with_stray_nibbles(rng, shape, ns),), i % 2 == 1, ns))
    return groups


#: Widths where a unit's segment count (or the thread count's cap) changes,
#: and one either side: four-lane units cover 1024 lanes a segment at 256
#: threads, sixteen-lane ones 4096.
FUSED_EDGE_WIDTHS = [0, 1, 2, 127, 128, 129, 1023, 1024, 1025, 2049, 4095, 4096, 4097, 8193]


def test_fused_geometry_at_its_edges():
    g = scan.fused_geometry
    assert [g(n) for n in (0, 1, 128, 129, 512, 1024, 1025, 2048, 65536)] == [
        32, 32, 32, 64, 128, 256, 256, 256, 256]
    for n in FUSED_EDGE_WIDTHS + [65536, 70000]:
        t = g(n)
        assert 32 <= t <= scan.FUSED_MAX_THREADS and t % 32 == 0


@pytest.mark.parametrize("width", FUSED_EDGE_WIDTHS)
def test_fused_model_matches_plain_at_geometry_edges(width):
    """The modelled kernel equals ``fused_scan_plain`` at every edge of
    ``fused_geometry``, in both emit modes (at one lane the plain version
    returns the lane as it is; at zero a carry is the identity)."""
    rng = np.random.default_rng(500 + width)
    states = range(1, 9) if width in (0, 1, 129, 4097) else (4, 5, 8)
    groups = _fused_edge_groups(rng, (2, width), states)
    got, want = _model_fused(groups), _fused_plain_flat(groups)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("swap,width", [("lanes", 512), ("warps", 2048), ("carry", 8193)])
def test_fused_model_fails_with_a_swapped_fold(swap, width):
    """Each fold of the unit's walk is order-sensitive for the affine and
    DFA units: with the later operand on the left the model no longer
    equals the plain version, in either emit mode.  (A long DFA
    composition forgets its prefix, so eight rows make a differing lane
    all but certain.)"""
    rng = np.random.default_rng(width + 1)
    shape = (8, width)
    m, a = _full_range(rng, shape), _full_range(rng, shape)
    f = _maps_with_stray_nibbles(rng, shape, 5)
    for last in (False, True):
        groups = [("affine", (m, a), last, 0), ("dfa", (f,), last, 5)]
        got, want = _model_fused(groups, swap=swap), _fused_plain_flat(groups)
        for g, w in zip(got, want):
            assert not np.array_equal(g, w)
