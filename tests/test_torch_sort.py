"""The port's ``sort2`` and ``sort3`` against the JAX package's bitonic Pallas kernel.

``sort2_plain`` (the CPU path of ``textblaster_tpu_torch.ops.sort``) must
equal ``pallas_sort2(interpret=True)`` and JAX ``sort2`` exactly, with
negative keys, ties and ``INT32_MAX`` pads.  Widths that are not a power of
two take the kernel's padding rule — pad with ``(INT32_MAX, INT32_MAX)``,
sort, keep the real columns — which is checked here against JAX ``sort2``
on the unpadded rows.  The CUDA kernel is compared with ``sort2_plain`` on
the card by ``tests/test_torch_card.py`` and ``chip_smoke.py``.

``sort3_plain`` must equal ``pallas_sort3(interpret=True)`` and
``lax.sort(num_keys=3)`` on full-range keys with ties and the int32
extremes, as must the CPU wrapper at widths that are not a power of two.

A numpy model of ``csrc/sort.cu``'s register network (one network for both
elements: two keys in a u64, three in a u64 and a u32) walks its stage
schedule, slots and cross-CTA rule in ``sort_geometry``'s layouts and in
clusters of 1, 2 and 4, and must sort as the plain versions do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textblaster_tpu.ops import pallas_sort as ps
from textblaster_tpu_torch.ops import sort

from test_torch_pipeline import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.torch_port

I32_MAX = 2**31 - 1


def _keys(rng, shape):
    """Negative and positive keys with many ties, some INT32_MAX pads, and
    non-negative payloads (the sort2 contract)."""
    k1 = rng.integers(-40, 40, size=shape).astype(np.int32)
    k1[rng.random(shape) < 0.1] = I32_MAX
    k1[rng.random(shape) < 0.05] = -(2**31)
    k2 = rng.integers(0, 50, size=shape).astype(np.int32)
    k2[rng.random(shape) < 0.1] = I32_MAX - 1
    return k1, k2


@pytest.mark.parametrize("shape", [(8, 128), (16, 256), (8, 1024)])
def test_plain_matches_pallas_interpret_and_jax_sort2(shape):
    rng = np.random.default_rng(shape[1])
    k1, k2 = _keys(rng, shape)
    kernel = ps.pallas_sort2(jnp.asarray(k1), jnp.asarray(k2), interpret=True)
    jax_sort = ps.sort2(jnp.asarray(k1), jnp.asarray(k2))
    got = sort.sort2_plain(torch.from_numpy(k1), torch.from_numpy(k2))
    for g, wk, wj in zip(got, kernel, jax_sort):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wj))


@pytest.mark.parametrize("width", [3, 100, 1536, 1000])
def test_padding_rule_matches_jax_sort2(width):
    rng = np.random.default_rng(width)
    k1, k2 = _keys(rng, (5, width))
    mp = 1 << (width - 1).bit_length()
    pad = np.full((5, mp - width), I32_MAX, np.int32)
    p1, p2 = np.concatenate([k1, pad], 1), np.concatenate([k2, pad], 1)
    s1, s2 = sort.sort2_plain(torch.from_numpy(p1), torch.from_numpy(p2))
    w1, w2 = ps.sort2(jnp.asarray(k1), jnp.asarray(k2))
    np.testing.assert_array_equal(s1[:, :width].numpy(), np.asarray(w1))
    np.testing.assert_array_equal(s2[:, :width].numpy(), np.asarray(w2))
    # The CPU wrapper (any width, no padding) agrees too.
    g1, g2 = sort.sort2(torch.from_numpy(k1), torch.from_numpy(k2))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(w2))


def _keys3(rng, shape):
    """Three signed keys with many ties and both int32 extremes."""
    out = []
    for _ in range(3):
        k = rng.integers(-3, 3, size=shape).astype(np.int32)
        k[rng.random(shape) < 0.05] = I32_MAX
        k[rng.random(shape) < 0.05] = -(2**31)
        out.append(k)
    return out


@pytest.mark.parametrize("shape", [(8, 128), (16, 256), (8, 1024)])
def test_sort3_plain_matches_pallas_interpret_and_lax(shape):
    ks = _keys3(np.random.default_rng(shape[1] + 1), shape)
    kernel = ps.pallas_sort3(*map(jnp.asarray, ks), interpret=True)
    lax = jax.lax.sort(tuple(map(jnp.asarray, ks)), dimension=1, num_keys=3)
    got = sort.sort3_plain(*map(torch.from_numpy, ks))
    for g, wk, wl in zip(got, kernel, lax):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wl))


@pytest.mark.parametrize("width", [1, 100, 1000])
def test_sort3_cpu_wrapper_matches_lax_at_any_width(width):
    ks = _keys3(np.random.default_rng(width), (5, width))
    lax = jax.lax.sort(tuple(map(jnp.asarray, ks)), dimension=1, num_keys=3)
    before = dict(sort.LAUNCHES)
    for g, w in zip(sort.sort3(*map(torch.from_numpy, ks)), lax):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sort.LAUNCHES == before


# --- a numpy rehearsal of csrc/sort.cu's register network ------------------------


def _swz(i):
    # sort.cu swz(): an 8-byte slot; the low four index bits XOR the next four.
    return i ^ ((i >> 4) & 15)


def _swz32(i):
    # sort.cu swz32(): a 4-byte slot; the low five index bits XOR the next five.
    return i ^ ((i >> 5) & 31)


_FLIP = np.uint64(0x80000000)
_LO32 = np.uint64(0xFFFFFFFF)


def _pack(ks):
    """The kernel's element as a tuple of uint64 words compared in order:
    (flip(k1) << 32 | k2,) for two keys (Key2), (flip(k1) << 32 | flip(k2),
    flip(k3)) for three (Key3)."""
    u = [k.astype(np.uint32).astype(np.uint64) for k in ks]
    if len(ks) == 2:
        return (((u[0] ^ _FLIP) << np.uint64(32)) | u[1],)
    return (((u[0] ^ _FLIP) << np.uint64(32)) | (u[1] ^ _FLIP), u[2] ^ _FLIP)


def _unpack(words, n_keys):
    def i32(x):
        return (x & _LO32).astype(np.uint32).view(np.int32)

    hi = words[0]
    if n_keys == 2:
        return i32((hi >> np.uint64(32)) ^ _FLIP), i32(hi)
    return i32((hi >> np.uint64(32)) ^ _FLIP), i32(hi ^ _FLIP), i32(words[1] ^ _FLIP)


def _less(a, b):
    """Key2/Key3 less(): words compared in order."""
    lt = a[-1] < b[-1]
    for x, y in zip(a[-2::-1], b[-2::-1]):
        lt = (x < y) | ((x == y) & lt)
    return lt


def _sel(c, a, b):
    return tuple(np.where(c, x, y) for x, y in zip(a, b))


def _exchange(x, y, asc):
    """sort.cu exchange(): (x, y) ascending where ``asc``, else descending."""
    swap = _less(y, x) == asc
    return _sel(swap, y, x), _sel(swap, x, y)


def _model_sort(ks, g=None):
    """``sort2`` (two keys) or ``sort3`` (three) through the stage schedule
    and index arithmetic of ``csrc/sort.cu``'s register network, in numpy,
    in the layout ``g`` (default: ``sort_geometry``'s): ``v[row, cta,
    thread, register]`` in the blocked layout, register stages below ``E``,
    shuffle stages below ``32 E`` (the partner lane ``lane ^ j / E``),
    shared-memory stages over the swizzled slots (pair ``q = t + r T``; for
    three keys hi in 8-byte ``swz`` slots, lo in 4-byte ``swz32`` slots),
    and each stride of at least ``n`` through the partner CTA ``rank ^ j /
    n``'s slots (element ``t + r T``), the lower rank keeping the minima
    where ``(rank n) & k`` is 0."""
    n_keys = len(ks)
    rows, m = ks[0].shape
    g = g or sort.sort_geometry(m, n_keys)
    E, T, C = g.keys, g.threads, g.ctas
    n = T * E
    pad = _pack([np.full((rows, g.mp - m), I32_MAX, np.int32)] * n_keys)
    v = tuple(np.concatenate([w, p], 1).reshape(rows, C, T, E) for w, p in zip(_pack(ks), pad))
    slot_of = (_swz, _swz32)[:len(v)]  # each word's slot function
    t = np.arange(T)[None, None, :, None]
    e = np.arange(E)[None, None, None, :]
    c = np.arange(C)[None, :, None, None]
    base = c * n + t * E
    blocked = (t * E + e)[0, 0]  # [T, E]: each register's element index

    def to_smem(v):
        s = tuple(np.empty((rows, C, n), np.uint64) for _ in v)
        for sw, w, f in zip(s, v, slot_of):
            sw[:, :, f(blocked)] = w
        return s

    def get(s, i):
        return tuple(sw[:, :, f(i)] for sw, f in zip(s, slot_of))

    def put(s, i, x):
        for sw, xw, f in zip(s, x, slot_of):
            sw[:, :, f(i)] = xw

    for k in (1 << b for b in range(1, g.mp.bit_length())):
        j = k // 2
        while C > 1 and j >= n:
            d = j // n
            s = to_smem(v)
            i = (np.arange(T)[:, None] + np.arange(E)[None, :] * T).ravel()  # t + r T
            x = tuple(sw[:, np.arange(C) ^ d][:, :, f(i)] for sw, f in zip(s, slot_of))
            y = get(s, i)
            keep_min = (((c & d) == 0) == (((c * n) & k) == 0))[..., 0]
            put(s, i, _sel(_less(x, y) == keep_min, x, y))
            v = tuple(sw[:, :, f(blocked)] for sw, f in zip(s, slot_of))
            j //= 2
        if j >= 32 * E:
            s = to_smem(v)
            rank = np.arange(C)[:, None]
            while j >= 64 * E:  # two strides a step: quadruples (b, b+h, b+j, b+j+h)
                q = (np.arange(T)[:, None] + np.arange(E // 4)[None, :] * T).ravel()
                h = j // 2
                b = 2 * j * (q // h) + q % h
                asc = ((rank * n + b[None, :]) & k) == 0
                idx = [b, b + h, b + j, b + j + h]
                x = [get(s, i) for i in idx]
                x[0], x[2] = _exchange(x[0], x[2], asc)
                x[1], x[3] = _exchange(x[1], x[3], asc)
                x[0], x[1] = _exchange(x[0], x[1], asc)
                x[2], x[3] = _exchange(x[2], x[3], asc)
                for i, xi in zip(idx, x):
                    put(s, i, xi)
                j //= 4
            if j >= 32 * E:
                q = (np.arange(T)[:, None] + np.arange(E // 2)[None, :] * T).ravel()
                lo = 2 * j * (q // j) + q % j
                asc = ((rank * n + lo[None, :]) & k) == 0
                a, b = _exchange(get(s, lo), get(s, lo + j), asc)
                put(s, lo, a)
                put(s, lo + j, b)
                j //= 2
            v = tuple(sw[:, :, f(blocked)] for sw, f in zip(s, slot_of))
        j = min(k // 2, 16 * E)
        while j >= E:
            lm = j // E
            o = tuple(w[:, :, np.arange(T) ^ lm] for w in v)
            keep_min = (((t % 32) & lm) == 0) == ((base & k) == 0)
            v = _sel(_less(o, v) == keep_min, o, v)
            j //= 2
        j = E // 2
        while j >= 1:
            if j < k:
                for r in range(E):
                    if r & j == 0:
                        asc = ((base[..., 0] + r) & k) == 0
                        a, b = _exchange(tuple(w[..., r] for w in v),
                                         tuple(w[..., r | j] for w in v), asc)
                        for w, aw, bw in zip(v, a, b):
                            w[..., r], w[..., r | j] = aw, bw
            j //= 2
    return _unpack(tuple(w.reshape(rows, g.mp)[:, :m] for w in v), n_keys)


def _model_keys(rng, n_keys, rows, width):
    """Rows with ties, both int32 extremes and (two keys) payloads up to
    INT32_MAX - 1; beyond 8 keys an already sorted and a reverse-sorted row."""
    if n_keys == 2:
        k1, k2 = _keys(rng, (rows, width))
        k2[:, ::7] = rng.integers(0, I32_MAX - 1, size=k2[:, ::7].shape)
        ks = [k1, k2]
    else:
        ks = _keys3(rng, (rows, width))
    if width > 8:
        ks[0][1] = np.sort(ks[0][1])
        ks[0][2 % rows] = np.sort(ks[0][2 % rows])[::-1]
    return ks


def _plain(ks):
    t = tuple(map(torch.from_numpy, ks))
    return [x.numpy() for x in (sort.sort2_plain(*t) if len(ks) == 2 else sort.sort3_plain(*t))]


_MODEL_CASES = (
    [pytest.param(2, w, id=str(w)) for w in (1, 3, 64, 255, 256, 512, 1025, 2048, 2049, 4096,
                                             8192, 16383, 16384)]
    + [pytest.param(3, w, id=f"sort3-{w}") for w in (1, 3, 255, 256, 1025, 8192, 16385, 32768)])


@pytest.mark.parametrize("n_keys, width", _MODEL_CASES)
def test_register_network_model_sorts(n_keys, width):
    """The numpy model of the kernel's stage schedule equals sort2_plain
    (two keys) or sort3_plain and ``lax.sort(num_keys=3)`` (three) on rows
    with ties and both int32 extremes, at every main-path width and ragged
    ones, in sort_geometry's layout."""
    rng = np.random.default_rng(width + 11 + 100 * n_keys)
    rows = 3 if n_keys == 2 or width <= 8192 else 2
    ks = _model_keys(rng, n_keys, rows, width)
    got = _model_sort(ks)
    want = _plain(ks)
    for gk, wk in zip(got, want):
        np.testing.assert_array_equal(gk, wk)
    if n_keys == 3:
        lax = jax.lax.sort(tuple(map(jnp.asarray, ks)), dimension=1, num_keys=3)
        for gk, wk in zip(got, lax):
            np.testing.assert_array_equal(gk, np.asarray(wk))


@pytest.mark.parametrize("n_keys, mp, keys, ctas", [
    (3, 8192, 8, 1), (3, 8192, 8, 2), (3, 8192, 16, 4), (3, 16384, 16, 4), (3, 32768, 8, 4),
    (2, 8192, 16, 4)])
def test_register_network_model_clusters(n_keys, mp, keys, ctas):
    """The model in layouts beside sort_geometry's (one CTA, clusters of 2
    and 4, E = 8 and 16): the general cross-CTA rule (partner rank ^ j/n,
    direction from the rank bits) sorts as the plain version does."""
    rng = np.random.default_rng(mp + keys + ctas)
    ks = _model_keys(rng, n_keys, 2, mp - 5)
    g = sort.SortGeometry(mp, keys, mp // keys // ctas, ctas, 1)
    for gk, wk in zip(_model_sort(ks, g), _plain(ks)):
        np.testing.assert_array_equal(gk, wk)


def test_register_network_geometry_and_banks():
    """Every width up to REG_WIDTH2 (sort2) or REG_WIDTH3 (sort3) has a
    layout whose threads cover the padded row once; above it the
    shared-memory network runs.  The swizzle is a bijection, and the 8-byte
    accesses of a half-warp (a blocked write of one register, a
    shared-memory stage's 16 consecutive pairs) land on 16 distinct bank
    pairs."""
    for n_keys, top in ((2, sort.REG_WIDTH2), (3, sort.REG_WIDTH3)):
        for m in (1, 2, 33, 64, 100, 1024, 1025, 5000, 8192, 16383, 16384, 16385, 32768):
            g = sort.sort_geometry(m, n_keys)
            if m > top:
                assert g is None
                continue
            assert g.mp >= m and g.keys * g.threads * g.ctas == g.mp
            assert g.threads % 32 == 0 and g.keys in (2, 4, 8, 16, 32)
            assert g.threads * g.keys <= 8192 and g.ctas in (1, 2, 4)
            assert g.rows_per_cta == 1 or (g.threads == 32 and g.ctas == 1)
            assert g.rows_per_cta in (1, 4)
        assert sort.sort_geometry(top + 1, n_keys) is None
    assert max(sort.sort_geometry(m, 2).ctas for m in range(1, 16385, 511)) == 2
    i = np.arange(8192)
    assert sorted(_swz(i)) == list(i)
    for e in range(16):
        for half in (0, 16):
            tt = np.arange(half, half + 16)
            assert len(set(_swz(tt * 16 + e) % 16)) == 16
    for j in (512, 1024, 4096):
        for q0 in (0, 16, 48, 2048 - 16):
            q = np.arange(q0, q0 + 16)
            lo = 2 * j * (q // j) + q % j
            assert len(set(_swz(lo) % 16)) == 16 and len(set(_swz(lo + j) % 16)) == 16
            if j >= 1024:  # a two-stride step's quadruples
                b = 2 * j * (q // (j // 2)) + q % (j // 2)
                for off in (0, j // 2, j, j + j // 2):
                    assert len(set(_swz(b + off) % 16)) == 16


def test_register_network_key3_banks():
    """sort3's two shared-memory arrays: the hi slots (8 bytes, ``swz``)
    take 16 distinct bank pairs a half-warp and the lo slots (4 bytes,
    ``swz32``) 32 distinct banks a warp, for a blocked write of one
    register at E = 8 and 16 and for the 32 consecutive pairs or
    quadruple members of a shared-memory stage (strides 32E .. 4096);
    ``swz32`` is a bijection."""
    i = np.arange(8192)
    assert sorted(_swz32(i)) == list(i)
    for E in (8, 16):
        for t0 in (0, 32, 96, 1024 // E - 32):
            lanes = np.arange(t0, t0 + 32)
            for e in range(E):
                idx = lanes * E + e
                assert len(set(_swz32(idx) % 32)) == 32
                for half in (idx[:16], idx[16:]):
                    assert len(set(_swz(half) % 16)) == 16
        j = 32 * E
        while j <= 4096:
            for q0 in (0, 32, 8192 // 4 - 32):
                q = np.arange(q0, q0 + 32)
                lo = 2 * j * (q // j) + q % j
                quads = [2 * j * (q // (j // 2)) + q % (j // 2)] if j >= 64 * E else []
                for b in [lo, lo + j] + [x + off for x in quads
                                         for off in (0, j // 2, j, j + j // 2)]:
                    assert len(set(_swz32(b) % 32)) == 32
                    assert len(set(_swz(b[:16]) % 16)) == 16
                    assert len(set(_swz(b[16:]) % 16)) == 16
            j *= 2
