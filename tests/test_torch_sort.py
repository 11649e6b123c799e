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
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textblaster_tpu.ops import pallas_sort as ps
from textblaster_tpu_torch.ops import sort

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


class Sort2Geometry(NamedTuple):
    """One row's layout in the register network (``csrc/sort.cu``
    ``sort2_registers``): ``mp`` padded keys, ``keys`` consecutive keys a
    thread, ``threads`` a CTA (one warp a row below 2048 keys), ``ctas`` a
    row (a cluster of two at 16384) and ``rows_per_cta``."""

    mp: int
    keys: int
    threads: int
    ctas: int
    rows_per_cta: int


def sort2_geometry(m):
    """The register network's geometry for rows of ``m`` keys, or None above
    ``SMEM_WIDTH`` (the shared-memory network)."""
    mp = max(2, 1 << (m - 1).bit_length())
    if mp > sort.SMEM_WIDTH:
        return None
    if mp <= 1024:
        mp = max(mp, 64)
        return Sort2Geometry(mp, mp // 32, 32, 1, 4)
    ctas = 2 if mp == sort.SMEM_WIDTH else 1
    return Sort2Geometry(mp, 16, mp // 16 // ctas, ctas, 1)


def _swz(i):
    # sort.cu swz(): the low four index bits XOR the next four.
    return i ^ ((i >> 4) & 15)


def _model_sort2(k1, k2):
    """``sort2`` through the stage schedule and index arithmetic of
    ``csrc/sort.cu``'s register network, in numpy: ``v[row, cta, thread,
    register]`` in the blocked layout, register stages below ``E``, shuffle
    stages below ``32 E`` (the partner lane ``lane ^ j / E``), shared-memory
    stages over the swizzled slots (pair ``q = t + r T``), and the
    cross-CTA stage through the partner's slots."""
    rows, m = k1.shape
    g = sort2_geometry(m)
    E, T, C = g.keys, g.threads, g.ctas
    n = T * E
    packed = (((k1.astype(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64) << np.uint64(32))
              | k2.astype(np.uint32).astype(np.uint64))
    pad = np.full((rows, g.mp - m), 0xFFFFFFFF7FFFFFFF, np.uint64)
    v = np.concatenate([packed, pad], 1).reshape(rows, C, T, E)
    t = np.arange(T)[None, None, :, None]
    e = np.arange(E)[None, None, None, :]
    c = np.arange(C)[None, :, None, None]
    base = c * n + t * E
    slot = _swz(t * E + e)[0, 0]  # [T, E]: each register's shared-memory slot

    def to_smem(v):
        s = np.empty((rows, C, n), np.uint64)
        s[:, :, slot] = v
        return s

    for k in (1 << s for s in range(1, g.mp.bit_length())):
        j = k // 2
        if C > 1 and j >= n:
            s = to_smem(v)
            x = s[:, ::-1][:, :, slot]  # the partner CTA's keys, same slots
            v = np.where(c == 0, np.minimum(v, x), np.maximum(v, x))
            j //= 2
        if j >= 32 * E:
            s = to_smem(v)
            rank = np.arange(C)[:, None]

            def exchange(x, y, asc):
                return (np.where(asc, np.minimum(x, y), np.maximum(x, y)),
                        np.where(asc, np.maximum(x, y), np.minimum(x, y)))

            while j >= 64 * E:  # two strides a step: quadruples (b, b+h, b+j, b+j+h)
                q = (np.arange(T)[:, None] + np.arange(E // 4)[None, :] * T).ravel()
                h = j // 2
                b = 2 * j * (q // h) + q % h
                asc = ((rank * n + b[None, :]) & k) == 0
                idx = [_swz(b), _swz(b + h), _swz(b + j), _swz(b + j + h)]
                x = [s[:, :, i] for i in idx]
                x[0], x[2] = exchange(x[0], x[2], asc)
                x[1], x[3] = exchange(x[1], x[3], asc)
                x[0], x[1] = exchange(x[0], x[1], asc)
                x[2], x[3] = exchange(x[2], x[3], asc)
                for i, xi in zip(idx, x):
                    s[:, :, i] = xi
                j //= 4
            if j >= 32 * E:
                q = (np.arange(T)[:, None] + np.arange(E // 2)[None, :] * T).ravel()
                lo = 2 * j * (q // j) + q % j
                asc = ((rank * n + lo[None, :]) & k) == 0
                s[:, :, _swz(lo)], s[:, :, _swz(lo + j)] = exchange(
                    s[:, :, _swz(lo)], s[:, :, _swz(lo + j)], asc)
                j //= 2
            v = s[:, :, slot]
        j = min(k // 2, 16 * E)
        while j >= E:
            lm = j // E
            o = v[:, :, np.arange(T) ^ lm]
            keep_min = (((t % 32) & lm) == 0) == ((base & k) == 0)
            v = np.where(keep_min, np.minimum(v, o), np.maximum(v, o))
            j //= 2
        j = E // 2
        while j >= 1:
            if j < k:
                for r in range(E):
                    if r & j == 0:
                        asc = ((base[..., 0] + r) & k) == 0
                        a, b = v[..., r].copy(), v[..., r | j].copy()
                        v[..., r] = np.where(asc, np.minimum(a, b), np.maximum(a, b))
                        v[..., r | j] = np.where(asc, np.maximum(a, b), np.minimum(a, b))
            j //= 2
    out = v.reshape(rows, g.mp)[:, :m]
    return ((out >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32), \
        (out & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("width", [1, 3, 64, 255, 256, 512, 1025, 2048, 2049, 4096, 8192,
                                   16383, 16384])
def test_register_network_model_sorts(width):
    """The numpy model of the kernel's stage schedule equals sort2_plain on
    rows with ties, both int32 extremes and payloads up to INT32_MAX - 1,
    at every main-path width and ragged ones."""
    rng = np.random.default_rng(width + 11)
    rows = 3
    k1, k2 = _keys(rng, (rows, width))
    k2[:, ::7] = rng.integers(0, I32_MAX - 1, size=k2[:, ::7].shape)
    if width > 8:  # an already sorted and a reverse-sorted row
        k1[1] = np.sort(k1[1])
        k1[2] = np.sort(k1[2])[::-1]
    got = _model_sort2(k1, k2)
    want = sort.sort2_plain(torch.from_numpy(k1), torch.from_numpy(k2))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def test_register_network_geometry_and_banks():
    """Every width up to SMEM_WIDTH has a layout whose threads cover the
    padded row once; above it the shared-memory network runs.  The swizzle
    is a bijection, and the 8-byte accesses of a half-warp (a blocked
    write of one register, a shared-memory stage's 16 consecutive pairs)
    land on 16 distinct bank pairs."""
    for m in (1, 2, 33, 64, 100, 1024, 1025, 5000, 8192, 16383, 16384):
        g = sort2_geometry(m)
        assert g.mp >= m and g.keys * g.threads * g.ctas == g.mp
        assert g.threads % 32 == 0 and g.threads <= 1024 and g.keys in (2, 4, 8, 16, 32)
        assert g.ctas == 1 or (g.ctas == 2 and g.rows_per_cta == 1)
        assert g.rows_per_cta == 1 or g.threads == 32  # several rows per CTA: one warp each
    assert sort2_geometry(16385) is None
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
