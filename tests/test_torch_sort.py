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
