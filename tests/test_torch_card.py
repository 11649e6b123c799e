"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one.  The file imports neither JAX nor the JAX package, so on a
machine with the GPU and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py

Every value is int32, so every comparison is exact.  ``chip_smoke.py``
repeats these checks at every main-path shape and times the kernels.
"""

import numpy as np
import pytest
import torch

from textblaster_tpu_torch.ops import scan, sort

pytestmark = pytest.mark.torch_port

I32_MAX = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _full_range(rng, shape, dev):
    a = rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(a).to(dev)


def _packed_maps(rng, shape, n_states, dev):
    out = np.zeros(shape, dtype=np.int64)
    for s in range(n_states):
        out |= rng.integers(0, n_states, size=shape, dtype=np.int64) << (4 * s)
    return torch.from_numpy(out.astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("shape", [(8, 128), (37, 1000), (64, 8192), (3, 70000)])
def test_scan_kernels_match_plain(cuda, shape):
    rng = np.random.default_rng(shape[1])
    m, a1, a2 = (_full_range(rng, shape, cuda) for _ in range(3))
    before = dict(scan.LAUNCHES)
    for accs in ((a1,), (a1, a2)):
        got = scan.affine_hash_scan(m, accs)
        want = scan.affine_hash_scan_plain(m, accs)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for ns in (4, 5, 8):
        f = _packed_maps(rng, shape, ns, cuda)
        assert torch.equal(scan.dfa_compose_scan(f, ns), scan.dfa_compose_scan_plain(f, ns))
    assert scan.LAUNCHES["affine_scan"] == before["affine_scan"] + 2
    assert scan.LAUNCHES["dfa_scan"] == before["dfa_scan"] + 3


@pytest.mark.parametrize("width", [1, 128, 1536, 16384, 32768, 65536])
def test_sort2_kernel_matches_plain(cuda, width):
    rng = np.random.default_rng(width)
    k1 = rng.integers(-40, 40, size=(8, width)).astype(np.int32)
    k1[rng.random(k1.shape) < 0.1] = I32_MAX
    k2 = rng.integers(0, I32_MAX, size=(8, width)).astype(np.int32)
    k1, k2 = torch.from_numpy(k1).to(cuda), torch.from_numpy(k2).to(cuda)
    before = sort.LAUNCHES["sort2"]
    got, want = sort.sort2(k1, k2), sort.sort2_plain(k1, k2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sort.LAUNCHES["sort2"] == before + 1


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        scan.affine_hash_scan(x.long(), (x.long(),))
    with pytest.raises(ValueError):
        scan.affine_hash_scan(x, (x, x, x))
    with pytest.raises(ValueError):
        scan.dfa_compose_scan(x, 9)
    with pytest.raises(ValueError):
        sort.sort2(x.t(), x.t())  # not contiguous
