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
from textblaster_tpu_torch.ops import stats

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


def _maps_with_stray_nibbles(rng, shape, n_states, dev):
    """Packed maps whose nibbles below ``n_states`` hold states and whose
    nibbles at or above it hold anything (the op clears those, except in a
    one-lane row, which the plain version returns as it is)."""
    out = rng.integers(0, 2**32, size=shape, dtype=np.int64)
    for s in range(n_states):
        out &= ~(15 << (4 * s))
        out |= rng.integers(0, n_states, size=shape, dtype=np.int64) << (4 * s)
    return torch.from_numpy(out.astype(np.uint32).view(np.int32)).to(dev)


def _offset_view(t):
    """``t``'s values in a contiguous view 4 bytes past an aligned base, so
    that the kernel takes its scalar loads and stores."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


#: Every edge of ops/scan.py's scan_geometry: one warp per row to 512
#: lanes, one CTA to 8192, clusters beyond, segments beyond 65536.
SCAN_EDGE_WIDTHS = [1, 31, 32, 511, 512, 513, 2047, 2048, 8192, 8193, 16384, 32768, 65536,
                    70000]


@pytest.mark.parametrize("rows", [1, 7, 64, 65])
@pytest.mark.parametrize("width", SCAN_EDGE_WIDTHS)
def test_scan_kernels_match_plain(cuda, width, rows):
    """k = 1 and 2, and every n_states on maps with stray upper nibbles, on
    aligned tensors and on offset views, exact."""
    rng = np.random.default_rng(width * 100 + rows)
    shape = (rows, width)
    m, a1, a2 = (_full_range(rng, shape, cuda) for _ in range(3))
    before = dict(scan.LAUNCHES)
    for view in (lambda t: t, _offset_view):
        for accs in ((a1,), (a1, a2)):
            mv, av = view(m), tuple(view(a) for a in accs)
            got = scan.affine_hash_scan(mv, av)
            want = scan.affine_hash_scan_plain(mv, av)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (view, len(accs))
        for ns in range(1, 9):
            f = view(_maps_with_stray_nibbles(rng, shape, ns, cuda))
            assert torch.equal(scan.dfa_compose_scan(f, ns), scan.dfa_compose_scan_plain(f, ns)), ns
    torch.cuda.synchronize()
    assert scan.LAUNCHES["affine_scan"] == before["affine_scan"] + 4
    assert scan.LAUNCHES["dfa_scan"] == before["dfa_scan"] + 16
    assert scan.SHAPE_LAUNCHES[("affine_scan", rows, width, 2)] >= 2
    assert scan.SHAPE_LAUNCHES[("dfa_scan", rows, width, 8)] >= 2


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


def _sort2_edge_keys(rng, rows, width):
    """Random rows with ties and both int32 extremes, and payloads up to
    INT32_MAX - 1; among them an all-equal row, an already sorted one and a
    reverse-sorted one."""
    k1 = rng.integers(-40, 40, size=(rows, width)).astype(np.int32)
    k1[rng.random(k1.shape) < 0.05] = I32_MAX
    k1[rng.random(k1.shape) < 0.05] = -(2**31)
    k2 = rng.integers(0, I32_MAX, size=(rows, width)).astype(np.int32)
    k2[rng.random(k2.shape) < 0.05] = I32_MAX - 1
    for i, kind in zip(range(rows), ("equal", "sorted", "reverse")):
        if kind == "equal":
            k1[i], k2[i] = 7, 3
        else:
            order = np.lexsort((k2[i], k1[i]))
            if kind == "reverse":
                order = order[::-1]
            k1[i], k2[i] = k1[i][order], k2[i][order]
    return k1, k2


@pytest.mark.parametrize("rows", [1, 7, 256, 320])
@pytest.mark.parametrize("width", [1, 3, 255, 256, 257, 1024, 1025, 2049, 8192, 16383, 16384])
def test_sort2_register_network_matches_plain(cuda, width, rows):
    """Every geometry of the register network (one warp per row, one CTA,
    a 2-CTA cluster) and its padding, exact."""
    k1, k2 = (torch.from_numpy(a).to(cuda)
              for a in _sort2_edge_keys(np.random.default_rng(width * 7 + rows), rows, width))
    got, want = sort.sort2(k1, k2), sort.sort2_plain(k1, k2)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sort.SHAPE_LAUNCHES[("sort2", rows, width)] >= 1


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


def _fused_groups(rng, shape, dev):
    """Every group kind and emit mode within the kernel's limits: affine
    k = 1, 3 and 5 (two units), add, dfa at 4, 5 and 8 states; 16 inputs,
    13 outputs."""
    m, a, b, c, d, v = (_full_range(rng, shape, dev) for _ in range(6))
    return [
        scan.affine_group(m, (a, b, c, d, v), emit="last"),
        scan.affine_group(v, (a,)),
        scan.affine_group(m, (b, c, d)),
        scan.add_group((v,), emit="last"),
        scan.dfa_group(_packed_maps(rng, shape, 4, dev), 4),
        scan.dfa_group(_packed_maps(rng, shape, 5, dev), 5, emit="last"),
        scan.dfa_group(_packed_maps(rng, shape, 8, dev), 8),
    ]


@pytest.mark.parametrize("shape", [(37, 1000), (64, 16384)])
def test_fused_kernel_matches_plain(cuda, shape):
    groups = _fused_groups(np.random.default_rng(shape[1]), shape, cuda)
    before = scan.LAUNCHES["fused_scan"]
    got = scan.fused_scan(groups)
    want = scan.fused_scan_plain(groups)
    assert scan.LAUNCHES["fused_scan"] == before + 1
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(g, w))


def _fused_edge_groups(rng, shape, dev, states, view=lambda t: t):
    """Affine k = 1 and 5 (two units), add scan and last, dfa groups with
    stray nibbles above ``states``, alternately scan and last."""
    r = [view(_full_range(rng, shape, dev)) for _ in range(7)]
    groups = [scan.affine_group(r[0], (r[1],)), scan.affine_group(r[1], r[2:7], emit="last"),
              scan.add_group((r[2], r[3])), scan.add_group((r[4],), emit="last")]
    for i, ns in enumerate(states):
        f = view(_maps_with_stray_nibbles(rng, shape, ns, dev))
        groups.append(scan.dfa_group(f, ns, emit="last" if i % 2 else "scan"))
    return groups


def _fused_equal(groups):
    before = scan.LAUNCHES["fused_scan"]
    got = scan.fused_scan(groups)
    torch.cuda.synchronize()
    want = scan.fused_scan_plain(groups)
    assert scan.LAUNCHES["fused_scan"] == before + (1 if groups[0]["xs"][0].shape[0] else 0)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(g, w))


#: Every width where a unit of csrc/fused.cu changes its segment count or
#: thread count, one either side, and one and zero lanes.
FUSED_EDGE_WIDTHS = [0, 1, 2, 127, 128, 129, 1023, 1024, 1025, 2049, 4095, 4096, 4097, 8193,
                     65536]


@pytest.mark.parametrize("rows", [1, 7, 65])
@pytest.mark.parametrize("width", FUSED_EDGE_WIDTHS)
def test_fused_kernel_matches_plain_at_geometry_edges(cuda, width, rows):
    """One launch per list, exact, on aligned tensors and offset views
    (scalar accesses), DFA maps with stray nibbles at 1..8 states, both
    emit modes (len 1: the lane as it is; len 0: a carry is the identity)."""
    rng = np.random.default_rng(width * 10 + rows)
    for view in (lambda t: t, _offset_view) if width else (lambda t: t,):
        for states in ((1, 2, 3, 4), (5, 6, 7, 8)):
            _fused_equal(_fused_edge_groups(rng, (rows, width), cuda, states, view))


def test_fused_kernel_matches_plain_on_fineweb_stats_list(cuda):
    """``fineweb_stats``' list (the chain schedule's one fused call) at
    [64, 8192]: a three-accumulator line group, a line hash, a reversed
    counter and two row totals."""
    rng = np.random.default_rng(8192)
    r = [_full_range(rng, (64, 8192), cuda) for _ in range(10)]
    _fused_equal([scan.affine_group(r[0], r[1:4]), scan.affine_group(r[4], (r[5],)),
                  scan.affine_group(r[6], (r[7],)), scan.add_group(r[8:10], emit="last")])


def test_fused_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # 9 groups
        scan.fused_scan([scan.add_group((x,)) for _ in range(9)])
    with pytest.raises(ValueError):  # 17 inputs
        scan.fused_scan([scan.add_group((x,) * 8), scan.add_group((x,) * 9, emit="last")])
    with pytest.raises(TypeError):
        scan.fused_scan([scan.affine_group(x.long(), (x.long(),))])
    with pytest.raises(ValueError):  # not contiguous
        scan.fused_scan([scan.add_group((torch.zeros((8, 4), dtype=torch.int32, device=cuda).t(),))])
    with pytest.raises(ValueError):
        scan.fused_scan([scan.dfa_group(x, 9)])


# --- chain_scan ------------------------------------------------------------------


def _generic_chain(rng, shape, dev):
    """Every group kind, forward and reverse passes, shift taps with nonzero
    fills, emit scan / last / none, on full-range int32 operands."""
    x = _full_range(rng, shape, dev)
    r = torch.from_numpy((rng.random(shape) < 0.05).astype(np.int32)).to(dev)
    m = torch.where(r != 0, 0, 1).to(torch.int32).contiguous()
    f4, f8 = _packed_maps(rng, shape, 4, dev), _packed_maps(rng, shape, 8, dev)
    T, cg = scan.Tap, scan.chain_group
    return [
        scan.chain_pass([
            scan.affine_group(m, (x,), emit="none"),
            scan.affine_group(x, (m, x)),
            scan.add_group((x, m), emit="last"),
            scan.dfa_group(f4, 4),
            scan.dfa_group(f8, 8, emit="none"),
        ]),
        scan.chain_pass([
            scan.segmax_group(x, r),
            cg("segmax", (T(0, 0), r), prep=scan.reset_value, n_ops=2, emit="none"),
            cg("copy", (T(0, 6, shift=1, fill=-7), T(0, 1))),
            cg("add", (T(0, 5, shift=1, fill=123456789),), prep=scan.state_is_one, n_ops=1,
               emit="last"),
        ], reverse=True),
        scan.chain_pass([
            cg("affine", (T(1, 1, shift=1, fill=5), T(0, 2), T(1, 0))),
            cg("add", (T(1, 2),), prep=scan.low_bit, n_ops=1),
            cg("copy", (T(1, 1), T(0, 0, shift=1, fill=-1)), prep=scan.sum2, n_ops=1, emit="scan"),
            cg("dfa", (T(0, 6),), emit="last", n_states=8),
        ]),
        scan.chain_pass([
            cg("add", (T(2, 0, shift=1, fill=2**31 - 1),), prep=scan.twice, n_ops=1, emit="last"),
            scan.segmax_group(T(2, 1), T(2, 2, shift=1, fill=-5)),
        ], reverse=True),
    ]


def _assert_chain_equal(got, want):
    assert len(got) == len(want)
    for gp, wp in zip(got, want):
        assert len(gp) == len(wp)
        for g, w in zip(gp, wp):
            assert len(g) == len(w)
            assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(g, w))


@pytest.mark.parametrize("shape", [(37, 1000), (8, 2048), (64, 8192), (2, 5000), (600, 256),
                                   (64, 16384), (64, 5000), (3, 7)])
def test_chain_kernel_matches_plain(cuda, shape):
    """The generic program (shift taps and reverse passes, so every chunk
    edge is crossed both ways) and the probe, on every geometry: one CTA a
    row (one warp at 7 lanes), clusters of 3, 5 and 8 and a ragged last
    chunk."""
    rng = np.random.default_rng(shape[1])
    r = torch.from_numpy((rng.random(shape) < 0.05).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.integers(0, 97, size=shape).astype(np.int32)).to(cuda)
    for passes in (_generic_chain(rng, shape, cuda), scan.chain_probe_program(vals, r)):
        before = scan.LAUNCHES["chain_scan"]
        got = scan.chain_scan(passes)
        assert scan.LAUNCHES["chain_scan"] == before + 1
        _assert_chain_equal(got, scan.chain_scan_plain(passes))


_TEXTS = (
    "",
    "Samme linje her igen og igen.\n" * 12,
    "Det er en god dag [1], og vi skal ud at gå tur.\nSolen skinner... Der er mange!\n\n"
    "- punkt et\n• punkt to\nLorem ipsum dolor sit amet javascript …",
    "数据处理流水线的测试文本。 Og lidt dansk tekst her.",
    "𝔘𝔫𝔦𝔠𝔬𝔡𝔢 𝕋𝕖𝕩𝕥 🚀 and café́ ascii. Terms of use apply {x}.",
    "ord " * 400,
    "en to tre fire fem seks en to tre fire fem seks en to tre fire fem",
    "Line one.\r\n\r\nLine two [3] ends here. Yes! \"Quoted.\" Done?",
)


def _text_batch(dev, length=1024, rows=8, fill=False):
    """The texts above, one a row in turn; with ``fill`` each is repeated
    (line by line) up to three quarters of the row."""
    cps = np.zeros((rows, length), np.int32)
    lens = np.zeros(rows, np.int32)
    for i in range(rows):
        t = _TEXTS[i % len(_TEXTS)]
        if fill and t:
            t = ("\n".join([t] * (3 * length // (4 * len(t)) + 1)))[: 3 * length // 4]
        cp = [ord(c) for c in t][:length]
        cps[i, : len(cp)] = cp
        lens[i] = len(cp)
    return torch.from_numpy(cps).to(dev), torch.from_numpy(lens).to(dev)


@pytest.mark.parametrize("impl", ["scatter", "sort"])
def test_chain_kernel_matches_plain_at_every_site(cuda, monkeypatch, impl):
    """Each call site's program, built by the site's own builder from a text
    batch, through the kernel and the plain version."""
    monkeypatch.setenv("TEXTBLAST_TABLE_IMPL", impl)
    cps, lens = _text_batch(cuda)
    c4 = stats.C4Params(True, True, True, 5, 3, 1000, True, True, True, True)
    programs = stats.chain_site_programs(cps, lens, (1, 2, 3), (2, 3, 4),
                                         (5, 6, 7, 8, 9, 10), 256, c4)
    assert set(programs) == {"structure", "structure_nohash", "gopher_quality", "gopher_rep",
                             "sorted_tables", "sorted_tables_rest", "c4_trim", "c4_sentences",
                             "c4_post", "sentence_counts"}
    for passes in programs.values():
        _assert_chain_equal(scan.chain_scan(passes), scan.chain_scan_plain(passes))


@pytest.mark.parametrize("length", [256, 512, 2048, 5000, 8192, 16384])
def test_chain_kernel_matches_plain_at_every_site_and_geometry(cuda, length):
    """Each call site's program on 64 rows: one CTA a row at 256, 512 and
    2048 lanes, clusters at 8192 and 16384 and a ragged 5000; the
    sorted-table programs at the same widths."""
    cps, lens = _text_batch(cuda, length, rows=64, fill=True)
    c4 = stats.C4Params(True, True, True, 5, 3, 1000, True, True, True, True)
    programs = stats.chain_site_programs(cps, lens, (1, 2, 3), (2, 3, 4), (5, 6, 7, 8, 9, 10),
                                         length, c4)
    for name, passes in programs.items():
        before = scan.LAUNCHES["chain_scan"]
        _assert_chain_equal(scan.chain_scan(passes, site=name), scan.chain_scan_plain(passes))
        assert scan.LAUNCHES["chain_scan"] == before + 1
        width = scan._chain_plan(passes)[1][0].shape[1]
        assert scan.CHAIN_SHAPE_LAUNCHES[(name, width)] >= 1


def _many_taps(xs):
    """A program whose first pass emits 25 tap-only streams, all tapped by a
    reverse pass (two 11-dep preps, shift taps with fills), whose streams a
    third pass taps again: 27 tapped streams, 5 operands a group."""
    T, cg = scan.Tap, scan.chain_group
    taps = [T(0, i, shift=i % 2, fill=-i) for i in range(25)]
    return [
        scan.chain_pass([scan.add_group(tuple(xs), emit="none") for _ in range(5)]),
        scan.chain_pass([
            cg("segmax", tuple(taps[:11]), prep=stats.sentence_cnt, n_ops=2),
            cg("segmax", tuple(taps[11:22]), prep=stats.sentence_cnt, n_ops=2, emit="last"),
            cg("add", tuple(taps[22:24]), prep=scan.sum2, n_ops=1),
            cg("add", (taps[24],), prep=scan.over_50, n_ops=1, emit="none"),
        ], reverse=True),
        scan.chain_pass([scan.add_group((T(1, 0, shift=1, fill=3), T(1, 3, shift=1, fill=-2)))]),
    ]


@pytest.mark.parametrize("shape", [(64, 16384), (8, 2048), (5, 300)])
def test_chain_kernel_global_taps_match_plain(cuda, shape):
    """27 tapped streams do not fit shared memory at 2048 lanes a chunk:
    their taps go through global memory, and the program stays exact (at
    300 lanes they fit and stay on chip)."""
    rng = np.random.default_rng(shape[1] + 5)
    passes = _many_taps([_full_range(rng, shape, cuda) for _ in range(5)])
    prog, _ = scan._chain_program(passes)
    geo = scan.chain_geometry(shape[1], prog.n_keep, prog.n_stage)
    assert (prog.n_keep, prog.n_stage) == (27, 5) and geo.tap_smem == (shape[1] <= 300)
    _assert_chain_equal(scan.chain_scan(passes), scan.chain_scan_plain(passes))


def test_chain_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # a prep without a kernel id
        scan.chain_scan([scan.chain_pass([
            scan.chain_group("add", (x,), prep=lambda a: (a + 1,), n_ops=1)])])
    with pytest.raises(ValueError):  # a registered prep given the wrong dep count
        scan.chain_scan([scan.chain_pass([
            scan.chain_group("add", (x, x), prep=scan.twice, n_ops=1)])])
    with pytest.raises(ValueError):  # 6 operands in one group
        scan.chain_scan([scan.chain_pass([scan.add_group((x,) * 6)])])
    with pytest.raises(TypeError):
        scan.chain_scan([scan.chain_pass([scan.add_group((x.long(),))])])
    with pytest.raises(ValueError):  # not contiguous
        y = torch.zeros((8, 4), dtype=torch.int32, device=cuda).t()
        scan.chain_scan([scan.chain_pass([scan.add_group((y,))])])
    with pytest.raises(ValueError):  # 9 passes
        scan.chain_scan([scan.chain_pass([scan.add_group((x,))])] * 9)


# --- sort3 ---------------------------------------------------------------------


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows", [1, 7, 64, 65])
@pytest.mark.parametrize("width", [1, 3, 100, 1000, 4097, 8192, 16384, 16385, 32767, 32768,
                                   40000])
def test_sort3_kernel_matches_plain(cuda, width, rows, aligned):
    """Every layout of the register network (one warp a row, one CTA,
    clusters of 2 and 4) and the shared-memory network above 32768 keys,
    with ties and both int32 extremes, on aligned tensors (int4 loads
    where the width allows) and on offset views (scalar loads): one launch,
    exact."""
    rng = np.random.default_rng(width * 5 + rows)
    ks = []
    for _ in range(3):
        k = rng.integers(-3, 3, size=(rows, width)).astype(np.int32)
        k[rng.random(k.shape) < 0.05] = I32_MAX
        k[rng.random(k.shape) < 0.05] = -(2**31)
        t = torch.from_numpy(k).to(cuda)
        ks.append(t if aligned else _offset_view(t))
    before = sort.LAUNCHES["sort3"]
    got, want = sort.sort3(*ks), sort.sort3_plain(*ks)
    torch.cuda.synchronize()
    assert sort.LAUNCHES["sort3"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_sort3_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sort.sort3(x, x, x.long())
    with pytest.raises(ValueError):
        sort.sort3(x, x, x[:, :4])
    with pytest.raises(ValueError):
        sort.sort3(x.t(), x.t(), x.t())


# --- the overlapped window on the card ------------------------------------------


def _card_corpus(n=130, seed=3):
    """Danish prose of 1-40 lines, boilerplate repeats, CJK and emoji rows:
    both buckets below, the dictionary-script and astral routes and tails."""
    rng = np.random.default_rng(seed)
    words = ("det er en god dag og vi skal ud at gå tur i skoven solen skinner over "
             "byen der mange mennesker på gaden som arbejde nu efter turen").split()
    rows = []
    for i in range(n):
        lines = [" ".join(words[int(j)] for j in rng.integers(0, len(words), int(rng.integers(4, 14))))
                 .capitalize() + "." for _ in range(int(rng.integers(1, 40)))]
        text = "\n".join(lines)
        if i % 17 == 3:
            text = "Samme linje her igen og igen.\n" * int(rng.integers(4, 30))
        elif i % 23 == 5:
            text = "数据处理流水线的测试文本。" + text
        elif i % 29 == 7:
            text = text + " \U0001F600"
        rows.append((f"c{i}", text[:2040]))
    return rows


def test_window_matches_serial_on_the_card(cuda, monkeypatch):
    """The windowed run at depth 2 (its dispatch thread on a stream of its
    own) gives depth 1's outcome sequence, and every stats dict it fetched
    equals a serial ``dispatch_batch`` + ``fetch`` of the same batch on the
    default stream."""
    import os

    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.data_model import TextDocument
    from textblaster_tpu_torch.ops.pipeline import CompiledPipeline

    monkeypatch.delenv("TEXTBLAST_NO_OVERLAP", raising=False)
    monkeypatch.setenv("TEXTBLAST_HOST_TAILS", "on")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rows = _card_corpus()
    seqs, fetched = {}, []
    for depth in (1, 2):
        cfg = load_pipeline_config(os.path.join(root, "configs/pipeline_config_offline.yaml"))
        cfg.overlap.pipeline_depth = depth
        tp = CompiledPipeline(cfg, buckets=(512, 2048), batch_size=16, device=cuda)
        assert tp.wire_u16
        if depth == 2:
            real = tp.run_batch

            def recording(batch, phase=0, stream=None):
                assert stream is not None and stream != torch.cuda.default_stream(cuda)
                out = real(batch, phase, stream)
                fetched.append((batch, phase, out[0]))
                return out

            monkeypatch.setattr(tp, "run_batch", recording)
        outs = tp.process_chunk([TextDocument(id=i, source="t", content=t) for i, t in rows])
        seqs[depth] = [(o.document.id, o.kind, o.reason,
                        tuple(sorted(o.document.metadata.items())), o.document.content)
                       for o in outs]
        assert tp.counters["seconds"]["device_busy"] > 0.0
        assert tp.counters["host_routed_astral"] > 0 and tp.counters["host_tail"] > 0
    assert len(seqs[1]) == len(rows)
    assert seqs[1] == seqs[2]
    assert fetched
    serial = CompiledPipeline(load_pipeline_config(
        os.path.join(root, "configs/pipeline_config_offline.yaml")),
        buckets=(512, 2048), batch_size=16, device=cuda)
    for batch, phase, stats in fetched:
        want = serial.fetch(serial.dispatch_batch(batch, phase))
        assert sorted(stats) == sorted(want)
        for k in want:
            assert np.array_equal(stats[k], want[k]), (batch.max_len, phase, k)


# --- device spans from CUDA events ------------------------------------------------


@pytest.fixture
def traced(cuda):
    """The port's TRACER in memory, and KERNEL_SPANS off, before and after."""
    from textblaster_tpu_torch.utils.trace import KERNEL_SPANS, TRACER

    TRACER.close()
    TRACER.drain()
    TRACER.configure(None, ring=1 << 16)
    yield TRACER
    TRACER.close()
    TRACER.drain()
    KERNEL_SPANS.enabled = False


def test_device_clock_maps_events_between_their_host_reads(cuda, traced):
    """An event's trace time lies between the host's reads of the trace
    clock around its ``record`` and its ``synchronize`` (the anchor on an
    idle stream), and a re-anchor after a synchronize measures the
    drift."""
    from textblaster_tpu_torch.utils.trace import DeviceClock

    s = torch.cuda.Stream(device=cuda)
    s.synchronize()
    clock = DeviceClock()
    clock.anchor(s)
    for cycles in (1_000, 1_000_000, 10_000_000):
        with torch.cuda.stream(s):
            h0 = traced.now_us()
            start = torch.cuda.Event(enable_timing=True)
            start.record(s)
            torch.cuda._sleep(cycles)
            end = torch.cuda.Event(enable_timing=True)
            end.record(s)
            end.synchronize()
            h1 = traced.now_us()
        clock.settle(s)
        t0, t1 = clock.to_us(start), clock.to_us(end)
        assert h0 - 50 <= t0 <= t1 <= h1 + 50, (h0, t0, t1, h1)
    assert clock.reanchors >= 1
    assert clock.stats()["max_drift_us"] < 1000


def test_kernel_spans_count_every_launch_inside_its_batch(cuda, traced, tmp_path):
    """Under ``--trace-device`` every kernel launch gets one span, inside
    its batch's span, counted as ``LAUNCHES`` counts it."""
    import json

    from textblaster_tpu_torch.utils.trace import KERNEL_SPANS, DeviceClock

    rng = np.random.default_rng(9)
    s = torch.cuda.current_stream(cuda)
    s.synchronize()
    clock = DeviceClock()
    clock.anchor(s)
    before = {**scan.LAUNCHES, **sort.LAUNCHES}
    KERNEL_SPANS.configure(str(tmp_path))
    for b in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(s)
        m, a = _full_range(rng, (64, 2048), cuda), _full_range(rng, (64, 2048), cuda)
        scan.affine_hash_scan(m, (a,))
        scan.dfa_compose_scan(_packed_maps(rng, (64, 2048), 4, cuda), 4)
        sort.sort2(a, torch.arange(2048, dtype=torch.int32, device=cuda).repeat(64, 1))
        end.record(s)
        end.synchronize()
        clock.settle(s)
        KERNEL_SPANS.resolve(clock, start, end, {"batch": b + 1})
    launched = {k: v - before[k] for k, v in {**scan.LAUNCHES, **sort.LAUNCHES}.items()}
    events = json.load(open(KERNEL_SPANS.close()))
    batches = {e["args"]["batch"]: e for e in events if e["ph"] == "X" and e["tid"] == 1}
    kernels = [e for e in events if e["ph"] == "X" and e["tid"] == 2]
    spans = {}
    for k in kernels:
        spans[k["args"]["kernel"]] = spans.get(k["args"]["kernel"], 0) + 1
    assert spans == {k: v for k, v in launched.items() if v}
    assert len(kernels) == 9
    assert 0 < sum(k["dur"] for k in kernels) <= sum(b["dur"] for b in batches.values())
    for k in kernels:
        b = batches[k["args"]["batch"]]
        assert b["ts"] - 1 <= k["ts"] and k["ts"] + k["dur"] <= b["ts"] + b["dur"] + 1


def test_run_batch_device_span_lies_inside_its_host_span(cuda, traced):
    """With the trace armed, ``run_batch`` emits one ``device_batch`` span
    per batch on the ``device`` track, inside the batch's
    ``device_dispatch`` span (the host's spans are floored to whole
    microseconds: 2 us of slack)."""
    import os

    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.data_model import TextDocument
    from textblaster_tpu_torch.ops.packing import pack_documents
    from textblaster_tpu_torch.ops.pipeline import CompiledPipeline

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tp = CompiledPipeline(load_pipeline_config(os.path.join(root, "configs/pipeline_config_offline.yaml")),
                          buckets=(512, 2048), batch_size=16, device=cuda)
    # The pipeline routes astral documents to the host before the u16 wire.
    docs = [TextDocument(id=i, source="t", content=t) for i, t in _card_corpus(40)
            if len(t) < 2000 and max(map(ord, t), default=0) < 0x10000]
    batch = pack_documents(docs[:16], batch_size=16, max_len=2048)
    for phase in (0, 1, 2, 0):
        tp.run_batch(batch, phase)
    events = traced.drain()
    host = {e["args"]["batch"]: e for e in events if e["name"] == "device_dispatch"}
    dev = [e for e in events if e["name"] == "device_batch"]
    assert len(dev) == len(host) == 4
    for d in dev:
        h = host[d["args"]["batch"]]
        assert h["ts"] - 2 <= d["ts"] and d["ts"] + d["dur"] <= h["ts"] + h["dur"] + 2, (h, d)
    lanes = {e["args"]["name"]: e["tid"] for e in events if e["name"] == "thread_name"}
    assert {d["tid"] for d in dev} == {lanes["device"]}


# --- the data mesh on the card ----------------------------------------------------


def _mesh_batch(cuda):
    import os

    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.data_model import TextDocument
    from textblaster_tpu_torch.ops.packing import pack_documents

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_pipeline_config(os.path.join(root, "configs/pipeline_config_offline.yaml"))
    docs = [TextDocument(id=i, source="t", content=t) for i, t in _card_corpus(60)
            if len(t) < 2000 and max(map(ord, t), default=0) < 0x10000]
    return cfg, pack_documents(docs[:16], batch_size=16, max_len=2048)


def test_two_shard_mesh_equals_one_device(cuda, traced, monkeypatch):
    """``[cuda:0, cuda:0]`` (two shards on two streams of the card): every
    phase's stats dict equals the single-device one, every kernel the
    single device launched was launched by each shard, each shard has its
    ``device_batch`` span, and the device seconds are the longer shard's."""
    from textblaster_tpu_torch.ops.pipeline import CompiledPipeline
    from textblaster_tpu_torch.parallel.mesh import data_mesh

    monkeypatch.setenv("TEXTBLAST_WIRE", "cp32")  # the mesh's wire, on both
    cfg, batch = _mesh_batch(cuda)
    one = CompiledPipeline(cfg, buckets=(512, 2048), batch_size=16, device=cuda)
    mesh = CompiledPipeline(cfg, buckets=(512, 2048), batch_size=16,
                            mesh=data_mesh([cuda, cuda]))
    assert not mesh.wire_u16 and len(set(mesh._mesh_streams)) == 2
    for phase in range(len(one.phases)):
        want, _, _ = one.run_batch(batch, phase)
        got, _, dev_s = mesh.run_batch(batch, phase)
        assert sorted(got) == sorted(want) and dev_s > 0.0
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (phase, k)
    per_shard = mesh.counters["shard_launches"]
    assert len(per_shard) == 2
    for k, n in one.counters["launches"].items():
        if n:
            assert all(s[k] > 0 for s in per_shard), (k, per_shard)
        assert mesh.counters["launches"][k] == sum(s[k] for s in per_shard)
    assert mesh.counters["batches_by_bucket"] == {2048: len(one.phases)}
    spans = [e for e in traced.drain() if e["name"] == "device_batch" and "shard" in e["args"]]
    assert sorted(e["args"]["shard"] for e in spans) == sorted([0, 1] * len(one.phases))


def test_mesh_devices_keep_one_copy_of_each_table(cuda):
    """The constant tables are cached per physical device: ``cuda`` and
    ``cuda:0`` are one copy, and every visible GPU keeps its own."""
    from textblaster_tpu_torch.ops import badwords
    from textblaster_tpu_torch.ops.device import class_table, const_i32, device_key, lower_table
    from textblaster_tpu_torch.ops.langid_device import table_q

    i = torch.cuda.current_device()
    for get in (class_table, lower_table, table_q, lambda d: const_i32([1, 2, 3], d)):
        assert get("cuda") is get(f"cuda:{i}") is get(torch.device("cuda", i))
    tables = badwords.BadwordTables.build(["foo", "bar baz"], check_boundaries=True)
    assert badwords._tables_on(tables, torch.device("cuda")) is badwords._tables_on(
        tables, torch.device("cuda", i))
    devices = [torch.device("cuda", d) for d in range(torch.cuda.device_count())]
    copies = [class_table(d) for d in devices] + [table_q(d) for d in devices]
    assert len({t.data_ptr() for t in copies}) == 2 * len(devices)
    assert [t.device for t in copies] == devices * 2
    assert {device_key(d) for d in devices} == {str(d) for d in devices}
