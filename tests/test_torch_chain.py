"""The port's chain scan against the JAX package's chain kernel, on the CPU.

``chain_scan_plain`` (the CPU path of ``textblaster_tpu_torch.ops.scan``)
must equal, exactly, the JAX ``chain_scan`` run in interpret mode on the
kernel-layer programs of ``tests/test_depfuse.py`` (every group kind,
forward and reverse passes, shift taps, a DFA feeding a counter) and on the
JAX package's probe program, from the same numpy inputs.  The plan errors
match the JAX package's, and every prep the call sites use has one kernel
id.  The CUDA kernel is compared with the plain version on the card by
``tests/test_torch_card.py`` and ``chip_smoke.py``.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textblaster_tpu.ops import pallas_scan as psc
from textblaster_tpu_torch.ops import scan
from textblaster_tpu_torch.ops import stats as ts

from test_torch_pipeline import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.torch_port


@pytest.fixture
def interp(monkeypatch):
    """The JAX chain kernel in interpret mode (as tests/test_depfuse.py
    runs it); the port reads the same switches."""
    for var in ("TEXTBLAST_PALLAS", "TEXTBLAST_NO_PALLAS", "TEXTBLAST_FUSED", "TEXTBLAST_DEPFUSE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TEXTBLAST_PALLAS_INTERPRET", "1")


def _full_range(rng, shape):
    return rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(got, want):
    assert len(got) == len(want)
    for gp, wp in zip(got, want):
        assert len(gp) == len(wp)
        for g, w in zip(gp, wp):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                b = np.asarray(b)
                assert a.dtype == torch.int32 and tuple(a.shape) == b.shape
                np.testing.assert_array_equal(a.numpy(), b)


def _multipass_inputs(rng, length):
    vals = _full_range(rng, (8, length))
    reset = (rng.random((8, length)) < 0.05).astype(np.int32)
    reset[:, 0] = 1
    return (vals, reset, np.abs(vals) % 1000, np.where(reset != 0, 0, 1).astype(np.int32),
            np.where(reset != 0, 0, 31).astype(np.int32))


def _multipass(mod, preps, vals, reset, nonneg, m, m_h):
    """tests/test_depfuse.py's four-pass program: a scratch seg-add feeding
    a reverse segmax, whose run totals feed a forward copy (with a shift
    tap) and a whole-row total, whose stream feeds a final sum."""
    cg, T = mod.chain_group, mod.Tap
    return [
        mod.chain_pass([
            {"kind": "affine", "xs": (m, nonneg), "emit": "none"},
            {"kind": "affine", "xs": (m_h, vals), "emit": "scan"},
            {"kind": "add", "xs": (vals,), "emit": "scan"},
        ]),
        mod.chain_pass([
            cg("segmax", (T(0, 0), reset), prep=preps["reset_value"], n_ops=2),
            {"kind": "segmax", "xs": (vals, reset), "emit": "scan"},
        ], reverse=True),
        mod.chain_pass([
            cg("copy", (T(1, 0), T(0, 0, shift=1, fill=0)), prep=preps["sum2"], n_ops=1, emit="scan"),
            cg("add", (T(1, 0),), prep=preps["over_50"], n_ops=1, emit="last"),
        ]),
        mod.chain_pass([cg("add", (T(2, 0),), prep=preps["low_bit"], n_ops=1, emit="scan")]),
    ]


JAX_PREPS = {
    "reset_value": lambda s, r: (jnp.where(r != 0, s, 0), r),
    "sum2": lambda a, b: (a + b,),
    "over_50": lambda a: (jnp.where(a > 50, 1, 0),),
    "low_bit": lambda c: (c & 1,),
    "twice": lambda x: (x * 2,),
    "state_is_one": lambda pk: ((pk & 15) == 1,),
}
PORT_PREPS = {k: getattr(scan, k) for k in JAX_PREPS}


def _jax_chain(passes_fn):
    """The JAX chain kernel (interpret mode) on a program built inside jit."""
    return jax.jit(lambda *a: psc.chain_scan(passes_fn(*a)))


@pytest.mark.parametrize("length", [128, 1280])
def test_multipass_every_kind_matches_jax_chain(interp, length):
    inputs = _multipass_inputs(np.random.default_rng(length), length)
    want = _jax_chain(lambda *a: _multipass(psc, JAX_PREPS, *a))(*map(jnp.asarray, inputs))
    got = scan.chain_scan_plain(_multipass(scan, PORT_PREPS, *map(_t, inputs)))
    _assert_same(got, want)


def test_reverse_shift_tap_matches_jax_chain(interp):
    """A reverse pass's shift tap reads the NEXT natural lane, ``fill`` at
    the row's end."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 100, size=(8, 384)).astype(np.int32)

    def program(mod, xx, twice):
        return [
            mod.chain_pass([{"kind": "add", "xs": (xx,), "emit": "scan"}]),
            mod.chain_pass([mod.chain_group("copy", (mod.Tap(0, 0, shift=1, fill=-7),),
                                            prep=twice, n_ops=1, emit="scan")], reverse=True),
        ]

    want = _jax_chain(lambda a: program(psc, a, JAX_PREPS["twice"]))(jnp.asarray(x))
    got = scan.chain_scan_plain(program(scan, _t(x), scan.twice))
    _assert_same(got, want)
    cs = np.cumsum(x, axis=1, dtype=np.int32)
    nxt = np.concatenate([cs[:, 1:], np.full((8, 1), -7, np.int32)], 1)
    np.testing.assert_array_equal(got[1][0][0].numpy(), nxt * 2)


@pytest.mark.parametrize("length", [128, 1280])
def test_dfa_pass_feeds_counter_matches_jax_chain(interp, length):
    from textblaster_tpu.ops.dfa import dfa_packed_fns
    from textblaster_tpu_torch.ops.dfa import dfa_packed_fns as port_fns

    rng = np.random.default_rng(length + 1)
    transition = rng.integers(0, 4, size=(4, 4)).astype(np.int32)
    cls = rng.integers(0, 4, size=(8, length)).astype(np.int32)

    def program(mod, fns, prep):
        return [
            mod.chain_pass([{"kind": "dfa", "xs": (fns,), "n_states": 4, "emit": "scan"}]),
            mod.chain_pass([mod.chain_group("add", (mod.Tap(0, 0),), prep=prep, n_ops=1)]),
        ]

    want = _jax_chain(lambda c: program(psc, dfa_packed_fns(c, jnp.asarray(transition)),
                                        JAX_PREPS["state_is_one"]))(jnp.asarray(cls))
    got = scan.chain_scan_plain(
        program(scan, port_fns(_t(cls), transition).contiguous(), scan.state_is_one)
    )
    _assert_same(got, want)


def test_probe_program_matches_jax_chain(interp):
    """The JAX package's chain probe (pallas_scan.py:1008-1039), at its 256
    lanes, against its own kernel."""
    length = 256
    iota = np.broadcast_to(np.arange(length, dtype=np.int32), (8, length))
    vals = ((iota * 7 + 3) % 97).astype(np.int32)
    reset = ((iota % 64) == 0).astype(np.int32)
    m = np.where(reset != 0, 0, 1).astype(np.int32)
    T, cg = psc.Tap, psc.chain_group

    def jax_probe(v, r, mm):
        return [
            psc.chain_pass([{"kind": "affine", "xs": (mm, v), "emit": "none"}]),
            psc.chain_pass([cg("segmax", (T(0, 0), r), prep=JAX_PREPS["reset_value"], n_ops=2)],
                           reverse=True),
            psc.chain_pass([
                cg("copy", (T(1, 0), T(0, 0, shift=1, fill=0)), prep=JAX_PREPS["sum2"], n_ops=1,
                   emit="scan"),
                cg("add", (T(1, 0),), prep=JAX_PREPS["over_50"], n_ops=1, emit="last"),
            ]),
        ]

    want = _jax_chain(jax_probe)(jnp.asarray(vals), jnp.asarray(reset), jnp.asarray(m))
    _assert_same(scan.chain_scan_plain(scan.chain_probe_program(_t(vals), _t(reset))), want)


def test_plan_errors_match_jax():
    x = torch.zeros((2, 8), dtype=torch.int32)
    xj = jnp.zeros((2, 8), jnp.int32)
    for mod, arr in ((scan, x), (psc, xj)):
        with pytest.raises(ValueError, match="earlier pass"):  # a tap of a later pass
            mod._chain_plan([mod.chain_pass([mod.chain_group("add", (mod.Tap(1, 0),))]),
                             mod.chain_pass([mod.add_group((arr,))])])
        with pytest.raises(ValueError, match="earlier pass"):  # a tap of its own pass
            mod._chain_plan([mod.chain_pass([mod.add_group((arr,)),
                                             mod.chain_group("add", (mod.Tap(0, 0),))])])
        with pytest.raises(ValueError, match="emit='last'"):
            mod._chain_plan([mod.chain_pass([mod.add_group((arr,), emit="last")]),
                             mod.chain_pass([mod.chain_group("add", (mod.Tap(0, 0),))])])
        with pytest.raises(ValueError, match="shift"):
            mod._chain_plan([mod.chain_pass([mod.add_group((arr,))]),
                             mod.chain_pass([mod.chain_group("add", (mod.Tap(0, 0, shift=2),))])])
        with pytest.raises(ValueError, match="n_ops"):
            mod.chain_group("add", (arr,), prep=lambda a: (a,))
        with pytest.raises(ValueError, match="copy"):
            mod._chain_plan([mod.chain_pass([mod.copy_group((arr,), emit="last")])])
        with pytest.raises(ValueError, match="external operand"):
            mod._chain_plan([mod.chain_pass([])])


SITE_PREPS = (
    "structure_sym", "structure_agg", "structure_hash", "structure_copy", "structure_vend",
    "line_flags", "nl_run_total", "para_hash", "para_bytes", "sentence_hst", "sentence_cnt",
    "sentence_first",
)


def test_every_prep_has_one_kernel_id():
    """The sites' preps and the kernel-layer ones are registered, each under
    a unique id whose counts match the function and the struct of the same
    id in csrc/chain.cu."""
    ids = [v[0] for v in scan.PREPS.values()]
    assert len(set(ids)) == len(ids) and min(ids) >= 1
    for name in SITE_PREPS:
        assert scan._PREP_FNS[name] is getattr(ts, name)
    assert set(scan._PREP_FNS) == set(scan.PREPS)
    for name, fn in scan._PREP_FNS.items():
        _, n_deps, n_ops = scan.PREPS[name]
        assert fn.__code__.co_argcount == n_deps, name
        outs = fn(*(torch.zeros((1, 3), dtype=torch.int32),) * n_deps)
        assert len(outs) == n_ops, name
    src = open(os.path.join(os.path.dirname(scan.__file__), "..", "csrc", "chain.cu")).read()
    declared = {
        m.group(1): tuple(int(m.group(i)) for i in (2, 3, 4))
        for m in re.finditer(
            r"struct Prep\w+ \{\s*// (\w+)\s*static constexpr int ID = (\d+), N_DEPS = (\d+), "
            r"N_OPS = (\d+);",
            src,
        )
    }
    assert declared == scan.PREPS


def test_chain_gate_and_cpu_wrapper(monkeypatch):
    """chain_scan_ok is TEXTBLAST_DEPFUSE plus the fused gate (so
    TEXTBLAST_FUSED=off turns it off too); the CPU wrapper runs the plain
    version and counts no launch."""
    for var in ("TEXTBLAST_FUSED", "TEXTBLAST_DEPFUSE"):
        monkeypatch.delenv(var, raising=False)
    assert scan.chain_scan_ok(37, 1000) and scan.chain_scan_ok(64, 16384)
    assert not scan.chain_scan_ok(64, 32768)
    monkeypatch.setenv("TEXTBLAST_DEPFUSE", "off")
    assert not scan.chain_scan_ok(64, 512) and scan.fused_scan_ok(64, 512)
    monkeypatch.delenv("TEXTBLAST_DEPFUSE")
    monkeypatch.setenv("TEXTBLAST_FUSED", "off")
    assert not scan.chain_scan_ok(64, 512)
    rng = np.random.default_rng(5)
    vals = _t(rng.integers(0, 97, size=(3, 9)).astype(np.int32))
    reset = _t((rng.random((3, 9)) < 0.3).astype(np.int32))
    before = dict(scan.LAUNCHES)
    passes = scan.chain_probe_program(vals, reset)
    got = scan.chain_scan(passes, site="probe")
    _assert_same(got, [[tuple(x.numpy() for x in g) for g in p]
                       for p in scan.chain_scan_plain(passes)])
    assert got[0] == [()] and got[2][1][0].shape == (3, 1)
    assert scan.LAUNCHES == before


def _site_batch(length=512):
    texts = [
        "Det er en god dag. Vi skal ud!\nEn linje mere... og så videre…\n\n- punkt et\n• punkt to",
        "en to tre fire fem seks syv " * 12,
        "Lorem ipsum dolor sit amet [1]. This page uses cookies.\r\nEnable javascript now.",
        "Line one.\n\n\nLine two ends here. Yes! \"Quoted.\" Done? e.g. ok",
        "",
        "ord " * 200,
    ]
    cps = np.zeros((len(texts), length), np.int32)
    lens = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        cp = [ord(c) for c in t][:length]
        cps[i, : len(cp)] = cp
        lens[i] = len(cp)
    return _t(cps), _t(lens)


def _signature(passes):
    """A program without its operand values: per pass the direction, per
    group the kind, prep, emit mode, states, operand count and deps (taps
    as they are, external operands by shape)."""
    return [
        (p["reverse"], [
            (g["kind"], getattr(g.get("prep"), "__name__", None), g.get("emit", "scan"),
             g.get("n_states"), g.get("n_ops"),
             tuple(d if isinstance(d, scan.Tap) else tuple(d.shape) for d in g["xs"]))
            for g in p["groups"]
        ])
        for p in passes
    ]


def _assert_same_operands(got, want):
    for pg, pw in zip(got, want):
        for gg, gw in zip(pg["groups"], pw["groups"]):
            for x, y in zip(gg["xs"], gw["xs"]):
                if isinstance(x, scan.Tap):
                    assert x == y
                else:
                    assert torch.equal(x.to(torch.int32), y.to(torch.int32))


def test_site_programs_are_the_sites_own(monkeypatch):
    """chain_site_programs, which chip_smoke.py holds the kernel to, builds
    the programs the sites launch: on the same batch the same program with
    the same operands; for structure without hashes, C4's post-compaction
    pass and sentence_counts, which the sites run on C4's rewritten text,
    the same program."""
    for var in ("TEXTBLAST_FUSED", "TEXTBLAST_DEPFUSE", "TEXTBLAST_TABLE_IMPL"):
        monkeypatch.delenv(var, raising=False)
    launched = {}
    real = ts.chain_scan

    def recording(passes, site=None):
        launched.setdefault(site, []).append(passes)
        return real(passes, site=site)

    monkeypatch.setattr(ts, "chain_scan", recording)
    cps, lens = _site_batch()
    stop = tuple(ts.hash_string(w) for w in ("og", "en", "the"))
    top_ns, dup_ns = (2, 3, 4), (5, 6, 7, 8, 9, 10)
    c4 = ts.C4Params(True, True, True, 5, 3, 1000, True, True, True, True)
    st = ts.structure(cps, lens)
    ts.gopher_quality_stats(st, stop)
    ts.gopher_rep_stats(st, top_ns, dup_ns, 128, 256)
    for split in (True, False):
        ts.c4_stage(cps, lens, c4._replace(split_paragraph=split), 128)
    programs = ts.chain_site_programs(cps, lens, stop, top_ns, dup_ns, 256, c4)

    # Row 1 repeats its n-grams, so the rarity gate fired and both
    # sorted-table programs were launched, the ungated jobs first.
    tables = launched.pop("sorted_tables")
    assert len(tables) == 2
    for passes, name in zip(tables, ("sorted_tables", "sorted_tables_rest")):
        assert _signature(passes) == _signature(programs[name])
        _assert_same_operands(passes, programs[name])
    assert set(launched) | {"sorted_tables", "sorted_tables_rest"} == set(programs)
    for site, calls in launched.items():
        for passes in calls:
            assert _signature(passes) == _signature(programs[site]), site
    for site in ("structure", "gopher_quality", "gopher_rep", "c4_trim", "c4_sentences"):
        _assert_same_operands(launched[site][0], programs[site])


# --- the encoding cache and the launch geometry ------------------------------------


def _site_programs(batch):
    cps, lens = batch
    c4 = ts.C4Params(True, True, True, 5, 3, 1000, True, True, True, True)
    stop = tuple(ts.hash_string(w) for w in ("og", "en", "the"))
    return ts.chain_site_programs(cps, lens, stop, (2, 3, 4), (5, 6, 7, 8, 9, 10), 256, c4)


def test_cached_encoding_is_a_fresh_encoding():
    """Every site's program is encoded once: the cached code equals a fresh
    _chain_code of the same program, its external operands are the plan's,
    and the same site's program on another batch hits the same entry with
    that batch's operands."""
    first = _site_programs(_site_batch())
    again = _site_programs(_site_batch())
    for name, passes in first.items():
        prog, ext = scan._chain_program(passes)
        plan, plan_ext, out_modes, n_scratch, layout = scan._chain_plan(passes)
        assert prog.code == scan._chain_code(plan, len(out_modes)), name
        assert len(ext) == len(plan_ext) and all(a is b for a, b in zip(ext, plan_ext)), name
        assert (prog.n_scratch, prog.layout) == (n_scratch, layout), name
        tapped = {d[1] for p in plan for gp in p["groups"] for d in gp["deps"] if d[0] == "s"}
        assert prog.n_keep == len(tapped), name
        prog2, ext2 = scan._chain_program(again[name])
        assert prog2 is prog, name
        assert all(a is b for a, b in zip(ext2, scan._chain_plan(again[name])[1])), name


def _generic_cpu(rng, shape, fill=-7, shift=1, prep=scan.low_bit, emit="scan"):
    x = _t(_full_range(rng, shape))
    r = _t((rng.random(shape) < 0.05).astype(np.int32))
    T, cg = scan.Tap, scan.chain_group
    return [
        scan.chain_pass([scan.affine_group(r, (x,), emit="none"), scan.add_group((x, r))]),
        scan.chain_pass([
            cg("copy", (T(0, 0, shift=shift, fill=fill), T(0, 1))),
            cg("add", (T(0, 2),), prep=prep, n_ops=1, emit=emit),
        ], reverse=True),
    ]


def test_programs_that_differ_get_their_own_entries():
    """A program differing in one fill, shift, prep or emit mode is a new
    cache entry; the same structure on new operands is not."""
    rng = np.random.default_rng(3)
    base = scan._chain_program(_generic_cpu(rng, (2, 40)))[0]
    assert scan._chain_program(_generic_cpu(rng, (3, 50)))[0] is base
    variants = [dict(fill=-8), dict(shift=0), dict(prep=scan.twice), dict(emit="none")]
    progs = [scan._chain_program(_generic_cpu(rng, (2, 40), **v))[0] for v in variants]
    assert len({id(p) for p in progs + [base]}) == 5
    assert len({tuple(p.code) for p in progs + [base]}) == 5


def _covered(geo, length):
    """Lanes each (chunk, thread, lane index) touches: the staging and
    output mapping (lane t + r * threads) and the scan's (walk positions
    t * items + j), both once over the chunk."""
    t = np.arange(geo.threads)[:, None]
    r = np.arange(geo.items)[None, :]
    strided = np.sort((t + r * geo.threads).ravel())
    blocked = np.sort((t * geo.items + r).ravel())
    assert np.array_equal(strided, np.arange(geo.chunk))
    assert np.array_equal(blocked, np.arange(geo.chunk))
    lanes = (np.arange(geo.cluster)[:, None] * geo.chunk + strided[None, :]).ravel()
    return lanes[lanes < length]


def test_geometry_covers_every_lane_once_within_shared_memory():
    """For every width the chain takes (and ragged ones), the geometry's
    chunks cover each lane of a row exactly once: one CTA of two lanes a
    thread up to 2048 lanes, beyond that a cluster of at most 8 CTAs of
    eight lanes a thread, never more than 1024 threads.  The largest site
    program (structure with hashes: 6 tapped streams, 3 operands) keeps its
    taps in shared memory at every width, within 227 KiB; a program with
    32 tapped streams falls back to global taps where they do not fit."""
    for length in (0, 1, 31, 100, 256, 512, 1000, 1024, 1025, 2048, 2049, 5000, 8192, 16383,
                   16384):
        for n_keep, n_stage in ((6, 3), (0, 2), (32, 5)):
            geo = scan.chain_geometry(length, n_keep, n_stage)
            lanes = _covered(geo, length)
            assert np.array_equal(np.sort(lanes), np.arange(length))
            assert geo.smem_bytes <= scan.CHAIN_SMEM_LIMIT
            assert geo.smem_bytes == 4 * scan._smem_words(
                n_stage, n_keep if geo.tap_smem else 0, geo.threads, geo.chunk)
            assert geo.threads % 32 == 0 and geo.threads <= 1024 and 1 <= geo.cluster <= 8
            assert (geo.cluster > 1) == (length > 2048)
            assert geo.items <= (2 if length <= 2048 else 8)
            if (n_keep, n_stage) == (6, 3):
                assert geo.tap_smem
    assert scan.chain_geometry(512, 6, 3)[:4] == (1, 256, 2, 512)
    assert scan.chain_geometry(8192, 6, 3)[:4] == (8, 128, 8, 1024)
    assert not scan.chain_geometry(16384, 32, 5).tap_smem  # 37 skewed rows of 2048 lanes
