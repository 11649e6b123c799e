"""C4BadWords on the device: the port against the JAX package on the CPU.

The same inputs, made from a numpy seed, go through both packages and are
compared exactly (``np.array_equal``, tolerance zero):

* ``synth_badwords`` and ``BadwordTables.build`` (every field);
* ``badwords_matches`` / ``badwords_matches_multi``: match and hazard rows
  on the boundary cases, a randomized set, fold-hazard rows, a table with
  an h1 collision (``max_dup`` > 1), empty rows and a uint16 batch;
* the stage dict of every phase of the offline Danish pipeline with the
  filter appended, on one packed batch;
* the run: ``process_documents_device`` outcomes of both packages and the
  host oracle, by id, text, metadata and reason, with
  ``worker_fold_hazard_rows_total``;
* placement (``device_steps``, ``host_steps``, ``fully_host``) and the
  badwords programs' ``scan_dispatch_counts``.

The port's scans run their plain versions here (CPU tensors); the JAX side
runs its lax scans, or its Pallas kernel in interpret mode where a test
forces it.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textblaster_tpu.config.pipeline import parse_pipeline_config as jax_parse
from textblaster_tpu.data_model import TextDocument as JaxDoc
from textblaster_tpu.filters.c4_badwords import load_local_badwords as jax_load_words
from textblaster_tpu.ops import badwords as jb
from textblaster_tpu.ops.packing import pack_documents as jax_pack
from textblaster_tpu.ops.pipeline import CompiledPipeline as JaxPipeline
from textblaster_tpu.ops.pipeline import process_documents_device as jax_process
from textblaster_tpu.orchestration import process_documents_host as jax_host
from textblaster_tpu.pipeline_builder import build_pipeline_from_config as jax_build
from textblaster_tpu.utils.metrics import METRICS as JAX_METRICS
from textblaster_tpu.utils.synthwords import synth_badwords as jax_synth
from textblaster_tpu_torch.config.pipeline import parse_pipeline_config
from textblaster_tpu_torch.data_model import TextDocument
from textblaster_tpu_torch.ops import badwords as tb
from textblaster_tpu_torch.ops.pipeline import CompiledPipeline, process_documents_device
from textblaster_tpu_torch.utils.metrics import METRICS
from textblaster_tpu_torch.utils.synthwords import synth_badwords

from test_torch_pipeline import DANISH, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

OFFLINE = "configs/pipeline_config_offline.yaml"

#: Two patterns of one length with equal h1 (98*31 + 33 == 97*31 + 64) and
#: different h2: the length-2 table's max_dup is 2.
COLLIDING = ["b!", "a@"]


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


def _pack(texts, width, dtype=np.int32):
    cps = np.zeros((len(texts), width), dtype)
    lengths = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        arr = np.array([ord(c) for c in t], dtype=dtype)[:width]
        cps[i, : len(arr)] = arr
        lengths[i] = len(arr)
    return cps, lengths


def _regex(words, cjk=False):
    alt = "|".join(re.escape(w) for w in words)
    return re.compile(f"(?i)({alt})" if cjk else rf"(?i)(?:\W|^)({alt})(?:\W|$)")


@pytest.mark.parametrize("seed", [101, 202, 303, 515])
@pytest.mark.parametrize("cjk", [False, True])
def test_synth_badwords_equal(seed, cjk):
    got = synth_badwords(seed, n=400, cjk=cjk)
    assert got == jax_synth(seed, n=400, cjk=cjk)
    assert len(got) == 400


def _lists():
    return {
        "vendored_da": (jax_load_words("da"), True),
        "vendored_en": (jax_load_words("en"), True),
        "synth_en": (synth_badwords(515, n=400), True),
        "synth_zh": (synth_badwords(303, n=400, cjk=True), False),
        "colliding": (COLLIDING + ["sin", "ok"], True),
        "fold_long_s": (["ſtop", "fine"], True),
        "fold_dotted_i": (["İstanbul"], True),
        "fold_sigma": (["σπαμ"], True),
        "oversized": (["x" * 100, "ok"], True),
        "empty_entry": (["ok", ""], True),
        "empty": ([], True),
    }


@pytest.mark.parametrize("name", sorted(_lists()))
def test_tables_equal_field_for_field(name):
    words, bounds = _lists()[name]
    want = jb.BadwordTables.build(words, check_boundaries=bounds)
    got = tb.BadwordTables.build(words, check_boundaries=bounds)
    if want is None:
        assert got is None
        assert name.startswith(("fold", "oversized", "empty"))
        return
    assert got is not None
    assert got.lengths == want.lengths
    assert got.max_dup == want.max_dup
    assert got.check_boundaries == want.check_boundaries
    assert got.hazard_cps == want.hazard_cps
    for g, w in zip(got.tables1 + got.tables2, want.tables1 + want.tables2):
        assert g.dtype == w.dtype == np.int32
        assert np.array_equal(g, w)
    if name == "colliding":
        assert got.max_dup == 2
    if name == "synth_en":
        assert len(got.lengths) >= 12 and set(got.hazard_cps) == {0x130, 0x131, 0x17F}


def _random_texts(rng, words, n, width):
    """Rows of list entries, in-word substrings, fold-hazard letters and
    filler, some longer than ``width`` (clipped by the packer)."""
    vocab = ["the", "dog,", "x", "sin!", "ſin", "ın", "İn", "Kelvin",
             "b!", "a@", "_bad", "bad_", "(", ")", "-"]
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(0, 40))):
            r = rng.random()
            if r < 0.12:
                parts.append(words[int(rng.integers(len(words)))])
            elif r < 0.2:  # an entry inside a longer token: no boundary
                w = words[int(rng.integers(len(words)))]
                parts.append("q" + w if rng.random() < 0.5 else w + "9")
            elif r < 0.25:  # an entry in upper case
                parts.append(words[int(rng.integers(len(words)))].upper())
            else:
                parts.append(vocab[int(rng.integers(len(vocab)))])
        out.append(" ".join(parts)[: int(rng.integers(0, width + 64))])
    return out


BOUNDARY_TEXTS = [
    "this is a bad word here",
    "BAD at the start",
    "nothing wrong at all",
    "embadded inside a token",
    "badges are fine",
    "a wide phrase spans words",
    "so bad",
    "bad",
    "",
]


def _cases():
    rng = np.random.default_rng(18)
    synth = synth_badwords(515, n=400)
    en_words = ["bad", "wide phrase", "sin"] + COLLIDING
    return {
        # (tables by language, texts, width, dtype)
        "boundaries": ({"en": (["bad", "wide phrase"], True)}, BOUNDARY_TEXTS, 64, np.int32),
        "cjk": ({"zh": (["悪い"], False)},
                ["これは悪い言葉です",
                 "これは良い言葉です", ""], 32, np.int32),
        "hazards": ({"en": (["sin"], True), "xx": (["gz"], True)},
                    ["with ſ char", "plain text", "K kelvin", "İ dotted",
                     "ı dotless", "ſin here", "sin here", "SİN"], 32, np.int32),
        "collision": ({"en": (COLLIDING, True)},
                      ["say b! now", "say a@ now", "b!", "a@", "ab!", "b!c", "a@@", "b! a@"],
                      16, np.int32),
        "random_synth": ({"en": (synth, True)}, _random_texts(rng, synth, 16, 2048), 2048,
                         np.int32),
        "random_multi": ({"en": (en_words, True), "zh": (["坏话"], False)},
                         _random_texts(rng, en_words + ["坏话"], 16, 512), 512,
                         np.int32),
        "empty_rows": ({"en": (synth, True)}, ["", "", synth[3], ""], 128, np.int32),
        "u16_wire": ({"en": (en_words, True)}, _random_texts(rng, en_words, 12, 256), 256,
                     np.uint16),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_matches_and_hazards_equal(name):
    lists, texts, width, dtype = _cases()[name]
    cps, lengths = _pack(texts, width, dtype)
    jt = {lang: jb.BadwordTables.build(w, check_boundaries=b) for lang, (w, b) in lists.items()}
    tt = {lang: tb.BadwordTables.build(w, check_boundaries=b) for lang, (w, b) in lists.items()}
    # One jitted JAX program (its pipeline jits the step the same way; op by
    # op it costs ~12 s a case).  Its pipeline widens the wire before the
    # step, so it takes int32 code points.
    j_fn = jax.jit(lambda c, n: jb.badwords_matches_multi(c, n, jt))
    want_m, want_h = j_fn(jnp.asarray(cps.astype(np.int32)), jnp.asarray(lengths))
    got_m, got_h = tb.badwords_matches_multi(torch.from_numpy(cps), torch.from_numpy(lengths), tt)
    assert sorted(got_m) == sorted(want_m) == sorted(got_h) == sorted(want_h)
    for lang in want_m:
        assert got_m[lang].dtype == torch.bool and got_m[lang].shape == (len(texts),)
        assert np.array_equal(got_m[lang].numpy(), np.asarray(want_m[lang])), lang
        assert np.array_equal(got_h[lang].numpy(), np.asarray(want_h[lang])), lang
    # The single-table entry point gives the same arrays.
    lang = sorted(tt)[0]
    m1, h1 = tb.badwords_matches(torch.from_numpy(cps), torch.from_numpy(lengths), tt[lang])
    assert torch.equal(m1, got_m[lang]) and torch.equal(h1, got_h[lang])
    # And the verdict is the regex's on every hazard-free row.
    for lang, (words, bounds) in lists.items():
        pattern = _regex(words, cjk=not bounds)
        for row, t in enumerate(texts):
            if not got_h[lang][row]:
                assert bool(got_m[lang][row]) == bool(pattern.search(t[:width])), (lang, t)
    if name == "boundaries":
        assert got_m["en"].tolist() == [True, True, False, False, False, True, True, True, False]
    if name == "hazards":
        assert got_h["en"].tolist() == [True, False, False, True, True, True, False, True]
        assert not got_h["xx"].any()
    if name == "collision":
        assert tt["en"].max_dup == 2
        assert got_m["en"].tolist() == [True, True, True, True, False, False, True, True]


BADWORDS_STEP = """
- type: C4BadWordsFilter
  default_language: {lang}
  keep_fraction: {keep}
  fail_on_missing_language: true
  seed: 7
"""


def _offline_with_badwords(parse, lang="da", keep=0.3):
    text = open(OFFLINE, encoding="utf-8").read()
    return parse(text + BADWORDS_STEP.format(lang=lang, keep=keep))


def test_stage_dict_equal_offline_pipeline_with_badwords(monkeypatch):
    """Every phase's stats dict, key for key, on one packed batch of Danish
    prose with list hits (after c4's rewrite); the JAX side on its lax
    scans (no Pallas kernel on the CPU outside interpret mode), the port on
    its default chain schedule (every schedule gives the same integers)."""
    for var in ("TEXTBLAST_PALLAS_INTERPRET", "TEXTBLAST_DEPFUSE", "TEXTBLAST_FUSED"):
        monkeypatch.delenv(var, raising=False)
    jp = JaxPipeline(_offline_with_badwords(jax_parse), buckets=(512,), batch_size=16)
    tp = CompiledPipeline(_offline_with_badwords(parse_pipeline_config), buckets=(512,),
                          batch_size=16, device="cpu")
    assert jp.phases == tp.phases and len(tp.phases) == 3
    assert [s.type for s in tp.device_steps][-1] == "C4BadWordsFilter" and not tp.host_steps
    assert 5 in tp.phases[2]
    da = jax_load_words("da")
    rng = np.random.default_rng(11)
    docs = []
    for i in range(16):
        lines = []
        for _ in range(int(rng.integers(3, 8))):
            ws = [DANISH[int(rng.integers(len(DANISH)))] for _ in range(int(rng.integers(5, 12)))]
            if rng.random() < 0.3:
                ws.insert(int(rng.integers(len(ws))), da[int(rng.integers(len(da)))])
            lines.append(" ".join(ws).capitalize() + ".")
        if i % 5 == 0:
            lines.append("Kort.")  # a line c4 drops: the rewrite moves the lengths
        docs.append(JaxDoc(id=f"s{i}", source="t", content="\n".join(lines)[:500]))
    batch = jax_pack(docs, 16, 512)
    for phase in range(3):
        want = {k: np.asarray(v) for k, v in
                jp._build_fn(512, phase)(batch.cps, batch.lengths).items()}
        got = tp._build_fn(512, phase)(torch.from_numpy(batch.cps),
                                       torch.from_numpy(batch.lengths))
        assert sorted(got) == sorted(want)
        for k in want:
            g = got[k].numpy()
            assert g.shape == want[k].shape, k
            np.testing.assert_array_equal(g.astype(want[k].dtype), want[k], err_msg=k)
    assert {"5:match:da", "5:match:en", "5:hazard:da", "5:hazard:en"} <= set(want)
    assert want["5:match:da"].any() and not want["5:match:da"].all()


def _run_docs(words):
    """(id, text, metadata) rows: hits, in-word substrings, fold hazards,
    clean rows, a Danish row decided by the vendored list, and a row whose
    language has no list."""
    rng = np.random.default_rng(29)
    da = jax_load_words("da")
    rows = []
    for i in range(40):
        r = rng.random()
        w = words[int(rng.integers(len(words)))]
        base = " ".join(DANISH[int(rng.integers(len(DANISH)))] for _ in range(12))
        if r < 0.35:
            text = f"{base} {w} slut"
        elif r < 0.5:
            text = f"{base} x{w}y"
        elif r < 0.6:
            text = f"{base} ſ{w[1:]} ı"
        else:
            text = base
        rows.append((f"r{i}", text, {}))
    rows.append(("da0", f"dette er {da[0]} her", {"language": "da"}))
    rows.append(("da1", "helt ren tekst om vejret", {"language": "da"}))
    rows.append(("xx0", "any text at all", {"language": "xx"}))
    rows.append(("long", ((" ".join(words[:40]) + " ") * 8)[:1500], {}))
    return rows


def _outcome_map(outs):
    return {
        o.document.id: (o.kind, o.document.content, tuple(sorted(o.document.metadata.items())),
                        o.reason or "")
        for o in outs
    }


def test_run_outcomes_equal_jax_and_host(tmp_path, monkeypatch):
    monkeypatch.setenv("TEXTBLAST_HOST_TAILS", "off")
    words = synth_badwords(515, n=400) + ["sin"]
    (tmp_path / "en").write_text("\n".join(words) + "\n", encoding="utf-8")
    yaml = ("pipeline:\n" + BADWORDS_STEP.format(lang="en", keep=0.3))
    rows = _run_docs(words)

    def docs(cls):
        return [cls(id=i, source="t", content=t, metadata=dict(md)) for i, t, md in rows]

    jcfg, tcfg = jax_parse(yaml), parse_pipeline_config(yaml)
    jcfg.pipeline[0].params.cache_base_path = tmp_path
    tcfg.pipeline[0].params.cache_base_path = tmp_path

    host = _outcome_map(jax_host(jax_build(jcfg), iter(docs(JaxDoc))))
    j0 = JAX_METRICS.get("worker_fold_hazard_rows_total")
    jax_out = _outcome_map(jax_process(jcfg, iter(docs(JaxDoc)), device_batch=16,
                                       buckets=(512, 2048), warmup=False))
    j_hazard = JAX_METRICS.get("worker_fold_hazard_rows_total") - j0
    pipe = CompiledPipeline(tcfg, buckets=(512, 2048), batch_size=16, device="cpu")
    assert pipe.device_steps and not pipe.host_steps and not pipe.fully_host
    t0 = METRICS.get("worker_fold_hazard_rows_total")
    port = _outcome_map(process_documents_device(tcfg, iter(docs(TextDocument)), pipeline=pipe))
    t_hazard = METRICS.get("worker_fold_hazard_rows_total") - t0

    assert port == jax_out == host
    assert t_hazard == j_hazard > 0
    assert set(pipe.counters["batches_by_bucket"]) == {512, 2048}
    statuses = {v[2] for v in port.values()}
    flat = {dict(s).get("c4_badwords_filter_status") for s in statuses}
    assert {"passed", "filtered", "passed_kept_by_fraction"} <= flat
    assert port["xx0"][0] != "Success" and "no badwords list" in port["xx0"][3]
    assert port["da0"][3] == "document_removed_with_badwords"


def _placement(pipe):
    return ([s.type for s in pipe.device_steps], [s.type for s in pipe.host_steps],
            pipe.fully_host)


def _build_both(yaml_text, cache=None):
    jcfg, tcfg = jax_parse(yaml_text), parse_pipeline_config(yaml_text)
    for cfg in (jcfg, tcfg):
        for s in cfg.pipeline:
            if s.type == "C4BadWordsFilter":
                s.params.cache_base_path = cache
    return (JaxPipeline(jcfg, buckets=(512,), batch_size=16),
            CompiledPipeline(tcfg, buckets=(512,), batch_size=16, device="cpu"))


LANGID = """
- type: LanguageDetectionFilter
  min_confidence: 0.65
  allowed_languages: [dan]
"""


@pytest.mark.parametrize("case", ["first", "last", "no_list_first", "no_list_last"])
def test_placement_equal(case, tmp_path):
    lang = "sv" if case.startswith("no_list") else "en"
    step = BADWORDS_STEP.format(lang=lang, keep=0.0)
    body = step + LANGID if case.endswith("first") else LANGID + step
    jp, tp = _build_both("pipeline:\n" + body, cache=tmp_path)
    assert _placement(tp) == _placement(jp)
    want = {
        "first": (["C4BadWordsFilter", "LanguageDetectionFilter"], [], False),
        "last": (["LanguageDetectionFilter", "C4BadWordsFilter"], [], False),
        "no_list_first": ([], ["C4BadWordsFilter", "LanguageDetectionFilter"], True),
        "no_list_last": (["LanguageDetectionFilter"], ["C4BadWordsFilter"], False),
    }[case]
    assert _placement(tp) == want


def test_placement_sees_a_list_written_between_builds(tmp_path):
    yaml_text = "pipeline:\n" + BADWORDS_STEP.format(lang="sv", keep=0.0) + LANGID
    before = _build_both(yaml_text, cache=tmp_path)
    assert _placement(before[1]) == _placement(before[0]) == (
        [], ["C4BadWordsFilter", "LanguageDetectionFilter"], True)
    (tmp_path / "sv").write_text("fult ord\nsvordet\n", encoding="utf-8")
    after = _build_both(yaml_text, cache=tmp_path)
    assert _placement(after[1]) == _placement(after[0]) == (
        ["C4BadWordsFilter", "LanguageDetectionFilter"], [], False)
    assert sorted(after[1]._badwords_device_tables[0]) == sorted(
        after[0]._badwords_device_tables[0]) == ["da", "en", "sv"]


@pytest.mark.parametrize("bucket", [512, 2048])
def test_scan_dispatch_counts_equal(bucket, monkeypatch):
    """The badwords programs' dispatches at geometry rows: two per-scan
    kernel launches (k = 1) for the step, alone and after the offline
    pipeline's phase-2 steps; the JAX package's Pallas kernel forced in
    interpret mode (its gate holds at geometry rows), under ``eval_shape``."""
    monkeypatch.setenv("TEXTBLAST_PALLAS_INTERPRET", "1")
    for var in ("TEXTBLAST_FUSED", "TEXTBLAST_DEPFUSE"):
        monkeypatch.delenv(var, raising=False)
    alone = "pipeline:\n" + BADWORDS_STEP.format(lang="en", keep=0.0)
    jp, tp = _build_both(alone)
    assert tp.scan_dispatch_counts(bucket, 0, 16) == jp.scan_dispatch_counts(bucket, 0, 16) == {
        "pallas_scan": 2}
    jfull = JaxPipeline(_offline_with_badwords(jax_parse), buckets=(bucket,), batch_size=16)
    tfull = CompiledPipeline(_offline_with_badwords(parse_pipeline_config), buckets=(bucket,),
                             batch_size=16, device="cpu")
    got = tfull.scan_dispatch_counts(bucket, 2, 16)
    assert got == jfull.scan_dispatch_counts(bucket, 2, 16)
    assert got["pallas_scan"] >= 2
