"""The port's native C++ host core against the JAX package's, on the CPU.

``textblaster_tpu_torch/native`` is the port's own copy of the JAX
package's core (the same C ABI), built by ``g++`` under a file lock into
``build/torch_native/<hash>/``.  Here it is held, with exact equality, to
the numpy paths of both packages (the source of truth), to the spec's
segmentation vectors, to ``tokenizers`` for BPE counts, and to the JAX
package's own core where that one loaded in this worker.  The build is
checked from two processes at once.  No case sets ``TEXTBLASTER_NATIVE``:
``native.disabled()`` switches the port's core off, and the JAX package's
numpy path is reached by patching its module's ``_native_spans``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import string
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from textblaster_tpu import native as jax_native
from textblaster_tpu.utils import text as JT
from textblaster_tpu_torch import native
from textblaster_tpu_torch.utils import chartables
from textblaster_tpu_torch.utils import text as PT
from textblaster_tpu_torch.utils.chartables import classify, codepoints

from test_torch_pipeline import DANISH, ENGLISH, make_corpus, one_torch_thread  # noqa: F401
from test_uax29_vectors import WORD_VECTORS

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "textblaster_tpu_torch")
STANDIN = os.path.join(PKG, "data", "tokenizers", "gpt2", "tokenizer.json")

#: ``tests/test_native.py``'s fuzz alphabet, then Danish, CJK, emoji and
#: WB4 attachers (a combining acute, ZWJ).
ALPHABETS = {
    "ascii": string.ascii_letters + string.digits + " .,!?'\"\n\t_-·:æøå日本１％",
    "danish": "abcdefghijklmnoprstuvyæøåÆØÅé " * 2 + ".,;:!?'’\n-1234567890",
    "cjk": "数据处理流水线的测试文本中文日本語のテキスト。！？ab 12" + "，、",
    "emoji": "ab cd\U0001F600\U0001F44D\U0001F3FD‍❤️ ́x1.,!\n",
}
TEXTS = {
    "danish": "Det er en god dag, og vi skal ud at gå en tur. " * 6
    + "Børnene kommer fra skole.\n\nDet er en god dag, og vi skal ud at gå en tur.",
    "english": "the quick brown fox jumps over the lazy dog and the dog sleeps. " * 8,
    "cjk": "数据处理流水线的测试文本，包含中文。" + "Det er en god dag og vi er glade. " * 5,
}
TOP_NS, DUP_NS = (2, 3, 4), (5, 6, 7, 8, 9, 10)


@pytest.fixture(autouse=True, scope="module")
def core():
    assert native.available(), "the port's native core did not build"


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's numpy paths, without touching its loader."""
    monkeypatch.setattr(JT, "_native_spans", None)


def _spans(text):
    cps = codepoints(text).astype(np.int32)
    return cps, native.word_spans_native(cps, classify(cps.astype(np.uint32)))


def _fuzz_texts(alphabet: str, seed: int, n: int = 150, max_len: int = 60):
    rng = np.random.default_rng(seed)
    return ["".join(alphabet[int(i)] for i in rng.integers(0, len(alphabet), int(rng.integers(0, max_len))))
            for _ in range(n)]


# --- segmentation -------------------------------------------------------------


@pytest.mark.parametrize("alphabet", sorted(ALPHABETS))
def test_word_spans_equal_both_numpy_paths(alphabet, jax_numpy):
    for text in _fuzz_texts(ALPHABETS[alphabet], seed=len(alphabet)):
        _, got = _spans(text)
        with native.disabled():
            port = PT.word_spans(text, cjk_dict=False)
        want = JT.word_spans(text, cjk_dict=False)
        assert [tuple(s) for s in got.tolist()] == port == want, repr(text)


@pytest.mark.parametrize("text,expected", WORD_VECTORS, ids=[v[0][:24] for v in WORD_VECTORS])
def test_word_vector_through_the_ports_core(text, expected):
    _, spans = _spans(text)
    assert [text[a:b] for a, b in spans] == expected


@pytest.mark.parametrize("name", sorted(TEXTS))
@pytest.mark.parametrize("on", [True, False], ids=["core_on", "core_off"])
def test_ngram_stats_and_words_equal_the_jax_packages(name, on):
    text = TEXTS[name]
    before = dict(native.CALLS)
    if on:
        top, dup = PT.ngram_dup_stats(text, TOP_NS, DUP_NS)
        words = PT.split_into_words(text)
    else:
        with native.disabled():
            top, dup = PT.ngram_dup_stats(text, TOP_NS, DUP_NS)
            words = PT.split_into_words(text)
    assert (top, dup) == JT.ngram_dup_stats(text, TOP_NS, DUP_NS)
    assert words == JT.split_into_words(text)
    assert (native.CALLS["word_spans"] > before["word_spans"]) == on
    # The dictionary-script text takes the numpy n-gram path either way.
    assert (native.CALLS["dup_ngram_bytes"] > before["dup_ngram_bytes"]) == (on and name != "cjk")


# --- duplicate scans ----------------------------------------------------------


def _item_spans(text: str, sep: "re.Pattern"):
    """Code point spans of ``sep.split(text)``'s pieces."""
    out, start = [], 0
    for m in sep.finditer(text):
        out.append((start, m.start()))
        start = m.end()
    out.append((start, len(text)))
    return np.array(out, dtype=np.int32).reshape(-1, 2)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_dup_scans_equal_the_jax_primitives(seed):
    rng = np.random.default_rng(seed)
    pool = ["og", "det", "er", "en", "dag", "hund", "kat", "hus", "æble", "ø", "数据", "\U0001F600"]
    for _ in range(60):
        lines = [" ".join(pool[int(i)] for i in rng.integers(0, len(pool), int(rng.integers(0, 8))))
                 for _ in range(int(rng.integers(1, 8)))]
        text = "".join(ln + "\n" * int(rng.integers(1, 3)) for ln in lines).strip()
        cps, spans = _spans(text)
        words = [text[s:e] for s, e in spans]
        assert words == [text[s:e] for s, e in JT.word_spans(text, cjk_dict=False)]
        for n in (1, 2, 3, 5, 10):
            assert native.dup_ngram_bytes(cps, spans, n) == JT.find_all_duplicate(words, n)
            assert native.top_ngram_bytes(cps, spans, n) == JT.find_top_duplicate(JT.get_n_grams(words, n))
        assert native.dup_items(cps, spans) == JT.find_duplicates(words)
        for sep in (re.compile(r"\n+"), re.compile(r"\n{2,}")):
            assert native.dup_items(cps, _item_spans(text, sep)) == JT.find_duplicates(sep.split(text))


def test_dup_scan_advances_past_a_hit():
    # find_all_duplicate advances by n on a hit (text.rs:241-259).
    cps, spans = _spans("a a a a a")
    assert native.dup_ngram_bytes(cps, spans, 2) == 4 == JT.find_all_duplicate(["a"] * 5, 2)


def test_dup_scan_compares_concatenations():
    # ["ab","c"] and ["a","bc"] concatenate equal: a duplicate.
    cps, spans = _spans("ab c a bc")
    assert native.dup_ngram_bytes(cps, spans, 2) == JT.find_all_duplicate(["ab", "c", "a", "bc"], 2) == 3


# --- packing ------------------------------------------------------------------


def _arrow(texts):
    blobs = [t.encode("utf-8") if isinstance(t, str) else t for t in texts]
    data = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    return data, np.cumsum([0] + [len(b) for b in blobs]).astype(np.int64)


def _decode_bytewise(blob: bytes):
    """The core's rule: a sequence that is not whole decodes as U+FFFD and
    moves on by one byte."""
    out, i = [], 0
    while i < len(blob):
        b0 = blob[i]
        n = 0 if b0 < 0x80 else 1 if b0 >> 5 == 6 else 2 if b0 >> 4 == 14 else 3 if b0 >> 3 == 30 else -1
        tail = blob[i + 1:i + 1 + n] if n > 0 else b""
        if n == 0:
            out.append(b0)
            i += 1
        elif n > 0 and len(tail) == n and all(b >> 6 == 2 for b in tail):
            cp = b0 & (0x7F >> (n + 1))
            for b in tail:
                cp = (cp << 6) | (b & 0x3F)
            out.append(cp)
            i += 1 + n
        else:
            out.append(0xFFFD)
            i += 1
    return out


def test_pack_utf8_round_trip_and_lengths():
    texts = list(TEXTS.values()) + ["", "x", "æblegrød \U0001F600", "日本語"]
    data, offs = _arrow(texts)
    cps, lens = native.pack_utf8(data, offs, max_len=1024, batch_size=len(texts) + 3)
    for i, t in enumerate(texts):
        ref = codepoints(t).astype(np.int32)
        assert lens[i] == len(ref) and (cps[i, : len(ref)] == ref).all() and not cps[i, len(ref):].any()
    assert not cps[len(texts):].any() and not lens[len(texts):].any()
    assert native.utf8_lengths(data, offs).tolist() == [len(t) for t in texts]
    if jax_native.available():
        want = jax_native.pack_utf8(data, offs, max_len=1024, batch_size=len(texts) + 3)
        assert all(np.array_equal(g, w) for g, w in zip((cps, lens), want))


def test_pack_utf8_flags_an_over_length_row():
    text = "æblegrød " * 40
    data, offs = _arrow([text, "kort"])
    cps, lens = native.pack_utf8(data, offs, max_len=100, batch_size=2)
    assert lens.tolist() == [-len(text), 4] and not cps[0].any()


def test_pack_utf8_decodes_invalid_bytes_one_at_a_time():
    blobs = [b"a\xffb", b"\xc3", b"\xc3A", b"\xe6\x97", b"\xe6\x97\xa5!", b"\x80\x80", b"\xf0\x9f\x98", b"\xf8z"]
    data, offs = _arrow(blobs)
    cps, lens = native.pack_utf8(data, offs, max_len=8, batch_size=len(blobs))
    for i, blob in enumerate(blobs):
        want = _decode_bytewise(blob)
        assert cps[i, : lens[i]].tolist() == want, blob
    assert _decode_bytewise(b"\xe6\x97") == [0xFFFD, 0xFFFD]
    if jax_native.available():
        want = jax_native.pack_utf8(data, offs, max_len=8, batch_size=len(blobs))
        assert np.array_equal(cps, want[0]) and np.array_equal(lens, want[1])


def test_char_class_bits_equal_the_ports_chartables():
    src = open(native.SOURCE, encoding="utf-8").read()
    bits = {name: 1 << int(shift) for name, shift in
            re.findall(r"constexpr uint8_t k(\w+) = 1 << (\d+);", src)}
    assert bits == {"Alnum": chartables.ALNUM, "Alpha": chartables.ALPHA, "Digit": chartables.DIGIT,
                    "Ws": chartables.WS, "Punct": chartables.PUNCT, "Extend": chartables.EXTEND}
    # The UAX#29 joiners of is_mid_letter / is_mid_num are utils/text.py's.
    bodies = re.findall(r"inline bool is_mid_(letter|num)\(uint32_t cp\) \{(.*?)\n\}", src, re.S)
    mids = {kind: sorted(int(h, 16) for h in re.findall(r"case 0x([0-9a-f]+):", body)) for kind, body in bodies}
    assert mids == {"letter": PT._MID_LETTER_CP.tolist(), "num": PT._MID_NUM_CP.tolist()}


# --- BPE ----------------------------------------------------------------------


def standin_merges_text() -> str:
    """The stand-in tokenizer's merges as a GPT-2 ``merges.txt``."""
    with open(STANDIN, encoding="utf-8") as f:
        merges = json.load(f)["model"]["merges"]
    return "#version: 0.2\n" + "".join(
        (m if isinstance(m, str) else " ".join(m)) + "\n" for m in merges)


@pytest.fixture(scope="module")
def toy():
    """``tests/test_native.py``'s toy byte-level BPE in ``tokenizers`` and
    the port's counter over the same merges."""
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, pre_tokenizers
    from tokenizers.models import BPE

    vocab = {ch: i for i, ch in enumerate(sorted(pre_tokenizers.ByteLevel.alphabet()))}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("o", "w"), ("hell", "o"),
              ("Ġ", "w"), ("Ġw", "o"), ("Ġwo", "r"), ("Ġwor", "l"), ("Ġworl", "d"),
              ("e", "r"), ("t", "h"), ("th", "e"), ("Ġ", "the"), ("a", "n"),
              ("an", "d"), ("1", "2"), ("12", "3"), ("Ã", "¦"), ("Ã", "¸")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    tok = Tokenizer(BPE(vocab, merges))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    return tok, native.BpeCounter("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))


BPE_TEXTS = ["hello world", "hello  world", "the and the", "it's we've they'll don't",
             "abc123 def", "   leading", "trailing   ", "tabs\t\tand\nnewlines\n",
             "æble søen gård", "日本語 text", "a", "", " ", "  ", "!!!",
             "price: $1,234.56 (12% off)!"]


@pytest.mark.parametrize("text", BPE_TEXTS)
def test_bpe_counts_equal_tokenizers_on_the_toy_merges(toy, text):
    tok, bpe = toy
    assert bpe.count(text) == len(tok.encode(text).tokens)


def test_bpe_fuzz_equals_tokenizers_on_the_toy_merges(toy):
    tok, bpe = toy
    for text in _fuzz_texts(string.ascii_letters + string.digits + " .,!?'\"\n\tæøå日本", seed=3, max_len=50):
        assert bpe.count(text) == len(tok.encode(text).tokens), repr(text)


def _prose(seed: int, n: int):
    """Seeded Danish/English prose with digits, punctuation and
    contractions, one text a line group."""
    rng = np.random.default_rng(seed)
    extras = ["12", "3,5", "1.234", "it's", "don't", "(se", "mere)", "—", "50%", "kr.", "“citat”"]
    pool = DANISH + ENGLISH + extras
    return ["\n".join(" ".join(pool[int(i)] for i in rng.integers(0, len(pool), int(rng.integers(1, 25))))
                      for _ in range(int(rng.integers(1, 5)))) for _ in range(n)]


def test_bpe_counts_equal_the_standin_tokenizer_json():
    tokenizers = pytest.importorskip("tokenizers")
    tok = tokenizers.Tokenizer.from_file(STANDIN)
    bpe = native.BpeCounter(standin_merges_text())
    for text in _prose(seed=19, n=80):
        assert bpe.count(text) == len(tok.encode(text, add_special_tokens=True).tokens), repr(text)


def test_bpe_counts_equal_the_jax_packages_counter():
    if not jax_native.available():
        pytest.skip("the JAX package's in-place core did not load in this worker")
    merges = standin_merges_text()
    port, ref = native.BpeCounter(merges), jax_native.BpeCounter(merges)
    texts = _prose(seed=23, n=60) + list(TEXTS.values()) + _fuzz_texts(ALPHABETS["emoji"], seed=5, n=40)
    before = native.CALLS["bpe_count"]
    assert [port.count(t) for t in texts] == [ref.count(t) for t in texts]
    assert native.CALLS["bpe_count"] - before == sum(1 for t in texts if t)


def test_token_counter_on_a_merges_file_counts_as_the_jax_packages(tmp_path):
    from textblaster_tpu.data_model import TextDocument as JaxDoc
    from textblaster_tpu.errors import UnexpectedError as JaxUnexpected
    from textblaster_tpu.filters.token_counter import TokenCounter as JaxTokenCounter
    from textblaster_tpu_torch.data_model import TextDocument
    from textblaster_tpu_torch.errors import UnexpectedError
    from textblaster_tpu_torch.filters.token_counter import TokenCounter

    bad = tmp_path / "bad" / "merges.txt"
    bad.parent.mkdir()
    bad.write_bytes(b"#version: 0.2\n\xff\xfe a\n")
    with pytest.raises(UnexpectedError) as got:
        TokenCounter(str(bad))
    with pytest.raises(JaxUnexpected) as want:
        JaxTokenCounter(str(bad))
    assert got.value.args == want.value.args == ("Error in loading tokenizer",)
    if not jax_native.available():
        pytest.skip("the JAX package's in-place core did not load in this worker")
    merges = tmp_path / "merges.txt"
    merges.write_text(standin_merges_text(), encoding="utf-8")
    for path in (str(merges), str(tmp_path)):  # the file, and a directory holding it
        port, ref = TokenCounter(path), JaxTokenCounter(path)
        for i, text in enumerate(_prose(seed=29, n=20) + [""]):
            got = port.process(TextDocument(id=str(i), source="s", content=text)).metadata
            want = ref.process(JaxDoc(id=str(i), source="s", content=text)).metadata
            assert got == want and "token_count" in got


# --- the build ----------------------------------------------------------------

_BUILDER = """
import ctypes, sys
import numpy as np
sys.path.insert(0, sys.argv[2])
from textblaster_tpu_torch.native import build
path = build(sys.argv[1])
lib = ctypes.CDLL(path)
data = np.frombuffer("æøå日本 ok".encode(), dtype=np.uint8).copy()
offs = np.array([0, data.shape[0]], dtype=np.int64)
out = np.zeros(1, dtype=np.int32)
ptr = ctypes.c_void_p
lib.tb_utf8_lengths(ptr(data.ctypes.data), ptr(offs.ctypes.data), ctypes.c_int64(1), ptr(out.ctypes.data))
print(path, int(out[0]))
"""


def _package_files():
    return sorted(os.path.join(d, f) for d, dirs, files in os.walk(PKG) for f in files
                  if "__pycache__" not in d)


def test_concurrent_builders_load_one_whole_library(tmp_path):
    before = _package_files()
    root = str(tmp_path / "native_root")
    env = {k: v for k, v in os.environ.items() if k != "TEXTBLASTER_NATIVE"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, root, ROOT], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    results = {o[0].strip() for o in outs}
    (line,) = results  # both loaded the same library and decoded the same count
    path, count = line.rsplit(" ", 1)
    assert count == "8" and path.startswith(root)
    (digest,) = os.listdir(root)
    assert sorted(os.listdir(os.path.join(root, digest))) == ["build.lock", "libtextblaster_native.so"]
    assert _package_files() == before  # nothing written under the package


def test_a_changed_source_or_compiler_gets_a_new_hash(tmp_path):
    same, changed = tmp_path / "same.cpp", tmp_path / "changed.cpp"
    src = open(native.SOURCE, "rb").read()
    same.write_bytes(src)
    changed.write_bytes(src + b"\n// changed\n")
    other_cxx = tmp_path / "other-cxx"
    other_cxx.write_text("#!/bin/sh\necho 'other-cxx 1.0'\n")
    other_cxx.chmod(0o755)
    cxx = native._compiler()
    base = native._digest(native.SOURCE, cxx)
    assert native._digest(str(same), cxx) == base
    assert native._digest(str(changed), cxx) != base
    assert native._digest(native.SOURCE, str(other_cxx)) != base
    assert os.path.dirname(native.build()) == os.path.join(ROOT, "build", "torch_native", base)


def test_a_failed_build_is_logged_once_and_not_kept_past_its_cause(monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    monkeypatch.setattr(native, "_compiler", lambda: "false")  # a compiler that always fails
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available() and not native.available()
        text = "Det er en god dag."
        assert PT.split_into_words(text) == JT.split_into_words(text)  # the numpy path serves
    assert len([r for r in caplog.records if "native core unavailable" in r.getMessage()]) == 1
    monkeypatch.setattr(native, "_compiler", lambda: os.environ.get("CXX") or "g++")
    assert native.available()  # the cause is gone: the library loads


# --- run level ----------------------------------------------------------------


def _shipped_spec(merges_path: str) -> str:
    with open(os.path.join(ROOT, "configs", "pipeline_config.yaml"), encoding="utf-8") as f:
        text = f.read()
    assert text.count("tokenizer_name: gpt2") == 1
    return text.replace("tokenizer_name: gpt2", f"tokenizer_name: {merges_path}")


def _rows(path):
    return sorted(pq.read_table(str(path)).to_pylist(), key=lambda r: r["id"])


def test_shipped_config_on_a_merges_file_equals_the_jax_host_run(tmp_path):
    """``configs/pipeline_config.yaml`` with TokenCounter on the stand-in's
    ``merges.txt``: the port's host executor and ``run_pipeline`` on the
    CPU against the JAX package's host executor, row for row."""
    if not jax_native.available():
        pytest.skip("the JAX package's in-place core did not load in this worker")
    from textblaster_tpu.config.pipeline import parse_pipeline_config as jax_parse
    from textblaster_tpu.io.parquet_reader import ParquetInputConfig as JaxInput
    from textblaster_tpu.io.parquet_reader import ParquetReader as JaxReader
    from textblaster_tpu.orchestration import aggregate_results_from_stream as jax_aggregate
    from textblaster_tpu.orchestration import process_documents_host as jax_host
    from textblaster_tpu.pipeline_builder import build_pipeline_from_config as jax_build
    from textblaster_tpu_torch.config.pipeline import parse_pipeline_config
    from textblaster_tpu_torch.io.parquet_reader import ParquetInputConfig, ParquetReader
    from textblaster_tpu_torch.orchestration import aggregate_results_from_stream, process_documents_host
    from textblaster_tpu_torch.pipeline_builder import build_pipeline_from_config
    from textblaster_tpu_torch.runner import run_pipeline

    merges = tmp_path / "merges.txt"
    merges.write_text(standin_merges_text(), encoding="utf-8")
    spec = _shipped_spec(str(merges))
    rows = make_corpus(60, seed=31)
    inp = tmp_path / "in.parquet"
    pq.write_table(pa.table({"id": [r[0] for r in rows], "text": [r[1] for r in rows]}), str(inp))
    outs = {}
    for name, parse, build, reader, inconf, host, agg in (
        ("jax", jax_parse, jax_build, JaxReader, JaxInput, jax_host, jax_aggregate),
        ("port", parse_pipeline_config, build_pipeline_from_config, ParquetReader,
         ParquetInputConfig, process_documents_host, aggregate_results_from_stream),
    ):
        docs = reader(inconf(str(inp), "text", "id")).read_documents()
        o, e = tmp_path / f"{name}_kept.parquet", tmp_path / f"{name}_excl.parquet"
        agg(host(build(parse(spec)), docs), str(o), str(e))
        outs[name] = (_rows(o), _rows(e))
    before = native.CALLS["bpe_count"]
    o, e = tmp_path / "run_kept.parquet", tmp_path / "run_excl.parquet"
    run_pipeline(parse_pipeline_config(spec), str(inp), str(o), str(e), device="cpu",
                 buckets=(512, 2048), device_batch=16, quiet=True)
    outs["run"] = (_rows(o), _rows(e))
    assert outs["port"] == outs["jax"] == outs["run"]
    kept, excluded = outs["run"]
    assert kept and excluded and len(kept) + len(excluded) == len(rows)
    assert all(json.loads(r["metadata"])["token_count"].isdigit() for r in kept)
    assert native.CALLS["bpe_count"] - before == sum(1 for r in kept if r["text"])
