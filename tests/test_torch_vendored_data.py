"""The port's own copies of the JAX package's vendored data, and the two
host steps that read them, against the JAX package with no network.

* ``textblaster_tpu_torch/data`` holds the stand-in ``gpt2`` tokenizer and
  the C4 bad-word lists for ``da`` and ``en``, byte for byte as the JAX
  package ships them.
* ``TokenCounter("gpt2")`` falls back to the vendored tokenizer in both
  packages and counts the same tokens; a ``merges.txt`` tokenizer counts
  with the port's native BPE core, as the JAX package's does.
* ``C4BadWordsFilter`` compiles the same pattern from the vendored lists in
  both packages, without trying a download.
* The port's ``run --device cpu`` with the shipped
  ``configs/pipeline_config.yaml`` equals the JAX package's
  ``run --backend host`` row for row.

The hub is made unreachable by a stand-in ``tokenizers`` module whose
``Tokenizer.from_pretrained`` raises, so no test here opens a connection.
"""

import filecmp
import json
import os
import sys
import types

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import tokenizers

from textblaster_tpu.cli import main as jax_main
from textblaster_tpu.filters import c4_badwords as jax_badwords
from textblaster_tpu.filters.token_counter import TokenCounter as JaxTokenCounter
from textblaster_tpu_torch.cli import main as torch_main
from textblaster_tpu_torch.errors import UnexpectedError
from textblaster_tpu_torch.filters import c4_badwords as torch_badwords
from textblaster_tpu_torch.filters.token_counter import TokenCounter as TorchTokenCounter

from test_torch_pipeline import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DATA = os.path.join(ROOT, "textblaster_tpu", "data")
TORCH_DATA = os.path.join(ROOT, "textblaster_tpu_torch", "data")
VENDORED = [
    os.path.join("tokenizers", "gpt2", "tokenizer.json"),
    os.path.join("tokenizers", "gpt2", "README.md"),
    os.path.join("c4_badwords", "da"),
    os.path.join("c4_badwords", "en"),
]

TEXTS = [
    "Det er en god dag, og vi skal ud at gå en tur i skoven.",
    "The quick brown fox jumps over the lazy dog near the river.",
    "Æbler, østers og ål — 12 stk. til 49,95 kr.!",
    "",
]


@pytest.fixture
def offline(monkeypatch):
    """A ``tokenizers`` module whose hub download fails at once, as it does
    on a machine with no network and no cache."""

    class Tokenizer:
        from_file = staticmethod(tokenizers.Tokenizer.from_file)

        @staticmethod
        def from_pretrained(name, *args, **kwargs):
            raise OSError(f"hub unreachable: {name}")

    stub = types.ModuleType("tokenizers")
    stub.Tokenizer = Tokenizer
    monkeypatch.setitem(sys.modules, "tokenizers", stub)


@pytest.mark.parametrize("rel", VENDORED)
def test_vendored_files_equal_the_jax_packages(rel):
    assert filecmp.cmp(os.path.join(JAX_DATA, rel), os.path.join(TORCH_DATA, rel), shallow=False)


def test_token_counter_counts_as_the_jax_package_offline(offline):
    from textblaster_tpu_torch.data_model import TextDocument as TorchDoc
    from textblaster_tpu.data_model import TextDocument as JaxDoc

    port, ref = TorchTokenCounter("gpt2"), JaxTokenCounter("gpt2")
    for i, text in enumerate(TEXTS):
        got = port.process(TorchDoc(id=str(i), source="s", content=text)).metadata
        want = ref.process(JaxDoc(id=str(i), source="s", content=text)).metadata
        assert got == want
        assert got["token_count_tokenizer"] == "vendored-standin"
    assert int(got["token_count"]) >= 0


def test_token_counter_merges_route_says_it_is_not_ported(offline, tmp_path):
    """The ``merges.txt`` route no longer raises: it counts on the port's
    native BPE core (``the`` is 1 token, `` then`` 3: ``Ġ``, ``the``,
    ``n``).  A merges file that does not decode, and a path that is no
    file, still fail with the loading error."""
    from textblaster_tpu_torch.data_model import TextDocument as TorchDoc

    merges = tmp_path / "merges.txt"
    merges.write_text("#version: 0.2\nt h\nth e\n", encoding="utf-8")
    doc = TorchTokenCounter(str(merges)).process(TorchDoc(id="1", source="s", content="the then"))
    assert doc.metadata["token_count"] == "4"
    bad = tmp_path / "bad" / "merges.txt"
    bad.parent.mkdir()
    bad.write_bytes(b"#version: 0.2\n\xff\xfe \xc3\n")
    for path in (bad, tmp_path / "missing" / "merges.txt"):
        with pytest.raises(UnexpectedError, match="Error in loading tokenizer"):
            TorchTokenCounter(str(path))


@pytest.mark.parametrize("lang", ["da", "en"])
def test_c4_badwords_compiles_the_vendored_list(lang, tmp_path, monkeypatch):
    """No cache directory in the working directory, and a download fails
    the test: the pattern comes from the vendored list."""
    monkeypatch.chdir(tmp_path)

    def no_download(self, *args):
        pytest.fail("the port tried to download a bad-word list")

    monkeypatch.setattr(torch_badwords.C4BadWordsFilter, "_download", no_download)
    monkeypatch.setattr(jax_badwords.C4BadWordsFilter, "_download", no_download)
    got = torch_badwords.C4BadWordsFilter(torch_badwords.C4BadWordsParams())._get_badwords(lang)
    want = jax_badwords.C4BadWordsFilter(jax_badwords.C4BadWordsParams())._get_badwords(lang)
    assert got is not None and got.pattern == want.pattern and got.flags == want.flags


DANISH_KEEPER = (
    "Det er en rigtig god dag i dag, og vi skal ud at gå en lang tur i den "
    "store grønne skov. Solen skinner over hele byen, og der er mange glade "
    "mennesker på gaden netop nu. Efter turen vil vi gerne drikke en stor kop "
    "varm kaffe og spise lidt friskbagt brød hjemme i køkkenet. Det bliver en "
    "rigtig dejlig eftermiddag, fordi vejret er så fint og mildt i dag. Om "
    "aftenen skal vi lave god mad sammen og se en lang film inde i stuen. "
    "Bagefter taler vi om planerne for den næste uge, og så går vi i seng."
)


def _rows(path):
    rows = pq.read_table(path).to_pylist()
    for r in rows:
        r["metadata"] = json.loads(r["metadata"])
    return rows


def test_shipped_config_run_equals_the_jax_host_run(offline, tmp_path):
    """``tests/test_default_config_e2e.py``'s two documents through the
    unmodified shipped config (TokenCounter included)."""
    inp = tmp_path / "in.parquet"
    pq.write_table(pa.table({"id": ["keep-1", "drop-1"], "text": [DANISH_KEEPER, "kort."]}), inp)
    config = os.path.join(ROOT, "configs", "pipeline_config.yaml")
    outs = {}
    for name, main, extra in (("port", torch_main, ["--device", "cpu"]),
                              ("jax", jax_main, ["--backend", "host"])):
        out, exc = tmp_path / f"{name}_out.parquet", tmp_path / f"{name}_exc.parquet"
        rc = main(["run", "-i", str(inp), "-c", config, "-o", str(out), "-e", str(exc),
                   "--quiet", *extra])
        assert rc == 0, name
        outs[name] = (_rows(out), _rows(exc))
    assert outs["port"] == outs["jax"]
    kept, dropped = outs["port"]
    assert [r["id"] for r in kept] == ["keep-1"] and [r["id"] for r in dropped] == ["drop-1"]
    assert int(kept[0]["metadata"]["token_count"]) > 50
