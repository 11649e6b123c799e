"""The port's boundary: no JAX, no JAX package, no silent CPU fallback.

* An AST walk over ``textblaster_tpu_torch/`` and ``chip_smoke.py`` finds no
  ``import jax`` and no import of ``textblaster_tpu``.
* A subprocess with ``sys.modules["jax"] = None`` imports the port and runs
  one tiny batch through ``CompiledPipeline(device="cpu")``.
* Without CUDA, an entry point called without ``device=`` raises.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "textblaster_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "textblaster_tpu")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_jax_package_imports():
    seen = 0
    for path in _sources():
        seen += 1
        bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
    assert seen > 20


def test_runs_a_batch_with_jax_blocked():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["textblaster_tpu"] = None
        from textblaster_tpu_torch.config.pipeline import load_pipeline_config
        from textblaster_tpu_torch.data_model import TextDocument
        from textblaster_tpu_torch.ops.pipeline import CompiledPipeline

        cfg = load_pipeline_config("configs/pipeline_config_offline.yaml")
        pipe = CompiledPipeline(cfg, buckets=(512,), batch_size=4, device="cpu")
        text = " ".join(["Det er en god dag og vi skal ud at gå tur i skoven."] * 8)
        docs = [TextDocument(id=str(i), source="s", content=text[: 100 + 40 * i])
                for i in range(3)]
        outs = list(pipe.process_chunk(docs))
        assert len(outs) == 3, outs
        assert set(pipe.counters["batches_by_bucket"]) == {512}, pipe.counters
        assert not any(m == "jax" or m.startswith("jax.") or m.startswith("textblaster_tpu.")
                       for m, v in sys.modules.items() if v is not None)
        print("OK", sorted(o.kind for o in outs))
        """
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK" in res.stdout


def test_entry_points_refuse_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from textblaster_tpu_torch.cli import main
    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.ops.pipeline import CompiledPipeline, resolve_device

    cfg = load_pipeline_config(os.path.join(ROOT, "configs/pipeline_config_offline.yaml"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledPipeline(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["run", "-i", "missing.parquet", "-c",
              os.path.join(ROOT, "configs/pipeline_config_offline.yaml")])
    assert resolve_device("cpu").type == "cpu"
