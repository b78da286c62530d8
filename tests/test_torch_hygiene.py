"""The port stands alone: ``repro_torch``, its examples
(``examples/torch_*.py``) and ``chip_smoke.py`` import no JAX and nothing
of the JAX package, and the port imports in a process
where ``jax`` cannot be imported at all."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)"
    r"|from\s+repro(\.|\s))", re.MULTILINE)

SOURCES = sorted(PORT.rglob("*.py")) + sorted(ROOT.glob("examples/torch_*.py")) \
    + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not bad, f"{path}: {bad}"



def test_sources_cover_the_lm_serving_slice():
    """The globs above reach every module of the LM-serving slice, its
    configs and its example."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("models/attention.py", "models/transformer.py",
                "models/layers.py", "serve/kv_cache.py", "serve/engine.py",
                "kernels/flash_attention.py", "kernels/decode_attention.py",
                "configs/base.py", "configs/archs.py",
                "configs/granite_3_8b.py", "configs/stablelm_3b.py",
                "interop.py"):
        assert f"src/repro_torch/{rel}" in names, rel
    assert "examples/torch_serve_lm.py" in names


def test_sources_cover_the_mamba_serving_slice():
    """The globs reach every module of the Mamba-2 serving slice: the
    mixer, the K12 wrapper, the dispatch, its config and the launcher."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("models/mamba.py", "kernels/mamba_ssd.py", "kernels/ops.py",
                "kernels/ref.py", "configs/mamba2_370m.py",
                "launch/serve.py", "launch/__init__.py"):
        assert f"src/repro_torch/{rel}" in names, rel


def test_sources_cover_the_schedule_pipeline_slice():
    """The globs reach the rest of the schedule pipeline, the data layer
    and the examples that drive them."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("pipeline/splice.py", "pipeline/persist.py",
                "pipeline/cache.py", "pipeline/composer.py",
                "pipeline/prefetch.py", "pipeline/pipeline.py",
                "pipeline/__init__.py", "data/loader.py",
                "data/synthetic.py", "data/trees.py", "data/__init__.py"):
        assert f"src/repro_torch/{rel}" in names, rel
    for ex in ("torch_treelstm_sentiment", "torch_quickstart",
               "torch_encoder_decoder"):
        assert f"examples/{ex}.py" in names, ex


def test_sources_cover_the_trainer_slice():
    """The globs reach the trainer, its metrics, the checkpoint manager,
    microbatching, the fault and compression primitives and the
    registry they write to."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("train/trainer.py", "train/metrics.py", "train/__init__.py",
                "checkpoint/manager.py", "checkpoint/__init__.py",
                "optim/accum.py", "optim/__init__.py", "dist/fault.py",
                "dist/compress.py", "obs/registry.py"):
        assert f"src/repro_torch/{rel}" in names, rel


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("")
                 .parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    """Without CUDA (or copied out of its checkout) the smoke run exits
    non-zero and prints no result line."""
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "",
                               "PATH": "/usr/bin:/bin"})
    assert here.returncode != 0
    assert '"ok"' not in here.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_sources_cover_the_lm_training_slice():
    """The globs reach every module of the LM-training slice: the loss, the
    K10 wrapper with its backward, the plain backward, the tree utilities,
    the launcher and the example."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("models/transformer.py", "kernels/flash_attention.py",
                "kernels/ref.py", "kernels/_build.py", "optim/adamw.py",
                "launch/train.py", "train/trainer.py", "interop.py"):
        assert f"src/repro_torch/{rel}" in names, rel
    assert "examples/torch_train_lm.py" in names
    assert (PORT / "kernels" / "csrc" / "flash_attention_bwd.cu").is_file()
