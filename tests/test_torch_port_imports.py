"""The port's boundaries: no JAX anywhere in ``vct_tpu_torch``, only the
framework-free host modules of ``vct_tpu``, and a chip check that refuses
to run without a CUDA card instead of falling back to the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "vct_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax"}
ALLOWED_REFERENCE = {"vct_tpu.config", "vct_tpu.text.tokenizer",
                     "vct_tpu.data.collate", "vct_tpu.evalcap"}
OK_LINE = '"ok": true'


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_only_host_modules_of_the_reference(path):
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
        if name == "vct_tpu" or name.startswith("vct_tpu."):
            assert any(name == a or name.startswith(a + ".") for a in ALLOWED_REFERENCE), \
                f"{path}: imports {name}"


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even where one exists
    return env


def test_serving_path_loads_no_jax():
    code = ("import sys, vct_tpu_torch.serve, vct_tpu_torch.decode_fast, "
            "vct_tpu_torch.cli.common; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert OK_LINE not in proc.stdout and "cuda" in proc.stdout.lower()


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_clean_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and OK_LINE not in proc.stdout


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the build raises; nothing is faked."""
    from vct_tpu_torch.ops import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    _build.load_library.cache_clear()
