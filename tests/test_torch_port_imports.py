"""The port's boundaries: no JAX and nothing of ``vct_tpu`` anywhere in
``vct_tpu_torch`` (it keeps its own copies of the framework-free host
modules, and a test holds each copy to its original), and a chip check that
refuses to run without a CUDA card instead of falling back to the CPU."""

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
ALLOWED_REFERENCE = set()  # the port imports nothing of the JAX package
# host modules the port copied from vct_tpu, by relative path
COPIED = ["config.py", "text/tokenizer.py", "data/collate.py", "data/datasets.py",
          "data/loader.py", "data/native.py", "train/earlystop.py", "evalcap/bleu.py",
          "evalcap/cider.py", "evalcap/meteor.py", "evalcap/meteor_data.py", "evalcap/ptb.py",
          "evalcap/rouge.py", "evalcap/scorer.py", "evalcap/stemmer.py", "clip/frames.py",
          "i3d/flow.py"]
# host definitions the port copied out of reference modules that import JAX:
# relative path -> the top-level names (functions, classes, constants) copied
COPIED_DEFINITIONS = {
    "clip/text.py": ["CONTEXT_LENGTH", "_bytes_to_unicode", "_get_pairs", "_PAT",
                     "_whitespace_clean", "CLIPBPETokenizer"],
    "clip/vision.py": ["IMAGE_SIZE", "CLIP_MEAN", "CLIP_STD", "preprocess_frames"],
    "i3d/model.py": ["FEATURE_DIM", "NUM_KINETICS_CLASSES", "STACK_SIZE", "STEP_SIZE",
                     "IMAGE_SIZE", "INCEPTION_CHANNELS", "resize_center_crop",
                     "scale_i3d_frames", "preprocess_i3d_frames", "i3d_stacks"],
    "i3d/convert.py": ["BN_EPS", "_STEM", "_BRANCHES", "load_i3d_state_dict"],
    "cli/extract.py": ["VIDEO_EXTS", "list_videos"],
    "cli/predict.py": ["_order_i3d_streams"],
}
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


def _stripped(path: Path) -> ast.Module:
    """The module's syntax tree with its docstrings blanked."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0].value.value = ""
    return tree


def _code_tree(path: Path, rename: bool) -> str:
    """The module's syntax tree without docstrings, with ``vct_tpu.`` imports
    renamed to ``vct_tpu_torch.`` when asked: what the code does, whatever its
    comments and docstrings say."""
    tree = _stripped(path)
    for node in ast.walk(tree):
        if rename and isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("vct_tpu."):
            node.module = "vct_tpu_torch." + node.module[len("vct_tpu."):]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_host_module_has_not_drifted(rel):
    """Each copy runs the same code as its original, import lines aside."""
    assert _code_tree(PORT / rel, rename=False) == _code_tree(REPO / "vct_tpu" / rel,
                                                              rename=True)


def _definitions(path: Path, names):
    """name -> the code of the top-level definition or assignment (annotated
    or not) of that name in ``path``, without docstrings."""
    out = {}
    for node in _stripped(path).body:
        targets = ([node.name] if isinstance(node, (ast.FunctionDef, ast.ClassDef)) else
                   [t.id for t in getattr(node, "targets", [getattr(node, "target", None)])
                    if isinstance(t, ast.Name)])
        for name in targets:
            if name in names:
                out[name] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel,name", [(rel, name) for rel, names in COPIED_DEFINITIONS.items()
                                      for name in names])
def test_copied_host_definition_has_not_drifted(rel, name):
    """Each copied definition runs the same code as its original."""
    got = _definitions(PORT / rel, {name})
    want = _definitions(REPO / "vct_tpu" / rel, {name})
    assert name in want and got == want


def test_serving_path_loads_no_jax():
    code = ("import sys, vct_tpu_torch.serve, vct_tpu_torch.decode_fast, "
            "vct_tpu_torch.cli.common, vct_tpu_torch.cli.train, vct_tpu_torch.cli.eval, "
            "vct_tpu_torch.train.loop, vct_tpu_torch.cli.predict, vct_tpu_torch.pipeline, "
            "vct_tpu_torch.clip, vct_tpu_torch.clip.convert, vct_tpu_torch.models.matching, "
            "vct_tpu_torch.i3d, vct_tpu_torch.cli.extract; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN | {'vct_tpu'})!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_layer_loads_no_jax():
    """``vct_tpu_torch.parallel`` and what drives it (the DDP step, the
    Trainer on a mesh, the training CLI that spawns ranks) load no JAX and
    nothing of ``vct_tpu``: every spawned rank imports them."""
    code = ("import sys, vct_tpu_torch.parallel, vct_tpu_torch.parallel.mesh, "
            "vct_tpu_torch.train.step, vct_tpu_torch.train.state, vct_tpu_torch.train.loop, "
            "vct_tpu_torch.cli.train, vct_tpu_torch.decode; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN | {'vct_tpu'})!r}]; print(bad); sys.exit(1 if bad else 0)")
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
