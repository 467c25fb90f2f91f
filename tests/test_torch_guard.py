"""The PyTorch port, chip_smoke.py and time_k1.py stand alone: they import
neither JAX, flax, PIL nor any module of the JAX package (which the card
machine lacks)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "multimodal_scene_text_recognition_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "time_k1.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL")
JAX_PACKAGE = "multimodal_scene_text_recognition_tpu"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN or top == JAX_PACKAGE


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_port_files_exist():
    assert (PORT / "api.py").exists() and (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 10


@pytest.mark.parametrize("name", ["parallel/mesh.py", "parallel/tensor.py", "parallel/dryrun.py",
                                  "utils/profiling.py", "utils/timing.py"])
def test_multi_device_and_timing_modules_are_guarded(name):
    assert PORT / name in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_flax_pil_or_jax_package_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module,bad", [
    ("jax.numpy", True), ("flax.linen", True), ("PIL", True),
    ("multimodal_scene_text_recognition_tpu.core.config", True),
    ("multimodal_scene_text_recognition_tpu_torch.ops", False), ("torch", False),
    ("numpy", False),
])
def test_guard_classifies_modules(module, bad):
    assert _forbidden(module) is bad


def _pandas_imports(path):
    """(line, enclosing function or None) of each import of pandas."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                else func
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                names = [child.module]
            if any(n.split(".")[0] == "pandas" for n in names):
                out.append((child.lineno, func))
            walk(child, inner)

    walk(tree, None)
    return out


def test_pandas_is_imported_only_inside_to_dataframe():
    """The card machine may lack pandas: the port imports it only inside the
    two functions that build tables, when they are called:
    ``EvalResult.to_dataframe`` and ``eval.attention.format_scores`` (as
    the JAX package's ``format_scores`` does)."""
    found = {str(p.relative_to(ROOT)): _pandas_imports(p) for p in FILES}
    found = {k: [f for _, f in v] for k, v in found.items() if v}
    assert found == {"multimodal_scene_text_recognition_tpu_torch/metrics.py": ["to_dataframe"],
                     "multimodal_scene_text_recognition_tpu_torch/eval/attention.py":
                         ["format_scores"]}
