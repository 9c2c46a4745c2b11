"""The port stands alone: no module of ``pytorch_distributedtraining_tpu_torch``
and not ``chip_smoke.py`` imports JAX, flax, optax or the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pytorch_distributedtraining_tpu"}
FILES = sorted((ROOT / "pytorch_distributedtraining_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_jax(path):
    assert path.exists()
    assert not _imported_roots(path) & FORBIDDEN


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "pytorch_distributedtraining_tpu_torch/stoke/facade.py" in names
    assert "pytorch_distributedtraining_tpu_torch/ops/window_attn.py" in names
    assert "pytorch_distributedtraining_tpu_torch/ops/flash_attn.py" in names
    assert "pytorch_distributedtraining_tpu_torch/models/gpt2.py" in names
    for module in ("runtime/dist.py", "runtime/mesh.py", "parallel/spec.py",
                   "parallel/policy.py", "parallel/remat.py", "parallel/state.py",
                   "parallel/step.py", "observe/profiling.py", "observe/capture.py",
                   "observe/opcost.py", "observe/comms.py"):
        assert f"pytorch_distributedtraining_tpu_torch/{module}" in names
    assert _imported_roots(ROOT / "tests" / "test_torch_stoke.py") & FORBIDDEN
