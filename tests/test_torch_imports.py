"""The port imports no JAX: a static scan of every module under
dualdiffusion_tpu_torch/ (and chip_smoke.py) for imports of ``jax``,
``flax`` or ``dualdiffusion_tpu``. A sys.modules check cannot tell here,
because the JAX package is imported by the test process itself."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dualdiffusion_tpu")
FILES = sorted((ROOT / "dualdiffusion_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom dualdiffusion_tpu.ops import fft\nimport jax.numpy as jnp\n")
    assert [m for m in imported_modules(f) if m.split(".")[0] in FORBIDDEN] == \
        ["dualdiffusion_tpu.ops", "jax.numpy"]
