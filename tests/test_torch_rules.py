"""Rules of the port that no behaviour test would catch."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gptqmodel_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    """Every module of the port (the quantization path's too) and the smoke
    script."""
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "gptqmodel_tpu")}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_kernel_sources_target_hopper():
    from gptqmodel_tpu_torch.ops import _build

    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {"qmatmul.cu", "qmlp.cu",
                                                           "gptq_solve.cu"}
    assert _build.BUILD_DIR.name == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
