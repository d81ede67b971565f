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
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "qmatmul.cu", "qmatmul_planes.cu", "qmm.cu", "qmlp.cu", "gptq_solve.cu", "qmoe.cu"}
    assert _build.BUILD_DIR.name == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def _counter_bumps(path: Path) -> dict[str, list[str]]:
    """``_build.LAUNCHES["name"] += 1`` statements of a module, by the
    function they sit in."""
    bumps: dict[str, list[str]] = {}
    for fn in ast.walk(ast.parse(path.read_text())):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Subscript)
                    and ast.unparse(node.target.value) == "_build.LAUNCHES"):
                bumps.setdefault(ast.unparse(node.target.slice).strip("'\""), []).append(
                    fn.name)
    return bumps


def test_each_kernel_counts_its_launches_in_one_wrapper():
    """Every kernel's launch counter is raised in exactly one wrapper, right
    after its launch was checked: the MoE kernels of ``ops/qmoe.py`` (K10,
    K11, K12, K13) as the earlier ones."""
    from gptqmodel_tpu_torch.ops import _build

    bumps: dict[str, list[str]] = {}
    for path in sorted((ROOT / "gptqmodel_tpu_torch" / "ops").glob("*.py")):
        for key, fns in _counter_bumps(path).items():
            bumps.setdefault(key, []).extend(f"{path.name}:{f}" for f in fns)
    assert set(bumps) == set(_build.LAUNCHES)
    assert all(len(v) == 1 for v in bumps.values()), bumps
    assert {k: v[0] for k, v in bumps.items() if k.startswith("qmoe")} == {
        "qmoe_e2e": "qmoe.py:qmoe_mlp_e2e", "qmoe_mlp_dyn": "qmoe.py:qmoe_mlp_matmul_dyn",
        "qmoe_mlp": "qmoe.py:qmoe_mlp_matmul", "qmoe_matmul": "qmoe.py:qmoe_matmul"}
