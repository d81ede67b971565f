"""Build, bind and count the port's CUDA kernels.

At the first CUDA call, ``csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, and linked into
``build/libgptqmodel_tpu_torch.so`` at the root of the checkout (listed in
``.gitignore``). Each process builds in a directory of its own and swaps the
library in whole, so processes that share a checkout do not race. The
library has a plain C interface and is loaded with ``ctypes``: ``c_void_p``
for pointers and the stream, ``c_int`` and ``c_float`` for scalars.
Importing this module builds nothing, so the package imports on a machine
with no card and no ``nvcc``.

``LAUNCHES`` counts, for each kernel, the calls of its wrapper that launched
it: one per product or solve, however many CUDA launches it takes. Beside
the kernels, ``reference`` counts the quantized products that took the
dequantize-then-matmul route on a CUDA tensor (``ops/registry.py``), which
launches no kernel of the port.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
LIB_NAME = "libgptqmodel_tpu_torch.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fno-gnu-unique: two builds loaded in one process (scripts/decode_sweep.py)
# keep their own template statics
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique",
              "-Xptxas", "-v"]

LAUNCHES = {"qmatmul": 0, "qmatmul_asym": 0, "qmatmul_fused": 0, "qmm": 0,
            "qmatmul_planes": 0, "qmatmul_planes_asym": 0, "qmlp": 0,
            "gptq_whole_solve": 0, "gptq_block_inner": 0, "qmoe_e2e": 0, "qmoe_mlp_dyn": 0,
            "qmoe_mlp": 0, "qmoe_matmul": 0, "reference": 0}
# what the last build did: commands, seconds, and the ptxas lines per source
BUILD_INFO: dict = {}

_lib = None
_lock = threading.Lock()


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the port's kernels build on a CUDA machine")
    return exe


def build(lib_path: Path = BUILD_DIR / LIB_NAME, sources: tuple[str, ...] = (),
          defines: dict[str, int] | None = None) -> Path:
    """Compile every ``csrc/*.cu`` (or only ``sources``) in parallel with the
    ``-D`` macros ``defines``, link into ``lib_path``, and return it."""
    nvcc = _nvcc()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    flags = [*ARCH_FLAGS, *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in (defines or {}).items())]
    with tempfile.TemporaryDirectory(prefix="objs-", dir=lib_path.parent) as work:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            if sources and src.name not in sources:
                continue
            obj = Path(work) / (src.stem + ".o")
            cmd = [nvcc, *flags, f"-I{CSRC}", "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        outs = [p.communicate()[0] for *_, p in procs]  # every nvcc ends first
        ptxas, objs = {}, []
        for (src, obj, _, p), out in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
            ptxas[src.name] = [ln.strip() for ln in out.splitlines()
                               if "ptxas" in ln or "spill" in ln]
            objs.append(str(obj))
        tmp = Path(work) / LIB_NAME
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
    BUILD_INFO.clear()
    BUILD_INFO.update(
        compile=[" ".join(c) for _, _, c, _ in procs], link=" ".join(link),
        seconds=time.time() - t0, ptxas=ptxas,
    )
    return lib_path


def _current() -> Path | None:
    """The built library if it is newer than every file of ``csrc/``."""
    lib_path = BUILD_DIR / LIB_NAME
    if not lib_path.exists():
        return None
    built = lib_path.stat().st_mtime
    return lib_path if all(f.stat().st_mtime < built for f in CSRC.iterdir()) else None


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use unless current, bound once."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(_current() or build()))
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            handle.gqt_qmatmul.argtypes = [vp, i, i, vp, vp, i, i, f, i, i, vp, vp]
            handle.gqt_qmatmul.restype = i
            handle.gqt_qmatmul_asym.argtypes = [vp, i, i, vp, vp, vp, i, i, i, i, vp, vp]
            handle.gqt_qmatmul_asym.restype = i
            handle.gqt_qmatmul_fused.argtypes = [vp, i, i, vp, vp, i, i, f, i, i, vp, vp]
            handle.gqt_qmatmul_fused.restype = i
            handle.gqt_decode_smem_bytes.argtypes = [i, i, i]
            handle.gqt_decode_smem_bytes.restype = i
            handle.gqt_qmm.argtypes = [vp, i, i, vp, vp, vp, i, i, f, i, i, vp, vp]
            handle.gqt_qmm.restype = i
            handle.gqt_qmatmul_planes.argtypes = [vp, i, i, vp, vp, i, i, f, i, i, i, vp, vp]
            handle.gqt_qmatmul_planes.restype = i
            handle.gqt_qmatmul_planes_asym.argtypes = [vp, i, i, vp, vp, vp, i, i, i, i, i, vp,
                                                       vp]
            handle.gqt_qmatmul_planes_asym.restype = i
            handle.gqt_qmlp.argtypes = [vp, i, i, i, vp, vp, f, vp, vp, f] + [i] * 4 + [vp] * 3
            handle.gqt_qmlp.restype = i
            handle.gqt_gptq_whole_solve.argtypes = [vp] * 4 + [i] * 4 + [f, i] + [vp] * 6
            handle.gqt_gptq_whole_solve.restype = i
            handle.gqt_gptq_block_inner.argtypes = [vp] * 4 + [i, f] + [vp] * 5
            handle.gqt_gptq_block_inner.restype = i
            handle.gqt_qmoe_matmul.argtypes = ([vp] * 3 + [i] * 4 + [vp, vp, i, i, f]
                                               + [i] * 3 + [vp] * 2)
            handle.gqt_qmoe_matmul.restype = i
            handle.gqt_qmoe_mlp.argtypes = ([vp] * 4 + [i] * 4 + [vp, vp, i, vp, vp, i, i, f, f]
                                            + [i] * 4 + [vp] * 3)
            handle.gqt_qmoe_mlp.restype = i
            handle.gqt_qmoe_e2e.argtypes = ([vp] * 6 + [i] * 6 + [vp, vp, i, vp, vp, i, i, i]
                                            + [f, f] + [i] * 6 + [vp] * 4)
            handle.gqt_qmoe_e2e.restype = i
            handle.gqt_qmoe_smem_bytes.argtypes = [i, i]
            handle.gqt_qmoe_smem_bytes.restype = i
            _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point did not launch."""
    if rc == -1:
        raise ValueError(f"{name}: unsupported configuration")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
