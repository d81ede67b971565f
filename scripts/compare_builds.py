#!/usr/bin/env python3
"""Compare the port's kernels as two checkouts compile them: the registers,
stack, shared and local memory of every kernel, read with ``cuobjdump
-res-usage`` from each checkout's ``build/libgptqmodel_tpu_torch.so``.

    python3 scripts/compare_builds.py OTHER_CHECKOUT

Builds both checkouts at once, each into its own ``build/``, then prints one
JSON object: how many kernels have equal usage, and the kernels whose usage
changed (other, this) or that only one build has, named ``kernel<template
arguments>`` as ``chip_smoke.py``'s build record names them; the object also
goes to ``chiprun_out/compare_builds.json``. ptxas's own lines carry compile
times, so they differ between any two builds; cuobjdump's lines do not.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import readable  # noqa: E402

BUILD = ("import sys; sys.path.insert(0, '.'); "
         "from gptqmodel_tpu_torch.ops import _build; print(_build.build())")


def usage(checkout: Path) -> dict:
    """Build ``checkout``'s kernels and read each kernel's resource usage."""
    res = subprocess.run([sys.executable, "-c", BUILD], cwd=checkout, capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"build of {checkout} failed:\n{res.stdout}{res.stderr}")
    lib = res.stdout.strip().splitlines()[-1]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                         check=True).stdout
    found, fn = {}, None
    for line in (ln.strip() for ln in out.splitlines()):
        if line.startswith("Function "):
            fn = readable(line[len("Function "):].rstrip(":"))
        elif fn and line.startswith("REG:"):
            found.setdefault(fn, set()).add(line)  # a kernel in two sources: one line each
            fn = None
    return {k: sorted(v) for k, v in found.items()}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    with ThreadPoolExecutor(2) as ex:
        other, this = ex.map(usage, (Path(sys.argv[1]).resolve(), ROOT))
    result = {"equal": sum(1 for k in other if this.get(k) == other[k]),
              "changed": {k: [other[k], this[k]] for k in other
                          if k in this and this[k] != other[k]},
              "only_other": {k: other[k] for k in other if k not in this},
              "only_this": {k: this[k] for k in this if k not in other}}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "compare_builds.json").write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
