#!/usr/bin/env python3
"""SASS instructions per weight code in the main loop of the dequant-matmul
kernels at decode, as each checkout compiles them.

    python3 scripts/sass_per_code.py CHECKOUT [CHECKOUT ...]

Builds each checkout's kernels (``ops/_build.py``, into its own ``build/``),
reads ``cuobjdump -sass`` of the library (``chip_smoke.sass_functions``),
and for each kernel of ``KERNELS`` that the build holds takes its main loop:
the backward branch whose range holds the most ``HMMA`` instructions (the
narrowest of those). It counts the instructions in that range (a static
count: the body of one iteration, with the rarely taken branches inside it,
such as a group's end, and one pass of the barrier's wait loop) and divides
by the weight codes one lane turns into mma operands in an iteration, times
the iterations the compiler unrolled into the body (its ``HMMA`` count over
one iteration's). Prints one JSON object per checkout, the counts by opcode
too; the objects also go to ``chiprun_out/sass_per_code.jsonl``, and each
loop's instructions to ``chiprun_out/sass_loops/<checkout>/<kernel>.sass``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import sass_functions, sass_main_loop  # noqa: E402
from compare_builds import BUILD  # noqa: E402

# kernel -> (codes a lane takes an iteration, HMMA an iteration). The decode
# ring (qmm_decode.cuh, one n-tile): an iteration is a 128-row chunk; a lane
# owns 4 columns and 16 of their rows (K4, K5: half of its unit; K1: two
# 8-code words), 8 weight mma and 4 of x's all-ones mma. The register tile
# that ran K4 and K5 at M <= 16 before the decode ring (qmatmul_planes.cu,
# Tile<1, 1>, in older checkouts): an iteration is a 128-row chunk; a lane
# owns one column's 32-row unit, 8 mma.
KERNELS = {
    "qmm_decode_kernel<3,1,Units,0,UniformZero,0>": (64, 12),
    "qmm_decode_kernel<3,1,Units,1,UniformZero,0>": (64, 12),
    "qmm_decode_kernel<5,1,Units,1,UniformZero,0>": (64, 12),
    "qmm_decode_kernel<7,1,Units,1,UniformZero,0>": (64, 12),
    "qmm_decode_kernel<3,1,Units,0,PlaneZeros,3,0,0>": (64, 12),
    "qmm_decode_kernel<7,1,Units,1,PlaneZeros,7,1,0>": (64, 12),
    "qmm_decode_kernel<4,1,UniformZero,0>": (64, 12),
    "planes_kernel<3,0,1,1,UniformZero>": (32, 8),
    "planes_kernel<3,0,1,1,PlaneZeros,3,0>": (32, 8),
    "planes_kernel<3,1,1,1,UniformZero>": (32, 8),
    "planes_kernel<5,1,1,1,UniformZero>": (32, 8),
    "planes_kernel<7,1,1,1,UniformZero>": (32, 8),
}


def loops(lib: str) -> dict:
    """kernel of ``KERNELS`` that ``lib`` holds -> its main loop
    (``chip_smoke.sass_main_loop``) with the codes of an iteration, the
    iterations unrolled into it and its instructions per code."""
    fns = sass_functions(lib)
    out = {}
    for name, (codes, hmma_iter) in KERNELS.items():
        if name not in fns:
            continue
        loop = sass_main_loop(fns[name])
        unroll = loop["hmma"] / hmma_iter if loop else 0
        out[name] = {**loop, "codes_per_iteration": codes, "unrolled": unroll,
                     "per_code": loop["instructions"] / (codes * unroll) if unroll else None}
    return out


def per_code(checkout: Path) -> dict:
    res = subprocess.run([sys.executable, "-c", BUILD], cwd=checkout, capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"build of {checkout} failed:\n{res.stdout}{res.stderr}")
    out = {"checkout": str(checkout),
           "kernels": loops(res.stdout.strip().splitlines()[-1])}
    for name, loop in out["kernels"].items():
        if "sass" in loop:
            dest = ROOT / "chiprun_out" / "sass_loops" / checkout.name
            dest.mkdir(parents=True, exist_ok=True)
            (dest / f"{name}.sass").write_text("\n".join(loop.pop("sass")) + "\n")
    return out


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    with open(dest / "sass_per_code.jsonl", "a") as f:
        for checkout in sys.argv[1:]:
            rec = per_code(Path(checkout).resolve())
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
