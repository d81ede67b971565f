#!/usr/bin/env python3
"""Time K4 and K5 (``qmatmul_planes``, ``qmatmul_planes_asym``) at decode,
as one or more checkouts build them.

    python3 scripts/planes_cases.py CHECKOUT [CHECKOUT ...]

For each checkout in the order given (say ``build/parent . . build/parent``,
so that both versions meet the card's drift alike), a fresh process with that
checkout's package first on ``sys.path`` (``per_checkout.py``) builds its
kernels into its own ``build/`` and times its K4 and K5 on the inputs of
this checkout's ``chip_smoke.py`` (``planes_variants``, ``planes_inputs``:
group 128, symmetric and with random zeros per group and column, the
weights rotated through copies past the L2): 3-bit stitched at Llama-3-8B's
four projections and the planar 3, 5, 6 and 7-bit layouts at qkv, each at
M = 1, 8 and 16. Each case is timed by ``chip_smoke.timed`` (torch.profiler,
a reading under the byte bound timed again) and printed with its bound, its
multiple of it and the kernels the profiler saw. One JSON line per case on
stdout, all of them also in ``chiprun_out/planes_cases.jsonl``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import per_checkout

MS = (1, 8, 16)


def worker() -> None:
    import numpy as np
    import torch

    cs = per_checkout.chip_smoke()
    from gptqmodel_tpu_torch.ops import _build

    _build.build()
    dev = torch.device("cuda")
    shapes = cs.llama_shapes()
    rng = np.random.default_rng([cs.SEED, 501])
    for proj, bits, planar, sym, ms in cs.planes_variants(shapes, MS, MS):
        K, N = shapes[proj]
        c = cs.planes_inputs(dev, rng, K, N, bits, planar, sym)
        fn, kw, n = c["fn"], c["kw"], len(c["copies"])
        for M in ms:
            x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(
                dev).to(torch.bfloat16)
            b_ms, _ = cs.bound(x.nbytes + c["wbytes"] + 2 * M * N, 2.0 * M * N * K)
            k = cs.timed(lambda i: fn(*c["ops"](x, i), **kw), n, floor_ms=b_ms)
            rec = {"checkout": str(Path.cwd()), "kernel": c["route"], "proj": proj,
                   "bits": bits, "planar": planar, "M": M, "K": K, "N": N, "ms": k["ms"],
                   "bound_ms": b_ms, "x_bound": k["ms"] / b_ms, "copies": n,
                   "kernels": k["kernels"]}
            print(json.dumps(rec), flush=True)
        del c
        torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    if args == ["--worker"]:
        per_checkout.worker_path()
        worker()
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    return per_checkout.run(__file__, args, [], "planes_cases.jsonl")


if __name__ == "__main__":
    sys.exit(main())
