#!/usr/bin/env python3
"""Time K10 (``qmoe_mlp_e2e``) pass by pass, as one or more checkouts build it.

    python3 scripts/k10_passes.py [--splits] CHECKOUT [CHECKOUT ...]

For each checkout in the order given (say ``build/parent . . build/parent``,
so that both versions meet the card's drift alike), a fresh process with that
checkout's package first on ``sys.path`` (``per_checkout.py``) builds its
kernels into its own ``build/`` and runs its ``qmoe_mlp_e2e`` on the K10
inputs of this checkout's ``chip_smoke.py`` (``k10_inputs``: Qwen3-30B-A3B's
stacks and routes from one seed, N = 1, 8 and 1024 tokens, the stacks
rotated through copies past the L2), the rt contract at every N and the ic one at N = 8.
Each case is timed by ``chip_smoke.timed`` and its device time split into the
gate|up pass, the down pass and the combine by kernel name; beside it the
byte bound. ``--splits`` also times other cluster splits than the plan's
(``qmoe.e2e_plan`` replaced). One JSON line per case on stdout, all of them
also in ``chiprun_out/k10_passes.jsonl``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import per_checkout

ROOT = Path(__file__).resolve().parents[1]
RT_ONLY_NS = (1, 1024)  # the ic contract is timed at N = 8 only
SPLITS = {1: ((1, 1), (2, 2), (3, 3), (4, 3), (6, 6)), 8: ((1, 1), (2, 2))}


def worker(splits: bool, bms: dict) -> None:
    import torch

    cs = per_checkout.chip_smoke()
    from gptqmodel_tpu_torch.ops import qmoe

    gu, dn, router, g = cs.moe_stacks(torch.device("cuda"), cs.SEED + 300)
    D, F = gu.in_features, gu.out_features // 2
    for c in cs.k10_inputs(gu, dn, router, g, lambda M: bms[str(M)]):
        N, x, ids, ops_, sets = c["N"], c["x"], c["ids"], c["ops"], c["sets"]
        b_ms, _ = cs.bound(c["n_bytes"], 2.0 * c["M"] * 3 * D * F)
        for rt in (True,) if N in RT_ONLY_NS else (True, False):
            kw = c["kw"](rt)
            run = lambda i, kw=kw: qmoe.qmoe_mlp_e2e(x, ids, *ops_, *sets[i], **kw)
            for forced in (None, *(SPLITS.get(N, ()) if splits else ())):
                plan = qmoe.e2e_plan
                if forced is not None:
                    qmoe.e2e_plan = lambda M_, E_, K, Nn, gs, sms=132, f=forced: (
                        dataclasses.replace(plan(M_, E_, K, Nn, gs, sms),
                                            split=f[0] if K == D else f[1]))
                try:
                    k = cs.timed(run, len(sets), floor_ms=b_ms)
                finally:
                    if forced is not None:
                        qmoe.e2e_plan = plan
                ms = cs.by_k10_pass(k["rows"])
                rec = {"checkout": str(Path.cwd()), "N": N, "M": c["M"], "bm": c["bm"],
                       "rt": rt, "distinct_experts": c["distinct"], "copies": len(sets),
                       "forced_splits": forced, "ms": k["ms"], "ms_by_pass": ms,
                       "bound_ms": b_ms, "kernels": k["kernels"]}
                if forced is None:
                    rec["plan_splits"] = [plan(c["M"], gu.qweight.shape[0], D, 2 * F, 128).split,
                                          plan(c["M"], gu.qweight.shape[0], F, D, 128).split]
                print(json.dumps(rec), flush=True)
        del c, sets


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--worker":
        per_checkout.worker_path()
        worker(splits=args[1] == "1", bms=json.loads(args[2]))
        return 0
    splits = "--splits" in args
    checkouts = [a for a in args if a != "--splits"]
    if not checkouts:
        print(__doc__, file=sys.stderr)
        return 2
    # rows a slot as this checkout's model picks them, for every checkout
    sys.path.insert(0, str(ROOT))
    from gptqmodel_tpu_torch.ops.qmoe import slot_rows
    from gptqmodel_tpu_torch.utils.testing import QWEN3_30B_A3B_CONFIG as C

    cs = per_checkout.chip_smoke()
    bms = {str(M): slot_rows(M)
           for M in (N * C["num_experts_per_tok"] for N in cs.MOE_E2E_NS)}
    return per_checkout.run(__file__, checkouts, ["1" if splits else "0", json.dumps(bms)],
                            "k10_passes.jsonl")


if __name__ == "__main__":
    sys.exit(main())
