#!/usr/bin/env python3
"""Time K11 and K12 (the fused slot MoE MLP) pass by pass, and K13, as one or
more checkouts build them.

    python3 scripts/slot_mlp_cases.py CHECKOUT [CHECKOUT ...]

For each checkout in the order given (say ``build/parent . . build/parent``,
so that both versions meet the card's drift alike), a fresh process with that
checkout's package first on ``sys.path`` (``per_checkout.py``) builds its
kernels into its own ``build/`` and runs its ``qmoe_mlp_matmul_dyn`` (K11),
``qmoe_mlp_matmul`` (K12) and ``qmoe_matmul`` (K13, gate|up and down) on the
inputs of this checkout's ``chip_smoke.py`` (``moe_stacks`` and
``slot_inputs``: Qwen3-30B-A3B's stacks and routes from one seed, N = 8 and
128 tokens at 8 rows a slot, the stacks rotated through copies past the L2).
Each case is timed by ``chip_smoke.timed``, K11 and K12 held to their byte
bound, and their device time split into the gate|up pass and the down pass
by kernel name; beside it the bound and a SHA-256 of the output (equal across
checkouts is equal bits). One JSON line per case on stdout, all of them also
in ``chiprun_out/slot_mlp_cases.jsonl``.
"""

from __future__ import annotations

import hashlib
import json
import re
import sys
from pathlib import Path

import per_checkout


def pass_of(name: str) -> str:
    """The pass of K11 or K12 a kernel name belongs to: the decode ring's
    ``MoeSlotGateUp`` or ``MoeSlotDown``, or, in a checkout from before K11
    and K12 ran on the ring, ``qmoe_pass_kernel``'s epilogue (1: gate|up
    with silu, 0: the masked store of the down pass)."""
    if "MoeSlotGateUp" in name:
        return "gate_up"
    if "MoeSlotDown" in name:
        return "down"
    m = re.search(r"qmoe_pass_kernel<\s*\d+,\s*\d+,\s*\d+,\s*(\d)>", name)
    if m:
        return "gate_up" if m.group(1) == "1" else "down"
    return "other"


def digest(t) -> str:
    """SHA-256 of a tensor's values (bf16 widened exactly to float32)."""
    return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()


def worker() -> None:
    import torch

    cs = per_checkout.chip_smoke()
    from gptqmodel_tpu_torch.ops import qmoe

    torch.backends.cuda.matmul.allow_tf32 = False
    gu, dn, router, g = cs.moe_stacks(torch.device("cuda"), cs.SEED + 300)
    D, F = gu.in_features, gu.out_features // 2
    for N in cs.MOE_SLOT_NS:
        c = cs.slot_inputs(gu, dn, router, g, N)
        xs, ids, counts, n_used, sets, kw, M = (
            c[k] for k in ("xs", "ids", "counts", "n_used", "sets", "kw", "M"))
        k13 = dict(bits=4, bm=c["bm"], zero_const=8.0, out_dtype=torch.bfloat16)
        gu_out = qmoe.qmoe_matmul(xs, ids, counts, gu.qweight, gu.scales, G=gu.G, **k13)
        inner = (torch.nn.functional.silu(gu_out[:, :F].float())
                 * gu_out[:, F:].float()).to(torch.bfloat16)
        runs = {
            "K11": (lambda i: qmoe.qmoe_mlp_matmul_dyn(xs, ids, counts, n_used, *sets[i], **kw),
                    c["n_bytes"], 2.0 * M * 3 * D * F),
            "K12": (lambda i: qmoe.qmoe_mlp_matmul(xs, ids, counts, *sets[i], **kw),
                    c["n_bytes"], 2.0 * M * 3 * D * F),
            "K13 gate_up": (lambda i: qmoe.qmoe_matmul(xs, ids, counts, *sets[i][:2], G=gu.G,
                                                       **k13),
                            cs.moe_bytes(c["top_i"], (gu,), M * D, M * 2 * F),
                            2.0 * M * D * 2 * F),
            "K13 down": (lambda i: qmoe.qmoe_matmul(inner, ids, counts, *sets[i][2:], G=dn.G,
                                                    **k13),
                         cs.moe_bytes(c["top_i"], (dn,), M * F, M * D), 2.0 * M * F * D),
        }
        for name, (run, n_bytes, ops) in runs.items():
            b_ms, b_by = cs.bound(n_bytes, ops)
            y = run(0)
            torch.cuda.synchronize()
            k = cs.timed(run, len(sets), floor_ms=b_ms if name in ("K11", "K12") else 0.0)
            rec = {"checkout": str(Path.cwd()), "kernel": name, "N": N, "M": M, "bm": c["bm"],
                   "slots": c["S"], "distinct_experts": int(c["top_i"].unique().numel()),
                   "copies": len(sets), "ms": k["ms"], "bound_ms": b_ms, "bound_by": b_by,
                   "sha256": digest(y), "kernels": k["kernels"]}
            if name in ("K11", "K12"):
                rec["ms_by_pass"] = {}
                for kname, t in k["rows"]:
                    rec["ms_by_pass"][pass_of(kname)] = rec["ms_by_pass"].get(pass_of(kname),
                                                                              0.0) + t
            print(json.dumps(rec), flush=True)
        del c, sets, xs, inner, gu_out
    print(json.dumps({"checkout": str(Path.cwd()), "profiler": dict(cs.PROFILER_SHORT)}),
          flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--worker":
        per_checkout.worker_path()
        worker()
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    return per_checkout.run(__file__, args, [], "slot_mlp_cases.jsonl")


if __name__ == "__main__":
    sys.exit(main())
