#!/usr/bin/env python3
"""Time K8 and K9 (``gptq_whole_solve``, ``gptq_block_inner``) as one or more
checkouts build them, and hash their outputs so that two builds can be held
bit for bit.

    python3 scripts/solve_cases.py CHECKOUT [CHECKOUT ...]
    python3 scripts/solve_cases.py --quantize CHECKOUT [CHECKOUT ...]

For each checkout in the order given (say ``build/parent . . build/parent``,
so that both versions meet the card's drift alike), a fresh process with that
checkout's package first on ``sys.path`` (``per_checkout.py``) builds its
kernels into its own ``build/`` and runs them on the inputs of this
checkout's ``chip_smoke.py`` (``solve_inputs``: Llama-3-8B's four solve
groups, 4-bit, group 128, symmetric). Per group it prints K8's device time
(``chip_smoke.timed``, a reading under the bound timed again), its bound and
its multiple of it, K9's time a 128-column block (its inputs rotated past
the L2) and the blocks a layer, and a SHA-256 over K8's Q, Dq, L, scales
and zeros and over K9's Q, Dq, E and L (``chip_smoke.digest``): equal
digests across checkouts are equal outputs. A last line per checkout gives
the profiler's short sessions (``chip_smoke.device_ms``).

With ``--quantize`` each checkout runs ``chip_smoke.quantize_phase`` instead
(16 layers at Llama-3-8B's widths: write, quantize, save, load, generate)
and prints its seconds and the SHA-256 of the saved tensors and of each
module's codes (``chip_smoke.checkpoint_digests``).

One JSON line per case on stdout, all of them also in
``chiprun_out/solve_cases.jsonl``.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import per_checkout


def kernels(cs) -> None:
    import torch

    from gptqmodel_tpu_torch.ops.gptq_solve import gptq_block_inner, gptq_whole_solve

    dev = torch.device("cuda")
    for proj in cs.SOLVE_SHAPES:
        c = cs.solve_inputs(dev, proj)
        W, U, kw, out_f, in_f, blk = c["W"], c["U"], c["kw"], c["out"], c["in"], c["block"]
        k8_sha = cs.digest(*gptq_whole_solve(W, U, **kw))
        b8, _ = cs.solve_bound(out_f, in_f)
        k8 = cs.timed(lambda i: gptq_whole_solve(W, U, **kw), 1, budget_ms=300.0, floor_ms=b8)
        k9_sha = cs.digest(*gptq_block_inner(*blk[0], maxq=15))
        b9, _ = cs.block_bound(out_f)
        k9 = cs.timed(lambda i: gptq_block_inner(*blk[i], maxq=15), len(blk), floor_ms=b9)
        rec = {"checkout": str(Path.cwd()), "proj": proj, "out": out_f, "in": in_f,
               "k8_ms": k8["ms"], "k8_bound_ms": b8, "k8_x_bound": k8["ms"] / b8,
               "k8_kernels": k8["kernels"], "k9_ms_per_block": k9["ms"],
               "k9_bound_ms": b9, "k9_blocks": in_f // 128,
               "k9_ms_per_solve": k9["ms"] * (in_f // 128), "k9_kernels": k9["kernels"],
               "k8_sha256": k8_sha, "k9_sha256": k9_sha}
        print(json.dumps(rec), flush=True)
        del W, U, c, blk
        torch.cuda.empty_cache()
    print(json.dumps({"checkout": str(Path.cwd()), "phase": "profiler",
                      "short_sessions": cs.PROFILER_SHORT["sessions"],
                      "read_from_kept_records": cs.PROFILER_SHORT["estimated"],
                      "under_bound": cs.PROFILER_SHORT["under_bound"]}), flush=True)


def quantize(cs) -> None:
    from gptqmodel_tpu_torch.device import gpu_info

    with tempfile.TemporaryDirectory(prefix="solve-cases-", dir=Path.cwd() / "build") as work:
        rec, _ = cs.quantize_phase(Path(work), cs.QUANT_LAYERS, gpu_info())
    keep = ("layers", "quantize_s", "s_per_layer", "durations_s", "quantize_counts",
            "loss_min", "loss_max", "saved_bytes", "checkpoint_sha256",
            "module_codes_sha256", "tokens_first_row")
    print(json.dumps({"checkout": str(Path.cwd()), "phase": "quantize",
                      **{k: rec[k] for k in keep}}), flush=True)


def worker(mode: str) -> None:
    cs = per_checkout.chip_smoke()
    from gptqmodel_tpu_torch.ops import _build

    _build.build()
    (quantize if mode == "--quantize" else kernels)(cs)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--worker"]:
        per_checkout.worker_path()
        worker(args[1] if len(args) > 1 else "")
        return 0
    mode = [a for a in args if a == "--quantize"]
    checkouts = [a for a in args if a != "--quantize"]
    if not checkouts:
        print(__doc__, file=sys.stderr)
        return 2
    return per_checkout.run(__file__, checkouts, mode, "solve_cases.jsonl")


if __name__ == "__main__":
    sys.exit(main())
