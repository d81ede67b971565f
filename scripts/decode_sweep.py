#!/usr/bin/env python3
"""Time the decode kernel of K3 and K7 (``csrc/qmm_decode.cuh``) against its
design choices, on one NVIDIA GPU, at Llama-3-8B's four projections (4-bit,
group 128, weights rotated past the L2 as ``chip_smoke.py`` does):

- the warps of a block: consumer warps per 32-column half (K shares) and
  producer warps, each pair a build of ``csrc/qmatmul.cu`` with
  ``-DGQT_DECODE_KPARTS`` and ``-DGQT_DECODE_PRODUCERS``;
- the cluster size (split of K) around the launch plan's;
- at M = 1024, K3's 32 x 32 prefill tile with and without its
  ``__launch_bounds__(128, 3)`` (``-DGQT_K3_WIDE_BOUND=0``), in turns (with,
  without, without, with).

    python3 scripts/decode_sweep.py [--ms 1,8,16]

Prints one JSON line per case (device ms by torch.profiler, the byte bound,
the error against the plain version, whether two runs give equal bits),
then the card's name and power limit; the lines also go to
``chiprun_out/decode_sweep.jsonl``. Builds into ``build/decode_sweep/``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
          "down": (14336, 4096)}
# (K shares per column half, producer warps); the sources' own pair is first
WARPS = [(2, 2), (2, 1), (4, 2)]


def bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gqt_qmatmul_asym.argtypes = [vp, i, i, vp, vp, vp, i, i, i, i, vp, vp]
    lib.gqt_qmatmul_asym.restype = i
    lib.gqt_qmatmul_fused.argtypes = [vp, i, i, vp, vp, i, i, f, i, i, vp, vp]
    lib.gqt_qmatmul_fused.restype = i
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.ops.qmatmul import (
        DECODE_MAX_SPLIT, decode_plan, qmatmul_asym_plain, qmatmul_fused_plain,
    )
    from gptqmodel_tpu_torch.ops.registry import post_init_module
    from gptqmodel_tpu_torch.utils.testing import random_quant_linear

    ap = argparse.ArgumentParser()
    ap.add_argument("--ms", default="1,8,16")
    args = ap.parse_args()
    out_dir = ROOT / "build" / "decode_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    log_path = ROOT / "chiprun_out" / "decode_sweep.jsonl"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    log = log_path.open("w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        log.write(line + "\n")

    jobs = {f"kp{kp}_prod{prod}": {"GQT_DECODE_KPARTS": kp, "GQT_DECODE_PRODUCERS": prod}
            for kp, prod in WARPS}  # variant -> -D macros
    jobs["prefill_unbounded"] = {"GQT_K3_WIDE_BOUND": 0}

    def build(name):
        so = _build.build(out_dir / f"lib_{name}.so", ("qmatmul.cu",), jobs[name])
        return name, bind(so)

    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(ex.map(build, jobs))

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng([0, 700])
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def asym(lib, x, m, split):
        M, K = x.shape
        N = m.qweight.shape[1]
        out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        rc = lib.gqt_qmatmul_asym(x.data_ptr(), M, K, m.qweight.data_ptr(), m.scales.data_ptr(),
                                  m.qzeros.data_ptr(), N, 128, 4, split, out.data_ptr(), stream())
        if rc != 0:
            raise RuntimeError(f"K3 launch returned {rc}")
        return out

    def fused(lib, x, m, split):
        M, K = x.shape
        N = m.qweight.shape[1]
        out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        rc = lib.gqt_qmatmul_fused(x.data_ptr(), M, K, m.qweight.data_ptr(), m.scales.data_ptr(),
                                   N, 128, float(m.zero_const), 4, split, out.data_ptr(),
                                   stream())
        if rc != 0:
            raise RuntimeError(f"K7 launch returned {rc}")
        return out

    ms_list = [int(v) for v in args.ms.split(",")]
    for proj, (K, N) in SHAPES.items():
        a = post_init_module(random_quant_linear(rng, K, N, 4, device=dev, sym=False))
        s = post_init_module(random_quant_linear(rng, K, N, 4, device=dev))
        wbytes = a.qweight.nbytes + a.scales.nbytes + a.qzeros.nbytes
        n = cs.copies_for(wbytes)
        A = [a] + [dataclasses.replace(a, qweight=a.qweight.clone(), scales=a.scales.clone(),
                                       qzeros=a.qzeros.clone()) for _ in range(n - 1)]
        S = [s] + [dataclasses.replace(s, qweight=s.qweight.clone(), scales=s.scales.clone())
                   for _ in range(n - 1)]
        G, tiles = K // 128, -(-N // 64)
        for M in ms_list:
            x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(dev).to(
                torch.bfloat16)
            ref = qmatmul_asym_plain(x, a.qweight, a.scales, a.qzeros, bits=4, group_size=128)
            ref7 = qmatmul_fused_plain(x, s.qweight, s.scales, bits=4, group_size=128,
                                       zero_const=s.zero_const)
            b_ms = cs.bound(x.nbytes + wbytes + 2 * M * N, 2.0 * M * N * K)[0]
            plan = decode_plan(M, K, N, 128, sms).split
            splits = sorted({plan} | {max(1, min(DECODE_MAX_SPLIT, G, -(-f * sms // tiles)))
                                      for f in (2, 3, 6)})
            for name in [f"kp{kp}_prod{prod}" for kp, prod in WARPS]:
                lib = libs[name]
                for split in splits:
                    y = asym(lib, x, a, split)
                    y7 = fused(lib, x, s, split)
                    torch.cuda.synchronize()
                    same = bool(torch.equal(y, asym(lib, x, a, split)))
                    k3 = cs.timed(lambda i: asym(lib, x, A[i], split), n)["ms"]
                    k7 = cs.timed(lambda i: fused(lib, x, S[i], split), n)["ms"]
                    emit({"proj": proj, "M": M, "warps": name, "split": split,
                          "plan_split": plan, "k3_ms": k3, "k7_ms": k7, "bound_ms": b_ms,
                          "k3_x_bound": k3 / b_ms, "k3_rel_err": cs.errors(y, ref)[0],
                          "k7_rel_err": cs.errors(y7, ref7)[0], "identical_runs": same})
        x = torch.from_numpy(rng.standard_normal((1024, K), dtype=np.float32)).to(dev).to(
            torch.bfloat16)
        runs = {}
        for name in ("kp2_prod2", "prefill_unbounded", "prefill_unbounded", "kp2_prod2"):
            runs.setdefault(name, []).append(
                cs.timed(lambda i: asym(libs[name], x, A[i], 0), n)["ms"])
        equal = bool(torch.equal(asym(libs["kp2_prod2"], x, a, 0),
                                 asym(libs["prefill_unbounded"], x, a, 0)))
        emit({"proj": proj, "M": 1024, "k3_bounded_ms": runs["kp2_prod2"],
              "k3_unbounded_ms": runs["prefill_unbounded"], "equal_outputs": equal,
              "bound_ms": cs.bound(x.nbytes + wbytes + 2 * 1024 * N, 2.0 * 1024 * N * K)[0]})
        del A, S
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit({"card": card.strip()})
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
