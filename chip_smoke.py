#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gptqmodel_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines on stdout:

1. ``build``: nvcc compiles every kernel of ``gptqmodel_tpu_torch/csrc`` for
   sm_90a, one process per source, and the phase prints the commands and
   what ptxas says of each kernel (registers, shared memory, spills).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the shapes of Llama-3-8B's main paths: K1 (``qmatmul``) at the qkv, o,
   gate_up and down projections for M = 1, 8 and 1024, K2 (``qmlp``) at
   D = 4096, F = 14336 for M = 1, 8 and 64, with the weights rotated through
   copies that exceed the 50 MB L2; K8 (``gptq_whole_solve``) at the four
   solve groups (qkv 6144 x 4096, o 4096 x 4096, gate_up 28672 x 4096, down
   4096 x 14336; g = 128, symmetric, 4-bit; Hinv from ``hessian_inverse`` of
   a Hessian of seeded activations), run twice for identical codes, and K9
   (``gptq_block_inner``) on the first 128-column block of each. Each case
   prints the error, the device time of the kernel (torch.profiler), of the
   plain version (the profiler for K1 and K2; CUDA events around one call
   for the solves, whose plain versions launch thousands of small kernels)
   and of ``torch._weight_int4pack_mm`` (K1's yardstick, where torch has it),
   and the bound: the larger of bytes over 3.35 TB/s and operations over
   989 TFLOP/s (bf16, K1 and K2) or 67 TFLOP/s (float32, K8 and K9).
3. ``slice``: a GPTQ v1 checkpoint at Llama-3-8B's published widths (4-bit,
   symmetric, group 128, dense lm_head; random weights from a seed, about
   5.7 GB) is written to a temporary directory under ``build/``, then
   ``GPTQModel.load(dir).optimize().generate(ids, 64)`` runs at B = 8,
   T = 128, first with a bf16 KV cache, then with an int8 one. The launch
   counts are asserted: 4 K1 per layer in a prefill (qkv, o, gate_up, down),
   2 K1 and 1 K2 per layer in a decode step. Then prefill and decode are
   timed through the engine, and a few decode steps run under
   ``torch.profiler`` for the device's busy share.
4. ``compare``: the first 2 layers of that model at full width, the kernel
   path's logits against the plain versions' on the card, teacher-forced.
5. ``quantize``: a random bf16 checkpoint at Llama-3-8B's published widths
   and all 32 layers (16 GB) goes through ``GPTQModel.load(dir,
   QuantizeConfig(bits=4, group_size=128, sym=True))``, ``.quantize(ids)``
   on 128 seeded rows of 512 tokens at batch 4, and ``.save(out)``; then
   ``GPTQModel.load(out).optimize().generate(ids[:8, :128], 16)``. Asserted:
   exactly 4 K8 launches per layer, no RTN fallback, finite losses, and the
   K1/K2 counts of a prefill and 15 decode steps. Printed: seconds in all
   and per layer (forward, solve, pack), peak device memory, the losses'
   range and the saved bytes.
6. ``compare-quantize``: layer 0 of that checkpoint quantized again, once
   with K8 swapped for its plain version and once through K9
   (``GPTQ_TPU_SOLVER=pallas``): per module, codes within 2e-3 of the K8
   run and the loss within 1e-3.

Then the card's name and power limit, the ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device":
{...}}``. Each record of the kernels line names its units: ``launches``
counts a whole run of the main path (``launches_per``: K1 and K2 the
generate run, K8 the quantize run, K9 the one-layer quantize run through
``GPTQ_TPU_SOLVER=pallas``), and the times are per ``ms_per``: K1 and K2 one
decode step at B = 8 (K1 over qkv and o of every layer, K2 over every
layer's MLP), K8 and K9 one quantized layer (K8 one solve of each group, K9
each group's 128-column blocks). A failed check raises and exits non-zero. Without a CUDA device it
exits 1 and prints no result. The records also go to
``chiprun_out/chip_smoke/chip_smoke.json``. Float32 products run in full
float32: TF32 is off for matmuls and cuDNN.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
FP32_FLOPS = 67e12  # non-tensor float32 peak, H100 SXM
L2_BYTES = 50e6
B, T, NEW = 8, 128, 64
K1_MS = (1, 8, 1024)
K2_MS = (1, 8, 64)
# K1 and its plain version sum the same exact products in f32 and round once
# to bf16; K2 also rounds inner to bf16 in both. Only the f32 order differs.
K1_TOL, K2_TOL = 1e-3, 2e-3
# logits after 2 layers: one-ulp bf16 flips of the products, carried on
SLICE_TOL = 1e-2
# K8 against its plain version: the JAX package's tolerances for its K8
# against the XLA scan (only the trailing product's f32 sums may differ)
K8_MISMATCH, K8_DQ_RTOL, K8_DQ_ATOL, K8_SCALE_RTOL, K8_LOSS_RTOL = 2e-3, 1e-4, 2e-4, 1e-5, 1e-3
# the solve's groups at Llama-3-8B's widths: out x in, g = 128, 4-bit, sym
SOLVE_SHAPES = {"qkv": (6144, 4096), "o": (4096, 4096), "gate_up": (28672, 4096),
                "down": (4096, 14336)}
QUANT_LAYERS = 32  # the quantize phase's depth: all of Llama-3-8B's layers
Q_ROWS, Q_T, Q_BATCH = 128, 512, 4  # calibration: seeded token ids
GEN_B, GEN_T, GEN_NEW = 8, 128, 16  # the quantized model's generate


class CheckFailed(RuntimeError):
    pass


def require(ok, what) -> None:
    if not ok:
        raise CheckFailed(str(what))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(n_bytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def solve_bound(out_f: int, in_f: int, B: int = 128) -> tuple[float, str]:
    """K8: the float32 multiply-adds of the trailing update,
    out*B^2*nb*(nb-1), and of the in-block updates, out*nb*B*(B-1), at the
    non-tensor FP32 peak; bytes: W and Hinv read once, Q, Dq, L and the
    group tables written once."""
    nb = in_f // B
    ops = out_f * B * B * nb * (nb - 1) + out_f * nb * B * (B - 1)
    n_bytes = 4 * (out_f * in_f + in_f * in_f + 3 * out_f * in_f + 2 * out_f * in_f // B)
    return bound(n_bytes, ops, FP32_FLOPS)


def block_bound(out_f: int, B: int = 128) -> tuple[float, str]:
    """K9: Wb, S, Z and Hbb read once, Q, Dq, E, L written once; the
    in-block multiply-subtracts."""
    return bound(4 * (7 * out_f * B + B * B), out_f * B * (B - 1), FP32_FLOPS)


def ptxas_summary(lines_by_source: dict) -> dict:
    """``kernel<template args>`` -> registers, smem bytes and spill bytes."""
    out, fn = {}, None
    for lines in lines_by_source.values():
        for ln in lines:
            m = re.search(r"Compiling entry function '_ZN3gqt(\d+)(\w+)'", ln)
            if m:  # gqt::<name>, its length first, then I<args>E for a template
                name, rest = m.group(2)[:int(m.group(1))], m.group(2)[int(m.group(1)):]
                args = (re.findall(r"Li(\d+)E", rest.split("EEv")[0] + "E")
                        if rest.startswith("I") else [])
                fn = f"{name}<{','.join(args)}>" if args else name
                out[fn] = {}
                continue
            if fn is None:
                continue
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                m = re.search(pat, ln)
                if m:
                    out[fn][key] = int(m.group(1))
    return out


@contextlib.contextmanager
def plain_versions():
    """Send the model's quantized products through the kernels' plain
    versions, on the card, for the reference of ``compare``. The package
    has no such switch; this swaps the registry's names and restores them."""
    from gptqmodel_tpu_torch.ops import qmatmul as k1, qmlp as k2, registry

    registry.qmatmul, registry.qmlp = k1.qmatmul_plain, k2.qmlp_plain
    try:
        yield
    finally:
        registry.qmatmul, registry.qmlp = k1.qmatmul, k2.qmlp


@contextlib.contextmanager
def plain_solve():
    """Send the quantize loop's solves through K8's plain version, on the
    card, for the reference of ``compare-quantize``. The package has no such
    switch; this swaps the name ``gptq_solve_core`` calls and restores it."""
    from gptqmodel_tpu_torch.ops import gptq_solve
    from gptqmodel_tpu_torch.quantization import gptq

    gptq.gptq_whole_solve = gptq_solve.gptq_whole_solve_plain
    try:
        yield
    finally:
        gptq.gptq_whole_solve = gptq_solve.gptq_whole_solve


def layer_codes(params, layer: int) -> dict:
    """module -> its integer codes ``[in, out]`` on the card."""
    from gptqmodel_tpu_torch.ops.pack import unpack_qweight

    lp = params["model"]["layers"][layer]
    return {f"{k}.{m}": unpack_qweight(lp[k][m].qweight, lp[k][m].bits)
            for k in ("self_attn", "mlp") for m in lp[k] if not m.startswith("_")}


def quantize_phase(root: Path, layers: int, card: str) -> tuple[dict, dict]:
    """The user's whole flow at Llama-3-8B's published widths, ``layers``
    deep: write a random bf16 checkpoint, ``GPTQModel.load(dir,
    QuantizeConfig())``, ``.quantize(ids)``, ``.save(out)``, then
    ``GPTQModel.load(out).optimize().generate(ids, GEN_NEW)``. Returns the
    record and what ``compare_quantize_phase`` needs."""
    import torch

    from gptqmodel_tpu_torch import GPTQModel, QuantizeConfig
    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.utils.testing import LLAMA3_8B_CONFIG, write_random_fp_checkpoint

    cfg = dict(LLAMA3_8B_CONFIG, num_hidden_layers=layers)
    fp_dir, q_dir = root / "fp", root / "quantized"
    t0 = time.perf_counter()
    fp_bytes = write_random_fp_checkpoint(fp_dir, cfg, seed=SEED, device="cuda")
    write_s = time.perf_counter() - t0
    ids = np.random.default_rng([SEED, 3]).integers(0, cfg["vocab_size"], (Q_ROWS, Q_T))
    none = dict.fromkeys(_build.LAUNCHES, 0)

    torch.cuda.reset_peak_memory_stats()
    model = GPTQModel.load(fp_dir, QuantizeConfig(bits=4, group_size=128, sym=True))
    require(model.device.type == "cuda", f"model on {model.device}")
    _build.reset_counts()
    t0 = time.perf_counter()
    qlog = model.quantize(ids, batch_size=Q_BATCH)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(counts == none | {"gptq_whole_solve": 4 * layers},
            f"quantize launched {counts}, expected 4 K8 per layer")
    losses = [r["loss"] for r in qlog]
    require(len(qlog) == 7 * layers, f"{len(qlog)} quant_log rows")
    require(not any(r["fallback"] for r in qlog), "a module fell back to RTN")
    require(all(math.isfinite(x) for x in losses), "non-finite loss")
    codes0 = layer_codes(model.params, 0)
    losses0 = {r["module"]: r["loss"] for r in qlog if r["layer"] == 0}
    t0 = time.perf_counter()
    model.save(q_dir)
    save_s = time.perf_counter() - t0
    q_bytes = sum(f.stat().st_size for f in q_dir.glob("*.safetensors"))
    durations, per_layer = model.durations, model.layer_durations
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    served = GPTQModel.load(q_dir).optimize()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    _build.reset_counts()
    tokens = served.generate(ids[:GEN_B, :GEN_T], max_new_tokens=GEN_NEW)
    gen_counts = dict(_build.LAUNCHES)
    want = none | {"qmatmul": 4 * layers + (GEN_NEW - 1) * 2 * layers,
                   "qmlp": (GEN_NEW - 1) * layers}
    require(gen_counts == want, f"generate launched {gen_counts}, expected {want}")
    require(tokens.shape == (GEN_B, GEN_NEW), f"tokens of shape {tokens.shape}")
    require(((tokens >= 0) & (tokens < cfg["vocab_size"])).all(), "token out of the vocabulary")
    del served
    torch.cuda.empty_cache()
    rec = {
        "phase": "quantize", "gpu": card, "layers": layers, "calibration_rows": Q_ROWS,
        "calibration_tokens": Q_T, "batch_size": Q_BATCH, "fp_checkpoint_bytes": fp_bytes,
        "write_s": write_s, "quantize_s": quantize_s,
        "s_per_layer": quantize_s / layers, "durations_s": durations,
        "per_layer_s": per_layer, "peak_mem_bytes": peak, "quantize_counts": counts,
        "loss_min": min(losses), "loss_max": max(losses), "save_s": save_s,
        "saved_bytes": q_bytes, "load_s": load_s, "generate_counts": gen_counts,
        "tokens_first_row": tokens[0].tolist(),
    }
    return rec, {"fp_dir": fp_dir, "ids": ids, "codes0": codes0, "losses0": losses0}


def compare_quantize_phase(root: Path, state: dict, card: str) -> dict:
    """Layer 0 of the quantize phase's checkpoint again, once through K8's
    plain version and once through K9 (``GPTQ_TPU_SOLVER=pallas``), each
    against the K8 run: per module, codes within K8_MISMATCH and the loss
    within K8_LOSS_RTOL (the log rounds losses to 8 decimals)."""
    import torch

    from gptqmodel_tpu_torch import GPTQModel, QuantizeConfig
    from gptqmodel_tpu_torch.ops import _build

    one = root / "fp-layer0"
    one.mkdir()
    for f in state["fp_dir"].iterdir():  # the same shards, a config of one layer
        if f.name != "config.json":
            (one / f.name).symlink_to(f)
    cfg = json.loads((state["fp_dir"] / "config.json").read_text())
    (one / "config.json").write_text(json.dumps(dict(cfg, num_hidden_layers=1)))
    in_fs = [in_f for _, in_f in SOLVE_SHAPES.values()]
    none = dict.fromkeys(_build.LAUNCHES, 0)
    rec = {"phase": "compare-quantize", "gpu": card, "layers": 1}
    for name, solver, want in (
            ("plain", plain_solve, none),
            ("k9", lambda: mock.patch.dict(os.environ, {"GPTQ_TPU_SOLVER": "pallas"}),
             none | {"gptq_block_inner": sum(in_f // 128 for in_f in in_fs)})):
        model = GPTQModel.load(one, QuantizeConfig(bits=4, group_size=128, sym=True))
        _build.reset_counts()
        with solver():
            qlog = model.quantize(state["ids"], batch_size=Q_BATCH)
        counts = dict(_build.LAUNCHES)
        require(counts == want, f"{name} solve launched {counts}, expected {want}")
        codes = layer_codes(model.params, 0)
        mods = {}
        for r in qlog:
            m = r["module"]
            frac = float((codes[m] != state["codes0"][m]).float().mean())
            ref = state["losses0"][m]
            loss_err = abs(r["loss"] - ref) / ref
            mods[m] = {"mismatch": frac, "loss": r["loss"], "loss_k8": ref,
                       "loss_rel_err": loss_err}
            require(frac <= K8_MISMATCH, f"{name} {m}: code mismatch {frac} > {K8_MISMATCH}")
            require(abs(r["loss"] - ref) <= K8_LOSS_RTOL * ref + 1e-8,
                    f"{name} {m}: loss {r['loss']} against {ref}")
        rec[name] = {"counts": counts, "modules": mods, "seconds": model.durations}
        del model
        torch.cuda.empty_cache()
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gptqmodel_tpu_torch import GPTQModel
    from gptqmodel_tpu_torch.device import gpu_info
    from gptqmodel_tpu_torch.inference.engine import (
        init_kv_cache, make_decode_fn, make_prefill_fn,
    )
    from gptqmodel_tpu_torch.models.optimize import _concat_quant
    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.ops.pack import unpack_qweight
    from gptqmodel_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain
    from gptqmodel_tpu_torch.ops.qmlp import qmlp, qmlp_plain
    from gptqmodel_tpu_torch.ops.gptq_solve import (
        gptq_block_inner, gptq_block_inner_plain, gptq_whole_solve, gptq_whole_solve_plain,
    )
    from gptqmodel_tpu_torch.ops.registry import post_init_module
    from gptqmodel_tpu_torch.quantization.gptq import hessian_inverse
    from gptqmodel_tpu_torch.quantization.quantizer import _minmax, _params_from_range
    from gptqmodel_tpu_torch.utils.testing import (
        LLAMA3_8B_CONFIG, random_quant_linear, write_random_gptq_checkpoint,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_info()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    record = {"gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    # ---------------------------------------------------------------- build
    _build.build()  # always, so that the phase reports this run's nvcc
    _build.lib()
    info = _build.BUILD_INFO
    kernels_ptxas = ptxas_summary(info["ptxas"])
    require(kernels_ptxas, "ptxas reported no kernel")
    build_rec = {"phase": "build", "seconds": info["seconds"], "compile": info["compile"],
                 "link": info["link"], "ptxas": kernels_ptxas, "torch": torch.__version__,
                 "cuda": torch.version.cuda}
    emit(build_rec)
    record["build"] = build_rec

    # -------------------------------------------------------------- kernels
    def device_ms(run, per: int, activities=(ProfilerActivity.CUDA,)) -> tuple[float, list]:
        """Kernel time on the device per ``per`` calls made by ``run()``
        under torch.profiler, in all and by kernel name. Now and then CUPTI
        hands a session no kernel record (once in sixteen runs of this script
        on an H100): such a session is run again, up to three times in all, and
        never replaced by another clock."""
        for _ in range(3):
            with profile(activities=list(activities)) as prof:
                run()
                torch.cuda.synchronize()
            rows = [(e.key, e.self_device_time_total / 1e3 / per) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            if rows:
                rows.sort(key=lambda kv: -kv[1])
                return sum(ms for _, ms in rows), rows
        raise CheckFailed("torch.profiler recorded no kernel on the device in three sessions")

    def timed(fn, n_copies: int, budget_ms: float = 150.0) -> dict:
        """Device time per call (``ms``: torch.profiler, kernels only) and
        wall time per call (``wall_ms``: CUDA events around the loop, host
        launch gaps included)."""
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(1 % n_copies)
        torch.cuda.synchronize()
        est_ms = (time.perf_counter() - t0) * 1e3
        iters = max(3, min(100, int(budget_ms / max(est_ms, 1e-3))))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def loop():
            start.record()
            for i in range(iters):
                fn(i % n_copies)
            end.record()

        ms = device_ms(loop, iters)[0]
        return {"ms": ms, "wall_ms": start.elapsed_time(end) / iters}

    def errors(y, ref) -> tuple[float, float]:
        d = y.float() - ref.float()
        return float(d.norm() / ref.float().norm()), float(d.abs().max())

    has_int4pack = all(hasattr(torch, f) for f in
                       ("_weight_int4pack_mm", "_convert_weight_to_int4pack"))
    library = ("torch._weight_int4pack_mm on a torch._convert_weight_to_int4pack copy"
               if has_int4pack else "null: this torch has no _weight_int4pack_mm")

    def int4pack(qweight, scales, zc):
        """tinygemm's copy of 4-bit weights: w = (q - 8) * s + z."""
        codes = unpack_qweight(qweight, 4).t().contiguous()  # [N, K]
        w_u8 = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)
        s = scales.float()
        return (torch._convert_weight_to_int4pack(w_u8, 8),
                torch.stack([s, (8.0 - zc) * s], dim=2).to(torch.bfloat16))

    def copies_for(n_bytes: int) -> int:
        """Weight copies to rotate through so that a call finds its weights
        out of the L2: together at least three times its size."""
        return max(3, math.ceil(3 * L2_BYTES / n_bytes))

    rng = np.random.default_rng([SEED, 100])
    D, F = LLAMA3_8B_CONFIG["hidden_size"], LLAMA3_8B_CONFIG["intermediate_size"]
    hd = D // LLAMA3_8B_CONFIG["num_attention_heads"]
    qkv_n = (LLAMA3_8B_CONFIG["num_attention_heads"]
             + 2 * LLAMA3_8B_CONFIG["num_key_value_heads"]) * hd
    k1_shapes = {"qkv": (D, qkv_n), "o": (D, D), "gate_up": (D, 2 * F), "down": (F, D)}
    cases = []
    for proj, (K, N) in k1_shapes.items():
        base = post_init_module(random_quant_linear(rng, K, N, 4, device=dev))
        wbytes = base.qweight.nbytes + base.scales.nbytes
        mods = [base] + [dataclasses.replace(base, qweight=base.qweight.clone(),
                                             scales=base.scales.clone())
                         for _ in range(copies_for(wbytes) - 1)]
        zc = base.zero_const
        lib_w = [int4pack(m.qweight, m.scales, zc) for m in mods] if has_int4pack else None
        for M in K1_MS:
            x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(dev).to(
                torch.bfloat16)
            kw = dict(bits=4, group_size=128, zero_const=zc)
            before = _build.LAUNCHES["qmatmul"]
            y = qmatmul(x, mods[0].qweight, mods[0].scales, **kw)
            ref = qmatmul_plain(x, mods[0].qweight, mods[0].scales, **kw)
            torch.cuda.synchronize()
            require(_build.LAUNCHES["qmatmul"] == before + 1, "qmatmul did not launch")
            rel, mx = errors(y, ref)
            k = timed(lambda i: qmatmul(x, mods[i].qweight, mods[i].scales, **kw), len(mods))
            p = timed(lambda i: qmatmul_plain(x, mods[i].qweight, mods[i].scales, **kw),
                      len(mods), budget_ms=100.0)
            lib, lib_rel = None, None
            if has_int4pack:
                lib = timed(lambda i: torch._weight_int4pack_mm(x, lib_w[i][0], 128,
                                                                lib_w[i][1]), len(mods))
                lib_rel = errors(torch._weight_int4pack_mm(x, lib_w[0][0], 128, lib_w[0][1]),
                                 ref)[0]
            b_ms, b_by = bound(x.nbytes + wbytes + y.nbytes, 2.0 * M * N * K)
            case = {"kernel": "qmatmul", "proj": proj, "M": M, "K": K, "N": N,
                    "rel_err": rel, "max_abs_err": mx, "ms": k["ms"], "wall_ms": k["wall_ms"],
                    "plain_ms": p["ms"], "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib["ms"] if lib else None, "library": library,
                    "library_rel_err": lib_rel, "plain_wall_ms": p["wall_ms"],
                    "library_wall_ms": lib["wall_ms"] if lib else None,
                    "weight_copies": len(mods)}
            cases.append(case)
            emit({"phase": "kernels", **case})
            require(rel <= K1_TOL, f"K1 {proj} M={M}: rel {rel} > {K1_TOL}")
        del base, mods, lib_w

    gate, up = (post_init_module(random_quant_linear(rng, D, F, 4, device=dev))
                for _ in range(2))
    down = post_init_module(random_quant_linear(rng, F, D, 4, device=dev))
    gu = _concat_quant([gate, up])
    del gate, up
    weights = (gu.qweight, gu.scales, down.qweight, down.scales)
    wbytes = sum(t.nbytes for t in weights)
    sets = [weights] + [tuple(t.clone() for t in weights)
                        for _ in range(copies_for(wbytes) - 1)]
    kw = dict(bits=4, group_size=128, zc_gu=gu.zero_const, zc_d=down.zero_const)
    for M in K2_MS:
        x = torch.from_numpy(rng.standard_normal((M, D), dtype=np.float32)).to(dev).to(
            torch.bfloat16)
        before = _build.LAUNCHES["qmlp"]
        y = qmlp(x, *sets[0], **kw)
        ref = qmlp_plain(x, *sets[0], **kw)
        torch.cuda.synchronize()
        require(_build.LAUNCHES["qmlp"] == before + 1, "qmlp did not launch")
        rel, mx = errors(y, ref)
        k = timed(lambda i: qmlp(x, *sets[i], **kw), len(sets))
        p = timed(lambda i: qmlp_plain(x, *sets[i], **kw), len(sets), budget_ms=100.0)
        b_ms, b_by = bound(x.nbytes + wbytes + y.nbytes, 6.0 * M * D * F)
        case = {"kernel": "qmlp", "proj": "mlp", "M": M, "D": D, "F": F, "rel_err": rel,
                "max_abs_err": mx, "ms": k["ms"], "wall_ms": k["wall_ms"], "plain_ms": p["ms"],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library": "null: no PyTorch call computes the fused quantized MLP",
                "plain_wall_ms": p["wall_ms"],
                "weight_copies": len(sets)}
        cases.append(case)
        emit({"phase": "kernels", **case})
        require(rel <= K2_TOL, f"K2 M={M}: rel {rel} > {K2_TOL}")
    del sets, weights, gu, down

    def event_ms(fn):
        """One call's time on the card's clock (CUDA events) and its result:
        the plain solves launch thousands of small kernels, so their time is
        taken whole rather than under the profiler."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    kw = dict(maxq=15, group_size=128, sym=True)
    for proj, (out_f, in_f) in SOLVE_SHAPES.items():
        g = np.random.default_rng([SEED, 200, out_f, in_f])
        W = torch.from_numpy(g.standard_normal((out_f, in_f), dtype=np.float32) * 0.02).to(dev)
        X = torch.from_numpy(g.standard_normal((2048, in_f), dtype=np.float32)).to(dev)
        U, damp = hessian_inverse((2.0 / 2048) * (X.T @ X), 0.01)
        del X
        before = _build.LAUNCHES["gptq_whole_solve"]
        Q, Dq, L, s_k, _ = gptq_whole_solve(W, U, **kw)
        identical = torch.equal(Q, gptq_whole_solve(W, U, **kw)[0])
        plain_ms, (rQ, rDq, rL, rs, _) = event_ms(lambda: gptq_whole_solve_plain(W, U, **kw))
        require(_build.LAUNCHES["gptq_whole_solve"] == before + 2, "K8 did not launch")
        mismatch = float((Q != rQ).float().mean())
        scale_err = float(((s_k - rs).abs() / rs.abs()).max())
        loss_err = abs(float(L.sum() / rL.sum()) - 1)
        dq_ok = bool(torch.allclose(Dq, rDq, rtol=K8_DQ_RTOL, atol=K8_DQ_ATOL))
        max_err = float((Dq - rDq).abs().max())
        del Q, Dq, L, s_k, rQ, rDq, rL, rs
        k = timed(lambda i: gptq_whole_solve(W, U, **kw), 1, budget_ms=300.0)
        b_ms, b_by = solve_bound(out_f, in_f)
        case = {"kernel": "gptq_whole_solve", "proj": proj, "out": out_f, "in": in_f,
                "group_size": 128, "bits": 4, "damp": damp, "code_mismatch": mismatch,
                "identical_runs": identical, "scale_rel_err": scale_err,
                "loss_rel_err": loss_err, "max_abs_err": max_err, "ms": k["ms"],
                "wall_ms": k["wall_ms"], "plain_ms": plain_ms, "plain_clock": "cuda events",
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library": "null: no PyTorch call computes a GPTQ solve"}
        cases.append(case)
        emit({"phase": "kernels", **case})
        require(identical, f"K8 {proj}: two runs gave different codes")
        require(mismatch < K8_MISMATCH, f"K8 {proj}: code mismatch {mismatch}")
        require(dq_ok, f"K8 {proj}: Dq off by {max_err}")
        require(scale_err <= K8_SCALE_RTOL, f"K8 {proj}: scales off by {scale_err}")
        require(loss_err <= K8_LOSS_RTOL, f"K8 {proj}: loss off by {loss_err}")

        # K9 on the first block of the same group, scales from its minmax
        Wb, Hbb = W[:, :128].contiguous(), U[:128, :128].contiguous()
        s_col, z_col = (t[:, None].expand(out_f, 128).contiguous()
                        for t in _params_from_range(*_minmax(Wb, True), 15, True))
        del W, U
        blk = [(Wb, Hbb, s_col, z_col)]
        blk += [tuple(t.clone() for t in blk[0])
                for _ in range(copies_for(sum(t.nbytes for t in blk[0])) - 1)]
        before = _build.LAUNCHES["gptq_block_inner"]
        got = gptq_block_inner(*blk[0], maxq=15)
        plain_ms, ref = event_ms(lambda: gptq_block_inner_plain(*blk[0], maxq=15))
        require(_build.LAUNCHES["gptq_block_inner"] == before + 1, "K9 did not launch")
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        max_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        k = timed(lambda i: gptq_block_inner(*blk[i], maxq=15), len(blk))
        b_ms, b_by = block_bound(out_f)
        case = {"kernel": "gptq_block_inner", "proj": proj, "out": out_f, "in": 128,
                "blocks_per_layer": in_f // 128, "equal": equal, "max_abs_err": max_err, "ms": k["ms"], "wall_ms": k["wall_ms"],
                "plain_ms": plain_ms, "plain_clock": "cuda events", "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None,
                "library": "null: no PyTorch call computes the GPTQ column loop",
                "input_copies": len(blk)}
        cases.append(case)
        emit({"phase": "kernels", **case})
        require(equal, f"K9 {proj}: differs from its plain version by {max_err}")
        del blk, got, ref
    record["kernels"] = cases
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- slice
    L = LLAMA3_8B_CONFIG["num_hidden_layers"]
    none = dict.fromkeys(_build.LAUNCHES, 0)
    prefill_counts = none | {"qmatmul": 4 * L}  # qkv, o, gate_up, down per layer
    step_counts = none | {"qmatmul": 2 * L, "qmlp": L}  # qkv, o per layer; the MLP is K2
    ids = np.random.default_rng([SEED, 1]).integers(0, LLAMA3_8B_CONFIG["vocab_size"], (B, T))
    slice_recs = []
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="llama3-8b-gptq-", dir=ROOT / "build") as ckpt:
        t0 = time.perf_counter()
        n_bytes = write_random_gptq_checkpoint(ckpt, LLAMA3_8B_CONFIG, seed=SEED)
        write_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = GPTQModel.load(ckpt)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.optimize()
        torch.cuda.synchronize()
        optimize_s = time.perf_counter() - t0
    require(model.device.type == "cuda", f"model on {model.device}")
    spec, params = model.spec, model.params
    layers = params["model"]["layers"]
    require(len(layers) == L and all(lp["mlp"].get("_fused") and "qkv_proj" in lp["self_attn"]
                                     for lp in layers), "optimize() left a layer unfused")
    weights_mem = torch.cuda.memory_allocated()

    for kv in ("bf16", "int8"):
        kv_quant = kv == "int8"
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        tokens = model.generate(ids, max_new_tokens=NEW, kv_quant=kv_quant)
        generate_s = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        require(tokens.shape == (B, NEW), f"tokens of shape {tokens.shape}")
        require(((tokens >= 0) & (tokens < spec.vocab_size)).all(), "token out of the vocabulary")
        want = {k: prefill_counts[k] + (NEW - 1) * step_counts[k] for k in step_counts}
        require(counts == want, f"generate launched {counts}, expected {want}")

        # the same path through the engine, timed: prefill, then decode steps
        caches = init_kv_cache(spec, B, T + NEW, torch.bfloat16, kv_quant, device=dev)
        prefill, decode = make_prefill_fn(spec), make_decode_fn(spec)
        ids_t = torch.as_tensor(ids, device=dev)
        lens = torch.full((B,), T, dtype=torch.long, device=dev)
        with torch.inference_mode():
            torch.cuda.synchronize()
            _build.reset_counts()
            t0 = time.perf_counter()
            logits, caches, key_valid = prefill(params, ids_t, lens, caches)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            require(dict(_build.LAUNCHES) == prefill_counts, f"prefill {_build.LAUNCHES}")
            require(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
            token, pos = logits.argmax(-1), lens.clone()
            warm, steps, n_prof = 2, 40, 4
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            finite = []
            for s in range(warm + steps):
                if s == warm:
                    torch.cuda.synchronize()
                    _build.reset_counts()
                    t0 = time.perf_counter()
                    start.record()
                logits, caches, key_valid = decode(params, token, pos, T + s, key_valid, caches)
                finite.append(torch.isfinite(logits).all())
                token, pos = logits.argmax(-1), pos + 1
            end.record()
            end.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / steps
            decode_ms = start.elapsed_time(end) / steps
            require(dict(_build.LAUNCHES) == {k: v * steps for k, v in step_counts.items()},
                    f"decode {_build.LAUNCHES}")
            require(bool(torch.stack(finite).all()), "non-finite decode logits")
            slot = T + warm + steps  # at most T + 54 < T + NEW with three sessions

            def profiled_steps():
                nonlocal token, pos, key_valid, slot
                for _ in range(n_prof):
                    out, _, key_valid = decode(params, token, pos, slot, key_valid, caches)
                    token, pos, slot = out.argmax(-1), pos + 1, slot + 1

            step_dev_ms, by_kernel = device_ms(
                profiled_steps, n_prof, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
        rec = {
            "phase": "slice", "gpu": card, "kv": kv, "layers": L, "B": B, "T": T,
            "new_tokens": NEW, "checkpoint_bytes": n_bytes, "write_s": write_s,
            "load_s": load_s, "optimize_s": optimize_s, "weights_mem_bytes": weights_mem,
            "generate_s": generate_s, "generate_counts": counts, "peak_mem_bytes": peak,
            "prefill_ms": prefill_ms, "prefill_counts": prefill_counts,
            "decode_ms_per_step": decode_ms, "decode_host_ms_per_step": host_ms,
            "decode_tok_per_s": B / (decode_ms / 1e3), "decode_counts_per_step": step_counts,
            # device kernel time per step under the profiler, over the step
            # timed without it
            "device_ms_per_step": step_dev_ms,
            "device_busy_share": step_dev_ms / decode_ms,
            "device_ms_per_step_by_kernel": [[k[:90], ms] for k, ms in by_kernel[:12]],
        }
        emit(rec)
        slice_recs.append(rec)
        del caches, logits
    record["slice"] = slice_recs

    # -------------------------------------------------------------- compare
    spec2 = dataclasses.replace(spec, num_layers=2)
    params2 = {**params, "model": {**params["model"], "layers": layers[:2]}}
    ids_t = torch.as_tensor(ids, device=dev)
    lens = torch.full((B,), T, dtype=torch.long, device=dev)

    def run(steps: int, forced=None):
        caches = init_kv_cache(spec2, B, T + steps, torch.bfloat16, False, device=dev)
        with torch.inference_mode():
            logits, caches, kv = make_prefill_fn(spec2)(params2, ids_t, lens, caches)
            dec = make_decode_fn(spec2)
            outs, toks, pos = [logits.float()], [logits.argmax(-1)], lens.clone()
            for s in range(steps):
                tok = toks[-1] if forced is None else forced[s]
                logits, caches, kv = dec(params2, tok, pos, T + s, kv, caches)
                outs.append(logits.float())
                toks.append(logits.argmax(-1))
                pos = pos + 1
        return torch.stack(outs), toks

    _build.reset_counts()
    got, got_toks = run(8)
    kernel_counts = dict(_build.LAUNCHES)
    with plain_versions():
        ref, ref_toks = run(8, forced=got_toks)
    require(dict(_build.LAUNCHES) == kernel_counts, "the plain path launched a kernel")
    require(kernel_counts["qmatmul"] > 0 and kernel_counts["qmlp"] > 0, kernel_counts)
    rel = float((got - ref).norm() / ref.norm())
    agree = float(torch.stack([a == b for a, b in zip(got_toks, ref_toks)]).float().mean())
    cmp_rec = {"phase": "compare", "gpu": card, "layers": 2, "positions": 9, "kv": "bf16",
               "logits_rel_err": rel, "logits_tol": SLICE_TOL, "greedy_agreement": agree}
    emit(cmp_rec)
    record["compare"] = cmp_rec
    require(bool(torch.isfinite(got).all()), "non-finite logits at 2 layers")
    require(rel <= SLICE_TOL, f"kernel path vs plain path: rel {rel} > {SLICE_TOL}")
    del model, params, layers, params2, got, ref
    torch.cuda.empty_cache()

    # ------------------------------------------- quantize, compare-quantize
    with tempfile.TemporaryDirectory(prefix="llama3-8b-fp-", dir=ROOT / "build") as work:
        q_rec, state = quantize_phase(Path(work), QUANT_LAYERS, card)
        emit(q_rec)
        record["quantize"] = q_rec
        cq_rec = compare_quantize_phase(Path(work), state, card)
        emit(cq_rec)
        record["compare_quantize"] = cq_rec

    # -------------------------------------------------------------- summary
    main_counts = slice_recs[0]["generate_counts"]  # the bf16-KV generate

    def per_step(kernel: str, parts: list[tuple[str, int]]) -> dict:
        sel = [(c, n) for c in cases for proj, n in parts
               if c["kernel"] == kernel and c["M"] == B and c["proj"] == proj]
        total = lambda key: sum(c[key] * n for c, n in sel)
        return {"ms": total("ms"), "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"),
                "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c, _ in sel)
                else "operations",
                "library_ms": (None if any(c["library_ms"] is None for c, _ in sel)
                               else total("library_ms"))}

    def per_layer(kernel: str) -> dict:
        """One quantized layer's work: every case once, or each K9 block as
        often as its group has blocks."""
        sel = [c for c in cases if c["kernel"] == kernel]
        total = lambda key: sum(c[key] * c.get("blocks_per_layer", 1) for c in sel)
        return {"max_abs_err": max(c["max_abs_err"] for c in sel), "ms": total("ms"),
                "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                "bound_by": ("bytes" if all(c["bound_by"] == "bytes" for c in sel)
                             else "operations"), "library_ms": None}

    summary = [
        {"name": "qmatmul (K1)", "route": "cuda",
         "source": "gptqmodel_tpu_torch/csrc/qmatmul.cu",
         "replaces": "gptqmodel_tpu/ops/pallas_qmatmul.py:198",
         "launches": main_counts["qmatmul"], "launches_per": "generate run",
         "ms_per": "decode step",
         "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == "qmatmul"),
         **per_step("qmatmul", [("qkv", L), ("o", L)])},
        {"name": "qmlp (K2)", "route": "cuda",
         "source": "gptqmodel_tpu_torch/csrc/qmlp.cu",
         "replaces": "gptqmodel_tpu/ops/pallas_qmlp.py:84",
         "launches": main_counts["qmlp"], "launches_per": "generate run",
         "ms_per": "decode step",
         "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == "qmlp"),
         **per_step("qmlp", [("mlp", L)])},
        {"name": "gptq_whole_solve (K8)", "route": "cuda",
         "source": "gptqmodel_tpu_torch/csrc/gptq_solve.cu",
         "replaces": "gptqmodel_tpu/ops/pallas_gptq.py:160",
         "launches": q_rec["quantize_counts"]["gptq_whole_solve"],
         "launches_per": f"quantize run of {q_rec['layers']} layers",
         "ms_per": "quantized layer", **per_layer("gptq_whole_solve")},
        {"name": "gptq_block_inner (K9)", "route": "cuda",
         "source": "gptqmodel_tpu_torch/csrc/gptq_solve.cu",
         "replaces": "gptqmodel_tpu/ops/pallas_gptq.py:47",
         "launches": cq_rec["k9"]["counts"]["gptq_block_inner"],
         "launches_per": f"quantize run of {cq_rec['layers']} layer",
         "ms_per": "quantized layer", **per_layer("gptq_block_inner")},
    ]
    record["summary"] = summary
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1) + "\n")
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
