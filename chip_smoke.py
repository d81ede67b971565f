#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gptqmodel_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines on stdout:

1. ``build``: nvcc compiles every kernel of ``gptqmodel_tpu_torch/csrc`` for
   sm_90a, one process per source, and the phase prints the commands and
   what ptxas says of each kernel (registers, static shared memory, spills),
   the dynamic shared memory of the decode kernel (``qmm_decode.cuh``: K1,
   K3, K4, K5, K6, K7 and both passes of K2 at M <= 16) by bits and M (K4's
   and K5's rings at 3, 5, 6 and 7 bits), and its instantiations and K10's
   ring by bm (``gqt_qmoe_smem_bytes``); it fails if K1's, K2's, K4's,
   K5's or K6's old 16-row tile is still built, if K4's, K5's (every
   layout, one and two n-tiles, both zero types), K6's, K10's or K11's,
   K12's and K13's (``MoeSlotGateUp``, ``MoeSlotDown``) decode
   instantiations are missing, if any ``qmoe_pass_kernel`` (K11-K13's
   kernel before they ran on the ring) is still built, or if the main loop
   of K4's 3-bit stitched decode kernel (``cuobjdump -sass``) spends more
   than ``K4_LOOP_LOP3`` LOP3 a 128-row chunk (one a code pair, and 8).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the shapes of Llama-3-8B's main paths: K1 (``qmatmul``) at the qkv, o,
   gate_up and down projections for M = 1, 8, 16 (its decode kernel) and
   1024, twice each for equal bits, K3 (``qmatmul_asym``,
   random zeros per group and column) at the same projections for M = 1, 8,
   16 (its decode kernel) and 1024 at 4 bits, with K1 timed beside it on its
   weights, and at qkv, M = 8 at 2 and 8 bits, twice each for equal bits, K2
   (``qmlp``) at D = 4096, F = 14336 for M = 1, 8, 16 (both passes on the
   decode kernel) and 64, twice each for equal bits, with the weights
   rotated through copies that exceed the 50 MB L2; K8 (``gptq_whole_solve``) at the four
   solve groups (qkv 6144 x 4096, o 4096 x 4096, gate_up 28672 x 4096, down
   4096 x 14336; g = 128, symmetric, 4-bit; Hinv from ``hessian_inverse`` of
   a Hessian of seeded activations; ``solve_inputs``), run twice for
   identical codes, and K9 (``gptq_block_inner``) on the first 128-column
   block of each, each with a SHA-256 of its outputs (``digest``: equal
   across two builds is equal bits). Each case
   prints the error, the device time of the kernel (torch.profiler), of the
   plain version (the profiler for K1 and K2; CUDA events around one call
   for the solves, whose plain versions launch thousands of small kernels)
   and of ``torch._weight_int4pack_mm`` (K1's and 4-bit K3's yardstick, K3's
   zeros folded into its scales-and-zeros, where torch has it),
   and the bound: the larger of bytes over 3.35 TB/s and operations over
   989 TFLOP/s (bf16, K1 and K2) or 67 TFLOP/s (float32, K8 and K9). Then
   the MoE kernels at Qwen3-30B-A3B's widths (D 2048, F 768, 128 experts,
   top-8, g 128, 4-bit, symmetric), routed by seeded router logits: K10
   (``qmoe_mlp_e2e``) at N = 1, 8 and 1024 tokens in the rt contract (the
   stacks') and the ic one, twice each for equal bits, its device time also
   by pass (gate|up, down, combine: the profiler's kernel names, which must
   be the decode kernel's ``MoeGateUp`` and ``MoeDown`` and the combine)
   and held to its byte bound,
   K11 and K12 (``qmoe_mlp_matmul_dyn``, ``qmoe_mlp_matmul``) at N = 8 and
   128, equal to each other and each to a second run of itself, their
   kernel names the decode kernel's (``MoeSlotGateUp``, ``MoeSlotDown``),
   and K13 (``qmoe_matmul``) on gate|up and down at N = 8 and 128, its
   kernel names the decode kernel's ``MoeSlotDown`` alone, and on K12's own
   inner equal to K12's output bit for bit (f32 and bf16); their
   bound counts the distinct routed experts' words and scales, once each,
   and the routed rows' operations. Then K6
   (``qmm``, groups of 32 and 64, and 16 with random zeros) at the same four
   projections for M = 1, 8, 16 (the decode kernel's ``DequantFirst``
   instantiation, asserted from the profiler's kernel names) and 256, 4-bit,
   symmetric and with random zeros per group and column, and at qkv, M = 8
   at 2 and 8 bits, twice each for equal bits, with
   ``torch._weight_int4pack_mm`` at the same group size as the yardstick
   where it takes that group (32 and 64; its bound counts the zeros only
   where they are read), and the reference
   route (dequantize, then ``torch.matmul``) at M = 1024, timed for the
   record; K7 (``qmatmul_fused``) at K3's projections and sizes, with K1
   and ``torch._weight_int4pack_mm`` timed beside it; and K4
   (``qmatmul_planes``, one zero point) and K5 (``qmatmul_planes_asym``,
   random zeros per group and column) at 3 bits, stitched, at the same four
   projections for M = 1, 8, 16 (the decode kernel's ``Units``
   instantiation, asserted from the profiler's kernel names) and 1024, and
   3, 5, 6 and 7-bit planar at qkv, M = 8, twice each for equal bits (no
   PyTorch call takes such weights, so no library time), with the
   reference route at M = 1024 timed for the record.
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
5. ``fused``: that model again under ``GPTQ_TPU_RT_FUSED=1``:
   ``generate(ids, 16)`` at all 32 layers with 4 K7 per layer in the prefill
   and 2 K7 and 1 K2 per layer in each decode step asserted (no K1), the
   served path timed as in ``slice``, and the 2-layer compare within 1e-2.
6. ``asym-act-slice``: the same widths, all 32 layers, written with
   ``sym=False, desc_act=True`` (random zeros per group and column, one
   act-order permutation per layer input), through ``GPTQModel.load(dir)
   .optimize().generate(ids, 64)`` at B = 8, T = 128, bf16 KV: post-init
   permutes each module's rows into group order on the card, q/k/v and
   gate/up fuse with their shared permutation, and every projection runs
   K3 after one x-column gather. Asserted: 4 K3 per layer in the prefill and
   in every decode step, no K1 or K2, no synchronizing call in a step.
   Printed: load s and peak memory, prefill ms, decode ms per step, device
   ms per step by kernel (the gathers' share too) and the busy share.
7. ``compare-act``: the kernel path against the plain path over 2 layers,
   as ``compare``, for that checkpoint (K3) and for a 2-layer one written
   with ``sym=True, desc_act=True`` (K1 after the gather, no K3): logits
   within 1e-2.
8. ``g32-slice``: the same widths, all 32 layers, written at group 32
   (4-bit, symmetric, drawn on the card, about 6.1 GB), through
   ``GPTQModel.load(dir).optimize().generate(ids, 64)`` at B = 8, T = 128,
   bf16 KV. Asserted: the prefill's 1024 rows on the counted reference
   route (4 per layer, no K6), 4 K6 per layer in every decode step, no K1,
   K2 or K3, no synchronizing call in a step. Printed as ``asym-act-slice``.
9. ``compare-g32``: its first 2 layers, and those of a 2-layer checkpoint at
   group 64 with ``sym=False``, kernel path against plain path over a
   prefill and 8 decode steps of B = 8 rows (where K6 runs; asserted):
   logits within 1e-2. The same over all 32 layers of the first is
   recorded, its launch counts asserted and its logits not held to a limit.
10. ``planes-slice``: the same widths, all 32 layers, written as a 3-bit GPTQ
   v1 checkpoint (symmetric, group 128, stitched words, drawn on the card,
   about 4.8 GB), through ``GPTQModel.load(dir).optimize().generate(ids,
   64)`` at B = 8, T = 128, bf16 KV. Asserted: 4 K4 per layer in the
   prefill and in every decode step, no other kernel and no reference
   product, no synchronizing call in a step. Printed as ``planes-slice``.
11. ``compare-planes``: its first 2 layers, and 2-layer checkpoints at 3 bits
   with ``sym=False, desc_act=True`` (K5 after the gather), at 5 bits
   gptq_p symmetric (K4 on planar words) and at 7 bits gptq_p with
   ``sym=False`` (K5 over three planes), kernel path against plain path as
   ``compare``: logits within 1e-2. Each of the three also generates 8
   tokens through ``generate``, its launches counted and asserted.
12. ``quantize``: a random bf16 checkpoint at Llama-3-8B's published widths
   and 16 of its 32 layers (8 GB) goes through ``GPTQModel.load(dir,
   QuantizeConfig(bits=4, group_size=128, sym=True))``, ``.quantize(ids)``
   on 128 seeded rows of 512 tokens at batch 4, and ``.save(out)``; then
   ``GPTQModel.load(out).optimize().generate(ids[:8, :128], 16)``. Asserted:
   exactly 4 K8 launches per layer, no RTN fallback, finite losses, and the
   K1/K2 counts of a prefill and 15 decode steps. Printed: seconds in all
   and per layer (forward, solve, pack), peak device memory, the losses'
   range, the saved bytes, a SHA-256 over the saved tensors and one over
   each module's codes (``checkpoint_digests``: two builds' runs compared).
13. ``compare-quantize``: layer 0 of that checkpoint quantized again, once
   with K8 swapped for its plain version and once through K9
   (``GPTQ_TPU_SOLVER=pallas``): per module, codes within 2e-3 of the K8
   run and the loss within 1e-3.
14. ``quantize-act``: its first 2 layers through ``QuantizeConfig(sym=False,
   desc_act=True)`` on K8, ``save``; ``GPTQModel.load`` of the result saved
   again must give the same bytes; then ``optimize().generate(ids, 8)`` on
   K3 alone.
15. ``quantize-g32``: the same through ``QuantizeConfig(group_size=32)``:
   4 K8 per layer, the re-save byte-equal, and ``generate(ids, 8)`` with
   the prefill on the reference route and every decode step on K6 alone.
16. ``quantize-planes``: the same through ``QuantizeConfig(bits=3)``: saved
   as a 3-bit v1 checkpoint, the re-save byte-equal, and ``generate(ids,
   8)`` on K4 alone.
17. ``moe-slice``: a GPTQ v1 checkpoint at Qwen3-30B-A3B's published widths
   and ``MOE_LAYERS`` = 16 of its 48 layers (4-bit, symmetric, group 128,
   dense router and lm_head; random weights drawn on the card from a seed,
   about 6.5 GB) is written under ``build/``, then
   ``GPTQModel.load(dir).optimize().generate(ids, 64)`` at B = 8, T = 128,
   bf16 KV. Asserted: 2 K1 (qkv, o)
   and 1 K10 per layer in the prefill and in every decode step, no other
   kernel; K10's passes in the profiled decode steps on the decode ring
   (``MoeGateUp``, ``MoeDown``) and its combine. Printed: load s
   and peak memory, device memory, prefill ms, decode ms per step, tokens/s,
   the device's busy share and K10's device ms per step by pass.
18. ``compare-moe``: its first 2 layers, the kernel path against the plain
   versions, teacher-forced: the plain path is fed the kernel path's tokens
   and follows its routes, experts and weights (the router's bf16 logits
   flip an expert at a near tie, or a weight by an ulp, and move a token's
   logits more than the kernels do); logits within 1e-2, the count of
   (token, layer) routes where the plain path's own router chose other
   experts, and the largest change of its probabilities; the kernel path's
   K10 ran its ring passes and its combine (the profiler's kernel names).
19. ``moe-routes``: layer 0 stacked again under each ``GPTQ_TPU_QMOE_*``
   setting and run at N = 8 and 1024 tokens: K10 (rt, the default; ic with
   ``RT=0``), K11, K12, K13 and the dense fallback; each within 2e-2 of the
   default, K10 (ic) within 2e-3 of K11, K11 equal to K12, and the kernel
   each route reached (the slot paths take the dense fallback past 1024
   routed rows).

Then ``{"phase": "profiler"}``: how many torch.profiler sessions lost
kernel records and were run again, how many were read from the records
they kept (``device_ms``), and how many timed loops of K1-K7 and K10-K13
read under their bound and were timed again (``timed``; a third such
reading fails the run). K1's, K2's, K4's, K5's, K6's and K10-K13's cases
also name the kernels the profiler saw; at M <= 16 (K10-K13: always) they
must all be ``qmm_decode_kernel`` (K6: its ``DequantFirst`` instantiation,
K4 and K5: ``Units``, K11 and K12: ``MoeSlotGateUp`` and ``MoeSlotDown``,
K13: ``MoeSlotDown``; K10 also its combine).
Then the card's name and power limit, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Each record of the kernels line
names its units: ``launches`` counts a whole run of the main path
(``launches_per``: K1 and K2 the generate run, K3 the asym-act-slice
generate run, K6 the g32-slice generate run, K7 the fused generate run, K4
the planes-slice generate run, K5 the compare-planes generate runs of its
two asymmetric checkpoints, K8 the quantize run, K9 the one-layer quantize run through
``GPTQ_TPU_SOLVER=pallas``, K10 the moe generate run, K11-K13 the
moe-routes run), and the times are per ``ms_per``: K1, K2, K3, K6 and K7
one decode step at B = 8 (K1 and K7 over qkv and o of every layer, K2 over
every layer's MLP, K3, K6, K4 and K5 over qkv, o, gate_up and down of every
layer, K6 at group 32, symmetric, K4 and K5 at 3 bits, stitched), K8 and K9 one quantized
layer (K8 one solve of each group, K9 each group's 128-column blocks), K10
one decode step at B = 8 over the moe-slice's 16 layers (rt; also
``ms_by_pass``),
K11-K13 one MoE layer at
N = 8 tokens (K13 gate|up and down). A failed check raises and exits
non-zero. Without a CUDA device it exits 1 and prints no result. The
records also go to ``chiprun_out/chip_smoke/chip_smoke.json``. Float32
products run in full float32: TF32 is off for matmuls and cuDNN.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
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
# K1, K3 and K7 at every projection, 4-bit (M <= 16 on the decode kernel);
# K3 also 2- and 8-bit at qkv, M = 8; K2 on the decode kernel at M <= 16
K1_MS = (1, 8, 16, 1024)
K3_MS = K7_MS = (1, 8, 16, 1024)
K3_EXTRA_BITS = {"qkv": (2, 8)}
K2_MS = (1, 8, 16, 64)
# K1 and its plain version sum the same exact products in f32 and round once
# to bf16; K2 also rounds inner to bf16 in both. Only the f32 order differs.
K1_TOL, K2_TOL = 1e-3, 2e-3
# K3 as K1: z*s is exact in f32 too
K3_TOL = K1_TOL
# K6 at every projection for M = 1, 8, 16 (its decode kernel) and 256 (the
# most rows its route gives it), 4-bit at groups of 32 and 64, symmetric and
# not, and 16 with zeros per group; 2- and 8-bit at qkv, M = 8, group 32.
K6_MS = (1, 8, 16, 256)
K6_GROUPS = ((32, True), (32, False), (64, True), (64, False), (16, False))
INT4PACK_GROUPS = (32, 64, 128, 256)  # the group sizes torch._weight_int4pack_mm takes
K6_EXTRA_BITS = {"qkv": (2, 8)}
K6_REF_M = 1024  # the prefill's rows, on the reference route: timed for the record
# K6 and K7 as K1: the same weights in both (K6 bf16(bf16(c - z) * bf16(s)),
# K7 bf16(c * s)), exact products, f32 sums in another order
K6_TOL = K7_TOL = K1_TOL
# the fused phase: the llama slice's model under GPTQ_TPU_RT_FUSED=1
FUSED_NEW = 16
# K4 and K5: 3-bit stitched at every projection for PLANES_MS (M <= 16 on the
# decode kernel), symmetric (K4) and with random zeros per group and column
# (K5); the planar layouts at qkv, M = 8, both kernels. As K1 and K3: exact
# products and z*s, f32 sums in another order
PLANES_MS = (1, 8, 16, 1024)
PLANE_LAYOUTS = ((3, True), (5, True), (6, True), (7, True))  # (bits, planar) at qkv
K4_TOL = K5_TOL = K1_TOL
PLANES_REF_M = 1024  # the reference route (dequantize, then torch.matmul): for the record
# K4's 3-bit stitched decode loop: a lane turns 32 code pairs a 128-row chunk
# into mma operands, one LOP3 each (mask and bf16 128 ORed in: unit_pair's
# magic in a register, qmm_decode.cuh), with 6 LOP3 besides when this limit
# was set; ptxas folding the magic into immediates takes two a pair
K4_LOOP = "qmm_decode_kernel<3,1,Units,0,UniformZero,0>"
K4_LOOP_LOP3 = 32 + 8
# compare-planes: 2-layer checkpoints beside the planes-slice's first 2 layers
# (bits, format, sym, desc_act) -> the kernel each runs
PLANE_COMPARES = {"3bit_asym_act": (3, "gptq", False, True, "qmatmul_planes_asym"),
                  "5bit_gptq_p_sym": (5, "gptq_p", True, False, "qmatmul_planes"),
                  "7bit_gptq_p_asym": (7, "gptq_p", False, False, "qmatmul_planes_asym")}
# logits after 2 layers: one-ulp bf16 flips of the products, carried on
SLICE_TOL = 1e-2
# K8 against its plain version: the JAX package's tolerances for its K8
# against the XLA scan (only the trailing product's f32 sums may differ)
K8_MISMATCH, K8_DQ_RTOL, K8_DQ_ATOL, K8_SCALE_RTOL, K8_LOSS_RTOL = 2e-3, 1e-4, 2e-4, 1e-5, 1e-3
# the solve's groups at Llama-3-8B's widths: out x in, g = 128, 4-bit, sym
SOLVE_SHAPES = {"qkv": (6144, 4096), "o": (4096, 4096), "gate_up": (28672, 4096),
                "down": (4096, 14336)}
# the quantize phase's depth: 16 of Llama-3-8B's 32 layers
QUANT_LAYERS = 16
# the moe-slice's depth: 16 of Qwen3-30B-A3B's 48 layers, cut so that the
# whole script stays well inside its 1200 s (888-1035 s with all 48)
MOE_LAYERS = 16
Q_ROWS, Q_T, Q_BATCH = 128, 512, 4  # calibration: seeded token ids
# quantize-act and quantize-g32: the quantize phase's checkpoint, its first 2
# layers, through QuantizeConfig(sym=False, desc_act=True) or
# QuantizeConfig(group_size=32), then 8 generated tokens on K3 or K6
QUANT_ACT_LAYERS, QUANT_ACT_NEW = 2, 8
GEN_B, GEN_T, GEN_NEW = 8, 128, 16  # the quantized model's generate
# K10 at decode B = 1, B = 8 and the prefill of 8 x 128 tokens; K11-K13 at
# decode B = 8 and at 128 tokens (1024 routed rows, the slot paths' bound)
MOE_E2E_NS, MOE_SLOT_NS = (1, 8, 1024), (8, 128)
# each MoE kernel against its plain version: the same exact products, f32
# sums in another order; K10-K12 also round inner to bf16 in both
K10_TOL = SLOT_MLP_TOL = 2e-3
K13_TOL = 1e-3
# K11's and K12's gate|up and down passes: the decode kernel's Z, in its name
SLOT_PASSES = ("MoeSlotGateUp", "MoeSlotDown")
# the reference's own tolerance across MoE routes (rt against ic differ by
# the bf16 rounding of (q - zc)*s, tests/test_pallas_qmoe.py); K10 and K11 on
# one contract, with K11's y kept in float32, differ only in where the
# combine adds
ROUTE_TOL, K10_IC_VS_K11 = 2e-2, 2e-3
# route -> GPTQ_TPU_QMOE_* switches, and what each reaches at N = 8 and at
# N = 1024 tokens (8192 routed rows: past the slot paths' 1024). "K11 f32"
# keeps the slot path's y in float32 (GPTQ_TPU_QMOE_BF16=0), as K10 does
# before its combine: the pair that holds K10 (ic) against K11.
MOE_ROUTES = {"K10 rt": {}, "K10 ic": {"RT": "0"}, "K11": {"RT": "0", "E2E": "0"},
              "K11 f32": {"RT": "0", "E2E": "0", "BF16": "0"},
              "K12": {"RT": "0", "E2E": "0", "DYN": "0"}, "K13": {"RT": "0", "FUSED": "0"},
              "dense": {"E2E": "0"}}
MOE_ROUTE_REACHES = {"K10 rt": ("qmoe_e2e",) * 2, "K10 ic": ("qmoe_e2e",) * 2,
                     "K11": ("qmoe_mlp_dyn", "dense"), "K11 f32": ("qmoe_mlp_dyn", "dense"),
                     "K12": ("qmoe_mlp", "dense"), "K13": ("qmoe_matmul", "dense"),
                     "dense": ("dense", "dense")}


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


def solve_inputs(dev, proj: str) -> dict:
    """K8's and K9's inputs at one of Llama-3-8B's solve groups
    (``SOLVE_SHAPES``, 4-bit, group 128, symmetric): W ~ N(0, 0.02) and the
    inverse factor ``U`` of a Hessian of 2048 seeded activation rows (the
    quantize loop's ``hessian_inverse``), the damp it took, K8's keyword
    arguments, and K9's first block ``(Wb, Hbb, scales, zeros)`` with per-row
    minmax scales broadcast over its 128 columns, rotated through copies past
    the L2 (``block``: the list of copies)."""
    import torch

    from gptqmodel_tpu_torch.quantization.gptq import hessian_inverse
    from gptqmodel_tpu_torch.quantization.quantizer import _minmax, _params_from_range

    out_f, in_f = SOLVE_SHAPES[proj]
    g = np.random.default_rng([SEED, 200, out_f, in_f])
    W = torch.from_numpy(g.standard_normal((out_f, in_f), dtype=np.float32) * 0.02).to(dev)
    X = torch.from_numpy(g.standard_normal((2048, in_f), dtype=np.float32)).to(dev)
    U, damp = hessian_inverse((2.0 / 2048) * (X.T @ X), 0.01)
    del X
    Wb, Hbb = W[:, :128].contiguous(), U[:128, :128].contiguous()
    s_col, z_col = (t[:, None].expand(out_f, 128).contiguous()
                    for t in _params_from_range(*_minmax(Wb, True), 15, True))
    blk = [(Wb, Hbb, s_col, z_col)]
    blk += [tuple(t.clone() for t in blk[0])
            for _ in range(copies_for(sum(t.nbytes for t in blk[0])) - 1)]
    return {"out": out_f, "in": in_f, "W": W, "U": U, "damp": damp,
            "kw": dict(maxq=15, group_size=128, sym=True), "block": blk}


def digest(*tensors) -> str:
    """SHA-256 over the bytes of ``tensors`` in order (None skipped): equal
    digests from two builds are equal outputs, bit for bit."""
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def template_args(mangled: str) -> list[str]:
    """The arguments of a mangled template argument list: integers and bools
    (``Li4E``, ``Lb1E``) and classes of the kernels' namespace (``NS_11UniformZeroE``,
    a length and a name, itself perhaps a template)."""
    out, i = [], 0
    pat = re.compile(r"L[ib](\d+)E|NS_(\d+)")
    while i < len(mangled):
        m = pat.match(mangled, i)
        if m is None:
            i += 1
        elif m.group(1) is not None:
            out.append(m.group(1))
            i = m.end()
        else:
            n = int(m.group(2))
            out.append(mangled[m.end():m.end() + n])
            i = m.end() + n
    return out


def readable(mangled: str) -> str:
    """``kernel<template args>`` of a mangled kernel name of namespace gqt."""
    m = re.match(r"_ZN3gqt(\d+)(\w+)", mangled)
    if m is None:
        return mangled
    n = int(m.group(1))
    name, rest = m.group(2)[:n], m.group(2)[n:]
    args = template_args(rest.split("EEv")[0]) if rest.startswith("I") else []
    return f"{name}<{','.join(args)}>" if args else name


SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")


def sass_functions(lib: str, mangled: tuple = ()) -> dict:
    """readable name -> [(address, opcode, operands, line)] of each kernel of
    ``lib`` (``cuobjdump -sass``; of the ``mangled`` names only, where
    given)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    only = ["-fun", ",".join(mangled)] if mangled else []
    out = subprocess.run([tool, "-sass", *only, lib], capture_output=True, text=True,
                         check=True).stdout
    found, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = readable(m.group(1))
            cur = None if name in found else found.setdefault(name, [])
            continue
        m = SASS_INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4), line.strip()))
    return found


def sass_main_loop(insns: list) -> dict:
    """The backward branch whose range holds the most HMMA (the narrowest of
    those), and its instructions: a static count, the body of one iteration
    with the rarely taken branches inside it."""
    best = None
    for addr, op, rest, _ in insns:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if m is None or int(m.group(1), 16) >= addr:
            continue
        lo = int(m.group(1), 16)
        body = [o for a, o, _, _ in insns if lo <= a <= addr]
        hmma = sum(o.startswith("HMMA") for o in body)
        key = (hmma, -len(body))
        if best is None or key > best[0]:
            best = (key, lo, addr, body)
    if best is None:
        return {}
    _, lo, hi, body = best
    return {"from": hex(lo), "to": hex(hi), "instructions": len(body),
            "sass": [text for a, _, _, text in insns if lo <= a <= hi],
            "hmma": sum(o.startswith("HMMA") for o in body),
            "by_opcode": dict(Counter(o.split(".")[0] for o in body).most_common())}


def k4_main_loop(lib_path, ptxas_by_source: dict) -> dict:
    """The main loop (``sass_main_loop``) of ``K4_LOOP`` in the library at
    ``lib_path``, its kernel found by the mangled name ptxas reported."""
    mangled = tuple({m.group(1) for lines in ptxas_by_source.values() for ln in lines
                     for m in [re.search(r"entry function '(_ZN3gqt\w+)'", ln)]
                     if m and readable(m.group(1)) == K4_LOOP})
    return sass_main_loop(sass_functions(str(lib_path), mangled).get(K4_LOOP, []))


def ptxas_summary(lines_by_source: dict) -> dict:
    """``kernel<template args>`` -> registers, smem bytes and spill bytes."""
    out, fn = {}, None
    for lines in lines_by_source.values():
        for ln in lines:
            m = re.search(r"Compiling entry function '(_ZN3gqt\w+)'", ln)
            if m:
                fn = readable(m.group(1))
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
    versions, on the card, for the reference of the compare phases. The package has no such switch; this swaps the names
    the registry and the MoE wrappers call, and restores them."""
    from gptqmodel_tpu_torch.ops import qmatmul as k1, qmlp as k2, qmoe, registry

    swaps = [(registry, "qmatmul", k1.qmatmul_plain),
             (registry, "qmatmul_asym", k1.qmatmul_asym_plain),
             (registry, "qmatmul_fused", k1.qmatmul_fused_plain),
             (registry, "qmm", k1.qmm_plain),
             (registry, "qmatmul_planes", k1.qmatmul_planes_plain),
             (registry, "qmatmul_planes_asym", k1.qmatmul_planes_asym_plain),
             (registry, "qmlp", k2.qmlp_plain)] + [
        (qmoe, name, getattr(qmoe, name + "_plain"))
        for name in ("qmoe_mlp_e2e", "qmoe_mlp_matmul_dyn", "qmoe_mlp_matmul", "qmoe_matmul")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


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


def checkpoint_digests(q_dir: Path) -> tuple[str, dict]:
    """SHA-256 over a saved checkpoint's tensors (each tensor's name, dtype,
    shape and bytes, in name order, whatever the shards), and the digest of
    each module's ``qweight`` (its codes), by module name."""
    from gptqmodel_tpu_torch.models.safetensors_io import read_header

    entries = []
    for f in sorted(q_dir.glob("*.safetensors")):
        header, base = read_header(f)
        entries += [(name, f, base, info) for name, info in header.items()]
    whole, per_module = hashlib.sha256(), {}
    for name, f, base, info in sorted(entries, key=lambda e: e[0]):
        begin, end = info["data_offsets"]
        with open(f, "rb") as fh:
            fh.seek(base + begin)
            data = fh.read(end - begin)
        whole.update(f"{name}|{info['dtype']}|{info['shape']}|".encode())
        whole.update(data)
        if name.endswith(".qweight"):
            per_module[name[:-len(".qweight")]] = hashlib.sha256(data).hexdigest()
    return whole.hexdigest(), per_module


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
    q_sha, module_sha = checkpoint_digests(q_dir)
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
        "saved_bytes": q_bytes, "checkpoint_sha256": q_sha, "module_codes_sha256": module_sha,
        "load_s": load_s, "generate_counts": gen_counts,
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


def moe_stacks(dev, seed: int):
    """A fused gate|up stack and a down stack of Qwen3-30B-A3B's 128
    experts (4-bit, g = 128, symmetric), random words and scales drawn on
    the card, and its router; the rt flag as ``stack_packed_experts`` sets
    it."""
    import torch

    from gptqmodel_tpu_torch.ops import qmoe
    from gptqmodel_tpu_torch.utils.testing import QWEN3_30B_A3B_CONFIG as C

    g = torch.Generator(dev).manual_seed(seed)
    E = C["num_experts"]

    def stack(K, N):
        G = K // 128
        qw = torch.randint(-2**31, 2**31, (E, K // 8, N), generator=g, dtype=torch.int64,
                           device=dev).to(torch.int32)
        sc = torch.zeros((E, max(8, -(-G // 8) * 8), N), device=dev)
        sc[:, :G] = (torch.rand((E, G, N), generator=g, device=dev) + 0.5) * (
            0.02 / math.sqrt(255 / 12))
        return qmoe.StackedQuantExperts(
            qweight=qw, scales=sc.to(torch.bfloat16), bits=4, G=G, zero_const=8.0,
            in_features=K, out_features=N, rt=qmoe.stacked_rt_ok(4, K, 128, subgroup=True))

    D, F = C["hidden_size"], C["moe_intermediate_size"]
    router = (torch.randn((E, D), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    return stack(D, 2 * F), stack(F, D), router, g


def moe_routing(router, N: int, g):
    """N seeded token rows and their routes: the router's bf16 product,
    softmax, top-8 and renormalization, as ``moe_mlp`` routes."""
    import torch

    from gptqmodel_tpu_torch.models.transformer import _topk
    from gptqmodel_tpu_torch.utils.testing import QWEN3_30B_A3B_CONFIG as C

    x = torch.randn((N, router.shape[1]), generator=g, device=router.device).to(torch.bfloat16)
    w, i = _topk(torch.softmax((x @ router.T).float(), -1), C["num_experts_per_tok"])
    return x, w / w.sum(-1, keepdim=True), i


def moe_bytes(top_i, stacks, rows_in: int, rows_out: int) -> int:
    """Bytes a MoE kernel must move: the words and real group scales of each
    distinct routed expert of each stack, read once, plus ``rows_in`` bf16
    values read and ``rows_out`` written."""
    distinct = int(top_i.unique().numel())
    per_expert = sum(st.qweight[0].nbytes + st.G * st.out_features * 2 for st in stacks)
    return distinct * per_expert + 2 * (rows_in + rows_out)


def moe_rotated(stacks, n_bytes: int) -> list:
    """The words and scales of ``stacks``, then copies of them:
    ``copies_for(n_bytes)`` sets to rotate through past the L2."""
    base = tuple(t for st in stacks for t in (st.qweight, st.scales))
    return [base] + [tuple(t.clone() for t in base) for _ in range(copies_for(n_bytes) - 1)]


def k10_inputs(gu, dn, router, g, bm_of):
    """K10's inputs at N = 1, 8 and 1024 tokens (``MOE_E2E_NS``), one dict
    an N: the routed rows, the slot plan at ``bm_of(M)`` rows a slot (the
    model's ``qmoe.slot_rows``), the operands of ``qmoe_mlp_e2e``, the bytes
    it must move, the stacks' sets to rotate through, and the keyword
    arguments of either contract, ``kw(rt)``."""
    from gptqmodel_tpu_torch.ops import qmoe

    E, D, F = gu.qweight.shape[0], gu.in_features, gu.out_features // 2
    for N in MOE_E2E_NS:
        x, w, top_i = moe_routing(router, N, g)
        M = N * w.shape[1]
        bm = bm_of(M)
        S = qmoe.slot_bound(M, E, bm)
        ids, counts, row_pos = qmoe.plan_rows(top_i.reshape(-1), E, bm, S)
        n_bytes = moe_bytes(top_i, (gu, dn), N * D, N * D)
        yield {"N": N, "M": M, "bm": bm, "S": S, "x": x, "ids": ids,
               "ops": qmoe.e2e_operands(row_pos.reshape(N, -1), w, counts, bm),
               "n_bytes": n_bytes, "distinct": int(top_i.unique().numel()),
               "sets": moe_rotated((gu, dn), n_bytes),
               "kw": lambda rt, bm=bm: dict(bits=4, G_gu=gu.G, G_d=dn.G, F=F, bm=bm, zc_gu=8.0,
                                            zc_d=8.0, rt_gu=rt, rt_d=rt)}


def slot_inputs(gu, dn, router, g, N: int, bm: int = 8) -> dict:
    """K11's, K12's and K13's inputs at N tokens, as the model's slot path
    makes them: the routed rows sorted by expert into slots of bm rows
    (``plan_slots``), the slot-sorted rows ``xs`` (padding rows 0),
    ``n_used``, the bytes K11 and K12 must move, the stacks' sets to rotate
    through, and K11's and K12's keyword arguments."""
    import torch

    from gptqmodel_tpu_torch.ops import qmoe

    E, D, F = gu.qweight.shape[0], gu.in_features, gu.out_features // 2
    x, w, top_i = moe_routing(router, N, g)
    M = N * w.shape[1]
    flat = top_i.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    S = qmoe.slot_bound(M, E, bm)
    ids, counts, pos = qmoe.plan_slots(flat[order], E, bm, S)
    xs = torch.zeros((S * bm, D), dtype=torch.bfloat16, device=x.device)
    xs[pos.long()] = x[order // w.shape[1]]
    n_bytes = moe_bytes(top_i, (gu, dn), M * D, M * D)
    return {"N": N, "M": M, "bm": bm, "S": S, "top_i": top_i, "xs": xs, "ids": ids,
            "counts": counts, "n_used": (counts > 0).sum().to(torch.int32).reshape(1),
            "n_bytes": n_bytes, "sets": moe_rotated((gu, dn), n_bytes),
            "kw": dict(bits=4, G_gu=gu.G, G_d=dn.G, F=F, bm=bm, zc_gu=8.0, zc_d=8.0,
                       out_dtype=torch.bfloat16)}


def moe_kernel_cases(dev) -> list:
    """K10 at N = 1, 8 and 1024 tokens (two runs each, for equal bits), K11
    and K12 at N = 8 and 128 (equal to each other and to a second run), K13
    gate|up and down at N = 8 and 128 (its down on K12's inner equal to
    K12), all on the decode ring by the profiler's names, at
    Qwen3-30B-A3B's widths, each against its plain version, the stacks
    rotated through copies past the L2."""
    import torch
    import torch.nn.functional as F_

    from gptqmodel_tpu_torch.ops import _build, qmoe

    gu, dn, router, g = moe_stacks(dev, SEED + 300)
    E, D, F = gu.qweight.shape[0], gu.in_features, gu.out_features // 2
    cases = []

    def case(kernel, N, M, y, ref, kern, plain, n_bytes, ops, tol, **extra):
        rel, mx = errors(y, ref)
        b_ms, b_by = bound(n_bytes, ops)
        k10 = kernel == "qmoe_e2e"
        k = timed(kern, extra["copies"], floor_ms=b_ms)
        p = timed(plain, extra["copies"], budget_ms=100.0)
        c = {"kernel": kernel, "N": N, "M": M, "D": D, "F": F, "E": E, "rel_err": rel,
             "max_abs_err": mx, "ms": k["ms"], "wall_ms": k["wall_ms"], "plain_ms": p["ms"],
             "plain_wall_ms": p["wall_ms"], "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None,
             "library": "null: no PyTorch call computes a quantized grouped expert MLP",
             **extra}
        if k10:  # by pass, from the profiler's kernel names
            c["ms_by_pass"] = by_k10_pass(k["rows"])
        c["kernel_names"] = k["kernels"]
        cases.append(c)
        emit({"phase": "kernels", **c})
        require(rel <= tol, f"{kernel} N={N}: rel {rel} > {tol}")
        require(not k10 or set(c["ms_by_pass"]) == {"gate_up", "down", "combine"},
                f"K10 N={N} ran {k['kernels']}")

    require(gu.rt and dn.rt, "Qwen3-30B-A3B's stacks take the rt contract")
    for c in k10_inputs(gu, dn, router, g, qmoe.slot_rows):
        N, M, x, ids, ops_, sets = c["N"], c["M"], c["x"], c["ids"], c["ops"], c["sets"]
        for rt in (True, False):  # the stacks' rt contract (the default), then ic
            kw = c["kw"](rt)
            kern = lambda i, kw=kw: qmoe.qmoe_mlp_e2e(x, ids, *ops_, *sets[i], **kw)
            plain = lambda i, kw=kw: qmoe.qmoe_mlp_e2e_plain(x, ids, *ops_, *sets[i], **kw)
            before = _build.LAUNCHES["qmoe_e2e"]
            y, y2, ref = kern(0), kern(0), plain(0)
            torch.cuda.synchronize()
            require(_build.LAUNCHES["qmoe_e2e"] == before + 2, "K10 did not launch")
            identical = torch.equal(y, y2)
            case("qmoe_e2e", N, M, y, ref, kern, plain, c["n_bytes"], 2.0 * M * 3 * D * F,
                 K10_TOL, bm=c["bm"], slots=c["S"], distinct_experts=c["distinct"],
                 rt=[rt, rt], identical_runs=identical, copies=len(sets))
            require(identical, f"K10 N={N} rt={rt}: two runs gave different bits")
            del y, y2, ref
        del c, sets

    for N in MOE_SLOT_NS:
        c = slot_inputs(gu, dn, router, g, N)
        M, bm, S, top_i, xs, ids, counts, n_used, n_bytes, sets, kw = (
            c[k] for k in ("M", "bm", "S", "top_i", "xs", "ids", "counts", "n_used", "n_bytes",
                           "sets", "kw"))
        dyn = lambda i: qmoe.qmoe_mlp_matmul_dyn(xs, ids, counts, n_used, *sets[i], **kw)
        grid = lambda i: qmoe.qmoe_mlp_matmul(xs, ids, counts, *sets[i], **kw)
        plain = lambda i: qmoe.qmoe_mlp_matmul_plain(xs, ids, counts, *sets[i], **kw)
        y_dyn, y_grid, ref = dyn(0), grid(0), plain(0)
        torch.cuda.synchronize()
        equal = torch.equal(y_dyn, y_grid)
        ops = 2.0 * M * 3 * D * F
        for kernel, fn, y in (("qmoe_mlp_dyn", dyn, y_dyn), ("qmoe_mlp", grid, y_grid)):
            identical = torch.equal(y, fn(0))
            case(kernel, N, M, y, ref, fn, plain, n_bytes, ops, SLOT_MLP_TOL, bm=bm, slots=S,
                 equal_k11_k12=equal, identical_runs=identical, copies=len(sets))
            require(identical, f"{kernel} N={N}: two runs gave different bits")
            names = cases[-1]["kernel_names"]
            require(on_decode_kernel(names) and all(k10_pass(n) == "other" for n in names)
                    and all(any(z in n for n in names) for z in SLOT_PASSES),
                    f"{kernel} N={N} ran {names}")
        require(equal, f"K11 and K12 differ at N={N}")

        # K13's down on K12's own inner is K12's down pass alone: equal bits
        inner12 = torch.zeros((S * bm, F), dtype=torch.bfloat16, device=dev)
        equal_k12 = {}
        for dt in (torch.float32, torch.bfloat16):
            y12 = qmoe._mlp_kernel("qmoe_mlp", xs, ids, counts, None, *sets[0], inner=inner12,
                                   **(kw | {"out_dtype": dt}))
            y13 = qmoe.qmoe_matmul(inner12, ids, counts, dn.qweight, dn.scales, bits=4, G=dn.G,
                                   bm=bm, zero_const=8.0, out_dtype=dt)
            equal_k12[str(dt)] = torch.equal(y12, y13)
        require(all(equal_k12.values()), f"K13 differs from K12's down at N={N}: {equal_k12}")
        del inner12, y12, y13

        k13 = dict(bits=4, bm=bm, zero_const=8.0, out_dtype=torch.bfloat16)
        gu_out = qmoe.qmoe_matmul(xs, ids, counts, gu.qweight, gu.scales, G=gu.G, **k13)
        inner = (F_.silu(gu_out[:, :F].float()) * gu_out[:, F:].float()).to(torch.bfloat16)
        for proj, xin, st, i_w, K, Nout in (("gate_up", xs, gu, (0, 1), D, 2 * F),
                                            ("down", inner, dn, (2, 3), F, D)):
            kern = lambda i: qmoe.qmoe_matmul(xin, ids, counts, sets[i][i_w[0]],
                                              sets[i][i_w[1]], G=st.G, **k13)
            plain = lambda i: qmoe.qmoe_matmul_plain(xin, ids, counts, sets[i][i_w[0]],
                                                     sets[i][i_w[1]], G=st.G, **k13)
            y, ref = kern(0), plain(0)
            case("qmoe_matmul", N, M, y, ref, kern, plain,
                 moe_bytes(top_i, (st,), M * K, M * Nout), 2.0 * M * K * Nout, K13_TOL,
                 proj=proj, bm=bm, slots=S, down_equal_to_k12=equal_k12, copies=len(sets))
            names = cases[-1]["kernel_names"]
            require(on_decode_kernel(names) and all(SLOT_PASSES[1] in n for n in names),
                    f"K13 {proj} N={N} ran {names}")
        del c, sets, xs, inner, gu_out
    del gu, dn
    torch.cuda.empty_cache()
    return cases


def compare_layers(spec, params, ids, layers: int = 2, steps: int = 8) -> dict:
    """The first ``layers`` layers of a model at full width: the kernel
    path's logits over a prefill of ``ids`` and ``steps`` greedy decode
    steps, against the plain versions' on the card, teacher-forced on the
    kernel path's tokens. Returns the record and the kernel path's launch
    counts; asserts that the plain path launches no kernel (both count the
    same reference-route products)."""
    import torch

    from gptqmodel_tpu_torch.inference.engine import (
        init_kv_cache, make_decode_fn, make_prefill_fn,
    )
    from gptqmodel_tpu_torch.ops import _build

    dev = torch.device("cuda")
    spec2 = dataclasses.replace(spec, num_layers=layers)
    params2 = {**params, "model": {**params["model"],
                                   "layers": params["model"]["layers"][:layers]}}
    Bn, Tn = ids.shape
    ids_t = torch.as_tensor(ids, device=dev)
    lens = torch.full((Bn,), Tn, dtype=torch.long, device=dev)

    def run(forced=None):
        caches = init_kv_cache(spec2, Bn, Tn + steps, torch.bfloat16, False, device=dev)
        with torch.inference_mode():
            logits, caches, kv = make_prefill_fn(spec2)(params2, ids_t, lens, caches)
            dec = make_decode_fn(spec2)
            outs, toks, pos = [logits.float()], [logits.argmax(-1)], lens.clone()
            for s in range(steps):
                tok = toks[-1] if forced is None else forced[s]
                logits, caches, kv = dec(params2, tok, pos, Tn + s, kv, caches)
                outs.append(logits.float())
                toks.append(logits.argmax(-1))
                pos = pos + 1
        return torch.stack(outs), toks

    _build.reset_counts()
    got, got_toks = run()
    counts = dict(_build.LAUNCHES)
    with plain_versions():
        ref, ref_toks = run(forced=got_toks)
    require(dict(_build.LAUNCHES) == counts | {"reference": 2 * counts["reference"]},
            "the plain path launched a kernel")
    require(bool(torch.isfinite(got).all()), f"non-finite logits at {layers} layers")
    rel = float((got - ref).norm() / ref.norm())
    agree = float(torch.stack([a == b for a, b in zip(got_toks, ref_toks)]).float().mean())
    return {"layers": layers, "positions": steps + 1, "kv": "bf16", "logits_rel_err": rel,
            "logits_tol": SLICE_TOL, "greedy_agreement": agree, "counts": counts}


def projections(model) -> list:
    """Every quantized projection of a loaded llama model, layer by layer."""
    return [m for lp in model.params["model"]["layers"]
            for m in (*lp["self_attn"].values(), *lp["mlp"].values())]


def slice_phase(root: Path, card: str, phase: str, ids, options: dict, module_ok,
                prefill: dict, step: dict):
    """One slice: a GPTQ checkpoint at Llama-3-8B's published widths and all
    32 layers, written with ``options`` under ``root`` (random weights drawn
    on the card from the seed), through ``GPTQModel.load(dir).optimize()
    .generate(ids, NEW)`` at B = 8, T = 128, bf16 KV. Asserted: q/k/v and
    gate/up fused, no MLP marked for K2, ``module_ok`` for every projection,
    the launch counts ``prefill`` in the prefill and ``step`` in each decode
    step, tokens in the vocabulary; then the prefill and the steps are timed
    (``serve_timing``). Emits the record; returns the model and the record."""
    import torch

    from gptqmodel_tpu_torch import GPTQModel
    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.utils.testing import LLAMA3_8B_CONFIG, write_random_gptq_checkpoint

    L = LLAMA3_8B_CONFIG["num_hidden_layers"]
    with tempfile.TemporaryDirectory(prefix=f"llama3-8b-{phase}-", dir=root) as ckpt:
        t0 = time.perf_counter()
        n_bytes = write_random_gptq_checkpoint(ckpt, LLAMA3_8B_CONFIG, seed=SEED, device="cuda",
                                               **options)
        write_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = GPTQModel.load(ckpt)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated()
    model.optimize()
    spec, params = model.spec, model.params
    lps = params["model"]["layers"]
    require(model.device.type == "cuda" and len(lps) == L and all(
        set(lp["self_attn"]) == {"qkv_proj", "o_proj"}
        and set(lp["mlp"]) == {"gate_up_proj", "down_proj"} for lp in lps),
        f"{phase}: q/k/v or gate/up left unfused, or an MLP marked for K2")
    require(all(module_ok(m) for m in projections(model)), f"{phase}: a module off its route")
    weights_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    tokens = model.generate(ids, max_new_tokens=NEW)
    generate_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    want = {k: prefill[k] + (NEW - 1) * step[k] for k in step}
    require(counts == want, f"{phase} generate launched {counts}, expected {want}")
    require(tokens.shape == (B, NEW) and ((tokens >= 0) & (tokens < spec.vocab_size)).all(),
            f"{phase}: tokens {tokens.shape}")
    timing = serve_timing(spec, params, ids, False, prefill, step)
    rec = {
        "phase": phase, "gpu": card, "layers": L, "B": B, "T": T, "new_tokens": NEW,
        "kv": "bf16", "options": options, "checkpoint_bytes": n_bytes, "write_s": write_s,
        "load_s": load_s, "load_peak_mem_bytes": load_peak, "weights_mem_bytes": weights_mem,
        "generate_s": generate_s, "generate_counts": counts,
        "generate_peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "prefill_counts": prefill, "decode_counts_per_step": step,
        "distinct_tokens_first_row": len(set(tokens[0].tolist())),
        "tokens_first_row": tokens[0].tolist(), **timing}
    emit(rec)
    return model, rec


def compare_checkpoint(root: Path, ids, name: str, seed: int, options: dict, module_ok,
                       generate_kernel: str | None = None) -> dict:
    """A 2-layer GPTQ checkpoint at Llama-3-8B's published widths, written
    with ``options`` under ``root`` (drawn on the card from ``seed``),
    ``module_ok`` for every projection, through ``compare_layers``. With
    ``generate_kernel`` the facade first generates ``QUANT_ACT_NEW`` tokens,
    every launch on that kernel (recorded as ``generate_counts``)."""
    import torch

    from gptqmodel_tpu_torch import GPTQModel
    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.utils.testing import LLAMA3_8B_CONFIG, write_random_gptq_checkpoint

    with tempfile.TemporaryDirectory(prefix=f"llama3-8b-{name}-", dir=root) as ckpt:
        write_random_gptq_checkpoint(ckpt, dict(LLAMA3_8B_CONFIG, num_hidden_layers=2),
                                     seed=seed, device="cuda", **options)
        model = GPTQModel.load(ckpt).optimize()
    require(all(module_ok(m) for m in projections(model)), f"{name}: a module off its route")
    rec = {"options": options}
    if generate_kernel:
        _build.reset_counts()
        tokens = model.generate(ids, max_new_tokens=QUANT_ACT_NEW)
        rec["generate_counts"] = gen_counts = dict(_build.LAUNCHES)
        want = dict.fromkeys(_build.LAUNCHES, 0) | {generate_kernel: 4 * 2 * QUANT_ACT_NEW}
        require(gen_counts == want, f"{name} generate launched {gen_counts}, expected {want}")
        require(tokens.shape == (B, QUANT_ACT_NEW), f"{name}: tokens {tokens.shape}")
    rec.update(compare_layers(model.spec, model.params, ids))
    del model
    torch.cuda.empty_cache()
    return rec


def compare_phase(card: str, phase: str, cmp: dict, want: dict, **extra) -> dict:
    """Emits the record of the compares ``cmp``, then asserts each: launch
    counts ``want[name]`` (every other kernel 0) and logits within
    ``SLICE_TOL``."""
    from gptqmodel_tpu_torch.ops import _build

    rec = {"phase": phase, "gpu": card, **cmp, **extra}
    emit(rec)
    none = dict.fromkeys(_build.LAUNCHES, 0)
    for name, c in cmp.items():
        require(c["counts"] == none | want[name],
                f"{phase} {name} launched {c['counts']}, expected {want[name]}")
        require(c["logits_rel_err"] <= SLICE_TOL,
                f"{phase} {name}: rel {c['logits_rel_err']} > {SLICE_TOL}")
    return rec


def act_phases(root: Path, card: str) -> dict:
    """``asym-act-slice`` and ``compare-act``: GPTQ checkpoints at
    Llama-3-8B's published widths written with ``sym=False, desc_act=True``
    (all 32 layers, ``slice_phase``, every projection on K3) and with
    ``sym=True, desc_act=True`` (2 layers, K1 after the gather), random
    weights drawn on the card from the seed, under ``root``."""
    import torch

    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.utils.testing import LLAMA3_8B_CONFIG

    L = LLAMA3_8B_CONFIG["num_hidden_layers"]
    k3 = dict.fromkeys(_build.LAUNCHES, 0) | {"qmatmul_asym": 4 * L}  # qkv, o, gate_up, down
    ids = np.random.default_rng([SEED, 6]).integers(0, LLAMA3_8B_CONFIG["vocab_size"], (B, T))
    model, rec = slice_phase(root, card, "asym-act-slice", ids, {"sym": False, "desc_act": True},
                             lambda m: m.act_perm is not None and m.zero_const < 0, k3, k3)
    out = {"asym_act_slice": rec}
    cmp = {"asym": compare_layers(model.spec, model.params, ids)}
    del model
    torch.cuda.empty_cache()
    cmp["sym"] = compare_checkpoint(root, ids, "sym-act", SEED + 1,
                                    {"sym": True, "desc_act": True},
                                    lambda m: m.act_perm is not None and m.zero_const >= 0)
    want = {"asym": {"qmatmul_asym": 4 * 2 * cmp["asym"]["positions"]},
            "sym": {"qmatmul": 4 * 2 * cmp["sym"]["positions"]}}  # K1 alone
    out["compare_act"] = compare_phase(card, "compare-act", cmp, want)
    return out


def requantize_phase(root: Path, state: dict, card: str, phase: str, options: dict,
                     served_ok, gen_counts: dict) -> dict:
    """The quantize phase's checkpoint, its first ``QUANT_ACT_LAYERS``
    layers, through ``GPTQModel.load(dir, QuantizeConfig(bits=4,
    group_size=128, sym=True, **options))``, ``.quantize(ids)`` on K8 and
    ``.save(out)``; then ``GPTQModel.load(out)`` is saved again, which must
    give the first save's bytes, ``served_ok(model)`` checks its prepared
    modules, and ``.optimize().generate(ids, 8)`` must launch
    ``gen_counts``. quantize-act: ``sym=False, desc_act=True``, rows
    permuted into group order at post-init, every projection on K3.
    quantize-g32: ``group_size=32``, the prefill on the reference route and
    every decode projection on K6."""
    import torch

    from gptqmodel_tpu_torch import GPTQModel, QuantizeConfig
    from gptqmodel_tpu_torch.ops import _build

    layers, new = QUANT_ACT_LAYERS, QUANT_ACT_NEW
    fp = root / f"fp-{layers}-layers"
    if not fp.exists():
        fp.mkdir()
        for f in state["fp_dir"].iterdir():  # the same shards, a config of fewer layers
            if f.name != "config.json":
                (fp / f.name).symlink_to(f)
        cfg = json.loads((state["fp_dir"] / "config.json").read_text())
        (fp / "config.json").write_text(json.dumps(dict(cfg, num_hidden_layers=layers)))
    none = dict.fromkeys(_build.LAUNCHES, 0)
    model = GPTQModel.load(fp, QuantizeConfig(**{"bits": 4, "group_size": 128, "sym": True,
                                                 **options}))
    _build.reset_counts()
    t0 = time.perf_counter()
    qlog = model.quantize(state["ids"], batch_size=Q_BATCH)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    require(counts == none | {"gptq_whole_solve": 4 * layers}, f"{phase} launched {counts}")
    require(not any(r["fallback"] for r in qlog) and all(math.isfinite(r["loss"]) for r in qlog),
            f"{phase}: a fallback or a non-finite loss")
    first, again = root / f"{phase}-quantized", root / f"{phase}-saved-again"
    model.save(first)
    del model
    torch.cuda.empty_cache()
    served = GPTQModel.load(first)
    require(served_ok(served), f"{phase}: a module loaded outside its route")
    served.save(again)
    served.optimize()
    _build.reset_counts()
    tokens = served.generate(state["ids"][:GEN_B, :GEN_T], max_new_tokens=new)
    got = dict(_build.LAUNCHES)
    require(got == none | gen_counts, f"{phase} generate launched {got}")
    require(tokens.shape == (GEN_B, new), f"tokens of shape {tokens.shape}")
    require(((tokens >= 0) & (tokens < served.spec.vocab_size)).all(),
            "token out of the vocabulary")
    del served
    torch.cuda.empty_cache()
    files = sorted(f.name for f in first.glob("model*.safetensors*"))
    equal = files == sorted(f.name for f in again.glob("model*.safetensors*")) and all(
        (first / f).read_bytes() == (again / f).read_bytes() for f in files)
    rec = {"phase": phase, "gpu": card, "layers": layers, **options,
           "quantize_s": quantize_s, "quantize_counts": counts,
           "loss_min": min(r["loss"] for r in qlog), "loss_max": max(r["loss"] for r in qlog),
           "generate_counts": got, "tokens_first_row": tokens[0].tolist(),
           "saved_files": files, "resave_byte_equal": equal}
    emit(rec)
    require(equal, f"{phase}: the save after load differs from the first save")
    return rec


def quantize_act_phase(root: Path, state: dict, card: str) -> dict:
    """quantize-act (``requantize_phase``): K3 alone at generate."""
    layers, new = QUANT_ACT_LAYERS, QUANT_ACT_NEW
    return requantize_phase(
        root, state, card, "quantize-act", {"sym": False, "desc_act": True},
        lambda m: all(q.act_perm is not None for lp in m.params["model"]["layers"]
                      for k in ("self_attn", "mlp") for q in lp[k].values()),
        {"qmatmul_asym": 4 * layers * new})


def quantize_g32_phase(root: Path, state: dict, card: str) -> dict:
    """quantize-g32 (``requantize_phase``): the prefill's GEN_B x GEN_T rows
    on the reference route, every decode step on K6 alone."""
    from gptqmodel_tpu_torch.ops.registry import kernel_route

    layers, new = QUANT_ACT_LAYERS, QUANT_ACT_NEW
    return requantize_phase(
        root, state, card, "quantize-g32", {"group_size": 32},
        lambda m: all(q.group_size == 32 and kernel_route(q) == "K6"
                      for lp in m.params["model"]["layers"]
                      for k in ("self_attn", "mlp") for q in lp[k].values()),
        {"reference": 4 * layers, "qmm": 4 * layers * (new - 1)})


def quantize_planes_phase(root: Path, state: dict, card: str) -> dict:
    """quantize-planes (``requantize_phase``): ``QuantizeConfig(bits=3)``,
    saved as a 3-bit v1 checkpoint (stitched words), K4 alone at
    generate."""
    from gptqmodel_tpu_torch.ops.registry import kernel_route

    layers, new = QUANT_ACT_LAYERS, QUANT_ACT_NEW
    return requantize_phase(
        root, state, card, "quantize-planes", {"bits": 3},
        lambda m: all(q.bits == 3 and not q.planar and kernel_route(q) == "K4"
                      for lp in m.params["model"]["layers"]
                      for k in ("self_attn", "mlp") for q in lp[k].values()),
        {"qmatmul_planes": 4 * layers * new})


def count_dense_fallback():
    """Count the dense fallback's calls: it launches no kernel of the port,
    so the MoE routes read this counter beside ``_build.LAUNCHES``. The
    package has no such counter; this wraps the name the dispatch calls."""
    from gptqmodel_tpu_torch.models import transformer

    fn, calls = transformer._moe_packed_dense_fallback, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)

    @contextlib.contextmanager
    def ctx():
        transformer._moe_packed_dense_fallback = counted
        try:
            yield calls
        finally:
            transformer._moe_packed_dense_fallback = fn

    return ctx()


def moe_phases(root: Path, card: str) -> dict:
    """``moe-slice``, ``compare-moe`` and ``moe-routes`` on a GPTQ
    Qwen3-30B-A3B-wide checkpoint (``MOE_LAYERS`` of its 48 layers, random
    weights from the seed, drawn on the card) written under ``root``."""
    import torch

    from gptqmodel_tpu_torch import GPTQModel
    from gptqmodel_tpu_torch.inference.engine import (
        init_kv_cache, make_decode_fn, make_prefill_fn,
    )
    from gptqmodel_tpu_torch.models import transformer
    from gptqmodel_tpu_torch.models.loader import CheckpointReader, build_params_tree
    from gptqmodel_tpu_torch.models.optimize import stack_moe_experts
    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.ops.registry import post_init_params
    from gptqmodel_tpu_torch.quantization.config import QuantizeConfig
    from gptqmodel_tpu_torch.utils.testing import (
        QWEN3_30B_A3B_CONFIG, write_random_qwen3_moe_checkpoint,
    )

    dev = torch.device("cuda")
    cfg = dict(QWEN3_30B_A3B_CONFIG, num_hidden_layers=MOE_LAYERS)
    L, V = cfg["num_hidden_layers"], cfg["vocab_size"]
    out = {}
    t0 = time.perf_counter()
    n_bytes = write_random_qwen3_moe_checkpoint(root, cfg, seed=SEED, device=dev)
    write_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPTQModel.load(root)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    model.optimize()
    torch.cuda.synchronize()
    optimize_s = time.perf_counter() - t0
    spec, params = model.spec, model.params
    layers = params["model"]["layers"]
    require(model.device.type == "cuda" and spec.model_type == "qwen3_moe", spec.model_type)
    require(len(layers) == L and all(
        "qkv_proj" in lp["self_attn"] and set(lp["mlp"]) == {"gate", "experts_stacked_q"}
        and set(lp["mlp"]["experts_stacked_q"]) == {"gateup", "down"}
        and lp["mlp"]["experts_stacked_q"]["gateup"].rt for lp in layers),
        "optimize() left a layer unstacked or off the rt contract")
    weights_mem, optimize_peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()

    # ------------------------------------------------------------ moe-slice
    none = dict.fromkeys(_build.LAUNCHES, 0)
    counts_per = none | {"qmatmul": 2 * L, "qmoe_e2e": L}  # a prefill or a decode step
    ids = np.random.default_rng([SEED, 5]).integers(0, V, (B, T))
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    tokens = model.generate(ids, max_new_tokens=NEW)
    generate_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    want = {k: NEW * v for k, v in counts_per.items()}
    require(counts == want, f"moe generate launched {counts}, expected {want}")
    require(tokens.shape == (B, NEW) and ((tokens >= 0) & (tokens < V)).all(),
            f"tokens {tokens.shape}")
    timing = serve_timing(spec, params, ids, False, counts_per, counts_per, by_k10_pass)
    k10_step = timing["device_ms_per_step_by_class"]
    out["moe_slice"] = rec = {
        "phase": "moe-slice", "gpu": card, "layers": L, "B": B, "T": T, "new_tokens": NEW,
        "kv": "bf16", "checkpoint_bytes": n_bytes, "write_s": write_s, "load_s": load_s,
        "load_peak_mem_bytes": load_peak, "optimize_s": optimize_s,
        "optimize_peak_mem_bytes": optimize_peak, "weights_mem_bytes": weights_mem,
        "generate_s": generate_s, "generate_counts": counts,
        "generate_peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "counts_per_prefill_and_step": counts_per, "tokens_first_row": tokens[0].tolist(),
        **timing,
    }
    emit(rec)
    # K10's layers ran its passes on the decode ring and its combine
    require(all(k10_step.get(p, 0.0) > 0 for p in ("gate_up", "down", "combine")),
            f"moe-slice's decode steps ran {k10_step}")

    # ---------------------------------------------------------- compare-moe
    spec2 = dataclasses.replace(spec, num_layers=2)
    params2 = {**params, "model": {**params["model"], "layers": layers[:2]}}
    ids_t = torch.as_tensor(ids, device=dev)
    lens = torch.full((B,), T, dtype=torch.long, device=dev)
    topk = transformer._topk

    def run(steps: int, forced=None, forced_routes=None):
        """Prefill and ``steps`` decode steps of the 2-layer model; its
        logits, tokens and, per router call, the (probabilities, experts) it
        chose and the largest change of its probabilities at the given
        experts. With ``forced_routes`` each call still records its own
        choice but routes through the given ones."""
        routes, prob_diff = [], []

        def recorded(x, k):
            v, i = topk(x, k)
            routes.append((v, i))
            if forced_routes is not None:
                v, i = forced_routes[len(routes) - 1]
                prob_diff.append(float((x.gather(-1, i) - v).abs().max()))
            return v, i

        transformer._topk = recorded
        try:
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
        finally:
            transformer._topk = topk
        return torch.stack(outs), toks, routes, prob_diff

    from torch.profiler import ProfilerActivity, profile

    _build.reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got, got_toks, got_routes, _ = run(8)
        torch.cuda.synchronize()
    k10_parts = sorted({k10_pass(e.key) for e in prof.key_averages()} - {"other"})
    kernel_counts = dict(_build.LAUNCHES)
    with plain_versions():
        ref, ref_toks, ref_routes, prob_diff = run(8, forced=got_toks, forced_routes=got_routes)
    require(dict(_build.LAUNCHES) == kernel_counts, "the plain path launched a kernel")
    require(kernel_counts == none | {"qmatmul": 2 * 2 * 9, "qmoe_e2e": 2 * 9}, kernel_counts)
    rel = float((got - ref).norm() / ref.norm())
    chosen = lambda rs: [torch.sort(i, dim=-1).values for _, i in rs]
    differ = sum(int((a != b).any(-1).sum())
                 for a, b in zip(chosen(got_routes), chosen(ref_routes)))
    n_routes = sum(i.shape[0] for _, i in got_routes)
    agree = float(torch.stack([a == b for a, b in zip(got_toks, ref_toks)]).float().mean())
    # distinct experts a decode step routes to, per layer (the calls after
    # the two prefill ones)
    distinct = [int(i.unique().numel()) for _, i in got_routes[2:]]
    out["compare_moe"] = rec = {
        "phase": "compare-moe", "gpu": card, "layers": 2, "positions": 9, "kv": "bf16",
        "logits_rel_err": rel, "logits_tol": SLICE_TOL, "greedy_agreement": agree,
        "routes": "the plain path follows the kernel path's routes (experts and weights)",
        "token_layer_routes": n_routes, "token_layer_routes_differing": differ,
        "router_prob_max_abs_diff": max(prob_diff),
        "decode_distinct_experts_per_layer": distinct, "k10_kernels": k10_parts}
    emit(rec)
    require(k10_parts == ["combine", "down", "gate_up"], f"compare-moe's K10 ran {k10_parts}")
    require(bool(torch.isfinite(got).all()), "non-finite logits at 2 layers")
    require(rel <= SLICE_TOL, f"kernel path vs plain path: rel {rel} > {SLICE_TOL}")
    del got, ref, params2, model, params, layers
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- moe-routes
    lp0 = post_init_params(build_params_tree(
        CheckpointReader(root), QuantizeConfig.from_pretrained(root), dev, layer_filter=0))
    routes = {}
    for N in (8, 1024):
        h = torch.randn((1, N, spec.hidden_size), generator=torch.Generator(dev).manual_seed(N),
                        device=dev).to(torch.bfloat16)
        ys = {}
        for name, env in MOE_ROUTES.items():  # "K10 rt" first: the default
            with mock.patch.dict(os.environ, {f"GPTQ_TPU_QMOE_{k}": v for k, v in env.items()}):
                mp = {"gate": lp0["mlp"]["gate"], "experts": list(lp0["mlp"]["experts"])}
                stack_moe_experts(spec, {"model": {"layers": [{"mlp": mp}]}})
                _build.reset_counts()
                with count_dense_fallback() as dense, torch.inference_mode():
                    ys[name] = transformer.moe_mlp(spec, mp, h)
                    torch.cuda.synchronize()
                launched = {k: v for k, v in _build.LAUNCHES.items() if v}
                reached = "dense" if dense[0] else "+".join(launched)
                routes[f"{name} N={N}"] = r = {
                    "env": env, "launched": launched, "dense_fallback_calls": dense[0],
                    "reached": reached,
                    "rel_vs_default": float((ys[name].float() - ys["K10 rt"].float()).norm()
                                            / ys["K10 rt"].float().norm())}
                require(r["rel_vs_default"] <= ROUTE_TOL, f"{name} N={N}: {r}")
                require(reached == MOE_ROUTE_REACHES[name][N > 128]
                        and dense[0] + sum(launched.values())
                        == (2 if reached == "qmoe_matmul" else 1),
                        f"{name} N={N}: {r}")
        if N == 8:  # the slot paths run only at most 1024 routed rows
            rel = lambda a, b: float((ys[a].float() - ys[b].float()).norm()
                                     / ys[b].float().norm())
            routes["K10 ic vs K11 f32, N=8"] = k10_ic_vs_k11 = rel("K10 ic", "K11 f32")
            routes["K10 ic vs K11 (bf16 y), N=8"] = rel("K10 ic", "K11")
            require(k10_ic_vs_k11 <= K10_IC_VS_K11, f"K10 ic vs K11: {k10_ic_vs_k11}")
        require(torch.equal(ys["K11"], ys["K12"]), f"K11 and K12 differ at N={N}")
    out["moe_routes"] = rec = {"phase": "moe-routes", "gpu": card, "layer": 0, "routes": routes}
    emit(rec)
    return out



def serve_timing(spec, params, ids, kv_quant, prefill_counts: dict,
                 step_counts: dict, classify=None) -> dict:
    """The served path through the engine, timed: one prefill (host clock
    with a synchronize), 40 decode steps after 2 of warm-up (CUDA events, and
    the host clock for the enqueue), then 4 steps under torch.profiler for
    the device's busy share and its time by kernel (and, with ``classify``,
    by the class it gives each kernel name). Asserts the launch counts
    of the prefill and of the timed steps, finite logits, and one decode step
    that makes no synchronizing call (``torch.cuda.set_sync_debug_mode``)."""
    import torch
    from torch.profiler import ProfilerActivity

    from gptqmodel_tpu_torch.inference.engine import (
        init_kv_cache, make_decode_fn, make_prefill_fn,
    )
    from gptqmodel_tpu_torch.ops import _build

    dev = torch.device("cuda")
    Bn, Tn = ids.shape
    caches = init_kv_cache(spec, Bn, Tn + NEW, torch.bfloat16, kv_quant, device=dev)
    prefill, decode = make_prefill_fn(spec), make_decode_fn(spec)
    ids_t = torch.as_tensor(ids, device=dev)
    lens = torch.full((Bn,), Tn, dtype=torch.long, device=dev)
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
            logits, caches, key_valid = decode(params, token, pos, Tn + s, key_valid, caches)
            finite.append(torch.isfinite(logits).all())
            token, pos = logits.argmax(-1), pos + 1
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        decode_ms = start.elapsed_time(end) / steps
        require(dict(_build.LAUNCHES) == {k: v * steps for k, v in step_counts.items()},
                f"decode {_build.LAUNCHES}")
        require(bool(torch.stack(finite).all()), "non-finite decode logits")
        slot = Tn + warm + steps  # at most T + 54 < T + NEW: three profiler sessions

        def profiled_steps():
            nonlocal token, pos, key_valid, slot
            for _ in range(n_prof):
                out, _, key_valid = decode(params, token, pos, slot, key_valid, caches)
                token, pos, slot = out.argmax(-1), pos + 1, slot + 1

        step_dev_ms, by_kernel = device_ms(
            profiled_steps, n_prof, (ProfilerActivity.CPU, ProfilerActivity.CUDA),
            uniform=False)
        # one more step with PyTorch's synchronization check raising: no value
        # of the step (the MoE routing plan included) waits on the host
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode(params, token, pos, slot, key_valid, caches)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "decode_host_ms_per_step": host_ms, "decode_tok_per_s": Bn / (decode_ms / 1e3),
        # device kernel time per step under the profiler, over the step timed
        # without it
        "device_ms_per_step": step_dev_ms, "device_busy_share": step_dev_ms / decode_ms,
        # the act-order x-column gathers: torch.index_select's kernels
        "device_ms_per_step_gather": sum(ms for k, ms in by_kernel
                                         if "scatter_gather" in k or "indexSelect" in k),
        "device_ms_per_step_by_kernel": [[k[:90], ms] for k, ms in by_kernel[:12]],
        **({"device_ms_per_step_by_class": classify(by_kernel)} if classify else {}),
    }


# Profiler sessions that lost kernel records: how many, and how many of those
# were read from the records they kept (see ``device_ms``)
PROFILER_SHORT = {"sessions": 0, "estimated": 0, "under_bound": 0}


def device_ms(run, per: int, activities=None, uniform: bool = True) -> tuple[float, list]:
    """Kernel time on the device per ``per`` calls made by ``run()``
    under torch.profiler (CUDA activity unless ``activities`` says more), in
    all and by kernel name. CUPTI now and then loses records: all of a
    session's (one to four sessions in a run of this script on an H100, once
    three in a row), one K8 record in most sessions on some machines,
    whatever the pause around the launches, or most of a 2 ms loop's (K3
    read 0.0032 ms at o, M = 8, under its byte bound). A session with fewer
    records than calls is run again: at most three that held some and six
    that held none. With ``uniform`` every call launches the same kernels,
    so each kernel's count must also be a multiple of ``per``; a machine
    that loses records loses them in most sessions, so the second short
    session that holds records (or one after two that held none) is read as
    each kernel's mean time over the records kept times its launches per call,
    ``ceil(count / per)``, which is the sum over ``per`` when none was lost.
    A decode step is not uniform (a few of its kernels launch on some steps
    only), so its sessions are held to the count of calls alone and read as
    the sum over ``per``. Never replaced by another clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    held = empty = 0  # earlier sessions of this call with too few records, with none
    while held < 3 and empty < 6:
        with profile(activities=list(activities or (ProfilerActivity.CUDA,))) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        n = sum(e.count for e in kernels)
        short = n < per or (uniform and any(e.count % per for e in kernels))
        if kernels and (not short or (uniform and (held or empty >= 2))):
            PROFILER_SHORT["estimated"] += short
            launches = (lambda c: -(-c // per)) if uniform else (lambda c: c / per)
            rows = sorted(((e.key, e.self_device_time_total / 1e3 / e.count
                            * launches(e.count)) for e in kernels), key=lambda kv: -kv[1])
            return sum(ms for _, ms in rows), rows
        PROFILER_SHORT["sessions"] += 1
        held, empty = held + bool(kernels), empty + (not kernels)
        print(f"chip_smoke: profiler session held {n} kernel records for {per} calls "
              f"({', '.join(str(e.count) for e in kernels)} by kernel)", file=sys.stderr)
    raise CheckFailed(f"torch.profiler recorded fewer kernels than calls in {held} sessions "
                      f"and none in {empty}")


def timed(fn, n_copies: int, budget_ms: float = 150.0, floor_ms: float = 0.0) -> dict:
    """Device time per call (``ms``: torch.profiler, kernels only), wall
    time per call (``wall_ms``: CUDA events around the loop, host launch
    gaps included), the names of the kernels the profiler saw and their
    (name, ms per call) rows. A reading
    under ``floor_ms`` (the work's bound: lost records) is rejected and the
    loop timed again; a third such reading fails."""
    import torch

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

    for _ in range(3):
        ms, rows = device_ms(loop, iters)
        if ms >= floor_ms:
            return {"ms": ms, "wall_ms": start.elapsed_time(end) / iters,
                    "kernels": [name for name, _ in rows], "rows": rows}
        PROFILER_SHORT["under_bound"] += 1
        print(f"chip_smoke: {ms} ms a call is under the bound of {floor_ms} ms: timed again",
              file=sys.stderr)
    raise CheckFailed(f"three readings under the bound of {floor_ms} ms")


def on_decode_kernel(names: list) -> bool:
    """Whether every kernel the profiler saw is an instantiation of the
    decode kernel (``csrc/qmm_decode.cuh``)."""
    return bool(names) and all("qmm_decode_kernel<" in n for n in names)


def k10_pass(name: str) -> str:
    """The part of K10 a kernel name belongs to: its gate|up or down pass on
    the decode ring (``qmm_decode_kernel`` with ``MoeGateUp`` or
    ``MoeDown``), its combine, or none of them (K11-K13's ring passes,
    ``SLOT_PASSES``, among them)."""
    if "qmm_decode_kernel<" in name and "MoeGateUp" in name:
        return "gate_up"
    if "qmm_decode_kernel<" in name and "MoeDown" in name:
        return "down"
    return "combine" if "qmoe_combine_kernel" in name else "other"


def by_k10_pass(rows) -> dict:
    """Device ms of (kernel name, ms) rows summed by ``k10_pass``."""
    out = {}
    for name, ms in rows:
        out[k10_pass(name)] = out.get(k10_pass(name), 0.0) + ms
    return out


def errors(y, ref) -> tuple[float, float]:
    """Relative error in norm and largest absolute error."""
    d = y.float() - ref.float()
    return float(d.norm() / ref.float().norm()), float(d.abs().max())

def int4pack_library() -> tuple[bool, str]:
    """Whether this torch has the int4 yardstick, and its name in the records."""
    import torch

    has = all(hasattr(torch, f) for f in ("_weight_int4pack_mm", "_convert_weight_to_int4pack"))
    return has, ("torch._weight_int4pack_mm on a torch._convert_weight_to_int4pack copy"
                 if has else "null: this torch has no _weight_int4pack_mm")

def int4pack(qweight, scales, zc):
    """tinygemm's copy of 4-bit weights, w = (q - 8) * s + z: with the zero
    point ``zc`` (a number, or K3's [G, N] zeros), z = (8 - zc) * s."""
    import torch

    from gptqmodel_tpu_torch.ops.pack import unpack_qweight

    codes = unpack_qweight(qweight, 4).t().contiguous()  # [N, K]
    w_u8 = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)
    s = scales.float()
    return (torch._convert_weight_to_int4pack(w_u8, 8),
            torch.stack([s, (8.0 - zc) * s], dim=2).to(torch.bfloat16))

def copies_for(n_bytes: int) -> int:
    """Weight copies to rotate through so that a call finds its weights
    out of the L2: together at least three times its size."""
    return max(3, math.ceil(3 * L2_BYTES / n_bytes))


def k3_kernel_cases(dev, rng, shapes: dict) -> list:
    """K3 against its plain version at Llama-3-8B's projections (``shapes``:
    proj -> K, N), 4-bit at K3_MS and 2- and 8-bit at the sizes
    ``K3_EXTRA_BITS`` names, group 128, random per-group zeros; two runs each
    for equal bits, the weights rotated through copies past the L2, and
    ``torch._weight_int4pack_mm`` with the zeros folded into its
    scales-and-zeros as the yardstick at 4 bits. K1 is timed beside it on
    the same qweight and scales (``zero_const = 8``; its result is not
    K3's), the control of the same kernel without zeros: the decode kernel
    at M <= 16, the same tile at prefill."""
    import torch

    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.ops.pack import unpack_qzeros
    from gptqmodel_tpu_torch.ops.qmatmul import qmatmul, qmatmul_asym, qmatmul_asym_plain
    from gptqmodel_tpu_torch.ops.registry import post_init_module
    from gptqmodel_tpu_torch.utils.testing import random_quant_linear

    has_int4pack, library = int4pack_library()
    cases = []
    for proj, (K, N) in shapes.items():
        for bits in (4, *K3_EXTRA_BITS.get(proj, ())):
            base = post_init_module(random_quant_linear(rng, K, N, bits, device=dev, sym=False))
            require(base.zero_const < 0, "K3 case with one zero point")
            wbytes = base.qweight.nbytes + base.scales.nbytes + base.qzeros.nbytes
            mods = [base] + [dataclasses.replace(base, qweight=base.qweight.clone(),
                                                 scales=base.scales.clone(),
                                                 qzeros=base.qzeros.clone())
                             for _ in range(copies_for(wbytes) - 1)]
            lib_w = ([int4pack(m.qweight, m.scales, unpack_qzeros(m.qzeros, 4).float())
                      for m in mods] if has_int4pack and bits == 4 else None)
            for M in (K3_MS if bits == 4 else (B,)):
                x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(
                    dev).to(torch.bfloat16)
                kw = dict(bits=bits, group_size=128)
                ops = lambda i: (x, mods[i].qweight, mods[i].scales, mods[i].qzeros)
                before = _build.LAUNCHES["qmatmul_asym"]
                y, y2 = qmatmul_asym(*ops(0), **kw), qmatmul_asym(*ops(0), **kw)
                ref = qmatmul_asym_plain(*ops(0), **kw)
                torch.cuda.synchronize()
                require(_build.LAUNCHES["qmatmul_asym"] == before + 2, "K3 did not launch")
                identical = torch.equal(y, y2)
                rel, mx = errors(y, ref)
                b_ms, b_by = bound(x.nbytes + wbytes + y.nbytes, 2.0 * M * N * K)
                k1_b = bound(x.nbytes + wbytes - base.qzeros.nbytes + y.nbytes,
                             2.0 * M * N * K)[0]
                k = timed(lambda i: qmatmul_asym(*ops(i), **kw), len(mods), floor_ms=b_ms)
                k1 = timed(lambda i: qmatmul(x, mods[i].qweight, mods[i].scales, bits=bits,
                                             group_size=128, zero_const=8.0), len(mods),
                           floor_ms=k1_b)
                pl_ = timed(lambda i: qmatmul_asym_plain(*ops(i), **kw), len(mods),
                            budget_ms=100.0)
                lib, lib_rel = None, None
                if lib_w is not None:
                    lib = timed(lambda i: torch._weight_int4pack_mm(x, lib_w[i][0], 128,
                                                                    lib_w[i][1]), len(mods))
                    lib_rel = errors(torch._weight_int4pack_mm(x, lib_w[0][0], 128,
                                                               lib_w[0][1]), ref)[0]
                case = {"kernel": "qmatmul_asym", "proj": proj, "bits": bits, "M": M, "K": K,
                        "N": N, "rel_err": rel, "max_abs_err": mx, "identical_runs": identical,
                        "ms": k["ms"], "wall_ms": k["wall_ms"], "k1_ms": k1["ms"],
                        "plain_ms": pl_["ms"], "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib["ms"] if lib else None,
                        "library": (library if bits == 4 else
                                    "null: torch._weight_int4pack_mm takes 4-bit weights"),
                        "library_rel_err": lib_rel, "plain_wall_ms": pl_["wall_ms"],
                        "library_wall_ms": lib["wall_ms"] if lib else None,
                        "weight_copies": len(mods)}
                cases.append(case)
                emit({"phase": "kernels", **case})
                require(rel <= K3_TOL, f"K3 {proj} {bits}-bit M={M}: rel {rel} > {K3_TOL}")
                require(identical, f"K3 {proj} {bits}-bit M={M}: two runs differ")
            del base, mods, lib_w
    return cases


def k6_kernel_cases(dev, rng, shapes: dict) -> list:
    """K6 against its plain version at Llama-3-8B's projections (``shapes``:
    proj -> K, N): 4-bit at ``K6_MS`` for each of ``K6_GROUPS``, 2- and
    8-bit at the sizes ``K6_EXTRA_BITS`` names (group 32, symmetric); two
    runs each for equal bits, the weights rotated through copies past the
    L2, and ``torch._weight_int4pack_mm`` at the same group size, the zeros
    folded into its scales-and-zeros, as the yardstick at 4 bits where it
    takes that group. At M <= 16 every call must run the decode kernel's
    ``DequantFirst`` instantiation (the profiler's kernel names). Then, per
    projection at group 32, the route that the prefill's ``K6_REF_M`` rows
    take (dequantize to bf16, then the product), timed for the record."""
    import torch

    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.ops.pack import unpack_qzeros
    from gptqmodel_tpu_torch.ops.qlinear import qlinear_forward_torch
    from gptqmodel_tpu_torch.ops.qmatmul import DECODE_MAX_M, qmm, qmm_plain
    from gptqmodel_tpu_torch.ops.registry import kernel_route, post_init_module
    from gptqmodel_tpu_torch.utils.testing import random_quant_linear

    has_int4pack, library = int4pack_library()
    cases = []
    for proj, (K, N) in shapes.items():
        variants = [(4, g, sym) for g, sym in K6_GROUPS]
        variants += [(bits, 32, True) for bits in K6_EXTRA_BITS.get(proj, ())]
        for bits, g, sym in variants:
            base = post_init_module(random_quant_linear(rng, K, N, bits, g, device=dev, sym=sym))
            require(kernel_route(base) == "K6" and (base.zero_const >= 0) == sym,
                    f"K6 case {proj} {bits}-bit g={g} sym={sym} off K6's route")
            # a symmetric module's zeros are not read: its one zero point is
            wbytes = base.qweight.nbytes + base.scales.nbytes + (0 if sym else base.qzeros.nbytes)
            mods = [base] + [dataclasses.replace(base, qweight=base.qweight.clone(),
                                                 scales=base.scales.clone(),
                                                 qzeros=base.qzeros.clone())
                             for _ in range(copies_for(wbytes) - 1)]
            zeros = lambda m: m.zero_const if sym else unpack_qzeros(m.qzeros, 4).float()
            lib_w = ([int4pack(m.qweight, m.scales, zeros(m)) for m in mods]
                     if has_int4pack and bits == 4 and g in INT4PACK_GROUPS else None)
            kw = dict(bits=bits, group_size=g, zero_const=base.zero_const)
            ops = lambda i: (x, mods[i].qweight, mods[i].scales, mods[i].qzeros)
            for M in (K6_MS if bits == 4 else (B,)):
                x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(
                    dev).to(torch.bfloat16)
                before = _build.LAUNCHES["qmm"]
                y, y2 = qmm(*ops(0), **kw), qmm(*ops(0), **kw)
                ref = qmm_plain(*ops(0), **kw)
                torch.cuda.synchronize()
                require(_build.LAUNCHES["qmm"] == before + 2, "K6 did not launch")
                identical = torch.equal(y, y2)
                rel, mx = errors(y, ref)
                b_ms, b_by = bound(x.nbytes + wbytes + y.nbytes, 2.0 * M * N * K)
                k = timed(lambda i: qmm(*ops(i), **kw), len(mods), floor_ms=b_ms)
                pl_ = timed(lambda i: qmm_plain(*ops(i), **kw), len(mods), budget_ms=100.0)
                lib, lib_rel = None, None
                if lib_w is not None:
                    lib = timed(lambda i: torch._weight_int4pack_mm(x, lib_w[i][0], g,
                                                                    lib_w[i][1]), len(mods))
                    lib_rel = errors(torch._weight_int4pack_mm(x, lib_w[0][0], g, lib_w[0][1]),
                                     ref)[0]
                case = {"kernel": "qmm", "proj": proj, "bits": bits, "group_size": g,
                        "sym": sym, "M": M, "K": K, "N": N, "rel_err": rel, "max_abs_err": mx,
                        "identical_runs": identical, "ms": k["ms"], "wall_ms": k["wall_ms"],
                        "kernel_names": k["kernels"],
                        "plain_ms": pl_["ms"], "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib["ms"] if lib else None,
                        "library": (library if bits == 4 and g in INT4PACK_GROUPS else
                                    "null: torch._weight_int4pack_mm takes 4-bit weights"
                                    if bits != 4 else
                                    "null: torch._weight_int4pack_mm takes groups of 32 to 256"),
                        "library_rel_err": lib_rel, "plain_wall_ms": pl_["wall_ms"],
                        "library_wall_ms": lib["wall_ms"] if lib else None,
                        "weight_copies": len(mods)}
                cases.append(case)
                emit({"phase": "kernels", **case})
                require(rel <= K6_TOL, f"K6 {proj} {bits}-bit g={g} sym={sym} M={M}: "
                        f"rel {rel} > {K6_TOL}")
                require(identical, f"K6 {proj} {bits}-bit g={g} sym={sym} M={M}: two runs differ")
                require(M > DECODE_MAX_M or (on_decode_kernel(k["kernels"]) and
                                             all("DequantFirst" in n for n in k["kernels"])),
                        f"K6 {proj} {bits}-bit g={g} sym={sym} M={M} ran {k['kernels']}")
            if (bits, g, sym) == (4, 32, True):
                x = torch.from_numpy(rng.standard_normal((K6_REF_M, K), dtype=np.float32)).to(
                    dev).to(torch.bfloat16)
                r = timed(lambda i: qlinear_forward_torch(mods[i], x), len(mods),
                          budget_ms=100.0)
                b_ms, b_by = bound(x.nbytes + wbytes + 2 * K6_REF_M * N,
                                   2.0 * K6_REF_M * N * K)
                case = {"kernel": "reference", "proj": proj, "bits": 4, "group_size": g,
                        "sym": True, "M": K6_REF_M, "K": K, "N": N, "ms": r["ms"],
                        "wall_ms": r["wall_ms"], "bound_ms": b_ms, "bound_by": b_by,
                        "route": "dequantize to bf16, then torch.matmul (no kernel of the port)"}
                cases.append(case)
                emit({"phase": "kernels", **case})
            del base, mods, lib_w
    torch.cuda.empty_cache()
    return cases


def k7_kernel_cases(dev, rng, shapes: dict) -> list:
    """K7 against its plain version at K3's projections and sizes (4-bit,
    group 128, one zero point), twice each for equal bits, the weights
    rotated through copies past the L2; K1 and ``torch._weight_int4pack_mm``
    timed in the same call on the same weights."""
    import torch

    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.ops.qmatmul import qmatmul, qmatmul_fused, qmatmul_fused_plain
    from gptqmodel_tpu_torch.ops.registry import post_init_module
    from gptqmodel_tpu_torch.utils.testing import random_quant_linear

    has_int4pack, library = int4pack_library()
    cases = []
    for proj, (K, N) in shapes.items():
        base = post_init_module(random_quant_linear(rng, K, N, 4, device=dev))
        wbytes = base.qweight.nbytes + base.scales.nbytes
        mods = [base] + [dataclasses.replace(base, qweight=base.qweight.clone(),
                                             scales=base.scales.clone())
                         for _ in range(copies_for(wbytes) - 1)]
        lib_w = ([int4pack(m.qweight, m.scales, base.zero_const) for m in mods]
                 if has_int4pack else None)
        kw = dict(bits=4, group_size=128, zero_const=base.zero_const)
        ops = lambda i: (x, mods[i].qweight, mods[i].scales)
        for M in K7_MS:
            x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(dev).to(
                torch.bfloat16)
            before = _build.LAUNCHES["qmatmul_fused"]
            y, y2 = qmatmul_fused(*ops(0), **kw), qmatmul_fused(*ops(0), **kw)
            ref = qmatmul_fused_plain(*ops(0), **kw)
            torch.cuda.synchronize()
            require(_build.LAUNCHES["qmatmul_fused"] == before + 2, "K7 did not launch")
            identical = torch.equal(y, y2)
            rel, mx = errors(y, ref)
            b_ms, b_by = bound(x.nbytes + wbytes + y.nbytes, 2.0 * M * N * K)
            k = timed(lambda i: qmatmul_fused(*ops(i), **kw), len(mods), floor_ms=b_ms)
            k1 = timed(lambda i: qmatmul(*ops(i), **kw), len(mods), floor_ms=b_ms)
            pl_ = timed(lambda i: qmatmul_fused_plain(*ops(i), **kw), len(mods),
                        budget_ms=100.0)
            lib = None
            if lib_w is not None:
                lib = timed(lambda i: torch._weight_int4pack_mm(x, lib_w[i][0], 128,
                                                                lib_w[i][1]), len(mods))
            case = {"kernel": "qmatmul_fused", "proj": proj, "M": M, "K": K, "N": N,
                    "rel_err": rel, "max_abs_err": mx, "identical_runs": identical,
                    "ms": k["ms"], "wall_ms": k["wall_ms"], "k1_ms": k1["ms"],
                    "plain_ms": pl_["ms"], "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib["ms"] if lib else None, "library": library,
                    "plain_wall_ms": pl_["wall_ms"], "weight_copies": len(mods)}
            cases.append(case)
            emit({"phase": "kernels", **case})
            require(rel <= K7_TOL, f"K7 {proj} M={M}: rel {rel} > {K7_TOL}")
            require(identical, f"K7 {proj} M={M}: two runs differ")
        del base, mods, lib_w
    torch.cuda.empty_cache()
    return cases


def g32_phases(root: Path, card: str) -> dict:
    """``g32-slice`` and ``compare-g32``: a GPTQ checkpoint at Llama-3-8B's
    published widths and all 32 layers at group 32 (4-bit, symmetric, dense
    lm_head; random weights drawn on the card from the seed, about 6.1 GB)
    through ``slice_phase``; then its first 2 layers and those of a 2-layer
    checkpoint at group 64 with ``sym=False``, each kernel path against the
    plain path over a prefill and 8 decode steps of B = 8 rows (the
    prefill's 1024 rows take the reference route in both, so the decode
    steps are what holds K6 to its plain version)."""
    import torch

    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.ops.registry import kernel_route
    from gptqmodel_tpu_torch.utils.testing import LLAMA3_8B_CONFIG

    cfg = LLAMA3_8B_CONFIG
    L = cfg["num_hidden_layers"]
    none = dict.fromkeys(_build.LAUNCHES, 0)
    prefill = none | {"reference": 4 * L}  # B x T = 1024 rows: above PALLAS_MAX_M
    step = none | {"qmm": 4 * L}  # fused qkv, o, fused gate_up, down
    ids = np.random.default_rng([SEED, 8]).integers(0, cfg["vocab_size"], (B, T))
    model, rec = slice_phase(
        root, card, "g32-slice", ids, {"bits": 4, "group_size": 32, "sym": True},
        lambda m: m.group_size == 32 and m.zero_const >= 0 and kernel_route(m) == "K6",
        prefill, step)
    out = {"g32_slice": rec}
    cmp = {"sym_g32": compare_layers(model.spec, model.params, ids)}
    # the same at all 32 layers, for the record: whether the plain path
    # picks the kernel path's greedy tokens through the whole model
    full = compare_layers(model.spec, model.params, ids, layers=L)
    require(full["counts"] == none | {"reference": 4 * L, "qmm": 4 * L * (full["positions"] - 1)},
            f"compare-g32 at {L} layers launched {full['counts']}")
    del model
    torch.cuda.empty_cache()
    cmp["asym_g64"] = compare_checkpoint(
        root, ids, "asym-g64", SEED + 2, {"group_size": 64, "sym": False},
        lambda m: m.group_size == 64 and m.zero_const < 0 and kernel_route(m) == "K6")
    want = {name: {"reference": 4 * 2, "qmm": 4 * 2 * (c["positions"] - 1)}  # K6 at every step
            for name, c in cmp.items()}
    out["compare_g32"] = compare_phase(card, "compare-g32", cmp, want,
                                       all_layers_unchecked=full)
    return out


def llama_shapes() -> dict:
    """Llama-3-8B's four projections: name -> (K, N)."""
    from gptqmodel_tpu_torch.utils.testing import LLAMA3_8B_CONFIG as C

    D, F = C["hidden_size"], C["intermediate_size"]
    qkv_n = (C["num_attention_heads"] + 2 * C["num_key_value_heads"]) * (
        D // C["num_attention_heads"])
    return {"qkv": (D, qkv_n), "o": (D, D), "gate_up": (D, 2 * F), "down": (F, D)}


def planes_variants(shapes: dict, stitched_ms, planar_ms) -> list:
    """K4's and K5's cases as (proj, bits, planar, sym, Ms): 3-bit stitched
    at every projection of ``shapes``, the layouts of ``PLANE_LAYOUTS`` at
    qkv."""
    variants = [(proj, 3, False, sym, stitched_ms) for proj in shapes for sym in (True, False)]
    return variants + [("qkv", bits, planar, sym, planar_ms) for bits, planar in PLANE_LAYOUTS
                       for sym in (True, False)]


def planes_inputs(dev, rng, K: int, N: int, bits: int, planar: bool, sym: bool) -> dict:
    """K4's (``sym``) or K5's weights at one shape from ``rng``, group 128
    (``random_quant_linear``; K5 with random zeros per group and column),
    rotated through copies past the L2: the route, the wrapper and its plain
    version, the module, the bytes of weights a call reads (a symmetric
    module's zeros are not read: its one zero point is), the copies, the
    keyword arguments and ``ops(x, i)``, the operands on copy i."""
    from gptqmodel_tpu_torch.ops import qmatmul as qm
    from gptqmodel_tpu_torch.ops.registry import post_init_module
    from gptqmodel_tpu_torch.utils.testing import random_quant_linear

    base = post_init_module(random_quant_linear(rng, K, N, bits, device=dev, sym=sym,
                                                planar=planar))
    wbytes = base.qweight.nbytes + base.scales.nbytes + (0 if sym else base.qzeros.nbytes)
    mods = [base] + [dataclasses.replace(base, qweight=base.qweight.clone(),
                                         scales=base.scales.clone(), qzeros=base.qzeros.clone())
                     for _ in range(copies_for(wbytes) - 1)]
    kw = dict(bits=bits, group_size=128, planar=planar)
    if sym:
        kw["zero_const"] = base.zero_const
        return {"route": "K4", "name": "qmatmul_planes", "fn": qm.qmatmul_planes,
                "plain": qm.qmatmul_planes_plain, "module": base, "wbytes": wbytes,
                "copies": mods, "kw": kw,
                "ops": lambda x, i: (x, mods[i].qweight, mods[i].scales)}
    return {"route": "K5", "name": "qmatmul_planes_asym", "fn": qm.qmatmul_planes_asym,
            "plain": qm.qmatmul_planes_asym_plain, "module": base, "wbytes": wbytes,
            "copies": mods, "kw": kw,
            "ops": lambda x, i: (x, mods[i].qweight, mods[i].scales, mods[i].qzeros)}


def planes_kernel_cases(dev, rng, shapes: dict) -> list:
    """K4 and K5 against their plain versions at Llama-3-8B's projections
    (``shapes``: proj -> K, N), 3-bit stitched at PLANES_MS, and the planar
    layouts of ``PLANE_LAYOUTS`` at qkv, M = 8 (``planes_variants``, inputs
    from ``planes_inputs``); two runs each for equal bits. At M <= 16 every
    call must run the decode kernel's ``Units`` instantiation (the
    profiler's kernel names). No PyTorch call takes 3/5/6/7-bit weights, so
    there is no library time; the reference route (dequantize to bf16, then
    ``torch.matmul``) is timed at ``PLANES_REF_M`` rows on the symmetric
    3-bit weights, for the record."""
    import torch

    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.ops.qlinear import qlinear_forward_torch
    from gptqmodel_tpu_torch.ops.qmatmul import DECODE_MAX_M
    from gptqmodel_tpu_torch.ops.registry import kernel_route

    cases = []
    for proj, bits, planar, sym, ms in planes_variants(shapes, PLANES_MS, (B,)):
        K, N = shapes[proj]
        c = planes_inputs(dev, rng, K, N, bits, planar, sym)
        route, name, fn, plain, kw = c["route"], c["name"], c["fn"], c["plain"], c["kw"]
        base, mods, wbytes = c["module"], c["copies"], c["wbytes"]
        require(kernel_route(base) == route and base.planar == planar,
                f"{route} case {proj} {bits}-bit planar={planar} off its route")
        ops = lambda i: c["ops"](x, i)
        for M in ms:
            x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(dev).to(
                torch.bfloat16)
            before = _build.LAUNCHES[name]
            y, y2 = fn(*ops(0), **kw), fn(*ops(0), **kw)
            ref = plain(*ops(0), **kw)
            torch.cuda.synchronize()
            require(_build.LAUNCHES[name] == before + 2, f"{route} did not launch")
            identical = torch.equal(y, y2)
            rel, mx = errors(y, ref)
            b_ms, b_by = bound(x.nbytes + wbytes + y.nbytes, 2.0 * M * N * K)
            k = timed(lambda i: fn(*ops(i), **kw), len(mods), floor_ms=b_ms)
            pl_ = timed(lambda i: plain(*ops(i), **kw), len(mods), budget_ms=100.0)
            case = {"kernel": name, "proj": proj, "bits": bits, "planar": planar, "sym": sym,
                    "M": M, "K": K, "N": N, "rel_err": rel, "max_abs_err": mx,
                    "identical_runs": identical, "ms": k["ms"], "wall_ms": k["wall_ms"],
                    "kernel_names": k["kernels"],
                    "plain_ms": pl_["ms"], "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None,
                    "library": "none exists: no PyTorch call takes 3/5/6/7-bit weights",
                    "plain_wall_ms": pl_["wall_ms"], "weight_copies": len(mods)}
            cases.append(case)
            emit({"phase": "kernels", **case})
            tol = K4_TOL if sym else K5_TOL
            require(rel <= tol, f"{route} {proj} {bits}-bit planar={planar} M={M}: "
                    f"rel {rel} > {tol}")
            require(identical, f"{route} {proj} {bits}-bit planar={planar} M={M}: "
                    "two runs differ")
            require(M > DECODE_MAX_M or (on_decode_kernel(k["kernels"]) and
                                         all("Units" in n for n in k["kernels"])),
                    f"{route} {proj} {bits}-bit planar={planar} M={M} ran {k['kernels']}")
        if (bits, planar, sym) == (3, False, True):
            x = torch.from_numpy(rng.standard_normal((PLANES_REF_M, K), dtype=np.float32)).to(
                dev).to(torch.bfloat16)
            r = timed(lambda i: qlinear_forward_torch(mods[i], x), len(mods), budget_ms=100.0)
            b_ms, b_by = bound(x.nbytes + wbytes + 2 * PLANES_REF_M * N,
                               2.0 * PLANES_REF_M * N * K)
            case = {"kernel": "reference", "proj": proj, "bits": 3, "planar": False,
                    "sym": True, "M": PLANES_REF_M, "K": K, "N": N, "ms": r["ms"],
                    "wall_ms": r["wall_ms"], "bound_ms": b_ms, "bound_by": b_by,
                    "route": "dequantize to bf16, then torch.matmul (no kernel of the port)"}
            cases.append(case)
            emit({"phase": "kernels", **case})
        del c, base, mods
    torch.cuda.empty_cache()
    return cases


def planes_phases(root: Path, card: str) -> dict:
    """``planes-slice`` and ``compare-planes``: a 3-bit GPTQ v1 checkpoint
    at Llama-3-8B's published widths and all 32 layers (symmetric, group 128,
    stitched words, dense lm_head; random weights drawn on the card from the
    seed, about 4.8 GB) through ``slice_phase``, every projection on K4; then
    its first 2 layers and the 2-layer checkpoints of ``PLANE_COMPARES`` (K5
    after the act-order gather, K4 on planar words, K5 over three planes),
    each generated 8 tokens (counted) and held, kernel path against plain
    path, within 1e-2."""
    import torch

    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.ops.registry import kernel_route
    from gptqmodel_tpu_torch.utils.testing import LLAMA3_8B_CONFIG

    cfg = LLAMA3_8B_CONFIG
    L = cfg["num_hidden_layers"]
    k4 = dict.fromkeys(_build.LAUNCHES, 0) | {"qmatmul_planes": 4 * L}  # qkv, o, gate_up, down
    ids = np.random.default_rng([SEED, 9]).integers(0, cfg["vocab_size"], (B, T))
    model, rec = slice_phase(
        root, card, "planes-slice", ids,
        {"bits": 3, "group_size": 128, "sym": True, "format": "gptq"},
        lambda m: m.bits == 3 and not m.planar and kernel_route(m) == "K4", k4, k4)
    out = {"planes_slice": rec}
    cmp = {"3bit_sym": compare_layers(model.spec, model.params, ids) | {"kernel": "qmatmul_planes"}}
    del model
    torch.cuda.empty_cache()
    for i, (name, (bits, fmt, sym, act, kernel)) in enumerate(PLANE_COMPARES.items()):
        route = "K4" if sym else "K5"

        def module_ok(m, bits=bits, fmt=fmt, act=act, route=route):
            return (m.bits == bits and m.planar == (fmt == "gptq_p")
                    and (m.act_perm is not None) == act and kernel_route(m) == route)

        cmp[name] = compare_checkpoint(
            root, ids, name, SEED + 3 + i,
            {"bits": bits, "format": fmt, "sym": sym, "desc_act": act}, module_ok,
            generate_kernel=kernel) | {"kernel": kernel}
    want = {name: {c["kernel"]: 4 * 2 * c["positions"]}  # 4 per layer, prefill and each step
            for name, c in cmp.items()}
    out["compare_planes"] = compare_phase(card, "compare-planes", cmp, want)
    return out


def fused_phase(model, ids, card: str) -> dict:
    """``fused``: the llama slice's model again under ``GPTQ_TPU_RT_FUSED=1``:
    ``generate(ids, FUSED_NEW)`` at all its layers (4 K7 per layer in the
    prefill, 2 K7 and 1 K2 per layer in each decode step, no K1), the
    served path timed as in ``slice``, and its first 2 layers, kernel path
    against plain path, within 1e-2."""
    from gptqmodel_tpu_torch.ops import _build

    spec, params = model.spec, model.params
    L = spec.num_layers
    none = dict.fromkeys(_build.LAUNCHES, 0)
    prefill = none | {"qmatmul_fused": 4 * L}
    step = none | {"qmatmul_fused": 2 * L, "qmlp": L}
    with mock.patch.dict(os.environ, {"GPTQ_TPU_RT_FUSED": "1"}):
        _build.reset_counts()
        t0 = time.perf_counter()
        tokens = model.generate(ids, max_new_tokens=FUSED_NEW)
        generate_s = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        want = {k: prefill[k] + (FUSED_NEW - 1) * step[k] for k in step}
        require(counts == want, f"fused generate launched {counts}, expected {want}")
        require(tokens.shape == (B, FUSED_NEW)
                and ((tokens >= 0) & (tokens < spec.vocab_size)).all(),
                f"fused: tokens {tokens.shape}")
        timing = serve_timing(spec, params, ids, False, prefill, step)
        cmp = compare_layers(spec, params, ids)
    rec = {"phase": "fused", "gpu": card, "env": {"GPTQ_TPU_RT_FUSED": "1"}, "layers": L,
           "B": B, "T": T, "new_tokens": FUSED_NEW, "kv": "bf16", "generate_s": generate_s,
           "generate_counts": counts, "prefill_counts": prefill,
           "decode_counts_per_step": step, "tokens_first_row": tokens[0].tolist(), **timing,
           "compare": cmp}
    emit(rec)
    per_run = none | {"qmatmul_fused": 4 * 2 + 2 * 2 * (cmp["positions"] - 1),
                      "qmlp": 2 * (cmp["positions"] - 1)}
    require(cmp["counts"] == per_run, f"fused compare launched {cmp['counts']}")
    require(cmp["logits_rel_err"] <= SLICE_TOL,
            f"fused compare: rel {cmp['logits_rel_err']} > {SLICE_TOL}")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from gptqmodel_tpu_torch import GPTQModel
    from gptqmodel_tpu_torch.device import gpu_info
    from gptqmodel_tpu_torch.models.optimize import _concat_quant
    from gptqmodel_tpu_torch.ops import _build
    from gptqmodel_tpu_torch.ops.qmatmul import (
        DECODE_MAX_M, KERNEL_BITS, PLANE_BITS, qmatmul, qmatmul_plain,
    )
    from gptqmodel_tpu_torch.ops.qmlp import qmlp, qmlp_plain
    from gptqmodel_tpu_torch.ops.gptq_solve import (
        gptq_block_inner, gptq_block_inner_plain, gptq_whole_solve, gptq_whole_solve_plain,
    )
    from gptqmodel_tpu_torch.ops.registry import post_init_module
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
    lib_path = _build.build()  # always, so that the phase reports this run's nvcc
    smem_of = _build.lib().gqt_decode_smem_bytes  # the header's own sizes
    info = _build.BUILD_INFO
    kernels_ptxas = ptxas_summary(info["ptxas"])
    require(kernels_ptxas, "ptxas reported no kernel")
    decode_kernels = sorted(k for k in kernels_ptxas if k.startswith("qmm_decode_kernel<"))
    # K1 and K2's down pass (UniformZero) and K2's gate/up pass (GateUpPairs)
    # at M <= 16, in place of K1's and K2's old 16-row tiles
    for bits in KERNEL_BITS:
        for nt in (1, 2):
            for z in ("UniformZero", "GateUpPairs"):
                require(f"qmm_decode_kernel<{bits},{nt},{z},0>" in decode_kernels,
                        f"no {bits}-bit {z} decode kernel for {8 * nt} rows in the build")
    # K6 at M <= 16 (its groups dividing 128): DequantFirst over either zeros
    for bits in KERNEL_BITS:
        for nt in (1, 2):
            for z in ("UniformZero", f"GroupZeros,{bits}"):
                require(f"qmm_decode_kernel<{bits},{nt},DequantFirst,{z},0>" in decode_kernels,
                        f"no {bits}-bit K6 decode kernel on {z} for {8 * nt} rows in the build")
    # K10's passes on the ring at every bm (n-tiles 1-4), rt and ic, and
    # K11's, K12's and K13's (ic); no qmoe_pass_kernel at all
    for bits in KERNEL_BITS:
        for nt in (1, 2, 3, 4):
            for z in ("MoeGateUp", "MoeDown"):
                for zeros in ("UniformZero", "DequantFirst,UniformZero"):
                    require(f"qmm_decode_kernel<{bits},{nt},{z},{zeros},0>" in decode_kernels,
                            f"no {bits}-bit K10 {z} on {zeros} for {8 * nt} rows in the build")
            for z in SLOT_PASSES:
                require(f"qmm_decode_kernel<{bits},{nt},{z},DequantFirst,UniformZero,0>"
                        in decode_kernels, f"no {bits}-bit K11-K13 {z} for {8 * nt} rows")
    old_pass = [k for k in kernels_ptxas if k.startswith("qmoe_pass_kernel<")]
    require(not old_pass, f"qmoe_pass_kernel is still built: {old_pass}")
    # K4 and K5 at M <= 16: Units over either zeros, at every layout
    for bits, planar in ((3, False), *PLANE_LAYOUTS):
        for nt in (1, 2):
            for z in ("UniformZero", f"PlaneZeros,{bits},{int(planar)}"):
                require(f"qmm_decode_kernel<{bits},{nt},Units,{int(planar)},{z},0>"
                        in decode_kernels,
                        f"no {bits}-bit planar={planar} K4/K5 decode kernel on {z} for "
                        f"{8 * nt} rows in the build")
    old_tile = (r"qmatmul_kernel<\d,1,1,UniformZero(,0)?>|qmlp_gate_up_kernel<\d,1>"
                r"|qmm_kernel<\d,1,1,.*>|planes_kernel<\d,[01],1,1,.*>")
    old_tiles = [k for k in kernels_ptxas if re.fullmatch(old_tile, k)]
    require(not old_tiles,
            f"K1's, K2's, K4's, K5's or K6's 16-row tile is still built: {old_tiles}")
    # K4's 3-bit stitched decode loop, from its SASS: one LOP3 a code pair
    t0 = time.perf_counter()
    k4_loop = k4_main_loop(lib_path, info["ptxas"])
    k4_lop3 = k4_loop.get("by_opcode", {}).get("LOP3")
    require(k4_lop3 is not None and k4_lop3 <= K4_LOOP_LOP3,
            f"{K4_LOOP}'s main loop holds {k4_lop3} LOP3 a chunk, more than {K4_LOOP_LOP3}")
    build_rec = {"phase": "build", "seconds": info["seconds"], "compile": info["compile"],
                 "link": info["link"], "ptxas": kernels_ptxas,
                 # of every decode kernel instantiation, which sizes its own
                 "decode_dynamic_smem": {f"{bits}-bit": {M: smem_of(bits, M, 0)
                                                         for M in (1, 8, 16)}
                                         for bits in KERNEL_BITS},
                 "k6_decode_dynamic_smem_g32": {f"{bits}-bit": {M: smem_of(bits, M, 32)
                                                                for M in (1, 8, 16)}
                                                for bits in KERNEL_BITS},
                 "planes_decode_dynamic_smem": {f"{bits}-bit": {M: smem_of(bits, M, 0)
                                                                for M in (1, 8, 16)}
                                                for bits in PLANE_BITS},
                 "k10_dynamic_smem": {f"{bits}-bit": {bm: _build.lib().gqt_qmoe_smem_bytes(bits, bm)
                                                      for bm in (8, 16, 24, 32)}
                                      for bits in KERNEL_BITS},
                 "decode_kernels": decode_kernels,
                 "k4_3bit_loop": {"kernel": K4_LOOP, "instructions": k4_loop["instructions"],
                                  "lop3": k4_lop3, "lop3_limit": K4_LOOP_LOP3,
                                  "sass_seconds": time.perf_counter() - t0},
                 "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(build_rec)
    record["build"] = build_rec

    # -------------------------------------------------------------- kernels
    has_int4pack, library = int4pack_library()
    rng = np.random.default_rng([SEED, 100])
    D, F = LLAMA3_8B_CONFIG["hidden_size"], LLAMA3_8B_CONFIG["intermediate_size"]
    k1_shapes = llama_shapes()
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
            y2 = qmatmul(x, mods[0].qweight, mods[0].scales, **kw)
            ref = qmatmul_plain(x, mods[0].qweight, mods[0].scales, **kw)
            torch.cuda.synchronize()
            require(_build.LAUNCHES["qmatmul"] == before + 2, "qmatmul did not launch")
            identical = torch.equal(y, y2)
            rel, mx = errors(y, ref)
            b_ms, b_by = bound(x.nbytes + wbytes + y.nbytes, 2.0 * M * N * K)
            k = timed(lambda i: qmatmul(x, mods[i].qweight, mods[i].scales, **kw), len(mods),
                      floor_ms=b_ms)
            p = timed(lambda i: qmatmul_plain(x, mods[i].qweight, mods[i].scales, **kw),
                      len(mods), budget_ms=100.0)
            lib, lib_rel = None, None
            if has_int4pack:
                lib = timed(lambda i: torch._weight_int4pack_mm(x, lib_w[i][0], 128,
                                                                lib_w[i][1]), len(mods))
                lib_rel = errors(torch._weight_int4pack_mm(x, lib_w[0][0], 128, lib_w[0][1]),
                                 ref)[0]
            case = {"kernel": "qmatmul", "proj": proj, "M": M, "K": K, "N": N,
                    "rel_err": rel, "max_abs_err": mx, "identical_runs": identical,
                    "ms": k["ms"], "wall_ms": k["wall_ms"], "kernel_names": k["kernels"],
                    "plain_ms": p["ms"], "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib["ms"] if lib else None, "library": library,
                    "library_rel_err": lib_rel, "plain_wall_ms": p["wall_ms"],
                    "library_wall_ms": lib["wall_ms"] if lib else None,
                    "weight_copies": len(mods)}
            cases.append(case)
            emit({"phase": "kernels", **case})
            require(rel <= K1_TOL, f"K1 {proj} M={M}: rel {rel} > {K1_TOL}")
            require(identical, f"K1 {proj} M={M}: two runs differ")
            require(M > DECODE_MAX_M or on_decode_kernel(k["kernels"]),
                    f"K1 {proj} M={M} ran {k['kernels']}")
        del base, mods, lib_w

    cases += k3_kernel_cases(dev, rng, k1_shapes)

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
        y, y2 = qmlp(x, *sets[0], **kw), qmlp(x, *sets[0], **kw)
        ref = qmlp_plain(x, *sets[0], **kw)
        torch.cuda.synchronize()
        require(_build.LAUNCHES["qmlp"] == before + 2, "qmlp did not launch")
        identical = torch.equal(y, y2)
        rel, mx = errors(y, ref)
        b_ms, b_by = bound(x.nbytes + wbytes + y.nbytes, 6.0 * M * D * F)
        k = timed(lambda i: qmlp(x, *sets[i], **kw), len(sets), floor_ms=b_ms)
        p = timed(lambda i: qmlp_plain(x, *sets[i], **kw), len(sets), budget_ms=100.0)
        case = {"kernel": "qmlp", "proj": "mlp", "M": M, "D": D, "F": F, "rel_err": rel,
                "max_abs_err": mx, "identical_runs": identical, "ms": k["ms"],
                "wall_ms": k["wall_ms"], "kernel_names": k["kernels"], "plain_ms": p["ms"],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library": "null: no PyTorch call computes the fused quantized MLP",
                "plain_wall_ms": p["wall_ms"],
                "weight_copies": len(sets)}
        cases.append(case)
        emit({"phase": "kernels", **case})
        require(rel <= K2_TOL, f"K2 M={M}: rel {rel} > {K2_TOL}")
        require(identical, f"K2 M={M}: two runs differ")
        # both passes: the paired gate/up epilogue, then K1's launch on inner
        require(M > DECODE_MAX_M or (on_decode_kernel(k["kernels"])
                                     and any("GateUpPairs" in n for n in k["kernels"])
                                     and any("UniformZero" in n for n in k["kernels"])),
                f"K2 M={M} ran {k['kernels']}")
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

    for proj in SOLVE_SHAPES:
        c = solve_inputs(dev, proj)
        W, U, kw, out_f, in_f = c["W"], c["U"], c["kw"], c["out"], c["in"]
        before = _build.LAUNCHES["gptq_whole_solve"]
        Q, Dq, L, s_k, z_k = gptq_whole_solve(W, U, **kw)
        k8_sha = digest(Q, Dq, L, s_k, z_k)
        identical = torch.equal(Q, gptq_whole_solve(W, U, **kw)[0])
        plain_ms, (rQ, rDq, rL, rs, _) = event_ms(lambda: gptq_whole_solve_plain(W, U, **kw))
        require(_build.LAUNCHES["gptq_whole_solve"] == before + 2, "K8 did not launch")
        mismatch = float((Q != rQ).float().mean())
        scale_err = float(((s_k - rs).abs() / rs.abs()).max())
        loss_err = abs(float(L.sum() / rL.sum()) - 1)
        dq_ok = bool(torch.allclose(Dq, rDq, rtol=K8_DQ_RTOL, atol=K8_DQ_ATOL))
        max_err = float((Dq - rDq).abs().max())
        del Q, Dq, L, s_k, z_k, rQ, rDq, rL, rs
        b_ms, b_by = solve_bound(out_f, in_f)
        k = timed(lambda i: gptq_whole_solve(W, U, **kw), 1, budget_ms=300.0, floor_ms=b_ms)
        case = {"kernel": "gptq_whole_solve", "proj": proj, "out": out_f, "in": in_f,
                "group_size": 128, "bits": 4, "damp": c["damp"], "code_mismatch": mismatch,
                "identical_runs": identical, "scale_rel_err": scale_err,
                "loss_rel_err": loss_err, "max_abs_err": max_err, "ms": k["ms"],
                "wall_ms": k["wall_ms"], "plain_ms": plain_ms, "plain_clock": "cuda events",
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library": "null: no PyTorch call computes a GPTQ solve",
                "sha256_q_dq_l_s_z": k8_sha}
        cases.append(case)
        emit({"phase": "kernels", **case})
        require(identical, f"K8 {proj}: two runs gave different codes")
        require(mismatch < K8_MISMATCH, f"K8 {proj}: code mismatch {mismatch}")
        require(dq_ok, f"K8 {proj}: Dq off by {max_err}")
        require(scale_err <= K8_SCALE_RTOL, f"K8 {proj}: scales off by {scale_err}")
        require(loss_err <= K8_LOSS_RTOL, f"K8 {proj}: loss off by {loss_err}")

        # K9 on the first block of the same group, scales from its minmax
        blk = c["block"]
        del W, U, c
        before = _build.LAUNCHES["gptq_block_inner"]
        got = gptq_block_inner(*blk[0], maxq=15)
        plain_ms, ref = event_ms(lambda: gptq_block_inner_plain(*blk[0], maxq=15))
        require(_build.LAUNCHES["gptq_block_inner"] == before + 1, "K9 did not launch")
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        max_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        b_ms, b_by = block_bound(out_f)
        k = timed(lambda i: gptq_block_inner(*blk[i], maxq=15), len(blk), floor_ms=b_ms)
        case = {"kernel": "gptq_block_inner", "proj": proj, "out": out_f, "in": 128,
                "blocks_per_layer": in_f // 128, "equal": equal, "max_abs_err": max_err,
                "ms": k["ms"], "wall_ms": k["wall_ms"],
                "plain_ms": plain_ms, "plain_clock": "cuda events", "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None,
                "library": "null: no PyTorch call computes the GPTQ column loop",
                "input_copies": len(blk), "sha256_q_dq_e_l": digest(*got)}
        cases.append(case)
        emit({"phase": "kernels", **case})
        require(equal, f"K9 {proj}: differs from its plain version by {max_err}")
        del blk, got, ref
    torch.cuda.empty_cache()
    cases += moe_kernel_cases(dev)
    small_rng = np.random.default_rng([SEED, 400])
    cases += k6_kernel_cases(dev, small_rng, k1_shapes)
    cases += k7_kernel_cases(dev, small_rng, k1_shapes)
    cases += planes_kernel_cases(dev, np.random.default_rng([SEED, 500]), k1_shapes)
    record["kernels"] = cases

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

        timing = serve_timing(spec, params, ids, kv_quant, prefill_counts, step_counts)
        rec = {
            "phase": "slice", "gpu": card, "kv": kv, "layers": L, "B": B, "T": T,
            "new_tokens": NEW, "checkpoint_bytes": n_bytes, "write_s": write_s,
            "load_s": load_s, "optimize_s": optimize_s, "weights_mem_bytes": weights_mem,
            "generate_s": generate_s, "generate_counts": counts, "peak_mem_bytes": peak,
            "prefill_counts": prefill_counts, "decode_counts_per_step": step_counts,
            "distinct_tokens_first_row": len(set(tokens[0].tolist())),
            "tokens_first_row": tokens[0].tolist(), **timing,
        }
        emit(rec)
        slice_recs.append(rec)
    record["slice"] = slice_recs

    # -------------------------------------------------------------- compare
    cmp_rec = {"phase": "compare", "gpu": card, **compare_layers(spec, params, ids)}
    emit(cmp_rec)
    record["compare"] = cmp_rec
    kernel_counts = cmp_rec["counts"]
    require(kernel_counts["qmatmul"] > 0 and kernel_counts["qmlp"] > 0, kernel_counts)
    require(cmp_rec["logits_rel_err"] <= SLICE_TOL,
            f"kernel path vs plain path: rel {cmp_rec['logits_rel_err']} > {SLICE_TOL}")

    # ---------------------------------------------------------------- fused
    record["fused"] = fused = fused_phase(model, ids, card)
    del model, params, layers
    torch.cuda.empty_cache()

    # ------------------------------------------- asym-act-slice, compare-act
    act = act_phases(ROOT / "build", card)
    record.update(act)

    # ---------------------------------------------- g32-slice, compare-g32
    g32 = g32_phases(ROOT / "build", card)
    record.update(g32)

    # ------------------------------------------ planes-slice, compare-planes
    planes = planes_phases(ROOT / "build", card)
    record.update(planes)

    # ------------------------------------------- quantize, compare-quantize
    with tempfile.TemporaryDirectory(prefix="llama3-8b-fp-", dir=ROOT / "build") as work:
        q_rec, state = quantize_phase(Path(work), QUANT_LAYERS, card)
        emit(q_rec)
        record["quantize"] = q_rec
        cq_rec = compare_quantize_phase(Path(work), state, card)
        emit(cq_rec)
        record["compare_quantize"] = cq_rec
        record["quantize_act"] = quantize_act_phase(Path(work), state, card)
        record["quantize_g32"] = quantize_g32_phase(Path(work), state, card)
        record["quantize_planes"] = quantize_planes_phase(Path(work), state, card)

    # ------------------------------------- moe-slice, compare-moe, moe-routes
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="qwen3-30b-a3b-gptq-", dir=ROOT / "build") as ckpt:
        moe = moe_phases(Path(ckpt), card)
    record.update(moe)

    # -------------------------------------------------------------- summary
    main_counts = slice_recs[0]["generate_counts"]  # the bf16-KV generate

    def per_step(kernel: str, parts: list[tuple[str, int]], bits: int = 4, **match) -> dict:
        sel = [(c, n) for c in cases for proj, n in parts
               if c["kernel"] == kernel and c["M"] == B and c["proj"] == proj
               and c.get("bits", 4) == bits and all(c[k] == v for k, v in match.items())]
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
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (M <= 16), "
                    "gptqmodel_tpu_torch/csrc/qmatmul.cu (M > 16)"),
         "replaces": "gptqmodel_tpu/ops/pallas_qmatmul.py:198",
         "launches": main_counts["qmatmul"], "launches_per": "generate run",
         "ms_per": "decode step",
         "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == "qmatmul"),
         **per_step("qmatmul", [("qkv", L), ("o", L)])},
        {"name": "qmatmul_asym (K3)", "route": "cuda",
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (M <= 16), "
                    "gptqmodel_tpu_torch/csrc/qmatmul.cu (M > 16)"),
         "replaces": "gptqmodel_tpu/ops/pallas_qmatmul.py:117",
         "launches": act["asym_act_slice"]["generate_counts"]["qmatmul_asym"],
         "launches_per": "asym-act-slice generate run", "ms_per": "decode step",
         "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == "qmatmul_asym"),
         **per_step("qmatmul_asym", [("qkv", L), ("o", L), ("gate_up", L), ("down", L)])},
        {"name": "qmatmul_fused (K7)", "route": "cuda",
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (M <= 16), "
                    "gptqmodel_tpu_torch/csrc/qmatmul.cu (M > 16)"),
         "replaces": "gptqmodel_tpu/ops/pallas_qmatmul.py:263",
         "launches": fused["generate_counts"]["qmatmul_fused"],
         "launches_per": f"fused generate run (GPTQ_TPU_RT_FUSED=1, {FUSED_NEW} tokens)",
         "ms_per": "decode step",
         "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == "qmatmul_fused"),
         **per_step("qmatmul_fused", [("qkv", L), ("o", L)])},
        {"name": "qmm (K6)", "route": "cuda",
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (M <= 16), "
                    "gptqmodel_tpu_torch/csrc/qmm.cu"),
         "replaces": "gptqmodel_tpu/ops/pallas_qmatmul.py:55",
         "launches": g32["g32_slice"]["generate_counts"]["qmm"],
         "launches_per": "g32-slice generate run", "ms_per": "decode step (group 32, symmetric)",
         "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == "qmm"),
         **per_step("qmm", [("qkv", L), ("o", L), ("gate_up", L), ("down", L)],
                    group_size=32, sym=True)},
        {"name": "qmatmul_planes (K4)", "route": "cuda",
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (M <= 16), "
                    "gptqmodel_tpu_torch/csrc/qmatmul_planes.cu (M > 16)"),
         "replaces": "gptqmodel_tpu/ops/pallas_qmatmul.py:385",
         "launches": planes["planes_slice"]["generate_counts"]["qmatmul_planes"],
         "launches_per": "planes-slice generate run",
         "ms_per": "decode step (3-bit stitched, symmetric)",
         "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == "qmatmul_planes"),
         **per_step("qmatmul_planes", [("qkv", L), ("o", L), ("gate_up", L), ("down", L)],
                    bits=3, planar=False)},
        {"name": "qmatmul_planes_asym (K5)", "route": "cuda",
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (M <= 16), "
                    "gptqmodel_tpu_torch/csrc/qmatmul_planes.cu (M > 16)"),
         "replaces": "gptqmodel_tpu/ops/pallas_qmatmul.py:421",
         "launches": sum(c["generate_counts"]["qmatmul_planes_asym"]
                         for c in planes["compare_planes"].values()
                         if isinstance(c, dict) and "generate_counts" in c),
         "launches_per": (f"compare-planes generate runs ({QUANT_ACT_NEW} tokens, 2 layers: "
                          "3-bit sym=False desc_act=True, 7-bit gptq_p sym=False)"),
         "ms_per": "decode step (3-bit stitched, zeros per group, 32 layers)",
         "max_abs_err": max(c["max_abs_err"] for c in cases
                            if c["kernel"] == "qmatmul_planes_asym"),
         **per_step("qmatmul_planes_asym", [("qkv", L), ("o", L), ("gate_up", L), ("down", L)],
                    bits=3, planar=False)},
        {"name": "qmlp (K2)", "route": "cuda",
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (M <= 16), "
                    "gptqmodel_tpu_torch/csrc/qmlp.cu (M > 16)"),
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
    L_moe = moe["moe_slice"]["layers"]
    route_counts = {k: sum(r["launched"].get(k, 0) for r in moe["moe_routes"]["routes"].values()
                           if isinstance(r, dict)) for k in _build.LAUNCHES}

    def moe_entry(kernel: str, N: int, times: int) -> dict:
        """The kernel's cases at N tokens, summed (K13: gate|up and down; K10
        its default rt contract, and by pass), times ``times``."""
        sel = [c for c in cases if c["kernel"] == kernel and c.get("N") == N
               and c.get("rt", [True, True]) == [True, True]]
        total = lambda key: times * sum(c[key] for c in sel)
        out = {"max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == kernel),
               "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
               "bound_by": ("bytes" if all(c["bound_by"] == "bytes" for c in sel)
                            else "operations"), "library_ms": None}
        if all("ms_by_pass" in c for c in sel):
            out["ms_by_pass"] = {p: times * sum(c["ms_by_pass"][p] for c in sel)
                                 for p in ("gate_up", "down", "combine")}
        return out

    per_route_layer = "MoE layer at N = 8 tokens (moe-routes)"
    summary += [
        {"name": "qmoe_mlp_e2e (K10)", "route": "cuda",
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (gate|up and down), "
                    "gptqmodel_tpu_torch/csrc/qmoe.cu (launch, combine)"),
         "replaces": "gptqmodel_tpu/ops/pallas_qmoe.py:678",
         "launches": moe["moe_slice"]["generate_counts"]["qmoe_e2e"],
         "launches_per": f"moe generate run ({L_moe} layers)",
         "ms_per": f"decode step at B = {B} ({L_moe} layers)",
         **moe_entry("qmoe_e2e", B, L_moe)},
        {"name": "qmoe_mlp_matmul_dyn (K11)", "route": "cuda",
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (gate|up and down), "
                    "gptqmodel_tpu_torch/csrc/qmoe.cu (launch)"),
         "replaces": "gptqmodel_tpu/ops/pallas_qmoe.py:534",
         "launches": route_counts["qmoe_mlp_dyn"], "launches_per": "moe-routes run",
         "ms_per": per_route_layer, **moe_entry("qmoe_mlp_dyn", B, 1)},
        {"name": "qmoe_mlp_matmul (K12)", "route": "cuda",
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (gate|up and down), "
                    "gptqmodel_tpu_torch/csrc/qmoe.cu (launch)"),
         "replaces": "gptqmodel_tpu/ops/pallas_qmoe.py:362",
         "launches": route_counts["qmoe_mlp"], "launches_per": "moe-routes run",
         "ms_per": per_route_layer, **moe_entry("qmoe_mlp", B, 1)},
        {"name": "qmoe_matmul (K13)", "route": "cuda",
         "source": ("gptqmodel_tpu_torch/csrc/qmm_decode.cuh (MoeSlotDown), "
                    "gptqmodel_tpu_torch/csrc/qmoe.cu (launch)"),
         "replaces": "gptqmodel_tpu/ops/pallas_qmoe.py:224",
         "launches": route_counts["qmoe_matmul"], "launches_per": "moe-routes run",
         "ms_per": per_route_layer + ", gate|up and down", **moe_entry("qmoe_matmul", B, 1)},
    ]
    record["summary"] = summary
    record["profiler_short"] = dict(PROFILER_SHORT)
    emit({"phase": "profiler", "short_sessions": PROFILER_SHORT["sessions"],
          "read_from_kept_records": PROFILER_SHORT["estimated"],
          "readings_under_bound": PROFILER_SHORT["under_bound"]})
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1) + "\n")
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
