"""K10–K13: the MoE kernels over stacked packed experts, and their runtime.

The counterpart of the JAX package's ``ops/pallas_qmoe.py``. Packed experts
are stacked per layer (``stack_packed_experts``): ``qweight [E, K/pf, N]``
int32 in the GPTQ interchange layout and ``scales [E, G_pad, N]`` bf16, the
groups zero-padded to ``G_pad``. Routed rows are planned on the device into
slots of at most ``bm`` rows, each slot owned by one expert
(``plan_rows`` / ``plan_slots``); slot ``s`` owns rows ``[s*bm, s*bm +
count_s)`` and the used slots form a prefix of the static slot bound ``S``.

Kernels (``csrc/qmoe.cu``), each with its plain PyTorch version here:

- K13 ``qmoe_matmul``: one projection over the slots
  (``_qmoe_kernel``, ``pallas_qmoe.py:224``).
- K12 ``qmoe_mlp_matmul``: gate|up, ``bf16(silu(g)·u)``, down for every
  slot of the static grid (``_qmoe_mlp_kernel``, ``:362``).
- K11 ``qmoe_mlp_matmul_dyn``: K12 over the used slots, whose number it
  reads on the device (``_qmoe_mlp_dyn_kernel``, ``:534``); bit-equal to
  K12. Both run their two passes on the decode kernel's shared-memory ring
  (``csrc/qmm_decode.cuh``), as K10 does, with the cluster splits of
  ``e2e_plan`` for the slot bound; K13 runs their down pass alone, with
  the same plan, so that on K12's inner it gives K12's output bit for bit.
- K10 ``qmoe_mlp_e2e``: the whole layer after routing: gathers each slot's
  token rows, runs the expert MLP and adds ``w·y`` into each token's row in
  float32, in slot order (ascending expert id), then rounds once
  (``_qmoe_mlp_e2e_kernel``, ``:678``). Its gate|up and down passes run the
  decode kernel's shared-memory ring (``csrc/qmm_decode.cuh``), one block
  per slot, 64-column tile and cluster rank, with the cluster splits of
  ``e2e_plan``; its combine is ``qmoe.cu``'s.

Two contracts, as in the JAX package. The *ic* contract (``_ic_contract``,
``:90``) dequantizes each weight to ``bf16((q - zc)·s)`` and takes a bf16
product with float32 sums; K11, K12 and K13 compute it. The *rt* contract
(``_rt_contract``, ``:131``) is K1's arithmetic: per-group partial dots of
the raw codes, float32 scales and the zero correction ``X1·zc·s``; K10
computes it for a stack whose ``rt`` flag is set (``stacked_rt_ok``), else
the ic contract. The TPU package re-packs an rt stack's words; the port's
kernels read the interchange words either way, so ``rt`` only picks the
arithmetic. The JAX kernels' plane permute of x is the TPU's relayout; the
CUDA kernels and the plain versions sum the same products without it.

A wrapper launches its kernel for a CUDA tensor (or raises) and runs its
plain version only for a tensor on the CPU. No routing plan value leaves the
device: ``S`` is static and the kernels read counts and ``n_used`` there.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F_

from gptqmodel_tpu_torch.ops import _build
from gptqmodel_tpu_torch.ops.pack import unpack_qweight
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear
from gptqmodel_tpu_torch.ops.qmatmul import (
    DECODE_COLS,
    DECODE_PLAN_SPLIT,
    H100_SMS,
    DecodePlan,
    _sm_count,
)

KERNEL_BITS = (2, 4, 8)
MAX_TOPK = 16  # K10's combine keeps a token's slot rows in registers
# K10's passes on the decode ring (e2e_plan): the blocks an SM that the
# launch plan aims at, counting the slots that can hold rows, and the fewest
# groups a cluster rank sums. On an H100 at Qwen3-30B-A3B's widths and N = 1
# (scripts/k10_passes.py --splits, PERF.md) gate|up ran fastest at a split of
# 2 (16 groups) and down at 1 (6 groups): a rank of one or two groups ends
# before its ring fills.
E2E_BLOCKS_PER_SM = 2
E2E_GROUPS_PER_RANK = 4
_PLAIN_SLOTS = 16  # slots per step of the plain versions (bounds their memory)


# --------------------------------------------------------------- the stacks


@dataclasses.dataclass
class StackedQuantExperts:
    """Packed expert weights of one projection, stacked for the kernels.

    ``qweight [E, K/pf, N]`` int32 (interchange layout), ``scales [E, G_pad,
    N]`` bf16 with the groups zero-padded, one symmetric zero point
    ``zero_const``. ``rt`` picks the contract the kernels compute (module
    docstring); the words are the same either way."""

    qweight: torch.Tensor
    scales: torch.Tensor
    bits: int = 4
    G: int = 0
    zero_const: float = 8.0
    in_features: int = 0
    out_features: int = 0
    rt: bool = False


def stacked_rt_ok(bits: int, K: int, g: int, subgroup: bool = False) -> bool:
    """The JAX package's rt eligibility at ``block_k == K``: whole groups per
    magic part, or with ``subgroup`` group-aligned cuts of 64 rows."""
    if bits not in KERNEL_BITS:
        return False
    pf = 32 // bits
    if K % pf:
        return False
    rpp = (K // pf) if bits == 8 else (2 * K // pf)
    if subgroup:
        cut = math.gcd(rpp, g)
        return g % 64 == 0 and cut % 64 == 0
    return g % 128 == 0 and rpp % g == 0


def stack_packed_experts(experts: list) -> StackedQuantExperts | None:
    """Stack per-expert ``QuantLinear``s (prepared by ``post_init_module``),
    on their device, or None where the contract does not hold (asymmetric or
    mixed configs, act-order, bias, other bits). The rt flag follows
    ``GPTQ_TPU_QMOE_RT`` and ``GPTQ_TPU_QMOE_RT_SUBGROUP`` as in the JAX
    package."""
    if not experts or not all(isinstance(e, QuantLinear) for e in experts):
        return None
    p0 = experts[0]
    for e in experts:
        if (e.bits, e.group_size, e.in_features, e.out_features) != (
                p0.bits, p0.group_size, p0.in_features, p0.out_features):
            return None
        if (e.g_idx is not None or e.bias is not None or e.zero_const < 0
                or e.bits not in KERNEL_BITS or e.zero_const != p0.zero_const):
            return None
    g = p0.group_size if p0.group_size > 0 else p0.in_features
    if g % (32 // p0.bits) or p0.in_features % g:
        return None
    G = p0.in_features // g
    G_pad = max(8, -(-G // 8) * 8)
    rt = (stacked_rt_ok(p0.bits, p0.in_features, g,
                        subgroup=os.environ.get("GPTQ_TPU_QMOE_RT_SUBGROUP", "1") == "1")
          and os.environ.get("GPTQ_TPU_QMOE_RT", "1") == "1")
    qweight = torch.stack([e.qweight for e in experts])
    scales = torch.zeros((len(experts), G_pad, p0.out_features), dtype=torch.float32,
                         device=qweight.device)
    scales[:, :G] = torch.stack([e.scales for e in experts]).to(torch.float32)
    return StackedQuantExperts(
        qweight=qweight, scales=scales.to(torch.bfloat16), bits=p0.bits, G=G,
        zero_const=float(p0.zero_const), in_features=p0.in_features,
        out_features=p0.out_features, rt=rt,
    )


def fuse_gate_up(sq_g: StackedQuantExperts, sq_u: StackedQuantExperts):
    """gate and up concatenated along the output axis (gate first), so that
    one pass reads x once for both, or None for different geometry."""
    key = lambda s: (s.bits, s.G, s.zero_const, s.in_features, s.rt)
    if key(sq_g) != key(sq_u):
        return None
    return dataclasses.replace(
        sq_g, qweight=torch.cat([sq_g.qweight, sq_u.qweight], dim=2),
        scales=torch.cat([sq_g.scales, sq_u.scales], dim=2),
        out_features=sq_g.out_features + sq_u.out_features,
    )


def kernel_contract(st: StackedQuantExperts) -> str | None:
    """None if the CUDA kernels take this stack, else what they need."""
    g = st.in_features // st.G
    if st.bits not in KERNEL_BITS:
        return f"bits={st.bits}: the MoE kernels take 2, 4 or 8"
    if g % 128 or st.in_features % st.G:
        return f"group size {g}: the MoE kernels need a multiple of 128 dividing K"
    if st.out_features % 8:
        return f"out_features={st.out_features}: the MoE kernels need a multiple of 8"
    return None


# ------------------------------------------------------------ routing plans


def build_slots(top_i: np.ndarray, E: int, bm: int, max_slots: int):
    """Host-side slot plan, the test oracle of ``plan_slots`` (the JAX
    package's ``build_slots``): ``(pos, expert_ids[S], row_count[S],
    order)``; ``order`` sorts the flat (token, k) rows by expert, sorted row
    ``r`` lands at padded row ``pos[r]``, pad slots repeat the last id with
    count 0."""
    flat = np.asarray(top_i).reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_e = flat[order]
    ids, counts = [], []
    pos = np.zeros(flat.shape[0], np.int64)
    i, M = 0, sorted_e.shape[0]
    while i < M:
        e = int(sorted_e[i])
        j = i
        while j < M and int(sorted_e[j]) == e:
            j += 1
        for s in range(i, j, bm):
            c = min(bm, j - s)
            pos[s:s + c] = len(ids) * bm + np.arange(c)
            ids.append(e)
            counts.append(c)
        i = j
    assert len(ids) <= max_slots, (len(ids), max_slots)
    pad_e = ids[-1] if ids else 0
    while len(ids) < max_slots:
        ids.append(pad_e)
        counts.append(0)
    return pos, np.asarray(ids, np.int32), np.asarray(counts, np.int32), order


def slot_rows(M: int) -> int:
    """K10's rows a slot (bm) for ``M`` routed rows, as the model picks it."""
    return 8 if M <= 128 else (16 if M <= 1024 else 32)


def slot_bound(M: int, E: int, bm: int) -> int:
    """The static slot count: ``ceil(M/bm) + min(E, M)`` slots hold any
    routing of ``M`` rows over ``E`` experts."""
    return -(-M // bm) + min(E, M)


def _slot_table(cnt, E: int, bm: int, S: int):
    """(expert_ids[S], row_count[S]) int32 from rows per expert; slots past
    the used prefix repeat the last expert with count 0."""
    ns = (cnt + bm - 1) // bm
    ends = torch.cumsum(ns, 0)
    slot_base = ends - ns
    s_idx = torch.arange(S, device=cnt.device)
    e_of = torch.searchsorted(ends, s_idx, right=True).clamp(0, E - 1)
    j = s_idx - slot_base[e_of]
    count = (cnt[e_of] - j * bm).clamp(0, bm)
    count = torch.where(s_idx < ends[-1], count, 0)
    return e_of.to(torch.int32), count.to(torch.int32), slot_base


def plan_slots(flat_e_sorted: torch.Tensor, E: int, bm: int, S: int):
    """``plan_slots_jit``: from expert ids sorted by expert, ``(expert_ids[S],
    row_count[S], pos[M])``: sorted row ``r`` goes to padded row ``pos[r]``."""
    e = flat_e_sorted.long()
    cnt = torch.bincount(e, minlength=E)[:E]
    ids, count, slot_base = _slot_table(cnt, E, bm, S)
    row_base = torch.cumsum(cnt, 0) - cnt
    rho = torch.arange(e.shape[0], device=e.device) - row_base[e]
    return ids, count, (slot_base[e] * bm + rho).to(torch.int32)


def plan_rows(flat_e: torch.Tensor, E: int, bm: int, S: int):
    """``plan_rows_jit``, sort-free: ``(expert_ids[S], row_count[S],
    row_pos[M])``: unsorted flat row ``r`` (token ``r // k``) goes to padded
    row ``row_pos[r]``, its rank within its expert the number of earlier rows
    routed there. The same layout as a stable sort then ``plan_slots``."""
    e = flat_e.long()
    onehot = (e[:, None] == torch.arange(E, device=e.device)[None, :]).to(torch.int32)
    cnt = onehot.sum(0)
    earlier = torch.cumsum(onehot, 0) - onehot
    rank = earlier.gather(1, e[:, None])[:, 0]
    ids, count, slot_base = _slot_table(cnt, E, bm, S)
    return ids, count, (slot_base[e] * bm + rank).to(torch.int32)


# ------------------------------------------------------- the plain versions


def _slot_weights(qw, s, ids, bits: int, G: int):
    """codes float32 ``[c, K, N]`` and scales float32 ``[c, G, N]`` of the
    experts ``ids [c]``."""
    w = qw.index_select(0, ids.long())  # [c, K/pf, N]
    c, R, N = w.shape
    codes = unpack_qweight(w.permute(1, 0, 2).reshape(R, c * N), bits)
    codes = codes.reshape(-1, c, N).permute(1, 0, 2).to(torch.float32)
    return codes, s.index_select(0, ids.long())[:, :G].to(torch.float32)


def _rt_dot(x, codes, sc, zc: float):
    """The rt contract, float32 ``[c, m, N]``: ``Σ_g (x_g·codes_g)·s_g −
    (Σ x_g)·zc·s_g`` for x ``[c, m, K]`` (bf16 values)."""
    c, m, K = x.shape
    G = sc.shape[1]
    xg = x.reshape(c, m, G, K // G)
    P = torch.einsum("cmgk,cgkn->cmgn", xg, codes.reshape(c, G, K // G, -1))
    X1 = xg.sum(-1)
    return (P * sc[:, None] - X1[..., None] * (zc * sc)[:, None]).sum(2)


def _ic_dot(x, codes, sc, zc: float):
    """The ic contract, float32 ``[c, m, N]``: ``x @ bf16((codes − zc)·s)``
    with float32 sums."""
    c, K, N = codes.shape
    G = sc.shape[1]
    w = (codes.reshape(c, G, K // G, N) - zc) * sc[:, :, None]
    return torch.bmm(x, w.to(torch.bfloat16).to(torch.float32).reshape(c, K, N))


def _bf16_rows(x) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _silu_mul(gu: torch.Tensor, F: int) -> torch.Tensor:
    """``bf16(silu(g)·u)`` from float32 ``[..., 2F]`` (gate columns first)."""
    return (F_.silu(gu[..., :F]) * gu[..., F:]).to(torch.bfloat16).to(torch.float32)


def _chunks(S: int):
    for c0 in range(0, S, _PLAIN_SLOTS):
        yield c0, min(c0 + _PLAIN_SLOTS, S)


def qmoe_matmul_plain(x_sorted, expert_ids, row_count, qw, s, *, bits, G, bm,
                      zero_const, out_dtype=torch.float32):
    """Plain PyTorch version of K13: the ic contract per slot, rows at or past
    the slot's count written 0."""
    S = expert_ids.shape[0]
    rows = torch.arange(bm, device=x_sorted.device)
    outs = []
    for c0, c1 in _chunks(S):
        codes, sc = _slot_weights(qw, s, expert_ids[c0:c1], bits, G)
        x = _bf16_rows(x_sorted[c0 * bm:c1 * bm]).reshape(c1 - c0, bm, -1)
        y = _ic_dot(x, codes, sc, zero_const)
        keep = rows[None, :] < row_count[c0:c1, None]
        outs.append(torch.where(keep[..., None], y, 0.0).to(out_dtype))
    return torch.cat(outs).reshape(S * bm, -1)


def _mlp_slots_plain(x_sorted, expert_ids, keep_slot, row_count, qw_gu, s_gu, qw_d, s_d,
                     *, bits, G_gu, G_d, F, bm, zc_gu, zc_d, out_dtype):
    S = expert_ids.shape[0]
    rows = torch.arange(bm, device=x_sorted.device)
    outs = []
    for c0, c1 in _chunks(S):
        ids = expert_ids[c0:c1]
        x = _bf16_rows(x_sorted[c0 * bm:c1 * bm]).reshape(c1 - c0, bm, -1)
        inner = _silu_mul(_ic_dot(x, *_slot_weights(qw_gu, s_gu, ids, bits, G_gu), zc_gu), F)
        y = _ic_dot(inner, *_slot_weights(qw_d, s_d, ids, bits, G_d), zc_d)
        keep = keep_slot[c0:c1, None] & (rows[None, :] < row_count[c0:c1, None])
        outs.append(torch.where(keep[..., None], y, 0.0).to(out_dtype))
    return torch.cat(outs).reshape(S * bm, -1)


def qmoe_mlp_matmul_plain(x_sorted, expert_ids, row_count, qw_gu, s_gu, qw_d, s_d, *,
                          bits, G_gu, G_d, F, bm, zc_gu, zc_d, out_dtype=torch.float32):
    """Plain PyTorch version of K12: every slot of the static grid, the ic
    contract for gate|up, ``bf16(silu(g)·u)``, the ic contract for down."""
    return _mlp_slots_plain(x_sorted, expert_ids, row_count > 0, row_count, qw_gu, s_gu,
                            qw_d, s_d, bits=bits, G_gu=G_gu, G_d=G_d, F=F, bm=bm,
                            zc_gu=zc_gu, zc_d=zc_d, out_dtype=out_dtype)


def qmoe_mlp_matmul_dyn_plain(x_sorted, expert_ids, row_count, n_used, qw_gu, s_gu, qw_d,
                              s_d, *, bits, G_gu, G_d, F, bm, zc_gu, zc_d,
                              out_dtype=torch.float32):
    """Plain PyTorch version of K11: K12's arithmetic on the slots below
    ``n_used``; the rest of the rows 0."""
    used = torch.arange(expert_ids.shape[0], device=expert_ids.device) < n_used.reshape(())
    return _mlp_slots_plain(x_sorted, expert_ids, used, row_count, qw_gu, s_gu, qw_d, s_d,
                            bits=bits, G_gu=G_gu, G_d=G_d, F=F, bm=bm, zc_gu=zc_gu,
                            zc_d=zc_d, out_dtype=out_dtype)


def qmoe_mlp_e2e_plain(x, expert_ids, n_used, tok_col, w_col, tok_pos, qw_gu, s_gu, qw_d,
                       s_d, *, bits, G_gu, G_d, F, bm, zc_gu, zc_d, rt_gu, rt_d,
                       out_dtype=torch.bfloat16):
    """Plain PyTorch version of K10: for each used slot, the token rows
    ``tok_col`` (-1: a zero row), the expert MLP (rt or ic contract per
    projection), ``y·w_col`` in float32; then each token's rows summed in
    slot order from 0 in float32 and rounded once to ``out_dtype``."""
    S = expert_ids.shape[0]
    N, D = x.shape
    xz = torch.cat([_bf16_rows(x), x.new_zeros((1, D), dtype=torch.float32)])  # row -1: 0
    used = torch.arange(S, device=x.device) < n_used.reshape(())
    gu_dot, d_dot = (_rt_dot if rt_gu else _ic_dot), (_rt_dot if rt_d else _ic_dot)
    ys = []
    for c0, c1 in _chunks(S):
        ids = expert_ids[c0:c1]
        xs = xz[tok_col[c0 * bm:c1 * bm].long()].reshape(c1 - c0, bm, D)
        inner = _silu_mul(gu_dot(xs, *_slot_weights(qw_gu, s_gu, ids, bits, G_gu), zc_gu), F)
        y = d_dot(inner, *_slot_weights(qw_d, s_d, ids, bits, G_d), zc_d)
        y = y * w_col[c0 * bm:c1 * bm].reshape(c1 - c0, bm, 1)
        ys.append(torch.where(used[c0:c1, None, None], y, 0.0))
    ybuf = torch.cat(ys).reshape(S * bm, D)
    pos = torch.sort(tok_pos.long(), dim=1).values
    acc = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    for j in range(pos.shape[1]):
        acc = acc + ybuf[pos[:, j]]
    return acc.to(out_dtype)


# ---------------------------------------------------------------- kernels


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def e2e_plan(M: int, E: int, K: int, N: int, group_size: int,
             sms: int = H100_SMS) -> DecodePlan:
    """The launch of one of K10's passes on the decode ring (``K x N``:
    gate|up ``D x 2F``, 32 gate and their 32 up columns a tile; down ``F x
    D``) for ``M`` routed rows over ``E`` experts: the fewest cluster blocks
    (at most ``DECODE_PLAN_SPLIT``, and ``E2E_GROUPS_PER_RANK`` groups or
    more a rank) that give the ``min(E, M)`` slots that can hold rows
    ``E2E_BLOCKS_PER_SM`` blocks an SM. The slots' row count ``bm`` is not an
    input: the plan, and with it every row's sums, is the same for every
    ``bm``."""
    tiles = -(-N // DECODE_COLS)
    groups = K // group_size
    busy = tiles * min(E, M)
    split = max(1, min(DECODE_PLAN_SPLIT, groups // E2E_GROUPS_PER_RANK,
                       -(-E2E_BLOCKS_PER_SM * sms // busy)))
    return DecodePlan(tiles, split, groups)


def _check(x, K, ids, counts, stacks, *, bm, n_used=None):
    """The kernels' contract on the operands; raises on what they do not take."""
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"the MoE kernels take bf16 rows of {K}, got {x.dtype} {tuple(x.shape)}")
    if bm % 8 or not 8 <= bm <= 32:
        raise ValueError(f"bm={bm}: the MoE kernels take 8, 16, 24 or 32 rows per slot")
    S = ids.shape[0]
    if S > 65535:
        raise ValueError(f"{S} slots: the grid holds at most 65535")
    ints = [ids] + ([counts] if counts is not None else []) + (
        [n_used] if n_used is not None else [])
    if any(t.dtype != torch.int32 for t in ints) or (counts is not None
                                                      and counts.shape != (S,)):
        raise ValueError("expert ids, counts and n_used must be int32")
    for qw, s, bits, g, K_, N in stacks:
        pf = 32 // bits
        if bits not in KERNEL_BITS or g % 128 or K_ % g:
            raise ValueError(f"bits={bits} group size {g} K={K_}: the MoE kernels take "
                             "2/4/8 bits and groups of a multiple of 128")
        if N % 8 or qw.dtype != torch.int32 or qw.dim() != 3 or qw.shape[1:] != (K_ // pf, N):
            raise ValueError(f"qweight {tuple(qw.shape)} {qw.dtype} for K={K_} N={N}")
        if (s.dtype != torch.bfloat16 or s.dim() != 3 or s.shape[0] != qw.shape[0]
                or s.shape[1] < K_ // g or s.shape[2] != N):
            raise ValueError(f"scales {tuple(s.shape)} {s.dtype} for K={K_} N={N}")
    for t in [x, *ints] + [a for st in stacks for a in st[:2]]:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("the MoE kernels' operands must be contiguous and on one device")
    if x.data_ptr() % 16:
        raise ValueError("the MoE kernels read x rows as 16-byte vectors: x must be aligned")


def qmoe_matmul(x_sorted, expert_ids, row_count, qw, s, *, bits, G, bm, zero_const,
                out_dtype=torch.float32):
    """K13: ``[S·bm, N]`` = each slot's rows times its expert's dequantized
    weight (ic contract), rows at or past the count 0. A CUDA tensor goes to
    the kernel (or raises); a CPU tensor to ``qmoe_matmul_plain``."""
    if x_sorted.device.type == "cpu":
        return qmoe_matmul_plain(x_sorted, expert_ids, row_count, qw, s, bits=bits, G=G,
                                 bm=bm, zero_const=zero_const, out_dtype=out_dtype)
    E, R, N = qw.shape
    K = R * (32 // bits)
    S = expert_ids.shape[0]
    _check(x_sorted, K, expert_ids, row_count, [(qw, s, bits, K // G, K, N)], bm=bm)
    if x_sorted.shape[0] != S * bm or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x_sorted of {x_sorted.shape[0]} rows for {S} slots of {bm}")
    if qw.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("K13 copies weights and scales in 16-byte pieces: the stack's "
                         "qweight and scales must be 16-byte aligned")
    out = torch.empty((S * bm, N), dtype=out_dtype, device=x_sorted.device)
    if S == 0:
        return out
    lib = _build.lib()
    # K12's plan for its down pass (the slot bound in place of the routed
    # rows): on K12's inner K13 then sums every row as K12 does
    plan = e2e_plan(S, E, K, N, K // G, _sm_count(x_sorted.device.index or 0))
    rc = lib.gqt_qmoe_matmul(
        x_sorted.data_ptr(), expert_ids.data_ptr(), row_count.data_ptr(), S, bm, K, N,
        qw.data_ptr(), s.data_ptr(), s.shape[1], K // G, float(zero_const), bits, plan.split,
        int(out_dtype == torch.float32), out.data_ptr(), _stream(x_sorted))
    _build.check(rc, "qmoe_matmul")
    _build.LAUNCHES["qmoe_matmul"] += 1
    return out


def _mlp_kernel(name, x_sorted, expert_ids, row_count, n_used, qw_gu, s_gu, qw_d, s_d, *,
                bits, G_gu, G_d, F, bm, zc_gu, zc_d, out_dtype, inner=None):
    """K11 or K12 on the card. The gate|up pass writes ``inner [S·bm, F]``
    bf16 and the down pass reads it: a fresh scratch, unless a check passes
    its own buffer to hold K13 on that ``inner`` against K12's down pass (no
    route of the port passes one)."""
    D = x_sorted.shape[1]
    S = expert_ids.shape[0]
    _check(x_sorted, D, expert_ids, row_count,
           [(qw_gu, s_gu, bits, D // G_gu, D, 2 * F), (qw_d, s_d, bits, F // G_d, F, D)],
           bm=bm, n_used=n_used)
    if x_sorted.shape[0] != S * bm or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x_sorted of {x_sorted.shape[0]} rows for {S} slots of {bm}")
    if D // G_gu != F // G_d:
        raise ValueError("the fused MoE kernels take one group size for gate|up and down")
    if any(t.data_ptr() % 16 for t in (qw_gu, s_gu, qw_d, s_d)):
        raise ValueError("K11 and K12 copy weights and scales in 16-byte pieces: both "
                         "stacks' qweight and scales must be 16-byte aligned")
    if inner is None:
        inner = torch.empty((S * bm, F), dtype=torch.bfloat16, device=x_sorted.device)
    elif (inner.shape != (S * bm, F) or inner.dtype != torch.bfloat16
          or inner.device != x_sorted.device or not inner.is_contiguous()):
        raise ValueError(f"inner must be contiguous bf16 [{S * bm}, {F}] on x's device")
    out = torch.empty((S * bm, D), dtype=out_dtype, device=x_sorted.device)
    if S == 0:
        return out
    lib = _build.lib()
    E, sms = qw_gu.shape[0], _sm_count(x_sorted.device.index or 0)
    # K10's plan with the slot bound S standing in for the routed rows, which
    # stay on the device: shapes only, so K11 and K12 get the same splits from
    # the same inputs and give the same bits; at Qwen3-30B-A3B's widths these
    # are the splits K10 gets for the rows that fill those slots.
    plan_gu = e2e_plan(S, E, D, 2 * F, D // G_gu, sms)
    plan_d = e2e_plan(S, E, F, D, F // G_d, sms)
    rc = lib.gqt_qmoe_mlp(
        x_sorted.data_ptr(), expert_ids.data_ptr(), row_count.data_ptr(),
        n_used.data_ptr() if n_used is not None else None, S, bm, D, F,
        qw_gu.data_ptr(), s_gu.data_ptr(), s_gu.shape[1], qw_d.data_ptr(), s_d.data_ptr(),
        s_d.shape[1], D // G_gu, float(zc_gu), float(zc_d), bits, plan_gu.split, plan_d.split,
        int(out_dtype == torch.float32), inner.data_ptr(), out.data_ptr(), _stream(x_sorted))
    _build.check(rc, name)
    return out


def qmoe_mlp_matmul(x_sorted, expert_ids, row_count, qw_gu, s_gu, qw_d, s_d, *, bits, G_gu,
                    G_d, F, bm, zc_gu, zc_d, out_dtype=torch.float32):
    """K12: the whole expert MLP per slot over the static slot grid,
    ``[S·bm, D]``. A CUDA tensor goes to the kernel (or raises); a CPU tensor
    to ``qmoe_mlp_matmul_plain``."""
    kw = dict(bits=bits, G_gu=G_gu, G_d=G_d, F=F, bm=bm, zc_gu=zc_gu, zc_d=zc_d,
              out_dtype=out_dtype)
    if x_sorted.device.type == "cpu":
        return qmoe_mlp_matmul_plain(x_sorted, expert_ids, row_count, qw_gu, s_gu, qw_d,
                                     s_d, **kw)
    out = _mlp_kernel("qmoe_mlp", x_sorted, expert_ids, row_count, None, qw_gu, s_gu, qw_d,
                      s_d, **kw)
    if expert_ids.shape[0]:  # no slots: nothing was launched
        _build.LAUNCHES["qmoe_mlp"] += 1
    return out


def qmoe_mlp_matmul_dyn(x_sorted, expert_ids, row_count, n_used, qw_gu, s_gu, qw_d, s_d, *,
                        bits, G_gu, G_d, F, bm, zc_gu, zc_d, out_dtype=torch.float32):
    """K11: K12 over the used slots, ``n_used [1]`` read on the device. A
    CUDA tensor goes to the kernel (or raises); a CPU tensor to
    ``qmoe_mlp_matmul_dyn_plain``."""
    kw = dict(bits=bits, G_gu=G_gu, G_d=G_d, F=F, bm=bm, zc_gu=zc_gu, zc_d=zc_d,
              out_dtype=out_dtype)
    if x_sorted.device.type == "cpu":
        return qmoe_mlp_matmul_dyn_plain(x_sorted, expert_ids, row_count, n_used, qw_gu,
                                         s_gu, qw_d, s_d, **kw)
    out = _mlp_kernel("qmoe_mlp_dyn", x_sorted, expert_ids, row_count, n_used, qw_gu, s_gu,
                      qw_d, s_d, **kw)
    if expert_ids.shape[0]:  # no slots: nothing was launched
        _build.LAUNCHES["qmoe_mlp_dyn"] += 1
    return out


def qmoe_mlp_e2e(x, expert_ids, n_used, tok_col, w_col, tok_pos, qw_gu, s_gu, qw_d, s_d, *,
                 bits, G_gu, G_d, F, bm, zc_gu, zc_d, rt_gu, rt_d,
                 out_dtype=torch.bfloat16):
    """K10: ``[N, D]`` = for each token, the sum over its slot rows (in slot
    order, float32) of ``w·expert_mlp(x[token])``, rounded once to
    ``out_dtype``. ``tok_col``/``w_col [S·bm]``: each slot row's token (-1:
    padding) and routing weight; ``tok_pos [N, k]``: each token's slot rows.
    A CUDA tensor goes to the kernel (or raises); a CPU tensor to
    ``qmoe_mlp_e2e_plain``."""
    kw = dict(bits=bits, G_gu=G_gu, G_d=G_d, F=F, bm=bm, zc_gu=zc_gu, zc_d=zc_d,
              rt_gu=rt_gu, rt_d=rt_d, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return qmoe_mlp_e2e_plain(x, expert_ids, n_used, tok_col, w_col, tok_pos, qw_gu, s_gu,
                                  qw_d, s_d, **kw)
    N, D = x.shape
    S = expert_ids.shape[0]
    _check(x, D, expert_ids, None,
           [(qw_gu, s_gu, bits, D // G_gu, D, 2 * F), (qw_d, s_d, bits, F // G_d, F, D)],
           bm=bm, n_used=n_used)
    topk = tok_pos.shape[1] if tok_pos.dim() == 2 else 0
    if (tok_col.shape != (S * bm,) or w_col.shape != (S * bm,) or tok_pos.shape != (N, topk)
            or tok_col.dtype != torch.int32 or tok_pos.dtype != torch.int32
            or w_col.dtype != torch.float32 or not 1 <= topk <= MAX_TOPK):
        raise ValueError(f"K10 takes int32 tok_col and float32 w_col of {S * bm} rows and "
                         f"int32 tok_pos [N, k <= {MAX_TOPK}]")
    if D % 128 or F % 8 or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K10 takes D a multiple of 128 (got {D}) and F of 8 (got {F})")
    for t in (tok_col, w_col, tok_pos):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("K10's plan tensors must be contiguous and on x's device")
    if any(t.data_ptr() % 16 for t in (qw_gu, s_gu, qw_d, s_d)):
        raise ValueError("K10 copies weights and scales in 16-byte pieces: both stacks' "
                         "qweight and scales must be 16-byte aligned")
    out = torch.empty((N, D), dtype=out_dtype, device=x.device)
    if N == 0:
        return out
    lib = _build.lib()
    E, sms = qw_gu.shape[0], _sm_count(x.device.index or 0)
    plan_gu = e2e_plan(N * topk, E, D, 2 * F, D // G_gu, sms)
    plan_d = e2e_plan(N * topk, E, F, D, F // G_d, sms)
    inner = torch.empty((S * bm, F), dtype=torch.bfloat16, device=x.device)
    ybuf = torch.empty((S * bm, D), dtype=torch.float32, device=x.device)
    rc = lib.gqt_qmoe_e2e(
        x.data_ptr(), expert_ids.data_ptr(), n_used.data_ptr(), tok_col.data_ptr(),
        w_col.data_ptr(), tok_pos.data_ptr(), S, bm, N, topk, D, F,
        qw_gu.data_ptr(), s_gu.data_ptr(), s_gu.shape[1], qw_d.data_ptr(), s_d.data_ptr(),
        s_d.shape[1], D // G_gu, F // G_d, float(zc_gu), float(zc_d), int(rt_gu), int(rt_d),
        bits, plan_gu.split, plan_d.split, int(out_dtype == torch.float32), inner.data_ptr(),
        ybuf.data_ptr(), out.data_ptr(), _stream(x))
    _build.check(rc, "qmoe_e2e")
    _build.LAUNCHES["qmoe_e2e"] += 1
    return out


# ------------------------------------------------------------ the wrappers


def _act_ok(act: str) -> None:
    if act != "silu":
        raise NotImplementedError(f"hidden_act {act!r}: the port's MoE kernels take silu")


def qmoe_mlp_forward_e2e(x, row_pos, top_w, expert_ids, row_count,
                         gu: StackedQuantExperts, down: StackedQuantExperts, *, act: str,
                         bm: int = 8, out_dtype=None):
    """The whole MoE layer after routing through K10: ``x [N, D]``,
    ``row_pos [N, k]`` (``plan_rows``: the padded row of each token's
    ``j``-th route), ``top_w [N, k]``. Returns ``[N, D]`` in ``out_dtype``
    (x's by default). The JAX function takes the rows in any order with
    their tokens; the port's layer passes them token-major, as the JAX
    layer does."""
    _act_ok(act)
    n_used, tok_col, w_col, tok_pos = e2e_operands(row_pos, top_w, row_count, bm)
    return qmoe_mlp_e2e(
        x.to(torch.bfloat16).contiguous(), expert_ids, n_used, tok_col, w_col, tok_pos,
        gu.qweight, gu.scales, down.qweight, down.scales, bits=gu.bits, G_gu=gu.G,
        G_d=down.G, F=gu.out_features // 2, bm=bm, zc_gu=gu.zero_const,
        zc_d=down.zero_const, rt_gu=gu.rt, rt_d=down.rt, out_dtype=out_dtype or x.dtype)


def e2e_operands(row_pos, top_w, row_count, bm: int):
    """K10's plan operands from ``plan_rows``, on the device: ``n_used [1]``,
    each slot row's token ``tok_col`` (-1: padding) and weight ``w_col`` (0),
    and ``tok_pos [N, k]``, the padded rows of each token."""
    N, k = row_pos.shape
    rows = row_count.shape[0] * bm
    flat = row_pos.reshape(-1).long()
    tok_col = torch.full((rows,), -1, dtype=torch.int32, device=row_pos.device)
    tok_col[flat] = torch.arange(N * k, device=row_pos.device, dtype=torch.int32) // k
    w_col = torch.zeros((rows,), dtype=torch.float32, device=row_pos.device)
    w_col[flat] = top_w.reshape(-1).to(torch.float32)
    n_used = (row_count > 0).sum().to(torch.int32).reshape(1)
    return n_used, tok_col, w_col, row_pos.to(torch.int32).contiguous()


def qmoe_mlp_forward_sorted(x_sorted, expert_ids, row_count, gu: StackedQuantExperts,
                            down: StackedQuantExperts, *, act: str, bm: int = 8,
                            out_dtype=torch.float32):
    """The fused slot MLP over slot-sorted rows ``[S·bm, D]``: K11 (used
    slots, the default) or K12 (``GPTQ_TPU_QMOE_DYN=0``: the static grid)."""
    _act_ok(act)
    kw = dict(bits=gu.bits, G_gu=gu.G, G_d=down.G, F=gu.out_features // 2, bm=bm,
              zc_gu=gu.zero_const, zc_d=down.zero_const, out_dtype=out_dtype)
    x_sorted = x_sorted.to(torch.bfloat16).contiguous()
    if os.environ.get("GPTQ_TPU_QMOE_DYN", "1") != "0":
        n_used = (row_count > 0).sum().to(torch.int32).reshape(1)
        return qmoe_mlp_matmul_dyn(x_sorted, expert_ids, row_count, n_used, gu.qweight,
                                   gu.scales, down.qweight, down.scales, **kw)
    return qmoe_mlp_matmul(x_sorted, expert_ids, row_count, gu.qweight, gu.scales,
                           down.qweight, down.scales, **kw)


def qmoe_forward_sorted(x_sorted, expert_ids, row_count, p: StackedQuantExperts, *,
                        bm: int = 8, out_dtype=torch.float32):
    """One projection over slot-sorted rows through K13."""
    return qmoe_matmul(x_sorted.to(torch.bfloat16).contiguous(), expert_ids, row_count,
                       p.qweight, p.scales, bits=p.bits, G=p.G, bm=bm,
                       zero_const=p.zero_const, out_dtype=out_dtype)
