"""Which computation a quantized module runs, and its runtime preparation.

There is no backend switch. On the card a module takes the route the JAX
package's registry takes on the TPU (``gptqmodel_tpu/ops/registry.py:91-162,
225-292``):

| module | route |
| --- | --- |
| contiguous or balanced act-order groups inside K1's contract (2/4/8 bits, groups a multiple of 128, ``qmatmul_supported``), one uniform zero point | K1 (``qmatmul``), after ``x[:, act_perm]`` for act-order; K7 (``qmatmul_fused``) instead under ``GPTQ_TPU_RT_FUSED=1`` |
| the same with a zero point per group (``zero_const < 0``) | K3 (``qmatmul_asym``), after the same gather |
| contiguous or balanced act-order groups of 3/5/6/7 bits inside K4's contract (groups a multiple of 128, N a multiple of 32, ``qmatmul_planes_supported``), stitched 3-bit or planar, one uniform zero point | K4 (``qmatmul_planes``), after the same gather |
| the same with a zero point per group | K5 (``qmatmul_planes_asym``), after the same gather |
| contiguous 2/4/8-bit groups outside K1's contract but inside K6's (``qmm_supported``: groups of 16, 32 or 64, N a multiple of 128), at most ``PALLAS_MAX_M`` rows | K6 (``qmm``) |
| the same, more rows; contiguous groups outside every kernel's contract (3/5/6/7 bits at groups that are not a multiple of 128 among them); any other ``g_idx`` (ragged, or act-order outside K1's or K4's contract); planar 2/4/8-bit words | the dequantize-then-matmul reference ``qlinear_forward_torch`` (the JAX package's XLA path) |

K1, K3, K4 and K5 modules stay on their kernel at every M, prefill
included, as the reference's rt-layout modules do; K6 modules take the reference above
``PALLAS_MAX_M`` rows, where the dequantized weight amortizes (JAX
``registry.py:119-150``). ``GPTQ_TPU_RT_FUSED`` is read at each forward, the
JAX package's own switch. Each wrapper launches its kernel for a CUDA
tensor and runs its plain version only for a CPU tensor. On a CUDA tensor
the reference route counts ``LAUNCHES["reference"]``. The port's K4 and K5
take any ``K % g == 0`` where the TPU kernels' tiles ask ``K % (16*g) ==
0`` (``ops/qmatmul.py``), so modules the JAX package runs on XLA for that
reason alone run K4 or K5 here. K2 (``qmlp``) takes an MLP only when
both its modules are K1's, with no act-order permutation (the JAX package's
``qmlp_forward`` refuses act-order and per-group zeros alike); it ignores
``GPTQ_TPU_RT_FUSED``, as the JAX package's does.

Stacked MoE experts (``ops/qmoe.py``) take K10, or with the JAX package's
switches K11/K12, when ``qmoe_supported`` holds, else K13 or the dense
fallback; the choice itself is ``models/transformer._moe_ragged_apply_q``.
``qmoe_supported`` is the JAX package's eligibility on bits, widths and
groups, without its TPU VMEM budgets. On the card a stack outside the kernels' own contract
(``qmoe_kernel_check``) raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from gptqmodel_tpu_torch.ops import _build
from gptqmodel_tpu_torch.ops import pack as packing
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear, qlinear_forward_torch
from gptqmodel_tpu_torch.ops.qmatmul import (
    PLANE_BITS,
    qmatmul,
    qmatmul_asym,
    qmatmul_fused,
    qmatmul_planes,
    qmatmul_planes_asym,
    qmatmul_planes_supported,
    qmatmul_supported,
    qmm,
    qmm_supported,
)
from gptqmodel_tpu_torch.ops.qmlp import qmlp, qmlp_supported
from gptqmodel_tpu_torch.ops.qmoe import KERNEL_BITS as QMOE_BITS
from gptqmodel_tpu_torch.ops.qmoe import kernel_contract

# Above this many rows a K6 module's product is compute-bound and the one
# dequantized weight amortizes (JAX registry.py:123).
PALLAS_MAX_M = 256


def _act_order_perm(p: QuantLinear) -> torch.Tensor | None:
    """The stable sort of ``g_idx`` when it is a balanced grouping (every one
    of the groups 0..G-1 has exactly ``group_size`` columns), as a GPTQ
    act-order permutation of contiguous groups is; None otherwise (a ragged
    ``g_idx`` keeps the reference route). JAX ``registry.py:225``."""
    if p.g_idx is None:
        return None
    g = p.in_features if p.group_size in (-1, None) else p.group_size
    if p.in_features % g:
        return None
    G = p.in_features // g
    gi = p.g_idx.long()
    if bool((gi < 0).any()) or bool((gi >= G).any()):
        return None
    if not bool((torch.bincount(gi, minlength=G) == g).all()):
        return None
    return torch.argsort(gi, stable=True).to(torch.int32)


def _rt_contract(p: QuantLinear) -> bool:
    """Inside K1's/K3's or K4's/K5's contract: the modules the JAX package
    prepares for its rt kernels (``registry.py:274-279``; planar storage
    only at 3/5/6/7 bits), without the TPU tile rule."""
    if p.bits in PLANE_BITS:
        return qmatmul_planes_supported(p.bits, p.group_size, p.in_features, p.out_features)
    return not p.planar and qmatmul_supported(p.bits, p.group_size, p.in_features,
                                              p.out_features)


def post_init_module(p: QuantLinear) -> QuantLinear:
    """Runtime preparation: v2 zeros, fp16 scales, the uniform zero point
    (``zero_const``, -1 when the zeros differ) that K1, K2 and K4 need, and
    for a balanced act-order module inside the kernels' contract the
    ``qweight`` rows permuted into group order on the module's device, in
    its own layout (stitched or planar), with ``act_perm`` (JAX
    ``registry.py:265-281``). Otherwise the packed weights stay in the
    storage layout. ``g_idx`` stays for the export."""
    if p.act_perm is not None:
        return p
    zeros = packing.unpack_qzeros(p.qzeros, p.bits, v1=p.v1, planar=p.planar)
    first = zeros.reshape(-1)[0]
    zero_const = float(first) if bool((zeros == first).all()) else -1.0
    qzeros = packing.convert_qzeros_v1_to_v2(p.qzeros, p.bits) if p.v1 else p.qzeros
    qweight, act_perm = p.qweight, None
    if p.g_idx is not None and _rt_contract(p):
        act_perm = _act_order_perm(p)
        if act_perm is not None:
            codes = packing.unpack_qweight(p.qweight, p.bits, planar=p.planar)
            qweight = packing.pack_qweight(codes[act_perm.long()], p.bits, planar=p.planar)
    return dataclasses.replace(
        p, qweight=qweight, qzeros=qzeros, scales=p.scales.to(torch.float16), v1=False,
        zero_const=zero_const, act_perm=act_perm,
    )


def post_init_params(tree):
    """Walk a params tree, preparing every QuantLinear. Dicts and lists are
    updated in place, so a module's loaded tensors go as soon as its
    prepared form exists: an act-order module's rows, permuted into new
    words, are not held twice for the whole tree."""
    if isinstance(tree, QuantLinear):
        return post_init_module(tree)
    if isinstance(tree, dict):
        for k, v in tree.items():
            tree[k] = post_init_params(v)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            tree[i] = post_init_params(v)
    return tree


def kernel_route(p: QuantLinear) -> str:
    """The module's route: ``"K1"`` or ``"K3"``, ``"K4"`` or ``"K5"`` (one
    zero point, or one per group); ``"K6"`` (the reference above
    ``PALLAS_MAX_M`` rows); ``"reference"`` for a ``g_idx`` that post-init
    did not bake into the rows and for a module outside every kernel's
    contract. JAX ``select_kernel`` (``registry.py:91-117``)."""
    if p.g_idx is not None and p.act_perm is None:
        return "reference"
    if _rt_contract(p):
        if p.bits in PLANE_BITS:
            return "K4" if p.zero_const >= 0 else "K5"
        return "K1" if p.zero_const >= 0 else "K3"
    if p.planar or p.bits in PLANE_BITS:
        return "reference"
    return ("K6" if qmm_supported(p.bits, p.group_size, p.in_features, p.out_features)
            else "reference")


def rt_fused() -> bool:
    """``GPTQ_TPU_RT_FUSED=1``: K1's modules run K7 (JAX
    ``pallas_qmatmul.py:669-673``)."""
    return os.environ.get("GPTQ_TPU_RT_FUSED", "0") == "1"


def mlp_fusable(gu: QuantLinear, down: QuantLinear) -> bool:
    """K2's module contract: both run K1, with no act-order permutation
    (down's input is the kernel's own intermediate, which no gather can
    reach; JAX ``registry.py:182-191``)."""
    return all(kernel_route(m) == "K1" and m.act_perm is None for m in (gu, down))


def qlinear_forward(p: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    route = kernel_route(p)
    if route == "K6" and x.numel() // p.in_features > PALLAS_MAX_M:
        route = "reference"
    if route == "reference":
        if x.device.type == "cuda":
            _build.LAUNCHES["reference"] += 1
        return qlinear_forward_torch(p, x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, p.in_features)
    # act-order: the rows are stored in group order; one gather of x's columns
    # replaces the per-row g_idx lookup (JAX registry.py:152-153)
    x2 = x2.contiguous() if p.act_perm is None else torch.index_select(x2, 1, p.act_perm)
    kw = dict(bits=p.bits, group_size=p.group_size)
    if route == "K1":
        k1 = qmatmul_fused if rt_fused() else qmatmul
        y = k1(x2, p.qweight, p.scales, zero_const=p.zero_const, **kw)
    elif route == "K3":
        y = qmatmul_asym(x2, p.qweight, p.scales, p.qzeros, **kw)
    elif route == "K4":
        y = qmatmul_planes(x2, p.qweight, p.scales, zero_const=p.zero_const, planar=p.planar,
                           **kw)
    elif route == "K5":
        y = qmatmul_planes_asym(x2, p.qweight, p.scales, p.qzeros, planar=p.planar, **kw)
    else:
        y = qmm(x2, p.qweight, p.scales, p.qzeros, zero_const=p.zero_const, **kw)
    y = y.reshape(*lead, p.out_features)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


def qmlp_forward(gu: QuantLinear, down: QuantLinear, x: torch.Tensor, act: str):
    """The fused MLP (K2), or None when the modules or the batch are outside
    its contract (the caller then runs the two projections)."""
    rows = x.numel() // x.shape[-1]
    D, F = gu.in_features, gu.out_features // 2
    if not (act == "silu" and mlp_fusable(gu, down)
            and gu.bias is None and gu.bits == down.bits
            and gu.group_size == down.group_size and down.in_features == F
            and qmlp_supported(bits=gu.bits, group_size=gu.group_size, D=D, F=F, M=rows)):
        return None
    y = qmlp(
        x.reshape(-1, D).contiguous(), gu.qweight, gu.scales, down.qweight, down.scales,
        bits=gu.bits, group_size=gu.group_size, zc_gu=gu.zero_const, zc_d=down.zero_const,
    ).reshape(*x.shape[:-1], down.out_features)
    if down.bias is not None:
        y = y + down.bias.to(y.dtype)
    return y


def qmoe_supported(*, bits, D, F, G_gu, G_d, act) -> bool:
    """K10's and K11/K12's eligibility for a fused gate|up stack and its down
    stack: the JAX package's ``qmoe_e2e_supported`` (``pallas_qmoe.py:892``)
    and ``qmoe_mlp_supported`` (``:404``) ask the same of bits, widths and
    groups and differ only in their TPU VMEM budgets, which the port has
    not."""
    if bits not in QMOE_BITS or act != "silu":
        return False
    pf = 32 // bits
    if D % pf or F % pf or (2 * F) % 128 or D % 128:
        return False
    # whole groups per extraction part of the JAX kernels' contracts
    rows_gu = (2 * D // pf) if bits != 8 else (D // pf)
    rows_d = (2 * F // pf) if bits != 8 else (F // pf)
    return rows_gu % G_gu == 0 and rows_d % G_d == 0


def qmoe_kernel_check(x: torch.Tensor, *stacks) -> None:
    """On the card, raise ``NotImplementedError`` for a stack outside the
    MoE kernels' contract, naming what they need; on the CPU the plain
    versions take any stack."""
    if x.device.type == "cpu":
        return
    for st in stacks:
        why = kernel_contract(st)
        if why is not None:
            raise NotImplementedError(f"no CUDA MoE kernel for this stack: {why}")
