"""Which computation a quantized module runs, and its runtime preparation.

There is no backend switch. A module inside K1's contract (symmetric, one
uniform zero point, contiguous groups, 2/4/8 bits) runs ``qmatmul``, which
launches the kernel for a CUDA tensor and runs its plain version only for a
CPU tensor. A module outside the contract runs the dequantize-then-matmul
reference on the CPU, and raises ``NotImplementedError`` on the card, naming
the TPU kernel whose port a later slice brings.

Stacked MoE experts (``ops/qmoe.py``) take K10, or with the JAX package's
switches K11/K12, when ``qmoe_supported`` holds, else K13 or the dense
fallback; the choice itself is ``models/transformer._moe_ragged_apply_q``.
``qmoe_supported`` is the JAX package's eligibility on bits, widths and
groups, without its TPU VMEM budgets. On the card a stack outside the kernels' own contract
(``qmoe_kernel_check``) raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from gptqmodel_tpu_torch.ops import pack as packing
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear, qlinear_forward_torch
from gptqmodel_tpu_torch.ops.qmatmul import qmatmul, qmatmul_supported
from gptqmodel_tpu_torch.ops.qmlp import qmlp, qmlp_supported
from gptqmodel_tpu_torch.ops.qmoe import KERNEL_BITS as QMOE_BITS
from gptqmodel_tpu_torch.ops.qmoe import kernel_contract


def post_init_module(p: QuantLinear) -> QuantLinear:
    """Runtime preparation: v2 zeros, fp16 scales, and the uniform zero point
    (``zero_const``, -1 when the zeros differ) that K1 and K2 need. The
    packed weights stay in the interchange layout."""
    zeros = packing.unpack_qzeros(p.qzeros, p.bits, v1=p.v1)
    first = zeros.reshape(-1)[0]
    zero_const = float(first) if bool((zeros == first).all()) else -1.0
    qzeros = packing.convert_qzeros_v1_to_v2(p.qzeros, p.bits) if p.v1 else p.qzeros
    return dataclasses.replace(
        p, qzeros=qzeros, scales=p.scales.to(torch.float16), v1=False,
        zero_const=zero_const,
    )


def post_init_params(tree):
    """Walk a params tree, preparing every QuantLinear."""
    if isinstance(tree, QuantLinear):
        return post_init_module(tree)
    if isinstance(tree, dict):
        return {k: post_init_params(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [post_init_params(v) for v in tree]
    return tree


def k1_eligible(p: QuantLinear) -> bool:
    return (p.zero_const >= 0 and p.g_idx is None
            and qmatmul_supported(p.bits, p.group_size, p.in_features, p.out_features))


def _later_kernel(p: QuantLinear) -> str:
    """The TPU kernel that would run this module, ported in a later slice."""
    if p.bits in (3, 5, 6, 7):
        return ("K4 _qmm_rtp_sym_kernel" if p.zero_const >= 0
                else "K5 _qmm_rtp_kernel") + " (ops/pallas_qmatmul.py)"
    if p.g_idx is not None:
        return "K6 _qmm_kernel with the act-order permutation (ops/pallas_qmatmul.py:55)"
    if p.zero_const < 0:
        return "K3 _qmm_rt_kernel (ops/pallas_qmatmul.py:117)"
    return "K6 _qmm_kernel (ops/pallas_qmatmul.py:55)"


def qlinear_forward(p: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    if not k1_eligible(p):
        if x.device.type == "cpu":
            return qlinear_forward_torch(p, x)
        raise NotImplementedError(
            f"no CUDA kernel yet for bits={p.bits} group_size={p.group_size} "
            f"zero_const={p.zero_const} g_idx={'set' if p.g_idx is not None else 'none'}: "
            f"needs the port of {_later_kernel(p)}"
        )
    lead = x.shape[:-1]
    y = qmatmul(
        x.reshape(-1, p.in_features).contiguous(), p.qweight, p.scales,
        bits=p.bits, group_size=p.group_size, zero_const=p.zero_const,
    ).reshape(*lead, p.out_features)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


def qmlp_forward(gu: QuantLinear, down: QuantLinear, x: torch.Tensor, act: str):
    """The fused MLP (K2), or None when the modules or the batch are outside
    its contract (the caller then runs the two projections)."""
    rows = x.numel() // x.shape[-1]
    D, F = gu.in_features, gu.out_features // 2
    if not (act == "silu" and k1_eligible(gu) and k1_eligible(down)
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
