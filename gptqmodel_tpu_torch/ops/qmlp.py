"""K2: fused quantized MLP ``down(bf16(silu(x @ W_gate) * (x @ W_up)))``.

The kernel (``csrc/qmlp.cu``) replaces the TPU kernel ``_qmlp_kernel``
(``gptqmodel_tpu/ops/pallas_qmlp.py:84``, via ``qmlp`` :140). It takes the
fused ``gate_up`` module (``[D/pf, 2F]``, gate columns first, as
``optimize.fuse_projections`` concatenates them) and ``down``, both
symmetric with a uniform zero point, at decode sizes (M <= 64). Like the TPU
kernel it keeps g and u in float32 and rounds ``inner`` to bf16 before down.
At M <= 16 both passes run the decode kernel (``csrc/qmm_decode.cuh``), each
with the split of its own launch plan: ``decode_plan(M, D, 2F, g)`` for
gate/up, whose tiles pair 32 gate columns with their up columns, and
``decode_plan(M, F, D, g)`` for down.

``qmlp`` launches the kernel for a CUDA tensor and uses ``qmlp_plain`` only
for a tensor on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from gptqmodel_tpu_torch.ops import _build
from gptqmodel_tpu_torch.ops.qmatmul import _check_operands, _decode_split, grouped_dot_f32

MAX_M = 64


def qmlp_supported(*, bits: int, group_size: int, D: int, F: int, M: int) -> bool:
    """K2's contract on shapes, re-derived for the interchange layout (the TPU
    kernel's ``qmlp_supported`` asks for its rt tiles instead). One group size
    serves both products, so a whole-row group (-1) is not taken."""
    g = group_size
    return (bits in (2, 4, 8) and g > 0 and g % 128 == 0 and D % g == 0
            and F % g == 0 and D % 8 == 0 and 1 <= M <= MAX_M)


def qmlp_plain(x, qw_gu, s_gu, qw_d, s_d, *, bits, group_size, zc_gu, zc_d):
    """Plain PyTorch version of K2: f32 gate and up, inner rounded to x's type."""
    F = qw_gu.shape[1] // 2
    gu = grouped_dot_f32(x, qw_gu, s_gu, bits=bits, group_size=group_size,
                         zero_const=zc_gu)
    inner = (F_.silu(gu[:, :F]) * gu[:, F:]).to(x.dtype)
    return grouped_dot_f32(inner, qw_d, s_d, bits=bits, group_size=group_size,
                           zero_const=zc_d).to(x.dtype)


def qmlp(x, qw_gu, s_gu, qw_d, s_d, *, bits, group_size, zc_gu, zc_d):
    """``x [M, D]`` -> ``[M, D]``. A CUDA tensor goes to the kernel (or
    raises); a CPU tensor to ``qmlp_plain``."""
    if x.device.type == "cpu":
        return qmlp_plain(x, qw_gu, s_gu, qw_d, s_d, bits=bits, group_size=group_size,
                          zc_gu=zc_gu, zc_d=zc_d)
    M, D = x.shape
    F = qw_gu.shape[1] // 2
    if not qmlp_supported(bits=bits, group_size=group_size, D=D, F=F, M=M):
        raise ValueError(f"K2 does not take bits={bits} group_size={group_size} "
                         f"D={D} F={F} M={M}")
    _check_operands(x, qw_gu, s_gu, bits=bits, group_size=group_size, zero_const=zc_gu)
    inner = torch.empty((M, F), dtype=torch.bfloat16, device=x.device)
    _check_operands(inner, qw_d, s_d, bits=bits, group_size=group_size, zero_const=zc_d)
    if qw_d.shape[1] != D:
        raise ValueError(f"down has {qw_d.shape[1]} outputs, x has {D} columns")
    out = torch.empty((M, D), dtype=torch.bfloat16, device=x.device)
    lib = _build.lib()
    split_gu = _decode_split(x, qw_gu, s_gu, group_size=group_size, name="K2")
    split_d = _decode_split(inner, qw_d, s_d, group_size=group_size, name="K2")
    rc = lib.gqt_qmlp(
        x.data_ptr(), M, D, F, qw_gu.data_ptr(), s_gu.data_ptr(), float(zc_gu),
        qw_d.data_ptr(), s_d.data_ptr(), float(zc_d), group_size, bits, split_gu, split_d,
        inner.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "qmlp")
    _build.LAUNCHES["qmlp"] += 1
    return out
