"""Quantized-linear parameters and the reference forward, on torch tensors.

``QuantLinear`` keeps the JAX package's layout (GPTQ interchange, see
``pack.py``), so the tests hand the same arrays to both packages. Compute
lives in ``registry.py``: the CUDA kernels for the card, and
``qlinear_forward_torch`` here, the dequantize-then-matmul reference that the
CPU and the tests use.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gptqmodel_tpu_torch.device import resolve_device
from gptqmodel_tpu_torch.ops import pack as packing


@dataclasses.dataclass
class QuantLinear:
    """A packed quantized linear layer.

    ``g_idx`` is None when groups are contiguous. ``v1`` marks qzeros still in
    the v1 (-1 offset) form; the loader converts them to v2. ``planar``
    marks the gptq_p layout of ``qweight`` and ``qzeros`` (``pack.py``; 5, 6
    and 7 bits have no other, planar zeros are always v2).
    ``zero_const`` is the uniform zero point found by
    ``registry.post_init_module`` (-1 when the zeros differ), which the
    symmetric kernels need. ``act_perm`` is runtime-only and never exported:
    for an act-order module it is the stable sort of ``g_idx`` by which
    post-init stored the ``qweight`` rows in group order; the forward gathers
    x's columns by it and the writer puts the rows back."""

    qweight: torch.Tensor  # int32 [in*bits/32, out]
    qzeros: torch.Tensor  # int32 [groups, out*bits/32]
    scales: torch.Tensor  # float16 [groups, out]
    g_idx: torch.Tensor | None  # int32 [in] or None
    bias: torch.Tensor | None
    act_perm: torch.Tensor | None = None  # int32 [in], runtime-only
    bits: int = 4
    group_size: int = 128
    in_features: int = 0
    out_features: int = 0
    sym: bool = True
    v1: bool = False
    zero_const: float = -1.0
    planar: bool = False

    def to(self, device) -> "QuantLinear":
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, qweight=move(self.qweight), qzeros=move(self.qzeros),
            scales=move(self.scales), g_idx=move(self.g_idx), bias=move(self.bias),
            act_perm=move(self.act_perm),
        )


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def make_quant_linear(
    *,
    Q,  # int codes [out, in]
    scales,  # [groups, out]
    zeros,  # [groups, out] integer zero points (v2 semantics)
    g_idx,  # [in] or None
    bias,
    bits: int,
    group_size: int,
    sym: bool = True,
    v1: bool = False,
    planar: bool = False,
    device: str | torch.device = "cuda",
) -> QuantLinear:
    """Pack integer codes and group parameters (numpy arrays, or tensors,
    packed where they lie) into a QuantLinear on ``device``; 5, 6 and 7 bits
    pack planar whatever ``planar`` says (JAX ``ops/qlinear.py:118-124``)."""
    Q = _tensor(Q)
    out_f, in_f = Q.shape
    g = in_f if group_size in (-1, None) else group_size
    planar = planar or bits in packing.PLANAR_ONLY_BITS
    if planar and v1:
        raise ValueError("planar (gptq_p) zeros are always v2")
    qweight = packing.pack_qweight(Q.T.contiguous(), bits, planar=planar)
    qzeros = packing.pack_qzeros(_tensor(zeros), bits, v1=v1, planar=planar)
    if g_idx is not None:
        g_idx = _tensor(g_idx).to(torch.int32)
        if torch.equal(g_idx.long(), torch.arange(in_f, device=g_idx.device) // g):
            g_idx = None
    return QuantLinear(
        qweight=qweight,
        qzeros=qzeros,
        scales=_tensor(scales).to(torch.float16),
        g_idx=g_idx,
        bias=None if bias is None else _tensor(bias),
        bits=bits, group_size=group_size, in_features=in_f, out_features=out_f,
        sym=sym, v1=v1, planar=planar,
    ).to(resolve_device(device))


def dequantize_weight(p: QuantLinear, dtype=torch.float32) -> torch.Tensor:
    """Unpack and dequantize to a dense ``w [in, out]`` (``y = x @ w``)."""
    codes = packing.unpack_qweight(p.qweight, p.bits, planar=p.planar)
    if p.act_perm is not None:  # runtime group order -> the order of g_idx
        codes = codes[torch.argsort(p.act_perm.long())]
    zeros = packing.unpack_qzeros(p.qzeros, p.bits, v1=p.v1, planar=p.planar)
    scales = p.scales.to(dtype)
    if p.g_idx is not None:
        gi = p.g_idx.long()
        return scales[gi] * (codes - zeros[gi]).to(dtype)
    g = p.in_features if p.group_size in (-1, None) else p.group_size
    z = zeros.repeat_interleave(g, dim=0)[: p.in_features]
    s = scales.repeat_interleave(g, dim=0)[: p.in_features]
    return (codes - z).to(dtype) * s


def qlinear_forward_torch(p: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    """Reference forward: dequantize, then matmul in the activation type.

    Counterpart of the JAX package's ``qlinear_forward_xla``: for bf16
    activations the dequantization runs in bf16, else in float32."""
    if x.dtype == torch.bfloat16:
        w = dequantize_weight(p, dtype=torch.bfloat16)
    else:
        w = dequantize_weight(p, dtype=torch.float32).to(x.dtype)
    y = torch.matmul(x, w)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y
