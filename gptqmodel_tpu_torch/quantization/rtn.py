"""RTN: round-to-nearest group quantization with no calibration.

The JAX package's ``quantization/rtn.py``: the failsafe for modules whose
input group saw fewer than ``fallback_min_samples`` rows, the last step of
``gptq_quantize``'s non-finite guard, and the ``mock_quantization`` path.
"""

from __future__ import annotations

import torch

from gptqmodel_tpu_torch.quantization.gptq import GPTQResult
from gptqmodel_tpu_torch.quantization.quantizer import find_params, quantize


def rtn_quantize(W, *, bits: int, group_size: int, sym: bool) -> GPTQResult:
    """Group-wise minmax quantization of ``W [out, in]`` on its device; the
    loss is the mean squared error against W, in float64."""
    W = torch.as_tensor(W).to(torch.float32)
    out_f, in_f = W.shape
    g = in_f if group_size in (-1, None) else group_size
    maxq = 2**bits - 1
    grouped = W.reshape(out_f, in_f // g, g).transpose(0, 1)  # [G, out, g]
    scales, zeros = find_params(grouped, bits=bits, sym=sym)
    q = quantize(grouped, scales[..., None], zeros[..., None], maxq)
    wq = scales[..., None] * (q - zeros[..., None])
    Wq = wq.transpose(0, 1).reshape(out_f, in_f)
    return GPTQResult(
        Q=q.transpose(0, 1).reshape(out_f, in_f).to(torch.int32), Wq=Wq,
        scales=scales, zeros=zeros,
        g_idx=(torch.arange(in_f, device=W.device) // g).to(torch.int32), perm=None,
        avg_loss=float(((Wq.double() - W.double()) ** 2).mean()), damp=0.0, nsamples=0,
    )
