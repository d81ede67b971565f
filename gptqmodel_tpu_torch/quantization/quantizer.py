"""Uniform affine weight quantizer: minmax scale and zero search, on torch.

The JAX package's ``quantization/quantizer.py`` (minmax path): parameters are
computed over the last axis, codes ``q`` lie in ``[0, maxq]`` with
``maxq = 2**bits - 1``, and dequantization is ``scale * (q - zero)``.
Symmetric zero is ``(maxq + 1) / 2``, asymmetric ``round(-xmin / scale)``;
``torch.round`` rounds half to even, as ``jnp.round`` does. The MSE
grid-shrink search is a later slice's (ROADMAP queue 1, "GPTQ leftovers").
"""

from __future__ import annotations

import numpy as np
import torch


def _minmax(x: torch.Tensor, sym: bool):
    """Per-row min and max over the last axis, widened to include 0, folded
    for ``sym``; an all-zero row gets the unit range so the scale is not 0."""
    xmin = torch.clamp(x.amin(dim=-1), max=0.0)
    xmax = torch.clamp(x.amax(dim=-1), min=0.0)
    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    return torch.where(degenerate, -1.0, xmin), torch.where(degenerate, 1.0, xmax)


def _params_from_range(xmin, xmax, maxq: int, sym: bool):
    # the JAX package's scale as XLA computes it: the division by the
    # constant maxq becomes a product with its float32 reciprocal
    scale = (xmax - xmin) * np.float32(1.0 / maxq)
    if sym:
        return scale, torch.full_like(scale, (maxq + 1) / 2.0)
    return scale, torch.round(-xmin / scale)


def quantize(x, scale, zero, maxq: int):
    """x -> integer codes in [0, maxq] (float); scale and zero broadcast."""
    return torch.clamp(torch.round(x / scale) + zero, 0, maxq)


def dequantize(q, scale, zero):
    return scale * (q - zero)


def find_params(x: torch.Tensor, *, bits: int, sym: bool):
    """(scale, zero) over the last axis of ``x``, shaped ``x.shape[:-1]``."""
    maxq = 2**bits - 1
    xmin, xmax = _minmax(x.to(torch.float32), sym)
    return _params_from_range(xmin, xmax, maxq, sym)


def find_params_grouped(w: torch.Tensor, *, bits: int, group_size: int, sym: bool):
    """Group-wise (scale, zero) ``[n_groups, out]`` of ``w [out, in]``; group
    ``g`` covers input columns ``[g*group_size, (g+1)*group_size)``."""
    out_f, in_f = w.shape
    g = in_f if group_size in (-1, None) else group_size
    if in_f % g:
        raise ValueError(f"in_features {in_f} % group_size {g} != 0")
    grouped = w.reshape(out_f, in_f // g, g).transpose(0, 1)  # [G, out, g]
    return find_params(grouped, bits=bits, sym=sym)
