"""The JAX package's params tree and ModelSpec, as the port's.

The tests build a model once with the JAX package and hand the same arrays to
both packages through these functions: packed trees (JAX ``QuantLinear``
leaves) and dense ones, such as a layer about to be quantized. They read the
JAX objects by their attributes and import nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gptqmodel_tpu_torch.device import resolve_device
from gptqmodel_tpu_torch.models.spec import ModelSpec
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear


def to_torch(a, device) -> torch.Tensor:
    """A numpy (or array-protocol) array as a torch tensor; bf16 by its bits."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def convert_quant_linear(p, device="cuda") -> QuantLinear:
    """A JAX ``QuantLinear`` in the storage layout (stitched or planar),
    before its ``post_init_module``. After it the JAX module may hold the TPU
    kernels' runtime repack (``rt_layout``: K1's permuted words, or at 3, 5,
    6 and 7 bits the plane-split words of ``repack_rt_planes``), which is no
    storage layout: such a module is refused, never passed on."""
    device = resolve_device(device)
    if getattr(p, "rt_layout", False) or getattr(p, "act_perm", None) is not None:
        raise ValueError("convert the module before the JAX post-init re-packs it")
    opt = lambda t: None if t is None else to_torch(t, device)
    return QuantLinear(
        qweight=to_torch(p.qweight, device), qzeros=to_torch(p.qzeros, device),
        scales=to_torch(p.scales, device), g_idx=opt(p.g_idx), bias=opt(p.bias),
        bits=p.bits, group_size=p.group_size, in_features=p.in_features,
        out_features=p.out_features, sym=p.sym, v1=p.v1, planar=p.planar,
    )


def convert_params(tree, device="cuda"):
    """Nested dicts/lists of arrays and JAX QuantLinears -> the port's tree."""
    device = resolve_device(device)
    if hasattr(tree, "qweight") and hasattr(tree, "qzeros"):
        return convert_quant_linear(tree, device)
    if isinstance(tree, dict):
        return {k: convert_params(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [convert_params(v, device) for v in tree]
    return to_torch(tree, device)


def convert_spec(spec) -> ModelSpec:
    """The fields of a JAX ``ModelSpec`` that the port's llama spec has."""
    names = {f.name for f in dataclasses.fields(ModelSpec)}
    return ModelSpec(**{n: getattr(spec, n) for n in names})
