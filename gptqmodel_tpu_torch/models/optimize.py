"""Inference-time rewrites of the params tree that keep the results.

``fuse_projections`` merges q/k/v into ``qkv_proj`` and gate/up into
``gate_up_proj`` (concatenated along the output columns, gate first), so one
wider K1 or K3 launch replaces three or two; act-order members fuse when they
share their permutation. ``stack_moe_experts`` stacks each
layer's packed experts for the MoE kernels (``ops/qmoe.py``).
``enable_fused_mlp`` marks the layers whose MLP K2 can run. The JAX
package's version also re-packs down to the TPU kernel's tile; the port's
kernels read the interchange layout, so there is nothing to re-pack.
"""

from __future__ import annotations

import dataclasses

import torch

from gptqmodel_tpu_torch.models.spec import ModelSpec
from gptqmodel_tpu_torch.models.transformer import model_layers
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear
from gptqmodel_tpu_torch.ops.qmoe import fuse_gate_up, stack_packed_experts
from gptqmodel_tpu_torch.ops.registry import mlp_fusable


def _same_order(m: QuantLinear, a: QuantLinear) -> bool:
    """Members share the order of their input columns: all contiguous, or all
    act-order with one ``g_idx`` and a permutation baked in at post-init
    (q/k/v and gate/up share their Hessian, so their permutations match).
    A ``g_idx`` the reference route runs stays per module. JAX
    ``optimize.py:28-40``."""
    if (m.g_idx is None) != (a.g_idx is None) or (m.act_perm is None) != (a.act_perm is None):
        return False
    if m.g_idx is None:
        return True
    return m.act_perm is not None and torch.equal(m.g_idx, a.g_idx)


def _can_fuse(mods: list) -> bool:
    if not all(isinstance(m, QuantLinear) for m in mods):
        return False
    a = mods[0]
    return all(
        m.bits == a.bits and m.group_size == a.group_size and m.planar == a.planar
        and m.in_features == a.in_features and m.v1 == a.v1 and _same_order(m, a)
        and (m.bias is None) == (a.bias is None)
        for m in mods
    )


def _concat_quant(mods: list[QuantLinear]) -> QuantLinear:
    """Concatenate along out-features (the last axis of every tensor); the
    first member's ``g_idx`` and ``act_perm`` serve all."""
    a = mods[0]
    cat = lambda f: torch.cat([getattr(m, f) for m in mods], dim=-1)
    return dataclasses.replace(
        a,
        qweight=cat("qweight"), qzeros=cat("qzeros"), scales=cat("scales"),
        bias=cat("bias") if a.bias is not None else None,
        out_features=sum(m.out_features for m in mods),
        # a uniform zero point survives fusion only if every member shares it
        zero_const=(a.zero_const if all(m.zero_const == a.zero_const for m in mods)
                    else -1.0),
    )


def fuse_projections(spec: ModelSpec, params: dict) -> dict:
    """In place: merge attention q/k/v and mlp gate/up per layer when safe."""
    for lp in model_layers(params):
        attn = lp["self_attn"]
        if all(k in attn for k in ("q_proj", "k_proj", "v_proj")):
            mods = [attn["q_proj"], attn["k_proj"], attn["v_proj"]]
            if _can_fuse(mods):
                attn["qkv_proj"] = _concat_quant(mods)
                del attn["q_proj"], attn["k_proj"], attn["v_proj"]
        mlp = lp["mlp"]
        if all(k in mlp for k in ("gate_proj", "up_proj")) and "experts" not in mlp:
            mods = [mlp["gate_proj"], mlp["up_proj"]]
            if _can_fuse(mods):
                mlp["gate_up_proj"] = _concat_quant(mods)
                del mlp["gate_proj"], mlp["up_proj"]
    return params


def stack_moe_experts(spec: ModelSpec, params: dict) -> dict:
    """In place, layer by layer: a list of packed experts becomes
    ``experts_stacked_q`` (``{"gateup", "down"}``, or ``{"gate", "up",
    "down"}`` where gate and up differ in geometry), stacked on the experts'
    device, and the per-expert modules are dropped as soon as their layer is
    stacked, so the experts are never held twice. A layer whose experts are
    outside the stack's contract keeps its list (the dense loop). The
    stacked form has bf16 scales and exists at runtime only: ``save`` refuses
    it. The JAX package's packed branch (``optimize.py:91-150``)."""
    for lp in model_layers(params):
        mp = lp["mlp"]
        experts = mp.get("experts")
        if not experts or not all(isinstance(e.get("gate_proj"), QuantLinear)
                                  for e in experts):
            continue
        sq = {name: stack_packed_experts([e[f"{name}_proj"] for e in experts])
              for name in ("gate", "up", "down")}
        if any(v is None for v in sq.values()):
            continue
        fused = fuse_gate_up(sq["gate"], sq["up"])
        mp["experts_stacked_q"] = sq if fused is None else {"gateup": fused,
                                                             "down": sq["down"]}
        del mp["experts"]
    return params


def enable_fused_mlp(spec: ModelSpec, params: dict) -> dict:
    """In place: mark MLPs with a fused packed ``gate_up_proj`` (run
    ``fuse_projections`` first) and a packed ``down_proj`` that K2's contract
    can take; ``gated_mlp`` then tries K2 before the two projections. The
    mark ``_fused`` is runtime-only, as ``_``-prefixed params are in the JAX
    package."""
    for lp in model_layers(params):
        mlp = lp["mlp"]
        gu, down = mlp.get("gate_up_proj"), mlp.get("down_proj")
        if (isinstance(gu, QuantLinear) and isinstance(down, QuantLinear)
                and mlp_fusable(gu, down)):
            mlp["_fused"] = True
    return params
