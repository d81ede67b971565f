"""Functional llama and qwen3_moe forward on torch tensors.

The subset of the JAX package's ``models/transformer.py`` that the port
serves, with the same params layout (nested dicts mirroring the HF tensor
names, packed linears as ``QuantLinear``) and the same rounding points:
norms and softmax in float32, attention logits in float32, probabilities
cast to the activation type. Attention is plain torch ops, as the
reference's is plain XLA. The port updates the KV cache in place, which the
JAX package cannot: it saves a copy of the cache on every step.

qwen3_moe adds the per-head RMSNorm on q and k and the routed experts
(``moe_mlp``): a dense router, softmax, top-k with ties to the lower index,
renormalization, then either the dense loop over the experts of an
un-stacked tree or, after ``optimize``, the stacked packed dispatch
(``_moe_ragged_apply_q``) through the MoE kernels of ``ops/qmoe.py``.

Quantization records module inputs through taps (the JAX package's
``_tap``): ``decoder_layer(..., taps={}, tap_paths={...})`` stores the input
of each named module in ``taps`` and raises ``TapsComplete`` once all are
recorded, so the forward past the last tap never runs (XLA drops that work
in the reference); without taps nothing changes.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F_

from gptqmodel_tpu_torch.models.spec import ModelSpec
from gptqmodel_tpu_torch.ops import qmoe
from gptqmodel_tpu_torch.ops.pack import unpack_qweight
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear
from gptqmodel_tpu_torch.ops.registry import (
    qlinear_forward,
    qmlp_forward,
    qmoe_kernel_check,
    qmoe_supported,
)

Params = dict[str, Any]

NEG = float(np.finfo(np.float32).min)


class TapsComplete(Exception):
    """Every requested tap is recorded; the rest of the forward is not needed."""


def _tap(taps, tap_paths, path: str, x: torch.Tensor) -> None:
    if taps is not None and path in tap_paths:
        taps[path] = x
        if len(taps) == len(tap_paths):
            raise TapsComplete


def apply_linear(p, x: torch.Tensor) -> torch.Tensor:
    """A packed ``QuantLinear`` or a dense HF-layout ``{"weight": [out, in]}``."""
    if isinstance(p, QuantLinear):
        return qlinear_forward(p, x)
    y = x @ p["weight"].T.to(x.dtype)
    b = p.get("bias")
    return y if b is None else y + b.to(y.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (normed * w.to(torch.float32)).to(x.dtype)


def rope_inv_freq(spec: ModelSpec) -> np.ndarray:
    """Inverse frequencies (float32), default or llama3/linear scaling."""
    dim = spec.head_dim
    inv = 1.0 / spec.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    rs = spec.rope_scaling
    kind = rs.get("rope_type", rs.get("type")) if rs else None
    if kind == "linear":
        inv = inv / rs["factor"]
    elif kind == "llama3":
        factor = rs["factor"]
        lo = rs.get("low_freq_factor", 1.0)
        hi = rs.get("high_freq_factor", 4.0)
        orig = rs.get("original_max_position_embeddings", 8192)
        wavelen = 2 * np.pi / inv
        smooth = (orig / wavelen - lo) / (hi - lo)
        inv = np.where(
            wavelen > orig / lo, inv / factor,
            np.where(wavelen < orig / hi, inv, (1 - smooth) / factor * inv + smooth * inv),
        )
    elif kind not in (None, "default"):
        raise NotImplementedError(f"rope scaling {kind!r}")
    return inv.astype(np.float32)


def rope_cos_sin(inv_freq: torch.Tensor, positions: torch.Tensor):
    """positions [B, T] -> (cos, sin) [B, T, head_dim] float32. ``inv_freq``
    (``rope_inv_freq``) lies on the positions' device already: a copy from
    the host here would wait for the card on every decode step."""
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k [B, H, T, D]; cos, sin [B, T, D] (rotate-half convention)."""
    c = cos[:, None].to(q.dtype)
    s = sin[:, None].to(q.dtype)
    return q * c + _rotate_half(q) * s, k * c + _rotate_half(k) * s


def kv_quantize(t: torch.Tensor):
    """Per-(batch, head, position) absmax int8: [B,H,T,D] -> (int8, f32 scales)."""
    tf = t.to(torch.float32)
    s = torch.clamp(tf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(tf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def cache_write_read(cache: dict, k, v, dtype):
    """Write k, v [B, H, T, D] at the cache's uniform write pointer, in place,
    and return the whole span (dequantized for an int8 cache)."""
    pos, T = cache["pos"], k.shape[2]
    if "k_s" in cache:
        (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
        cache["k"][:, :, pos:pos + T] = kq
        cache["v"][:, :, pos:pos + T] = vq
        cache["k_s"][:, :, pos:pos + T] = ks
        cache["v_s"][:, :, pos:pos + T] = vs
        kf = cache["k"].to(dtype) * cache["k_s"][..., None].to(dtype)
        vf = cache["v"].to(dtype) * cache["v_s"][..., None].to(dtype)
    else:
        cache["k"][:, :, pos:pos + T] = k.to(cache["k"].dtype)
        cache["v"][:, :, pos:pos + T] = v.to(cache["v"].dtype)
        kf, vf = cache["k"], cache["v"]
    cache["pos"] = pos + T
    return kf, vf, cache


def attention(spec: ModelSpec, ap: Params, h: torch.Tensor, cos, sin, attn_bias,
              cache: Optional[dict] = None, taps=None, tap_paths=frozenset()):
    B, T, _ = h.shape
    nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    if "qkv_proj" in ap:
        qf, kf, vf = torch.split(apply_linear(ap["qkv_proj"], h),
                                 [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        for name in ("q_proj", "k_proj", "v_proj"):
            _tap(taps, tap_paths, f"self_attn.{name}", h)
        qf = apply_linear(ap["q_proj"], h)
        kf = apply_linear(ap["k_proj"], h)
        vf = apply_linear(ap["v_proj"], h)
    q = qf.reshape(B, T, nh, hd)
    k = kf.reshape(B, T, nkv, hd)
    if spec.qk_norm:  # qwen3: per-head RMSNorm before RoPE
        q = rms_norm(q, ap["q_norm"]["weight"], spec.rms_norm_eps)
        k = rms_norm(k, ap["k_norm"]["weight"], spec.rms_norm_eps)
    q, k = q.transpose(1, 2), k.transpose(1, 2)
    v = vf.reshape(B, T, nkv, hd).transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)
    if cache is not None:
        k, v, cache = cache_write_read(cache, k, v, q.dtype)
    rep = nh // nkv
    # grouped-query attention without repeating K/V: fold the group into q
    qg = q.reshape(B, nkv, rep, T, hd)
    logits = torch.einsum("bgrqd,bgkd->bgrqk", qg.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    if attn_bias is not None:
        logits = logits + attn_bias.to(torch.float32)[:, :, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bgkd->bgrqd", probs, v.to(q.dtype))
    out = out.reshape(B, nh, T, hd).transpose(1, 2).reshape(B, T, nh * hd)
    _tap(taps, tap_paths, "self_attn.o_proj", out)
    return apply_linear(ap["o_proj"], out), cache


def _act(name: str):
    if name != "silu":
        raise NotImplementedError(f"hidden_act {name!r}")
    return F_.silu


def gated_mlp(spec: ModelSpec, mp: Params, h: torch.Tensor, taps=None,
              tap_paths=frozenset()) -> torch.Tensor:
    if "gate_up_proj" in mp:
        if mp.get("_fused") and taps is None:  # optimize.enable_fused_mlp
            y = qmlp_forward(mp["gate_up_proj"], mp["down_proj"], h, spec.hidden_act)
            if y is not None:
                return y
        g, u = torch.chunk(apply_linear(mp["gate_up_proj"], h), 2, dim=-1)
    else:
        _tap(taps, tap_paths, "mlp.gate_proj", h)
        _tap(taps, tap_paths, "mlp.up_proj", h)
        g = apply_linear(mp["gate_proj"], h)
        u = apply_linear(mp["up_proj"], h)
    inner = _act(spec.hidden_act)(g) * u
    _tap(taps, tap_paths, "mlp.down_proj", inner)
    return apply_linear(mp["down_proj"], inner)


# ----------------------------------------------------------------- experts


def _topk(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index. ``torch.topk`` leaves the order of ties open, so this is a stable
    descending sort, which keeps equal values in index order on the CPU and
    on the card."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_dequant_stacked(st: qmoe.StackedQuantExperts, e: int) -> torch.Tensor:
    """One stacked expert dequantized to bf16 ``[in, out]``."""
    q = unpack_qweight(st.qweight[e], st.bits).to(torch.float32)
    g = st.in_features // st.G
    sc = st.scales[e][:st.G].to(torch.float32)
    wd = (q.reshape(st.G, g, -1) - st.zero_const) * sc[:, None, :]
    return wd.reshape(st.in_features, -1).to(torch.bfloat16)


def _moe_packed_dense_fallback(spec: ModelSpec, sq: dict, x, top_w, top_i):
    """Every expert on every token, one expert dequantized at a time, then
    ``torch.matmul`` (plain XLA in the reference): the path of large
    dispatches off K10 and of rt stacks that K10 does not take."""
    N, D = x.shape
    gu = sq.get("gateup")
    E = (gu or sq["gate"]).qweight.shape[0]
    # add, not set: duplicate expert ids in a row sum, as the slot paths do
    w_full = torch.zeros((N, E), dtype=torch.float32, device=x.device).scatter_add_(
        1, top_i.long(), top_w.to(torch.float32))
    xb = x.to(torch.bfloat16)
    act = _act(spec.hidden_act)
    out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    for e in range(E):
        if gu is not None:
            gw, uw = torch.chunk(_moe_dequant_stacked(gu, e), 2, dim=-1)
        else:
            gw, uw = _moe_dequant_stacked(sq["gate"], e), _moe_dequant_stacked(sq["up"], e)
        inner = (act(xb @ gw) * (xb @ uw)).to(torch.bfloat16)
        y = (inner @ _moe_dequant_stacked(sq["down"], e)).to(torch.float32)
        out = out + y * w_full[:, e, None]
    return out.to(x.dtype)


# the token-row bound of the slot paths (K11-K13); larger dispatches off K10
# take the dense fallback, as in the reference
_QMOE_MAX_TOKENS = 1024


def _env_on(name: str) -> bool:
    return os.environ.get(name, "1") != "0"


def _combine_sorted(y, pos, w, order, N: int, k: int) -> torch.Tensor:
    """``out[tok] += y[pos]·w`` in float32, each token's rows added from 0 in
    sorted (ascending expert) order, with no atomics."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    mine = torch.sort(inv.reshape(N, k), dim=1).values  # sorted rows of each token
    acc = torch.zeros((N, y.shape[1]), dtype=torch.float32, device=y.device)
    for j in range(k):
        r = mine[:, j]
        acc = acc + y[pos[r].long()].to(torch.float32) * w[r, None]
    return acc


def _moe_ragged_apply_q(spec: ModelSpec, sq: dict, x, top_w, top_i):
    """Packed stacked experts, as ``transformer.py:970`` picks the kernel:
    K10 by default; with ``GPTQ_TPU_QMOE_E2E=0`` or ``GPTQ_TPU_QMOE_FUSED=0``
    the slot paths (K11, or K12 with ``GPTQ_TPU_QMOE_DYN=0``, or K13 with
    ``FUSED=0``) over at most ``_QMOE_MAX_TOKENS`` routed rows; rt stacks
    and larger dispatches off K10 take the dense fallback. The port does not
    cut a prefill into token chunks: no VMEM bounds the kernel, and each
    token's result does not depend on the others."""
    N, D = x.shape
    k = top_i.shape[1]
    M = N * k
    gate, up, down = sq.get("gate"), sq.get("up"), sq["down"]
    gu = sq.get("gateup")
    E = (gu or gate).qweight.shape[0]
    flat_e = top_i.reshape(-1)
    fused_ok = gu is not None and qmoe_supported(
        bits=gu.bits, D=gu.in_features, F=gu.out_features // 2, G_gu=gu.G, G_d=down.G,
        act=spec.hidden_act)
    if fused_ok and _env_on("GPTQ_TPU_QMOE_E2E") and _env_on("GPTQ_TPU_QMOE_FUSED"):
        bm = qmoe.slot_rows(M)
        qmoe_kernel_check(x, gu, down)
        ids, counts, row_pos = qmoe.plan_rows(flat_e, E, bm, qmoe.slot_bound(M, E, bm))
        return qmoe.qmoe_mlp_forward_e2e(x, row_pos.reshape(N, k), top_w, ids, counts,
                                         gu, down, act=spec.hidden_act, bm=bm)
    if M > _QMOE_MAX_TOKENS or any(s is not None and s.rt for s in (gu, gate, up, down)):
        return _moe_packed_dense_fallback(spec, sq, x, top_w, top_i)
    qmoe_kernel_check(x, *(s for s in (gu, gate, up, down) if s is not None))
    bm = 8
    S = qmoe.slot_bound(M, E, bm)
    order = torch.sort(flat_e, stable=True).indices
    ids, counts, pos = qmoe.plan_slots(flat_e[order], E, bm, S)
    w = top_w.reshape(-1)[order].to(torch.float32)
    bf = torch.bfloat16 if _env_on("GPTQ_TPU_QMOE_BF16") else torch.float32
    xs = torch.zeros((S * bm, D), dtype=torch.bfloat16, device=x.device)
    xs[pos.long()] = x[order // k].to(torch.bfloat16)
    if fused_ok and _env_on("GPTQ_TPU_QMOE_FUSED"):
        y = qmoe.qmoe_mlp_forward_sorted(xs, ids, counts, gu, down, act=spec.hidden_act,
                                         bm=bm, out_dtype=bf)
        return _combine_sorted(y, pos, w, order, N, k).to(x.dtype)
    if gu is not None:
        g, u = torch.chunk(qmoe.qmoe_forward_sorted(xs, ids, counts, gu, bm=bm, out_dtype=bf),
                           2, dim=-1)
    else:
        g = qmoe.qmoe_forward_sorted(xs, ids, counts, gate, bm=bm, out_dtype=bf)
        u = qmoe.qmoe_forward_sorted(xs, ids, counts, up, bm=bm, out_dtype=bf)
    inner = (_act(spec.hidden_act)(g.to(torch.float32)) * u.to(torch.float32)).to(
        torch.bfloat16)
    y = qmoe.qmoe_forward_sorted(inner, ids, counts, down, bm=bm, out_dtype=bf)
    return _combine_sorted(y, pos, w, order, N, k).to(x.dtype)


def moe_mlp(spec: ModelSpec, mp: Params, h: torch.Tensor) -> torch.Tensor:
    """Top-k routed experts (qwen3_moe): the dense bf16 router, softmax in
    float32, top-k, renormalization, then the stacked packed dispatch or the
    dense loop over an un-stacked expert list."""
    if spec.moe_scoring != "softmax":
        raise NotImplementedError(f"moe_scoring {spec.moe_scoring!r}: the port routes "
                                  "with softmax")
    extra = {"shared_expert", "shared_experts", "shared_mlp"} & set(mp)
    if extra:
        raise NotImplementedError(f"{sorted(extra)}: the port's MoE has routed experts only")
    B, T, D = h.shape
    x = h.reshape(B * T, D)
    logits = apply_linear(mp["gate"], x).to(torch.float32)
    top_w, top_i = _topk(torch.softmax(logits, dim=-1), spec.num_experts_per_tok)
    if spec.norm_topk_prob:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    if "experts_stacked_q" in mp:
        return _moe_ragged_apply_q(spec, mp["experts_stacked_q"], x, top_w,
                                   top_i).reshape(B, T, D)
    # the dense loop: every expert on every token, weighted (0 where unrouted)
    w_full = torch.zeros((B * T, spec.num_experts), dtype=torch.float32,
                         device=x.device).scatter_(1, top_i, top_w)
    out = torch.zeros_like(x)
    for e, ep in enumerate(mp["experts"]):
        out = out + gated_mlp(spec, ep, x) * w_full[:, e, None].to(x.dtype)
    return out.reshape(B, T, D)


def decoder_layer(spec: ModelSpec, lp: Params, h, cos, sin, attn_bias,
                  cache: Optional[dict] = None, taps=None, tap_paths=frozenset()):
    """One llama or qwen3_moe layer: ``(h', cache)``. With ``taps`` (a dict)
    it records the inputs of the modules named in ``tap_paths`` and raises
    ``TapsComplete`` when the last is recorded (dense MLPs only)."""
    normed = rms_norm(h, lp["input_layernorm"]["weight"], spec.rms_norm_eps)
    attn_out, cache = attention(spec, lp["self_attn"], normed, cos, sin, attn_bias, cache,
                                taps, tap_paths)
    h = h + attn_out
    normed2 = rms_norm(h, lp["post_attention_layernorm"]["weight"], spec.rms_norm_eps)
    mp = lp["mlp"]
    if spec.num_experts > 0 and ("experts" in mp or "experts_stacked_q" in mp):
        if taps is not None:
            raise NotImplementedError("taps inside routed experts: the port quantizes "
                                      "dense MLPs only")
        return h + moe_mlp(spec, mp, normed2), cache
    return h + gated_mlp(spec, mp, normed2, taps, tap_paths), cache


def model_layers(params: Params) -> list:
    return params["model"]["layers"]


def embed(params: Params, input_ids: torch.Tensor, dtype) -> torch.Tensor:
    return params["model"]["embed_tokens"]["weight"][input_ids].to(dtype)


def final_norm(spec: ModelSpec, params: Params, h: torch.Tensor) -> torch.Tensor:
    return rms_norm(h, params["model"]["norm"]["weight"], spec.rms_norm_eps)


def lm_logits(spec: ModelSpec, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """The dense bf16 head is a plain matmul, as XLA computes it in the
    reference; a packed head goes through the registry."""
    if spec.tie_word_embeddings or "lm_head" not in params:
        return hidden @ params["model"]["embed_tokens"]["weight"].T.to(hidden.dtype)
    return apply_linear(params["lm_head"], hidden)


def causal_mask(q_len: int, kv_len: int, device) -> torch.Tensor:
    """Additive causal mask [1, 1, q_len, kv_len], the query block aligned to
    the end of the kv span."""
    qi = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    ki = torch.arange(kv_len, device=device)[None, :]
    return torch.where(ki <= qi, 0.0, NEG).to(torch.float32)[None, None]


def forward_logits(spec: ModelSpec, params: Params, input_ids: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Logits [B, T, V] of a full causal forward, no cache."""
    B, T = input_ids.shape
    positions = torch.arange(T, device=input_ids.device).expand(B, T)
    inv_freq = torch.from_numpy(rope_inv_freq(spec)).to(input_ids.device)
    cos, sin = rope_cos_sin(inv_freq, positions)
    bias = causal_mask(T, T, input_ids.device)
    h = embed(params, input_ids, dtype)
    for lp in model_layers(params):
        h, _ = decoder_layer(spec, lp, h, cos, sin, bias)
    return lm_logits(spec, params, final_norm(spec, params, h))
