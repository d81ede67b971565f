"""Functional llama forward on torch tensors.

The llama subset of the JAX package's ``models/transformer.py``, with the same
params layout (nested dicts mirroring the HF tensor names, packed linears as
``QuantLinear``) and the same rounding points: norms and softmax in float32,
attention logits in float32, probabilities cast to the activation type.
Attention is plain torch ops, as the reference's is plain XLA. The port
updates the KV cache in place, which the JAX package cannot: it saves a copy
of the cache on every step.

Quantization records module inputs through taps (the JAX package's
``_tap``): ``decoder_layer(..., taps={}, tap_paths={...})`` stores the input
of each named module in ``taps`` and raises ``TapsComplete`` once all are
recorded, so the forward past the last tap never runs (XLA drops that work
in the reference); without taps nothing changes.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F_

from gptqmodel_tpu_torch.models.spec import ModelSpec
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear
from gptqmodel_tpu_torch.ops.registry import qlinear_forward, qmlp_forward

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
    q = qf.reshape(B, T, nh, hd).transpose(1, 2)
    k = kf.reshape(B, T, nkv, hd).transpose(1, 2)
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


def decoder_layer(spec: ModelSpec, lp: Params, h, cos, sin, attn_bias,
                  cache: Optional[dict] = None, taps=None, tap_paths=frozenset()):
    """One llama layer: ``(h', cache)``. With ``taps`` (a dict) it records the
    inputs of the modules named in ``tap_paths`` and raises ``TapsComplete``
    when the last is recorded."""
    normed = rms_norm(h, lp["input_layernorm"]["weight"], spec.rms_norm_eps)
    attn_out, cache = attention(spec, lp["self_attn"], normed, cos, sin, attn_bias, cache,
                                taps, tap_paths)
    h = h + attn_out
    normed2 = rms_norm(h, lp["post_attention_layernorm"]["weight"], spec.rms_norm_eps)
    return h + gated_mlp(spec, lp["mlp"], normed2, taps, tap_paths), cache


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
