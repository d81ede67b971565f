"""ModelSpec: the static architecture the forward needs, from an HF config.

The subset of the JAX package's ``models/spec.py`` that the port serves:
llama (RMSNorm, RoPE with default or llama3 scaling, grouped-query
attention, gated SiLU MLP) and qwen3_moe (the same, plus a per-head RMSNorm
on q and k before RoPE and top-k routed experts in every layer, softmax
scoring).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional


@dataclass(frozen=True)
class ModelSpec:
    model_type: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    rope_scaling: Optional[dict] = None
    qk_norm: bool = False  # qwen3: per-head RMSNorm on q and k before RoPE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    moe_scoring: str = "softmax"  # the only scoring the port routes with


MODEL_TYPES = ("llama", "qwen3_moe")


def spec_from_hf_config(cfg: dict[str, Any]) -> ModelSpec:
    """Build a ModelSpec from a parsed HF ``config.json`` (llama or
    qwen3_moe, as the JAX package's ``spec.py:880-891`` reads them)."""
    mt = cfg.get("model_type", "llama")
    if mt not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {mt!r}: the port runs {', '.join(MODEL_TYPES)}")
    hidden = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    moe = {}
    if mt == "qwen3_moe":
        moe = dict(
            qk_norm=True,
            num_experts=cfg.get("num_experts", 0),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 0),
            moe_intermediate_size=cfg.get("moe_intermediate_size", 0),
            norm_topk_prob=cfg.get("norm_topk_prob", True),
        )
    return ModelSpec(
        model_type=mt,
        vocab_size=cfg["vocab_size"],
        hidden_size=hidden,
        intermediate_size=cfg.get("intermediate_size", 4 * hidden),
        num_layers=cfg["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=cfg.get("num_key_value_heads", heads),
        head_dim=cfg.get("head_dim") or hidden // heads,
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        hidden_act=cfg.get("hidden_act", "silu"),
        rope_scaling=cfg.get("rope_scaling"),
        **moe,
    )


def load_hf_config(model_dir: str | Path) -> dict:
    return json.loads((Path(model_dir) / "config.json").read_text())
