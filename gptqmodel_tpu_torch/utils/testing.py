"""Random llama checkpoints, written with numpy from a seed.

``write_random_gptq_checkpoint`` writes a llama checkpoint as a GPTQ
exporter leaves it: ``config.json`` (with ``quantization_config``),
``quantize_config.json`` and sharded safetensors with an index. The packed
modules hold uniform random codes, one symmetric zero point in the v1 form and
fp16 group scales; embeddings, norms and the dense ``lm_head`` are bf16.
``write_random_fp_checkpoint`` writes the dense checkpoint that quantization
starts from: every linear weight N(0, 0.02) (HF's ``initializer_range``),
norms 1, drawn by torch on the device the caller names. Both put one shard per decoder layer. Nothing is downloaded. The
tests write tiny ones; ``chip_smoke.py`` writes them at Llama-3-8B's
published widths (about 5.7 GB packed, 16 GB dense in bf16).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from gptqmodel_tpu_torch.models.safetensors_io import save_file
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear
from gptqmodel_tpu_torch.quantization.config import QUANT_CONFIG_FILENAME

# meta-llama/Meta-Llama-3-8B config.json
LLAMA3_8B_CONFIG = {
    "architectures": ["LlamaForCausalLM"],
    "model_type": "llama",
    "vocab_size": 128256,
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
    "max_position_embeddings": 8192,
    "tie_word_embeddings": False,
    "hidden_act": "silu",
    "bos_token_id": 128000,
    "eos_token_id": 128001,
    "torch_dtype": "bfloat16",
}

WEIGHT_STD = 0.02


def gptq_config(bits: int = 4, group_size: int = 128) -> dict:
    """``quantize_config.json`` of a symmetric GPTQ v1 export, dense lm_head."""
    return {"bits": bits, "group_size": group_size, "desc_act": False, "sym": True,
            "lm_head": False, "quant_method": "gptq", "checkpoint_format": "gptq"}


def random_gptq_module(rng: np.random.Generator, in_f: int, out_f: int, bits: int = 4,
                       group_size: int = 128) -> dict[str, np.ndarray]:
    """qweight, qzeros (v1), scales and g_idx of one symmetric module whose
    dequantized weights have a standard deviation near ``WEIGHT_STD``."""
    pf = 32 // bits
    v1_zero = 2 ** (bits - 1) - 1  # v1 stores zero - 1
    word = sum(v1_zero << (bits * j) for j in range(pf))
    code_std = math.sqrt((4**bits - 1) / 12)  # uniform codes, bits in (2, 4, 8)
    groups = in_f // group_size
    scales = rng.uniform(0.5, 1.5, (groups, out_f)) * (WEIGHT_STD / code_std)
    return {
        "qweight": rng.integers(0, 2**32, (in_f // pf, out_f), dtype=np.uint32).view(np.int32),
        "qzeros": np.full((groups, out_f // pf), word, np.uint32).view(np.int32),
        "scales": scales.astype(np.float16),
        "g_idx": (np.arange(in_f) // group_size).astype(np.int32),
    }


def random_quant_linear(rng: np.random.Generator, in_f: int, out_f: int, bits: int = 4,
                        group_size: int = 128, device="cuda") -> QuantLinear:
    """``random_gptq_module`` as a ``QuantLinear`` on ``device``, v1 zeros as
    on disk (``registry.post_init_module`` prepares it)."""
    a = random_gptq_module(rng, in_f, out_f, bits, group_size)
    t = {k: torch.from_numpy(a[k]).to(device) for k in ("qweight", "qzeros", "scales")}
    return QuantLinear(**t, g_idx=None, bias=None, bits=bits, group_size=group_size,
                       in_features=in_f, out_features=out_f, sym=True, v1=True)


def _normal_bf16(rng: np.random.Generator, shape) -> torch.Tensor:
    a = rng.standard_normal(shape, dtype=np.float32)
    a *= np.float32(WEIGHT_STD)
    return torch.from_numpy(a).to(torch.bfloat16)


def _projections(c: dict) -> dict[str, tuple[int, int]]:
    """module -> (in_features, out_features) of a llama layer."""
    D, F = c["hidden_size"], c["intermediate_size"]
    hd = c.get("head_dim") or D // c["num_attention_heads"]
    q, kv = c["num_attention_heads"] * hd, c.get("num_key_value_heads",
                                                 c["num_attention_heads"]) * hd
    return {"self_attn.q_proj": (D, q), "self_attn.k_proj": (D, kv),
            "self_attn.v_proj": (D, kv), "self_attn.o_proj": (q, D),
            "mlp.gate_proj": (D, F), "mlp.up_proj": (D, F), "mlp.down_proj": (F, D)}


def write_random_gptq_checkpoint(path: str | Path, hf_config: dict, seed: int = 0,
                                 bits: int = 4, group_size: int = 128) -> int:
    """Write the checkpoint into ``path``: one shard for the embedding and the
    final norm, one per decoder layer, one for ``lm_head``. Each tensor draws
    from its own stream of ``seed``. Returns the bytes of the shards."""
    qcfg = gptq_config(bits, group_size)

    def layer(i, pre, projections):
        rng = np.random.default_rng([seed, 1, i])
        tensors = {}
        for proj, (in_f, out_f) in projections.items():
            for leaf, arr in random_gptq_module(rng, in_f, out_f, bits, group_size).items():
                tensors[f"{pre}{proj}.{leaf}"] = arr
        return tensors

    def normal(shape, key):
        return _normal_bf16(np.random.default_rng([seed, *key]), shape)

    total = _write_llama(path, hf_config, layer, normal, {"quantization_config": qcfg})
    (Path(path) / QUANT_CONFIG_FILENAME).write_text(json.dumps(qcfg, indent=1))
    return total


def write_random_fp_checkpoint(path: str | Path, hf_config: dict, seed: int = 0,
                               dtype=torch.bfloat16, device: str | torch.device = "cpu") -> int:
    """Write an unquantized llama checkpoint into ``path``, sharded as
    ``write_random_gptq_checkpoint`` does, in ``dtype``. The normals are
    drawn by a torch generator on ``device`` (a card draws Llama-3-8B's 8
    billion in well under a second), one stream per tensor, keyed by the
    seed; the same seed and device give the same checkpoint. Returns the
    bytes of the shards."""

    def normal(shape, key):
        g = torch.Generator(device).manual_seed(
            int(np.random.SeedSequence([seed, *key]).generate_state(1)[0]))
        w = torch.randn(shape, generator=g, device=device) * WEIGHT_STD
        return w.to(dtype).cpu()

    def layer(i, pre, projections):
        return {f"{pre}{proj}.weight": normal((out_f, in_f), [1, i, j])
                for j, (proj, (in_f, out_f)) in enumerate(projections.items())}

    return _write_llama(path, hf_config, layer, normal,
                        {"torch_dtype": str(dtype).removeprefix("torch.")}, dtype)


def _write_llama(path, hf_config: dict, layer_tensors, normal, config_extra: dict,
                 dtype=torch.bfloat16) -> int:
    """Shards of a llama checkpoint with ``layer_tensors(i, prefix,
    projections)`` for decoder layer ``i``, ``normal(shape, key)`` for the
    embedding and lm_head, the index and ``config.json``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    c = hf_config
    D, V, L = c["hidden_size"], c["vocab_size"], c["num_hidden_layers"]
    projections = _projections(c)
    tied = c.get("tie_word_embeddings", False)
    n_files = L + (1 if tied else 2)
    weight_map: dict[str, str] = {}
    total = 0

    def shard(i: int, tensors: dict):
        nonlocal total
        fname = f"model-{i + 1:05d}-of-{n_files:05d}.safetensors"
        save_file(tensors, path / fname, metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(tensors, fname))
        total += (path / fname).stat().st_size

    ones = torch.ones(D, dtype=dtype)
    shard(0, {"model.embed_tokens.weight": normal((V, D), [0]), "model.norm.weight": ones})
    for i in range(L):
        pre = f"model.layers.{i}."
        shard(1 + i, {pre + "input_layernorm.weight": ones,
                      pre + "post_attention_layernorm.weight": ones,
                      **layer_tensors(i, pre, projections)})
    if not tied:
        shard(L + 1, {"lm_head.weight": normal((V, D), [2])})

    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}, indent=1))
    (path / "config.json").write_text(json.dumps({**hf_config, **config_extra}, indent=1))
    return total
