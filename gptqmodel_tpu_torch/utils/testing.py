"""Random llama and qwen3_moe checkpoints, written from a seed.

``write_random_gptq_checkpoint`` writes a llama checkpoint as a GPTQ
exporter leaves it: ``config.json`` (with ``quantization_config``),
``quantize_config.json`` and sharded safetensors with an index. The packed
modules hold uniform random codes (random words are valid codes in every
layout: 2/3/4/8-bit v1, planar gptq_p at any width), one symmetric zero
point (v1 words, or v2 in gptq_p; or with ``sym=False`` a random zero point
per group and column) and fp16 group scales; with ``desc_act=True`` each
module's ``g_idx`` is an act-order grouping, one random permutation per
layer input, shared by q/k/v and by gate/up as a GPTQ export shares it.
Embeddings, norms and the dense ``lm_head`` are bf16; numpy draws them, or
torch on the device the caller names.
``write_random_fp_checkpoint`` writes the dense checkpoint that quantization
starts from: every linear weight N(0, 0.02) (HF's ``initializer_range``),
norms 1, drawn by torch on the device the caller names.
``write_random_qwen3_moe_checkpoint`` writes a GPTQ qwen3_moe checkpoint the
same way: packed attention and experts, the dense bf16 router ``mlp.gate``,
and ``q_norm``/``k_norm``, drawn by torch on the device the caller names. All
put one shard per decoder layer and hold one layer in host memory at a time.
Nothing is downloaded. The tests write tiny ones; ``chip_smoke.py`` writes
them at Llama-3-8B's published widths (about 5.7 GB packed at 4 bits, 4.8
GB at 3 bits, 16 GB dense in bf16) and at Qwen3-30B-A3B's (about 17 GB
packed).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from gptqmodel_tpu_torch.models.safetensors_io import save_file
from gptqmodel_tpu_torch.ops.pack import PLANAR_ONLY_BITS, pack_qzeros
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

# Qwen/Qwen3-30B-A3B config.json (every layer sparse: decoder_sparse_step 1,
# no mlp_only_layers)
QWEN3_30B_A3B_CONFIG = {
    "architectures": ["Qwen3MoeForCausalLM"],
    "model_type": "qwen3_moe",
    "vocab_size": 151936,
    "hidden_size": 2048,
    "intermediate_size": 6144,
    "moe_intermediate_size": 768,
    "num_hidden_layers": 48,
    "num_attention_heads": 32,
    "num_key_value_heads": 4,
    "head_dim": 128,
    "num_experts": 128,
    "num_experts_per_tok": 8,
    "norm_topk_prob": True,
    "decoder_sparse_step": 1,
    "mlp_only_layers": [],
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "max_position_embeddings": 40960,
    "attention_bias": False,
    "tie_word_embeddings": False,
    "hidden_act": "silu",
    "bos_token_id": 151643,
    "eos_token_id": 151645,
    "torch_dtype": "bfloat16",
}

WEIGHT_STD = 0.02


def gptq_config(bits: int = 4, group_size: int = 128, sym: bool = True,
                desc_act: bool = False, format: str = "gptq") -> dict:
    """``quantize_config.json`` of a GPTQ export, dense lm_head: v1
    (``format="gptq"``) or planar (``"gptq_p"``, the only one at 5, 6 and 7
    bits, as ``QuantizeConfig`` has it)."""
    if bits in PLANAR_ONLY_BITS:
        format = "gptq_p"
    return {"bits": bits, "group_size": group_size, "desc_act": desc_act, "sym": sym,
            "lm_head": False, "quant_method": "gptq", "checkpoint_format": format}


def _module_layout(in_f: int, bits: int, group_size: int):
    """What every random module shares: the rows of its packed words, the
    number of groups and the scale unit. A uniform spread in [0.5, 1.5) times
    the unit gives dequantized weights with a standard deviation near
    ``WEIGHT_STD``."""
    code_std = math.sqrt((4**bits - 1) / 12)  # uniform codes
    return in_f * bits // 32, in_f // group_size, WEIGHT_STD / code_std


def act_order_g_idx(perm: np.ndarray, group_size: int) -> np.ndarray:
    """The ``g_idx`` GPTQ writes with ``desc_act``: column ``perm[j]`` is the
    ``j``-th quantized and belongs to group ``j // group_size``."""
    g_idx = np.empty(perm.shape[0], np.int32)
    g_idx[perm] = np.arange(perm.shape[0]) // group_size
    return g_idx


def random_gptq_module(rng: np.random.Generator, in_f: int, out_f: int, bits: int = 4,
                       group_size: int = 128, sym: bool = True,
                       perm: np.ndarray | None = None,
                       planar: bool = False) -> dict[str, np.ndarray]:
    """qweight, qzeros (v1, or v2 when ``planar``), scales and g_idx of one
    module whose dequantized weights have a standard deviation near
    ``WEIGHT_STD``. ``sym=False`` draws each group's zero points from the
    middle half of the codes after the rest; ``perm`` (a permutation of the
    inputs) gives an act-order ``g_idx``."""
    rows, groups, unit = _module_layout(in_f, bits, group_size)
    scales = rng.uniform(0.5, 1.5, (groups, out_f)) * unit
    qweight = rng.integers(0, 2**32, (rows, out_f), dtype=np.uint32).view(np.int32)
    qzeros, g_idx = _zeros_and_g_idx(rng, in_f, out_f, bits, group_size, sym, perm, planar)
    return {"qweight": qweight, "qzeros": qzeros, "scales": scales.astype(np.float16),
            "g_idx": g_idx}


def _zeros_and_g_idx(rng: np.random.Generator | None, in_f: int, out_f: int, bits: int,
                     group_size: int, sym: bool, perm: np.ndarray | None,
                     planar: bool = False):
    """The ``qzeros`` words (v1, or v2 when ``planar``) and the ``g_idx`` of
    a random module: one symmetric zero point, or with ``sym=False`` zero
    points drawn by ``rng`` from the middle half of the codes; a contiguous
    ``g_idx``, or the act-order one of ``perm``. Only whole words (3-bit and
    planar: whole 32-column units) of zeros are packed: a symmetric module
    whose columns end mid-word has no zero word for the last ones, which no
    kernel of one zero point reads."""
    groups = in_f // group_size
    if sym:
        z = np.full((groups, out_f), 2 ** (bits - 1), np.int64)
    else:
        lo = 2 ** (bits - 2)
        z = rng.integers(lo, 3 * lo, (groups, out_f))
    unit = 32 if planar or bits == 3 else 32 // bits
    z = z[:, :out_f - out_f % unit]
    qzeros = pack_qzeros(torch.from_numpy(z), bits, v1=not planar, planar=planar).numpy()
    g_idx = (np.arange(in_f) // group_size if perm is None
             else act_order_g_idx(perm, group_size)).astype(np.int32)
    return qzeros, g_idx


def random_quant_linear(rng: np.random.Generator, in_f: int, out_f: int, bits: int = 4,
                        group_size: int = 128, device="cuda", sym: bool = True,
                        perm: np.ndarray | None = None, planar: bool = False) -> QuantLinear:
    """``random_gptq_module`` as a ``QuantLinear`` on ``device``, zeros as
    on disk: v1, or v2 when ``planar`` (``registry.post_init_module``
    prepares it). 5, 6 and 7 bits are planar whatever ``planar`` says."""
    planar = planar or bits in PLANAR_ONLY_BITS
    a = random_gptq_module(rng, in_f, out_f, bits, group_size, sym, perm, planar)
    t = {k: torch.from_numpy(a[k]).to(device) for k in ("qweight", "qzeros", "scales")}
    g_idx = None if perm is None else torch.from_numpy(a["g_idx"]).to(device)
    return QuantLinear(**t, g_idx=g_idx, bias=None, bits=bits, group_size=group_size,
                       in_features=in_f, out_features=out_f, sym=sym, v1=not planar,
                       planar=planar)


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
                                 bits: int = 4, group_size: int = 128, sym: bool = True,
                                 desc_act: bool = False,
                                 device: str | torch.device | None = None,
                                 format: str = "gptq") -> int:
    """Write the checkpoint into ``path``: one shard for the embedding and the
    final norm, one per decoder layer, one for ``lm_head``. Each tensor draws
    from its own stream of ``seed``, with numpy, or with torch on ``device``
    when one is named (a card draws Llama-3-8B's 5.7 GB in seconds); the
    act-order permutations from numpy streams of their own, so the defaults
    write the same bytes as before those options existed. ``format`` is
    ``gptq`` (v1) or ``gptq_p`` (planar, v2 zeros; 5, 6 and 7 bits always).
    Returns the bytes of the shards."""
    qcfg = gptq_config(bits, group_size, sym, desc_act, format)
    planar = qcfg["checkpoint_format"] == "gptq_p"

    projections = _projections(hf_config)
    # the input each module reads: q/k/v share one, gate/up another
    inputs = {"self_attn.q_proj": 0, "self_attn.k_proj": 0, "self_attn.v_proj": 0,
              "self_attn.o_proj": 1, "mlp.gate_proj": 2, "mlp.up_proj": 2, "mlp.down_proj": 3}

    def layer(i, pre):
        rng = np.random.default_rng([seed, 1, i])
        gen = None if device is None else _torch_gen(device, [seed, 1, i])
        tensors = {}
        for proj, (in_f, out_f) in projections.items():
            perm = (np.random.default_rng([seed, 5, i, inputs[proj]]).permutation(in_f)
                    if desc_act else None)
            module = (random_gptq_module(rng, in_f, out_f, bits, group_size, sym, perm, planar)
                      if gen is None else
                      _torch_gptq_module(gen, in_f, out_f, bits, group_size, device, rng, sym,
                                         perm, planar))
            for leaf, arr in module.items():
                tensors[f"{pre}{proj}.{leaf}"] = arr
        return tensors

    def normal(shape, key):
        if device is None:
            return _normal_bf16(np.random.default_rng([seed, *key]), shape)
        w = torch.randn(shape, generator=_torch_gen(device, [seed, *key]), device=device)
        return (w * WEIGHT_STD).to(torch.bfloat16).cpu()

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
        w = torch.randn(shape, generator=_torch_gen(device, [seed, *key]),
                        device=device) * WEIGHT_STD
        return w.to(dtype).cpu()

    projections = _projections(hf_config)

    def layer(i, pre):
        return {f"{pre}{proj}.weight": normal((out_f, in_f), [1, i, j])
                for j, (proj, (in_f, out_f)) in enumerate(projections.items())}

    return _write_llama(path, hf_config, layer, normal,
                        {"torch_dtype": str(dtype).removeprefix("torch.")}, dtype)


def _write_llama(path, hf_config: dict, layer_tensors, normal, config_extra: dict,
                 dtype=torch.bfloat16) -> int:
    """Shards of a llama-lineage checkpoint with ``layer_tensors(i, prefix)``
    for decoder layer ``i``, ``normal(shape, key)`` for the embedding and
    lm_head, the index and ``config.json``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    c = hf_config
    D, V, L = c["hidden_size"], c["vocab_size"], c["num_hidden_layers"]
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
                      **layer_tensors(i, pre)})
    if not tied:
        shard(L + 1, {"lm_head.weight": normal((V, D), [2])})

    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}, indent=1))
    (path / "config.json").write_text(json.dumps({**hf_config, **config_extra}, indent=1))
    return total


def _torch_gen(device, key) -> torch.Generator:
    """A torch generator on ``device`` seeded from the key's numpy seed sequence."""
    return torch.Generator(device).manual_seed(
        int(np.random.SeedSequence(key).generate_state(1)[0]))


def _torch_gptq_module(gen: torch.Generator, in_f: int, out_f: int, bits: int,
                       group_size: int, device, rng: np.random.Generator | None = None,
                       sym: bool = True, perm: np.ndarray | None = None,
                       planar: bool = False) -> dict[str, torch.Tensor]:
    """``random_gptq_module`` with its codes and scales drawn by ``gen`` on
    ``device`` and its zeros and ``g_idx`` by ``rng``, on the CPU."""
    rows, groups, unit = _module_layout(in_f, bits, group_size)
    qweight = torch.randint(-2**31, 2**31, (rows, out_f), generator=gen,
                            dtype=torch.int64, device=device).to(torch.int32)
    scales = (torch.rand((groups, out_f), generator=gen, device=device) + 0.5) * unit
    qzeros, g_idx = _zeros_and_g_idx(rng, in_f, out_f, bits, group_size, sym, perm, planar)
    return {"qweight": qweight.cpu(), "qzeros": torch.from_numpy(qzeros),
            "scales": scales.to(torch.float16).cpu(), "g_idx": torch.from_numpy(g_idx)}


def write_random_qwen3_moe_checkpoint(path: str | Path, hf_config: dict, seed: int = 0,
                                      bits: int = 4, group_size: int = 128,
                                      device: str | torch.device = "cpu") -> int:
    """Write a GPTQ v1 qwen3_moe checkpoint into ``path``, sharded as
    ``write_random_gptq_checkpoint`` does: per layer the packed q/k/v/o
    projections, ``q_norm``/``k_norm`` (1 + N(0, 0.1)), the dense router
    ``mlp.gate`` (N(0, 0.02)) and every expert's packed gate/up/down. Each
    tensor draws from its own torch stream keyed by the seed, on ``device``;
    the same seed and device give the same checkpoint. Returns the bytes of
    the shards."""
    c = hf_config
    qcfg = gptq_config(bits, group_size)
    D, E, F = c["hidden_size"], c["num_experts"], c["moe_intermediate_size"]
    hd = c.get("head_dim") or D // c["num_attention_heads"]
    attn = {k: v for k, v in _projections(c).items() if k.startswith("self_attn.")}

    def gen(key) -> torch.Generator:
        return _torch_gen(device, [seed, *key])

    def normal(shape, key, std=WEIGHT_STD):
        w = torch.randn(shape, generator=gen(key), device=device) * std
        return w.to(torch.bfloat16).cpu()

    def layer(i, pre):
        g = gen([1, i])
        tensors = {}
        mods = dict(attn)
        for e in range(E):
            mods.update({f"mlp.experts.{e}.gate_proj": (D, F), f"mlp.experts.{e}.up_proj": (D, F),
                         f"mlp.experts.{e}.down_proj": (F, D)})
        for proj, (in_f, out_f) in mods.items():
            for leaf, t in _torch_gptq_module(g, in_f, out_f, bits, group_size, device).items():
                tensors[f"{pre}{proj}.{leaf}"] = t
        for j, norm in enumerate(("q_norm", "k_norm")):
            tensors[f"{pre}self_attn.{norm}.weight"] = 1 + normal((hd,), [3, i, j], 0.1)
        tensors[f"{pre}mlp.gate.weight"] = normal((E, D), [4, i])
        return tensors

    total = _write_llama(path, hf_config, layer, normal, {"quantization_config": qcfg})
    (Path(path) / QUANT_CONFIG_FILENAME).write_text(json.dumps(qcfg, indent=1))
    return total
