"""Quantized-checkpoint writer: params tree -> sharded safetensors.

The JAX package's ``models/writer.py`` for ``QuantLinear`` and dense leaves:
``flatten_params`` turns the tree back into HF tensor names (a packed module
into qweight, qzeros in the v1 interchange form (planar gptq_p words and
their v2 zeros as they are), scales, g_idx and bias;
``_``-prefixed runtime entries are skipped, and the rows of an act-order
module go back to the order they were loaded in, without its ``act_perm``), ``_write_shards`` splits them by
size in the same order and under the same names, and ``save_quantized`` also
writes ``quantize_config.json``, ``config.json`` with ``quantization_config``,
``quant_log.csv`` and the source's tokenizer files. For the same params tree
the tensors are byte-equal to the JAX writer's and the shard index is the
same.
"""

from __future__ import annotations

import csv
import json
import shutil
from pathlib import Path

import torch

from gptqmodel_tpu_torch.models.safetensors_io import save_file
from gptqmodel_tpu_torch.ops import pack as packing
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear
from gptqmodel_tpu_torch.quantization.config import QuantizeConfig

DEFAULT_MAX_SHARD = 4 * 1024**3  # bytes, HF's default "4GB"

_TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "tokenizer.model", "special_tokens_map.json",
    "vocab.json", "merges.txt", "generation_config.json", "preprocessor_config.json",
    "chat_template.jinja",
)


def flatten_params(tree, prefix: str = "", out: dict | None = None,
                   v1_zeros: bool = True) -> dict:
    """Nested params -> flat ``{hf_tensor_name: CPU tensor}``. With
    ``v1_zeros`` (the interchange default) runtime v2 zeros go to disk in the
    v1 form."""
    if out is None:
        out = {}
    if isinstance(tree, QuantLinear):
        qzeros = tree.qzeros
        if tree.planar:
            pass  # planar zeros are v2 on disk too; words saved as they are
        elif not tree.v1 and v1_zeros:
            qzeros = packing.pack_qzeros(packing.unpack_qzeros(qzeros, tree.bits), tree.bits,
                                         v1=True)
        elif tree.v1 and not v1_zeros:
            qzeros = packing.convert_qzeros_v1_to_v2(qzeros, tree.bits)
        qweight = tree.qweight
        if tree.act_perm is not None:  # runtime group order -> the rows as loaded
            inv = torch.argsort(tree.act_perm.long())
            codes = packing.unpack_qweight(qweight, tree.bits, planar=tree.planar)
            qweight = packing.pack_qweight(codes[inv], tree.bits, planar=tree.planar)
        out[f"{prefix}.qweight"] = qweight.cpu()
        out[f"{prefix}.qzeros"] = qzeros.cpu()
        out[f"{prefix}.scales"] = tree.scales.cpu()
        g = tree.group_size if tree.group_size > 0 else tree.in_features
        out[f"{prefix}.g_idx"] = (tree.g_idx.cpu() if tree.g_idx is not None else
                                  (torch.arange(tree.in_features) // g).to(torch.int32))
        if tree.bias is not None:
            out[f"{prefix}.bias"] = tree.bias.cpu()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if not k.startswith("_"):  # runtime-only entries never export
                flatten_params(v, f"{prefix}.{k}" if prefix else k, out, v1_zeros)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            flatten_params(v, f"{prefix}.{i}", out, v1_zeros)
    else:
        out[prefix] = tree.cpu()
    return out


def _write_shards(save_dir: Path, flat: dict, max_shard_size: int) -> None:
    flat = {k: v.contiguous() for k, v in flat.items()}
    sizes = {k: v.numel() * v.element_size() for k, v in flat.items()}
    total = sum(sizes.values())
    if total <= max_shard_size:
        save_file(flat, save_dir / "model.safetensors", metadata={"format": "pt"})
        return
    shards: list[dict] = [{}]
    acc = 0
    for name in flat:
        if acc + sizes[name] > max_shard_size and shards[-1]:
            shards.append({})
            acc = 0
        shards[-1][name] = flat[name]
        acc += sizes[name]
    weight_map = {}
    for i, shard in enumerate(shards, 1):
        fname = f"model-{i:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, save_dir / fname, metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(shard, fname))
    index = {"metadata": {"total_size": total}, "weight_map": weight_map}
    (save_dir / "model.safetensors.index.json").write_text(json.dumps(index, indent=2))


def save_quantized(save_dir: str | Path, params: dict, qcfg: QuantizeConfig, hf_config: dict,
                   source_dir: str | Path | None = None, quant_log: list[dict] | None = None,
                   max_shard_size: int = DEFAULT_MAX_SHARD) -> None:
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    export_v1 = qcfg.format not in ("gptq_v2", "gptq_p", "exl3")
    _write_shards(save_dir, flatten_params(params, v1_zeros=export_v1), max_shard_size)

    qcfg_export = QuantizeConfig.from_dict(qcfg.to_dict())
    if export_v1:
        qcfg_export.format = "gptq"  # v1 is the on-disk interchange format
    qcfg_export.save_pretrained(save_dir)
    hf_config = dict(hf_config, quantization_config=qcfg_export.to_dict())
    (save_dir / "config.json").write_text(json.dumps(hf_config, indent=2))

    if quant_log:
        with open(save_dir / "quant_log.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(quant_log[0].keys()))
            w.writeheader()
            w.writerows(quant_log)
    if source_dir is not None:
        for fname in _TOKENIZER_FILES:
            if (Path(source_dir) / fname).exists():
                shutil.copy2(Path(source_dir) / fname, save_dir / fname)
