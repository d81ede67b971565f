"""Checkpoint reader -> params tree, for llama checkpoints, dense or GPTQ.

The llama subset of the JAX package's ``models/loader.py``: a sharded
safetensors checkpoint becomes nested dicts that mirror the HF tensor names
(decoder layers as a list), dense tensors as they are stored and packed
modules as ``QuantLinear``. GPTQ v1 (``format == "gptq"``, 2/3/4/8 bits)
has its zero points converted to v2 at load; planar gptq_p (any width, v2
zeros on disk) is read as it is, ``planar=True``.
Each tensor moves to ``device`` as it is read. ``layer_filter`` and
``skip_layers`` stream an unquantized checkpoint one decoder layer at a time,
for quantization.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Iterable

import torch

from gptqmodel_tpu_torch.models.safetensors_io import SafetensorsFile
from gptqmodel_tpu_torch.ops import pack as packing
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear
from gptqmodel_tpu_torch.quantization.config import QuantizeConfig


class CheckpointReader:
    """Index of a (sharded) safetensors checkpoint; tensors read on demand."""

    def __init__(self, model_dir: str | Path):
        self.dir = Path(model_dir)
        index_file = self.dir / "model.safetensors.index.json"
        if index_file.exists():
            weight_map = json.loads(index_file.read_text())["weight_map"]
            files = {f: SafetensorsFile(self.dir / f) for f in sorted(set(weight_map.values()))}
            self._name_to_file = {n: files[f] for n, f in weight_map.items()}
        else:
            paths = sorted(self.dir.glob("*.safetensors"))
            if not paths:
                raise FileNotFoundError(f"no .safetensors files in {self.dir}")
            self._name_to_file = {}
            for p in paths:
                fh = SafetensorsFile(p)
                for name in fh.keys():
                    self._name_to_file[name] = fh

    def names(self) -> Iterable[str]:
        return self._name_to_file.keys()

    def get(self, name: str) -> torch.Tensor:
        return self._name_to_file[name].get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._name_to_file


_QUANT_LEAVES = {"qweight", "qzeros", "scales"}
_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.*)$")


def _insert(tree: dict, parts: list[str], value):
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def build_params_tree(reader: CheckpointReader, qcfg: QuantizeConfig | None,
                      device: torch.device, layer_filter: int | None = None,
                      skip_layers: bool = False) -> dict:
    """Materialize the params tree on ``device``. ``layer_filter=i`` loads
    decoder layer ``i`` alone, its tree rooted at the layer;
    ``skip_layers=True`` loads everything but the decoder layers."""
    modules: dict[str, dict[str, str]] = {}
    for name in reader.names():
        mod, _, leaf = name.rpartition(".")
        modules.setdefault(mod, {})[leaf] = name
    tree: dict = {}
    for mod_path, leaves in modules.items():
        m = _LAYER_RE.match(mod_path)
        if m is not None and skip_layers:
            continue
        if layer_filter is not None:
            if m is None or int(m.group(1)) != layer_filter:
                continue
            mod_path = m.group(2)
        parts = mod_path.split(".") if mod_path else []
        if _QUANT_LEAVES.issubset(leaves):
            if qcfg is None:
                raise ValueError(f"{mod_path} holds packed tensors but no QuantizeConfig given")
            _insert(tree, parts, _load_quant_linear(reader, leaves, qcfg).to(device))
        else:
            for leaf, tensor_name in leaves.items():
                _insert(tree, parts + [leaf], reader.get(tensor_name).to(device))
    _listify_layers(tree)
    return tree


def _load_quant_linear(reader: CheckpointReader, leaves: dict[str, str],
                       qcfg: QuantizeConfig) -> QuantLinear:
    if qcfg.format not in ("gptq", "gptq_p") or qcfg.method != "gptq":
        raise NotImplementedError(
            f"format {qcfg.format!r} / method {qcfg.method!r}: the port loads GPTQ v1 and "
            "gptq_p so far")
    bits = qcfg.bits
    qweight = reader.get(leaves["qweight"])
    scales = reader.get(leaves["scales"])
    in_f = qweight.shape[0] * 32 // bits
    out_f = scales.shape[1]
    planar = qcfg.format == "gptq_p"  # v2 zeros on disk (JAX loader.py:298-303)
    qzeros = reader.get(leaves["qzeros"])
    if not planar:  # v1 on disk -> v2 (true zeros) once at load, the runtime format
        qzeros = packing.convert_qzeros_v1_to_v2(qzeros, bits)
    g = qcfg.group_size if qcfg.group_size > 0 else in_f
    g_idx = reader.get(leaves["g_idx"]) if "g_idx" in leaves else None
    if g_idx is not None and torch.equal(g_idx.long(), torch.arange(in_f) // g):
        g_idx = None
    return QuantLinear(
        qweight=qweight, qzeros=qzeros, scales=scales, g_idx=g_idx,
        bias=reader.get(leaves["bias"]) if "bias" in leaves else None,
        bits=bits, group_size=qcfg.group_size, in_features=in_f, out_features=out_f,
        sym=qcfg.sym, v1=False, planar=planar,
    )


def _listify_layers(tree: dict):
    """Contiguous digit-keyed dicts ({"0": .., "1": ..}) become lists, in place."""
    for key, val in list(tree.items()):
        if not isinstance(val, dict):
            continue
        if val and set(val) == {str(i) for i in range(len(val))}:
            tree[key] = [val[str(i)] for i in range(len(val))]
            for sub in tree[key]:
                if isinstance(sub, dict):
                    _listify_layers(sub)
        else:
            _listify_layers(val)
