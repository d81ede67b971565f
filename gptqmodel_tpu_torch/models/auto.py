"""GPTQModel facade: quantize a checkpoint, or load a quantized one and serve it.

The port's counterpart of the JAX package's ``models/auto.py``.
``GPTQModel.load(dir, quantize_config=None, device="cuda")`` reads a GPTQ v1
checkpoint onto the card (or the CPU when the caller names it), or, for an
unquantized checkpoint, returns a model to quantize:
``.quantize(calibration_ids)`` runs GPTQ layer by layer and ``.save(out)``
writes the quantized checkpoint. ``.optimize()`` fuses projections and
enables the fused MLP, and ``.generate(ids, max_new_tokens)`` decodes
greedily.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gptqmodel_tpu_torch.device import resolve_device
from gptqmodel_tpu_torch.inference.engine import greedy_generate
from gptqmodel_tpu_torch.looper.calibration import CalibrationBatches, prepare_calibration
from gptqmodel_tpu_torch.looper.quantize_loop import quantize_model
from gptqmodel_tpu_torch.models.loader import CheckpointReader, build_params_tree
from gptqmodel_tpu_torch.models.optimize import (
    enable_fused_mlp,
    fuse_projections,
    stack_moe_experts,
)
from gptqmodel_tpu_torch.models.spec import ModelSpec, load_hf_config, spec_from_hf_config
from gptqmodel_tpu_torch.models.writer import DEFAULT_MAX_SHARD, save_quantized
from gptqmodel_tpu_torch.ops.registry import post_init_params
from gptqmodel_tpu_torch.quantization.config import QUANT_CONFIG_FILENAME, QuantizeConfig

log = logging.getLogger("gptqmodel_tpu_torch")


class GPTQModel:
    @classmethod
    def load(cls, model_dir: str | Path, quantize_config: QuantizeConfig | dict | None = None,
             device: str | torch.device = "cuda") -> "BaseQModel":
        """A quantized checkpoint is loaded (``from_quantized``); any other
        is opened for quantization (``from_pretrained``)."""
        model_dir = Path(model_dir)
        is_quantized = (model_dir / QUANT_CONFIG_FILENAME).exists() or (
            "quantization_config" in json.loads((model_dir / "config.json").read_text()))
        if is_quantized:
            return cls.from_quantized(model_dir, device=device)
        return cls.from_pretrained(model_dir, quantize_config, device=device)

    @classmethod
    def from_pretrained(cls, model_dir, quantize_config: QuantizeConfig | dict | None = None,
                        device: str | torch.device = "cuda") -> "BaseQModel":
        if isinstance(quantize_config, dict):
            quantize_config = QuantizeConfig.from_dict(quantize_config)
        return BaseQModel(Path(model_dir), quantize_config or QuantizeConfig(), device,
                          quantized=False)

    @classmethod
    def from_quantized(cls, model_dir, device: str | torch.device = "cuda") -> "BaseQModel":
        model_dir = Path(model_dir)
        m = BaseQModel(model_dir, QuantizeConfig.from_pretrained(model_dir), device,
                       quantized=True)
        m._load_params()
        return m


class BaseQModel:
    """Holds (spec, params tree, config, device); compute lives in
    ``models/transformer.py``, ``inference/engine.py`` and ``looper/``."""

    def __init__(self, model_dir: Path, qcfg: QuantizeConfig, device="cuda",
                 quantized: bool = True):
        self.model_dir = Path(model_dir)
        self.qcfg = qcfg
        self.device = resolve_device(device)
        self.quantized = quantized
        self.hf_config = load_hf_config(self.model_dir)
        self.spec: ModelSpec = spec_from_hf_config(self.hf_config)
        self.params: Optional[dict] = None
        self.quant_log: list[dict] = []
        self.durations: dict = {}
        self.layer_durations: list[dict] = []

    def _load_params(self):
        reader = CheckpointReader(self.model_dir)
        self.params = post_init_params(build_params_tree(reader, self.qcfg, self.device))

    def quantize(self, calibration, batch_size: int = 4,
                 calibration_concat_size: Optional[int] = None,
                 calibration_sort: Optional[str] = "desc", max_length: int = 2048,
                 activation_dtype=torch.float32) -> list[dict]:
        """GPTQ with calibration token ids (a 2-D int array, a list of 1-D
        sequences, or ``CalibrationBatches``); returns the quant log, one row
        per module. Seconds by phase are in ``durations`` and
        ``layer_durations``."""
        if self.quantized:
            raise RuntimeError("model is already quantized")
        if self.spec.model_type != "llama":
            raise NotImplementedError(
                f"quantizing {self.spec.model_type}: the port quantizes llama so far; "
                'MoE quantization is ROADMAP queue 1, "MoE quantization, then MoE breadth"')
        if not isinstance(calibration, CalibrationBatches):
            calibration = prepare_calibration(
                calibration, batch_size=batch_size, max_length=max_length,
                concat_size=calibration_concat_size, sort=calibration_sort)
        result = quantize_model(self.model_dir, self.qcfg, calibration,
                                activation_dtype=activation_dtype, device=self.device)
        self.params = post_init_params(result.params)
        self.quant_log = result.quant_log
        self.durations, self.layer_durations = result.durations, result.layer_durations
        self.quantized = True
        log.info("quantized %d modules in %.1fs (forward %.1fs solve %.1fs pack %.1fs)",
                 len(self.quant_log), self.durations["total"], self.durations["forward"],
                 self.durations["solve"], self.durations["pack"])
        return self.quant_log

    def save(self, save_dir: str | Path, max_shard_size: Optional[int] = None) -> None:
        if not self.quantized or self.params is None:
            raise RuntimeError("nothing to save: model not quantized/loaded")
        if any("experts_stacked_q" in lp.get("mlp", {}) for lp in self.params["model"]["layers"]):
            raise NotImplementedError(
                "save after optimize(): stacked experts are a runtime form with bf16 "
                "scales; save the model as loaded or quantized")
        save_quantized(save_dir, self.params, self.qcfg, self.hf_config,
                       source_dir=self.model_dir, quant_log=self.quant_log,
                       max_shard_size=max_shard_size or DEFAULT_MAX_SHARD)

    def generate(self, prompts, max_new_tokens: int = 32, dtype=torch.bfloat16,
                 kv_quant: bool | str = False) -> np.ndarray:
        """Greedy generation from token ids ``[B, T]`` (text prompts need a
        tokenizer, which the port does not have yet). ``kv_quant`` is the
        engine's cache mode: False (cache in ``dtype``) or "int8"."""
        if isinstance(prompts, str) or (
                isinstance(prompts, (list, tuple)) and prompts and isinstance(prompts[0], str)):
            raise NotImplementedError("text prompts need a tokenizer; pass token ids")
        ids = np.asarray(prompts, dtype=np.int64)
        lens = np.full((ids.shape[0],), ids.shape[1], dtype=np.int64)
        return greedy_generate(
            self.spec, self.params, ids, lens, max_new_tokens=max_new_tokens,
            eos_token_id=self.hf_config.get("eos_token_id"), dtype=dtype, kv_quant=kv_quant,
        )

    def optimize(self) -> "BaseQModel":
        """Fuse q/k/v and gate/up into single wide products, stack each
        layer's packed experts for the MoE kernels (K10-K13) and let eligible
        MLPs run as one fused kernel (K2), the JAX facade's default."""
        params = stack_moe_experts(self.spec, fuse_projections(self.spec, self.params))
        self.params = enable_fused_mlp(self.spec, params)
        return self
