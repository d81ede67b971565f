"""Quantize config: the JAX package's ``QuantizeConfig`` field for field.

The same fields, defaults and normalisation as ``gptqmodel_tpu``'s
``quantization/config.py``, so ``quantize_config.json`` written by either
package is, as JSON, the same for the same settings, and either package reads
the other's. Method and format are plain strings here (the JAX package's
string enums serialise to the same values). What this slice of the port runs
is GPTQ; ``looper/quantize_loop.py`` raises for the rest.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Optional

QUANT_CONFIG_FILENAME = "quantize_config.json"

METHODS = ("gptq", "awq", "rtn", "fp8", "qqq", "fp4", "bitsandbytes", "paroquant", "exl3")
FORMATS = ("gptq", "gptq_v2", "gptq_p", "gemm", "gemv", "gemv_fast", "exl3")

# keys of reference checkpoints
_COMPAT_KEYS = {
    "checkpoint_format": "format",
    "quant_method": "method",
    "version": "quantizer_version",
}


@dataclass
class QuantizeConfig:
    bits: int = 4
    group_size: int = 128
    desc_act: bool = False
    sym: bool = True
    method: str = "gptq"
    format: str = "gptq"
    true_sequential: bool = True
    lm_head: bool = False
    mse: float = 0.0
    damp_percent: float = 0.01
    damp_auto_increment: float = 0.0025
    static_groups: bool = False
    act_group_aware: bool = False
    mock_quantization: bool = False
    pack_dtype: str = "int32"
    dynamic: Optional[dict[str, Optional[dict[str, Any]]]] = None
    adapter: Optional[dict[str, Any]] = None
    rotation: Optional[str] = None
    gptaq: Optional[dict[str, Any]] = None
    foem: Optional[dict[str, Any]] = None
    paroquant: Optional[dict[str, Any]] = None
    codebook: str = "mcg"
    head_bits: Optional[int] = None
    out_scales: Optional[str] = "auto"
    tp_pad: bool = False
    fallback_min_samples: int = 1
    fallback_smooth: Optional[Any] = None
    smooth: Optional[Any] = None
    smooth_group_threshold: int = 128
    journal: Optional[str] = None
    pack_workers: int = 2
    device: Optional[str] = None
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        self.method, self.format = str(self.method), str(self.format)
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}")
        if self.format not in FORMATS:
            raise ValueError(f"unknown format {self.format!r}")
        if self.method not in ("fp8", "fp4", "exl3") and self.bits not in (2, 3, 4, 5, 6, 7, 8):
            raise ValueError(f"unsupported bits: {self.bits}")
        if self.method == "qqq":
            if self.bits != 4:
                raise ValueError("QQQ requires bits=4 (W4A8)")
            self.sym = True
        if self.bits in (5, 6, 7) and self.format in ("gptq", "gptq_v2"):
            self.format = "gptq_p"  # no continuous layout for 5/6/7 bits
        self.bits = {"fp8": 8, "fp4": 4, "bitsandbytes": 4}.get(self.method, self.bits)
        if self.method == "exl3":
            if not (1 <= int(self.bits) <= 8):
                raise ValueError(f"EXL3 bits must be 1..8, got {self.bits}")
            self.bits, self.format, self.group_size = int(self.bits), "exl3", -1
            self.desc_act, self.sym = False, True
            self.codebook = str(self.codebook).strip().lower()
            if self.codebook not in ("mcg", "mul1", "3inst"):
                raise ValueError(f"EXL3 codebook must be mcg|mul1|3inst: {self.codebook}")
            aliases = {"always": "always", "true": "always", "never": "never",
                       "false": "never", "auto": "auto", "none": "auto", None: "auto"}
            key = self.out_scales if self.out_scales is None else str(self.out_scales).lower()
            if key not in aliases:
                raise ValueError(f"EXL3 out_scales must be always|never|auto: {self.out_scales}")
            self.out_scales = aliases[key]
        if self.rotation is not None and self.rotation not in (
                "hadamard", "random", "online", "hadamard+online", "random+online"):
            raise ValueError(f"unknown rotation mode: {self.rotation}")
        if self.group_size != -1 and self.group_size <= 0:
            raise ValueError(f"invalid group_size: {self.group_size}")

    def to_dict(self) -> dict:
        d = asdict(self)
        d["quant_method"] = d.pop("method")
        d["checkpoint_format"] = d.pop("format")
        d.pop("mock_quantization")
        d.pop("device")
        if self.method != "exl3":
            for k in ("codebook", "head_bits", "out_scales"):
                d.pop(k)
        return d

    def save_pretrained(self, save_dir: str | Path) -> None:
        path = Path(save_dir) / QUANT_CONFIG_FILENAME
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def from_dict(cls, d: dict) -> "QuantizeConfig":
        d = dict(d)
        if d.get("quant_method") == "awq" and d.get("version") in ("gemm", "gemv", "gemv_fast"):
            d["format"] = d.pop("version")  # AutoAWQ schema
            for src, dst in (("w_bit", "bits"), ("q_group_size", "group_size")):
                if src in d:
                    d[dst] = d.pop(src)
            if "zero_point" in d:
                d["sym"] = not d.pop("zero_point")
        for src, dst in _COMPAT_KEYS.items():
            if src in d:
                val = d.pop(src)
                if dst == "quantizer_version":
                    d.setdefault("meta", {})["quantizer_version"] = val
                else:
                    d[dst] = val
        known = set(cls.__dataclass_fields__)
        extra = {k: v for k, v in d.items() if k not in known}
        cfg = cls(**{k: v for k, v in d.items() if k in known})
        if extra:
            cfg.meta.setdefault("extra", {}).update(extra)
        return cfg

    @classmethod
    def from_pretrained(cls, model_dir: str | Path) -> "QuantizeConfig":
        """``quantize_config.json``, else config.json's ``quantization_config``."""
        model_dir = Path(model_dir)
        qc = model_dir / QUANT_CONFIG_FILENAME
        if qc.exists():
            return cls.from_dict(json.loads(qc.read_text()))
        hf = model_dir / "config.json"
        if hf.exists():
            cfg = json.loads(hf.read_text())
            if "quantization_config" in cfg:
                return cls.from_dict(cfg["quantization_config"])
        raise FileNotFoundError(f"no {QUANT_CONFIG_FILENAME} in {model_dir}")
