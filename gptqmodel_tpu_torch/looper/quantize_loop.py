"""Layer-by-layer GPTQ quantization of a llama checkpoint.

The GPTQ path of the JAX package's ``looper/quantize_loop.py``
(``quantize_model``, ``_build_groups``, ``_quantize_group``):

- Embeddings of the calibration batches are computed once, at
  ``activation_dtype``; decoder layers then stream from disk one at a time.
- Per subset (llama: ``[q, k, v, gate, up]``, then ``[o, down]``), one
  forward per batch records each input group's input through the taps and
  accumulates ``G += xfᵀxf`` over real (unpadded) rows; ``H = (2/n)·G``.
- Each input group is one ``gptq_quantize`` of its members' weights
  stacked along the output rows (one K8 launch on the card); each member is
  packed into a ``QuantLinear`` and its dequantized weight, cast to the
  checkpoint's dtype, replaces the dense one (true-sequential).
- The quantized layer is replayed to make the next layer's inputs.

Hidden states stay on the device. The port packs inline (planar for
``format == "gptq_p"``, as the JAX loop packs at ``quantize_loop.py:851``)
and writes no file; the JAX package's pack worker threads, journal and
streaming CSV are later work (ROADMAP queue 1, "GPTQ leftovers").
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from gptqmodel_tpu_torch.device import resolve_device
from gptqmodel_tpu_torch.looper.calibration import CalibrationBatches
from gptqmodel_tpu_torch.models.loader import CheckpointReader, build_params_tree
from gptqmodel_tpu_torch.models.module_tree import LLAMA_TREE, input_group_key, parse_module_tree
from gptqmodel_tpu_torch.models.spec import load_hf_config, spec_from_hf_config
from gptqmodel_tpu_torch.models.transformer import (
    TapsComplete,
    causal_mask,
    decoder_layer,
    embed,
    rope_cos_sin,
    rope_inv_freq,
)
from gptqmodel_tpu_torch.ops.qlinear import make_quant_linear
from gptqmodel_tpu_torch.quantization.config import QuantizeConfig
from gptqmodel_tpu_torch.quantization.gptq import gptq_quantize
from gptqmodel_tpu_torch.quantization.rtn import rtn_quantize

log = logging.getLogger("gptqmodel_tpu_torch")


@dataclass
class QuantResult:
    params: dict
    quant_log: list[dict]
    durations: dict = field(default_factory=dict)  # seconds: forward, solve, pack, total
    layer_durations: list[dict] = field(default_factory=list)  # the same, per layer


def check_supported(qcfg: QuantizeConfig) -> None:
    """Raise for what this slice of the port does not quantize, naming where
    it comes. Nothing is dropped silently."""
    later = {
        "gptaq": (qcfg.gptaq is not None, "GPTAQ"),
        "foem": (qcfg.foem is not None, "FOEM"),
        "mse": (qcfg.mse > 0, "the MSE grid search"),
        "act_group_aware": (qcfg.act_group_aware, "GAR reordering"),
        "rotation": (qcfg.rotation is not None, "rotation / Hadamard"),
        "smooth": (qcfg.smooth is not None, "the Smoother"),
        "fallback_smooth": (qcfg.fallback_smooth is not None, "fallback smoothing"),
        "adapter": (qcfg.adapter is not None, "EoRA adapters"),
        "tp_pad": (qcfg.tp_pad, "the TP padder"),
        "lm_head": (qcfg.lm_head, "lm_head quantization"),
        "journal": (qcfg.journal is not None, "the quantization journal"),
        "dynamic": (bool(qcfg.dynamic), "per-module dynamic overrides"),
    }
    if qcfg.method != "gptq":
        raise NotImplementedError(
            f"method {qcfg.method!r}: the port quantizes GPTQ so far; other methods come "
            'with a later slice (ROADMAP queue 1, "Other quantization methods and formats")')
    for name, (on, what) in later.items():
        if on:
            raise NotImplementedError(
                f"QuantizeConfig.{name}: {what} comes with a later slice of the port "
                '(ROADMAP queue 1, "GPTQ leftovers")')


def _get(tree, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class _Group:
    tap: str  # the member whose input the forward records
    members: list[str]  # module paths that read that input


def _build_groups(subset: list[str]) -> list[_Group]:
    """Group a subset's modules by shared input."""
    by_key: dict[str, _Group] = {}
    for path in subset:
        grp = by_key.setdefault(input_group_key(path), _Group(tap=path, members=[]))
        grp.tap = min(grp.tap, path)
        grp.members.append(path)
    return list(by_key.values())


def quantize_model(model_dir: str | Path, qcfg: QuantizeConfig, calibration: CalibrationBatches,
                   activation_dtype=torch.float32, device="cuda") -> QuantResult:
    check_supported(qcfg)
    t_start = time.perf_counter()
    device = resolve_device(device)
    model_dir = Path(model_dir)
    hf_cfg = load_hf_config(model_dir)
    spec = spec_from_hf_config(hf_cfg)
    reader = CheckpointReader(model_dir)
    base = build_params_tree(reader, None, device, skip_layers=True)
    plan = parse_module_tree(LLAMA_TREE)
    subsets = plan.build_subsets()

    ids_all = torch.as_tensor(calibration.input_ids, dtype=torch.long, device=device)
    mask_all = torch.as_tensor(calibration.row_mask, device=device)
    nb, B, T = ids_all.shape
    hidden = [embed(base, ids_all[b], activation_dtype) for b in range(nb)]
    positions = torch.arange(T, device=device).expand(B, T)
    cos, sin = rope_cos_sin(torch.from_numpy(rope_inv_freq(spec)).to(device), positions)
    bias = causal_mask(T, T, device)

    quant_log: list[dict] = []
    out_layers: list[dict] = []
    durations = {"forward": 0.0, "solve": 0.0, "pack": 0.0}
    layer_durations: list[dict] = []
    for li in range(spec.num_layers):
        t_layer = time.perf_counter()
        before = dict(durations)
        lp = build_params_tree(reader, None, device, layer_filter=li)
        qlayer_mods: dict = {}
        for subset in subsets:
            groups = _build_groups(subset)
            t0 = time.perf_counter()
            taps_wanted = frozenset(g.tap for g in groups)
            Gs = {g.tap: torch.zeros((n, n), dtype=torch.float32, device=device)
                  for g in groups for n in [_get(lp, g.members[0])["weight"].shape[1]]}
            ns = {k: torch.zeros((), dtype=torch.float32, device=device) for k in Gs}
            with torch.no_grad():
                for b in range(nb):
                    taps: dict = {}
                    try:
                        decoder_layer(spec, lp, hidden[b], cos, sin, bias,
                                      taps=taps, tap_paths=taps_wanted)
                    except TapsComplete:
                        pass
                    m = mask_all[b].reshape(-1)
                    for key, x in taps.items():
                        xf = x.reshape(-1, x.shape[-1]).to(torch.float32) * m[:, None]
                        Gs[key] += xf.T @ xf
                        ns[key] += m.sum()
            _sync(device)
            durations["forward"] += time.perf_counter() - t0
            for grp in groups:
                _quantize_group(grp, lp, Gs[grp.tap], float(ns[grp.tap]), li, qcfg,
                                qlayer_mods, quant_log, durations, device)
            del Gs
        t0 = time.perf_counter()
        with torch.no_grad():
            for b in range(nb):
                hidden[b] = decoder_layer(spec, lp, hidden[b], cos, sin, bias)[0]
        _sync(device)
        durations["forward"] += time.perf_counter() - t0
        for path, qmod in qlayer_mods.items():
            parent, _, leaf = path.rpartition(".")
            _get(lp, parent)[leaf] = qmod
        out_layers.append(lp)
        layer_durations.append({k: durations[k] - before[k] for k in durations}
                               | {"total": time.perf_counter() - t_layer})
        log.info("layer %d/%d quantized in %.2fs", li + 1, spec.num_layers,
                 layer_durations[-1]["total"])

    params = dict(base)
    params["model"] = dict(base["model"], layers=out_layers)
    durations["total"] = time.perf_counter() - t_start
    return QuantResult(params=params, quant_log=quant_log, durations=durations,
                       layer_durations=layer_durations)


def _quantize_group(grp: _Group, lp: dict, G: torch.Tensor, n_rows: float, layer_idx: int,
                    qcfg: QuantizeConfig, qlayer_mods: dict, quant_log: list,
                    durations: dict, device: torch.device) -> None:
    """One solve for all members of an input group (their weights stacked
    along the output rows), then one QuantLinear per member."""
    t0 = time.perf_counter()
    H = (2.0 / max(n_rows, 1.0)) * G
    members = grp.members
    dense = [_get(lp, m) for m in members]
    out_sizes = [int(d["weight"].shape[0]) for d in dense]
    W_cat = torch.cat([d["weight"].to(torch.float32) for d in dense])
    fallback = n_rows < max(qcfg.fallback_min_samples, 1)
    kw = dict(bits=qcfg.bits, group_size=qcfg.group_size, sym=qcfg.sym)
    if qcfg.mock_quantization or fallback:
        res = rtn_quantize(W_cat, **kw)
    else:
        res = gptq_quantize(W_cat, H, desc_act=qcfg.desc_act, damp_percent=qcfg.damp_percent,
                            damp_auto_increment=qcfg.damp_auto_increment,
                            nsamples=int(n_rows), static_groups=qcfg.static_groups, **kw)
    if not math.isfinite(res.avg_loss):
        log.warning("NaN loss for %s — falling back to RTN", ",".join(members))
        res = rtn_quantize(W_cat, **kw)
        fallback = True
    del W_cat, H
    _sync(device)
    solve_t = time.perf_counter() - t0
    durations["solve"] += solve_t

    t0 = time.perf_counter()
    row0 = 0
    for m, d, out_f in zip(members, dense, out_sizes):
        sl = slice(row0, row0 + out_f)
        row0 += out_f
        qlayer_mods[m] = make_quant_linear(
            Q=res.Q[sl], scales=res.scales[:, sl], zeros=res.zeros[:, sl], g_idx=res.g_idx,
            bias=d.get("bias"), bits=qcfg.bits, group_size=qcfg.group_size, sym=qcfg.sym,
            planar=qcfg.format == "gptq_p", device=device)
        # true-sequential: later subsets and the replay see the quantized weight
        d["weight"] = res.Wq[sl].to(d["weight"].dtype)
        quant_log.append({
            "layer": layer_idx,
            "module": m,
            "loss": round(res.avg_loss, 8),
            "samples": int(n_rows),
            "damp": res.damp,
            "bits": qcfg.bits,
            "group_size": qcfg.group_size,
            "fallback": bool(fallback or qcfg.mock_quantization),
            "time_s": round(solve_t / len(members), 4),
        })
    _sync(device)
    durations["pack"] += time.perf_counter() - t0
