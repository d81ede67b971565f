"""GPTQ for one weight matrix, on torch tensors.

The port of the JAX package's ``quantization/gptq.py`` for plain GPTQ:
Hessian accumulation, the damped inverse factor with its damp ladder, the
solver choice, the blocked solve's routing, and ``gptq_quantize`` with dead
columns, ``desc_act``, ``static_groups``, the NaN guard and its RTN fallback.

The solve runs where ``W`` lies. On the card it is K8 (``gptq_whole_solve``)
by default, or K9 (``gptq_block_inner``, one launch per block, the trailing
update in ``torch.matmul``) with ``GPTQ_TPU_SOLVER=pallas``, the JAX
package's switch; any other value raises there, and a solve outside K8's
contract raises. A CPU tensor takes the plain blocked solve. All arithmetic
is float32.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from gptqmodel_tpu_torch.ops.gptq_solve import (
    BLOCK,
    gptq_block_inner,
    gptq_whole_solve,
    solve_blocks,
    whole_solve_supported,
)
from gptqmodel_tpu_torch.quantization.quantizer import find_params, find_params_grouped

log = logging.getLogger("gptqmodel_tpu_torch")

MAX_DAMP_ATTEMPTS = 6


def accumulate_hessian(H: torch.Tensor, nsamples: int, x: torch.Tensor):
    """Running-mean update ``H' = H·n/(n+rows) + (2/(n+rows))·xᵀx``:
    ``(H', n + rows)`` for activations ``x [rows, in]``."""
    x = x.to(torch.float32)
    new_n = nsamples + x.shape[0]
    x_scaled = x * np.sqrt(np.float32(2.0) / np.float32(new_n))
    H = H * (np.float32(nsamples) / np.float32(new_n)) + x_scaled.T @ x_scaled
    return H, new_n


def _chol_inv_upper(H: torch.Tensor, damp: float):
    """U with ``inv(H + damp·mean(diag)·I) = UᵀU``, U upper triangular, from
    the Cholesky factor of the index-reversed matrix (``U = J·Lr⁻¹·J``), and
    whether it passed: Cholesky succeeded and the inverse's residual on 8
    spot columns is below 5e-2, the JAX package's check."""
    n = H.shape[0]
    Hd = H.clone()
    Hd.diagonal().add_(np.float32(damp) * Hd.diagonal().mean())
    Lr, info = torch.linalg.cholesky_ex(torch.flip(Hd, (0, 1)))
    del Hd
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    Li = torch.linalg.solve_triangular(Lr, eye, upper=False)
    del eye
    cols = (torch.arange(8, device=H.device) * max(n // 8, 1)) % n
    P = Li @ Lr[:, cols]
    I_cols = (torch.arange(n, device=H.device)[:, None] == cols[None, :]).to(H.dtype)
    resid = (P - I_cols).abs().max()
    ok = bool((info == 0) & torch.isfinite(resid) & (resid < 5e-2))
    return torch.flip(Li, (0, 1)).contiguous(), ok


def hessian_inverse(H: torch.Tensor, damp: float, damp_auto_increment: float = 0.0025):
    """The damp ladder: ``(U, final damp)``; raises if no damp works."""
    cur = float(damp)
    for _ in range(MAX_DAMP_ATTEMPTS):
        U, ok = _chol_inv_upper(H, cur)
        if ok:
            return U, cur
        cur = cur + damp_auto_increment if damp_auto_increment > 0 else cur * 10
    raise np.linalg.LinAlgError(
        f"Hessian not positive-definite after {MAX_DAMP_ATTEMPTS} damp attempts "
        f"(final damp={cur})")


def _solver_backend(device: torch.device) -> str:
    """The solve for a tensor on ``device``: "" (the plain blocked solve) on
    the CPU; on the card "mega" (K8, the default) or "pallas" (K9) from
    ``GPTQ_TPU_SOLVER``, as in the JAX package."""
    if device.type == "cpu":
        return ""
    ov = os.environ.get("GPTQ_TPU_SOLVER", "")
    if ov in ("", "mega"):
        return "mega"
    if ov == "pallas":
        return "pallas"
    raise ValueError(f"GPTQ_TPU_SOLVER={ov!r}: on the card the solve runs K8 ('mega', the "
                     "default) or K9 ('pallas'); there is no interpret mode and no plain path")


def gptq_solve_core(W, Hinv_u, SP=None, ZP=None, *, bits: int, group_size: int,
                    sym: bool) -> dict:
    """Blocked GPTQ solve of ``W [out, in]`` float32 (permuted, dead columns
    zeroed) with ``Hinv_u`` the upper factor of the damped inverse Hessian.
    ``SP``/``ZP [out, in]``: static per-column tables. Returns Q (int32),
    Wq (= Dq), scales and zeros ``[G, out]`` (zeros with static tables, which
    the caller holds) and the per-column losses."""
    out_f, in_f = W.shape
    maxq = 2**bits - 1
    g = in_f if group_size in (-1, None) else group_size
    B = BLOCK
    if in_f % B:
        pad = B - in_f % B
        W = torch.nn.functional.pad(W, (0, pad))
        Hinv_u = torch.nn.functional.pad(Hinv_u, (0, pad, 0, pad))
        Hinv_u[in_f:, in_f:] = torch.eye(pad, dtype=Hinv_u.dtype, device=Hinv_u.device)
        if SP is not None:
            SP = torch.nn.functional.pad(SP, (0, pad), value=1.0)
            ZP = torch.nn.functional.pad(ZP, (0, pad))
        return _solve_padded(W, Hinv_u, SP, ZP, in_f, bits=bits, group_size=group_size,
                             sym=sym)
    if not (g == in_f or (g <= B and B % g == 0) or (g > B and g % B == 0)):
        raise ValueError(f"group_size {g} incompatible with blocksize {B}")
    static = SP is not None
    n_groups = in_f // g
    if g == in_f and not static:  # per-channel: one table from the whole W
        s_full, z_full = find_params(W, bits=bits, sym=sym)
        SP = s_full[:, None].expand(out_f, in_f).contiguous()
        ZP = z_full[:, None].expand(out_f, in_f).contiguous()
    solver = _solver_backend(W.device)
    kw = dict(maxq=maxq, group_size=g, sym=sym)
    if solver == "mega":
        if not whole_solve_supported(in_f, g, SP is not None):
            raise NotImplementedError(
                f"K8 takes static tables or groups of at most {B} columns, at most 8 per "
                f"block; group_size={g} waits for a later slice of the port (ROADMAP queue 1, "
                f'"GPTQ leftovers"), or runs through K9 with GPTQ_TPU_SOLVER=pallas')
        Qf, Dq, L, s_out, z_out = gptq_whole_solve(W, Hinv_u, SP, ZP, **kw)
    else:
        Qf, Dq, L, s_out, z_out = solve_blocks(W, Hinv_u, SP, ZP, inner=gptq_block_inner, **kw)
    if static:
        scales = torch.zeros((n_groups, out_f), dtype=torch.float32, device=W.device)
        zeros = torch.zeros_like(scales)
    elif g == in_f:
        scales, zeros = s_full[None], z_full[None]
    else:
        scales, zeros = s_out[:n_groups], z_out[:n_groups]
    return {"Q": Qf.to(torch.int32), "Wq": Dq, "scales": scales, "zeros": zeros,
            "losses": L}


def _solve_padded(W, Hinv_u, SP, ZP, orig_in, **kw):
    res = gptq_solve_core(W, Hinv_u, SP, ZP, **kw)
    g = kw["group_size"]
    n_groups = 1 if g in (-1, None) else -(-orig_in // g)
    return {"Q": res["Q"][:, :orig_in], "Wq": res["Wq"][:, :orig_in],
            "scales": res["scales"][:n_groups], "zeros": res["zeros"][:n_groups],
            "losses": res["losses"][:, :orig_in]}


@dataclass
class GPTQResult:
    """One solved matrix, as tensors on the solve's device."""

    Q: torch.Tensor  # int32 codes [out, in], original column order
    Wq: torch.Tensor  # float32 dequantized weight [out, in], original order
    scales: torch.Tensor  # float32 [G, out], group order follows perm when desc_act
    zeros: torch.Tensor  # float32 [G, out] integer zero points
    g_idx: torch.Tensor  # int32 [in] column -> group (original order)
    perm: torch.Tensor | None  # column permutation of the solve (None: identity)
    avg_loss: float
    damp: float
    nsamples: int


def _preprocess_dead(W: torch.Tensor, H: torch.Tensor):
    """Columns no sample touched: diag 1 in H, weights zeroed."""
    dead = torch.diagonal(H) == 0
    H = H + torch.diag(dead.to(H.dtype))
    return W * (~dead)[None, :], H, dead


def gptq_quantize(W, H, *, bits: int, group_size: int, sym: bool, desc_act: bool = False,
                  damp_percent: float = 0.01,
                  damp_auto_increment: float = 0.0025, nsamples: int = 0,
                  static_groups: bool = False) -> GPTQResult:
    """GPTQ of ``W [out, in]`` with the accumulated Hessian ``H [in, in]``
    (tensors or arrays; the solve runs on W's device). Handles dead columns,
    the activation-order permutation, static groups, the damp ladder, the
    non-finite guard (damp x10, x100, then RTN) and un-permutation; ``Wq`` is
    rebuilt from (Q, scales, zeros), which equals the solve's Dq."""
    W = torch.as_tensor(W).to(torch.float32)
    H = torch.as_tensor(H).to(device=W.device, dtype=torch.float32)
    out_f, in_f = W.shape
    g = in_f if group_size in (-1, None) else group_size

    W, H, _ = _preprocess_dead(W, H)
    W_orig_order = W
    perm = None
    if desc_act:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        W = W[:, perm]
        H = H[perm][:, perm]

    U, damp = hessian_inverse(H, damp_percent, damp_auto_increment)
    SP = ZP = static_sz = None
    if static_groups and g < in_f:
        # tables from the original W and group membership; under desc_act each
        # column keeps its original group, so g_idx stays contiguous
        W_orig = W if perm is None else W[:, torch.argsort(perm)]
        static_sz = find_params_grouped(W_orig, bits=bits, group_size=group_size, sym=sym)
        col_group = torch.arange(in_f, device=W.device) // g
        if perm is not None:
            col_group = col_group[perm]
        SP = static_sz[0][col_group].T.contiguous()
        ZP = static_sz[1][col_group].T.contiguous()

    kw = dict(bits=bits, group_size=group_size, sym=sym)
    res = gptq_solve_core(W, U, SP, ZP, **kw)

    def _finite(r):
        return bool(torch.isfinite(r["losses"].sum()) & torch.isfinite(r["scales"]).all()
                    & torch.isfinite(r["Wq"]).all())

    if not _finite(res):
        if not bool(torch.isfinite(W).all()):
            raise ValueError(
                "gptq_quantize: weight matrix contains NaN/inf — upstream layer produced "
                "non-finite activations; aborting instead of writing garbage codes")
        for mult in (10.0, 100.0):
            U, damp = hessian_inverse(H, damp * mult, damp_auto_increment)
            res = gptq_solve_core(W, U, SP, ZP, **kw)
            if _finite(res):
                log.warning("gptq_quantize: non-finite solve outputs; recovered with damp "
                            "escalated to %.4g", damp)
                break
        else:
            log.warning("gptq_quantize: non-finite solve outputs after damp escalation; "
                        "falling back to RTN")
            from gptqmodel_tpu_torch.quantization.rtn import rtn_quantize

            fb = rtn_quantize(W_orig_order, bits=bits, group_size=group_size, sym=sym)
            fb.nsamples = nsamples
            return fb

    avg_loss = float(res["losses"].sum()) / max(nsamples, 1)
    Q = res["Q"]
    g_idx = (torch.arange(in_f, device=W.device) // g).to(torch.int32)
    if perm is not None:
        invperm = torch.argsort(perm)
        Q = Q[:, invperm]
        if static_sz is None:
            g_idx = g_idx[invperm]
    scales, zeros = static_sz if static_sz is not None else (res["scales"], res["zeros"])
    gi = g_idx.long()
    Wq = scales[gi].T * (Q.to(torch.float32) - zeros[gi].T)
    return GPTQResult(Q=Q, Wq=Wq, scales=scales, zeros=zeros, g_idx=g_idx, perm=perm,
                      avg_loss=avg_loss, damp=damp, nsamples=nsamples)
