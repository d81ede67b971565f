"""K8 and K9: the GPTQ error-feedback solve on the card.

K8, ``gptq_whole_solve`` (kernel ``gqt::gptq_whole_solve_kernel`` in
``csrc/gptq_solve.cu``), replaces the TPU kernel ``_mega_kernel``
(``gptqmodel_tpu/ops/pallas_gptq.py:160``, through ``gptq_whole_solve``
:275): the whole solve of one weight matrix in one launch. For each block of
128 columns, in order: minmax group parameters from the current (trailing-
updated) weights, or static per-column tables; the column loop; the trailing
update ``W[:, later] -= E @ Hinv[block, later]``, inside the kernel.

K9, ``gptq_block_inner`` (kernel ``gqt::gptq_block_inner_kernel``), replaces
``_kernel`` (``pallas_gptq.py:47``, through ``gptq_block_inner`` :87): the
column loop of one block alone. Its caller keeps the trailing update outside,
as ``torch.matmul`` in float32.

Both wrappers launch the kernel for a CUDA tensor or raise, and run the plain
versions beside them only for a CPU tensor. ``gptq_block_inner_plain`` is the
column loop in torch ops, ``solve_blocks`` the blocked solve around any column
loop; with the plain column loop it is K8's plain version. The kernels round
and order the column loop's arithmetic as the plain versions do (half-to-even
rounding, IEEE division, no fused multiply-adds), so only the trailing
product's float32 sums differ in order: K9 equals its plain version bit for
bit, and K8 sums each trailing product element in ascending k with fused
multiply-adds (the order ``csrc/gptq_solve.cu`` states as its invariant).
"""

from __future__ import annotations

import torch

from gptqmodel_tpu_torch.ops import _build
from gptqmodel_tpu_torch.quantization.quantizer import _minmax, _params_from_range

BLOCK = 128  # columns per block, the kernels' B
MAX_GROUPS_PER_BLOCK = 8  # K8's per-block group tables without static tables


def _group_params(x, maxq: int, sym: bool):
    return _params_from_range(*_minmax(x, sym), maxq, sym)


def gptq_block_inner_plain(Wb, Hbb, scale_cols, zero_cols, *, maxq: int):
    """Plain version of K9: ``(Q, Dq, E, L)``, all ``[out, B]`` float32."""
    out_f, B = Wb.shape
    Wc = Wb.to(torch.float32).clone()
    Q, Dq, E, L = (torch.empty_like(Wc) for _ in range(4))
    for i in range(B):
        w, s, z, d = Wc[:, i], scale_cols[:, i], zero_cols[:, i], Hbb[i, i]
        q = torch.clamp(torch.round(w / s) + z, 0, maxq)
        dq = s * (q - z)
        diff = w - dq
        err = diff / d
        Q[:, i], Dq[:, i], E[:, i] = q, dq, err
        L[:, i] = 0.5 * diff * diff / (d * d)
        Wc[:, i + 1:] -= err[:, None] * Hbb[i, i + 1:][None, :]
    return Q, Dq, E, L


def _check_block_inner(Wb, Hbb, scale_cols, zero_cols):
    out_f, B = Wb.shape
    if B != BLOCK or tuple(Hbb.shape) != (B, B):
        raise ValueError(f"K9 takes [out, {BLOCK}] blocks, got Wb {tuple(Wb.shape)} "
                         f"Hbb {tuple(Hbb.shape)}")
    for t in (Wb, Hbb, scale_cols, zero_cols):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != Wb.device:
            raise ValueError("K9 operands must be contiguous float32 on one device")
        if t.data_ptr() % 16:
            raise ValueError("K9 reads its operands in 16-byte words: align them to 16 bytes")
    if scale_cols.shape != Wb.shape or zero_cols.shape != Wb.shape:
        raise ValueError("K9 takes per-column scale and zero tables shaped like Wb")


def gptq_block_inner(Wb, Hbb, scale_cols, zero_cols, *, maxq: int):
    """The column loop of one block: ``Wb [out, 128]``, ``Hbb [128, 128]``
    (the block's diagonal block of the upper inverse factor), per-column
    scales and zeros ``[out, 128]`` -> ``(Q, Dq, E, L)`` ``[out, 128]``."""
    if Wb.device.type == "cpu":
        return gptq_block_inner_plain(Wb, Hbb, scale_cols, zero_cols, maxq=maxq)
    _check_block_inner(Wb, Hbb, scale_cols, zero_cols)
    out_f = Wb.shape[0]
    Q, Dq, E, L = (torch.empty_like(Wb) for _ in range(4))
    rc = _build.lib().gqt_gptq_block_inner(
        Wb.data_ptr(), Hbb.data_ptr(), scale_cols.data_ptr(), zero_cols.data_ptr(), out_f,
        float(maxq), Q.data_ptr(), Dq.data_ptr(), E.data_ptr(), L.data_ptr(),
        torch.cuda.current_stream(Wb.device).cuda_stream,
    )
    _build.check(rc, "gptq_block_inner")
    _build.LAUNCHES["gptq_block_inner"] += 1
    return Q, Dq, E, L


def solve_blocks(W, Hinv_u, SP=None, ZP=None, *, maxq: int, group_size: int, sym: bool,
                 inner=gptq_block_inner_plain):
    """The blocked GPTQ solve with the column loop ``inner`` and the trailing
    update as ``torch.matmul``: ``(Q, Dq, L, scales, zeros)``.

    ``W [out, in]`` float32 (permuted, dead columns zeroed), ``in`` a multiple
    of 128; ``Hinv_u [in, in]`` the upper factor of the damped inverse
    Hessian. Group parameters come from ``SP``/``ZP [out, in]`` when given
    (``scales``/``zeros`` are then None), else from the current weights:
    per block for ``group_size <= 128``, at each group's first block for a
    larger one (then carried). Tables are ``[in / group_size, out]``."""
    out_f, in_f = W.shape
    B, g = BLOCK, group_size
    W = W.to(torch.float32).clone()
    Q, Dq, L = (torch.empty_like(W) for _ in range(3))
    static = SP is not None
    s_rows, z_rows = [], []
    for i1 in range(0, in_f, B):
        blk = slice(i1, i1 + B)
        Wb = W[:, blk]
        if static:
            S, Z = SP[:, blk], ZP[:, blk]
        elif g <= B:
            s, z = _group_params(Wb.reshape(out_f, B // g, g), maxq, sym)  # [out, B/g]
            S, Z = s.repeat_interleave(g, dim=1), z.repeat_interleave(g, dim=1)
            s_rows.append(s.T)
            z_rows.append(z.T)
        else:
            if i1 % g == 0:
                s_cur, z_cur = _group_params(W[:, i1:i1 + g], maxq, sym)
                s_rows.append(s_cur[None])
                z_rows.append(z_cur[None])
            S, Z = s_cur[:, None].expand(out_f, B), z_cur[:, None].expand(out_f, B)
        Qb, Dqb, Eb, Lb = inner(Wb.contiguous(), Hinv_u[blk, blk].contiguous(),
                                S.contiguous(), Z.contiguous(), maxq=maxq)
        Q[:, blk], Dq[:, blk], L[:, blk] = Qb, Dqb, Lb
        if i1 + B < in_f:
            W[:, i1 + B:] -= Eb @ Hinv_u[blk, i1 + B:]
    if static:
        return Q, Dq, L, None, None
    return Q, Dq, L, torch.cat(s_rows), torch.cat(z_rows)


def gptq_whole_solve_plain(W, Hinv_u, SP=None, ZP=None, *, maxq: int, group_size: int,
                           sym: bool):
    """Plain version of K8: ``solve_blocks`` with the plain column loop."""
    return solve_blocks(W, Hinv_u, SP, ZP, maxq=maxq, group_size=group_size, sym=sym,
                        inner=gptq_block_inner_plain)


def whole_solve_supported(in_f: int, group_size: int, static: bool) -> bool:
    """K8's contract on shapes: whole 128-column blocks, and static tables or
    groups of at most 128 columns that tile a block, at most 8 per block
    (the TPU kernel's own limit, ``quantization/gptq.py:302-303``)."""
    g = group_size
    return in_f % BLOCK == 0 and (
        static or (0 < g <= BLOCK and BLOCK % g == 0 and BLOCK // g <= MAX_GROUPS_PER_BLOCK))


def _check_whole_solve(W, Hinv_u, SP, ZP, group_size):
    out_f, in_f = W.shape
    static = SP is not None
    if not whole_solve_supported(in_f, group_size, static):
        raise ValueError(f"K8 does not take in_features={in_f} group_size={group_size} "
                         f"without static tables")
    if tuple(Hinv_u.shape) != (in_f, in_f):
        raise ValueError(f"Hinv_u {tuple(Hinv_u.shape)} for in_features {in_f}")
    ops = [W, Hinv_u] + ([SP, ZP] if static else [])
    for t in ops:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != W.device:
            raise ValueError("K8 operands must be contiguous float32 on one device")
        if t.data_ptr() % 16:
            raise ValueError("K8 reads its operands in 16-byte words: align them to 16 bytes")
    if static and (SP.shape != W.shape or ZP.shape != W.shape):
        raise ValueError("K8's static tables are per column, shaped like W")


def gptq_whole_solve(W, Hinv_u, SP=None, ZP=None, *, maxq: int, group_size: int,
                     sym: bool):
    """The whole GPTQ solve of ``W [out, in]`` (see ``solve_blocks``):
    ``(Q, Dq, L, scales, zeros)``, codes, dequantized weights and losses
    ``[out, in]`` float32, group tables ``[in / group_size, out]`` (None
    with static tables). One kernel launch for a CUDA tensor."""
    if W.device.type == "cpu":
        return gptq_whole_solve_plain(W, Hinv_u, SP, ZP, maxq=maxq, group_size=group_size,
                                      sym=sym)
    _check_whole_solve(W, Hinv_u, SP, ZP, group_size)
    out_f, in_f = W.shape
    static = SP is not None
    Q, Dq, L = (torch.empty_like(W) for _ in range(3))
    s_out = z_out = None
    if not static:
        s_out = torch.empty((in_f // group_size, out_f), dtype=torch.float32, device=W.device)
        z_out = torch.empty_like(s_out)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.lib().gqt_gptq_whole_solve(
        W.data_ptr(), Hinv_u.data_ptr(), ptr(SP), ptr(ZP), out_f, in_f,
        1 if static else BLOCK // group_size, int(static), float(maxq), int(sym),
        Q.data_ptr(), Dq.data_ptr(), L.data_ptr(), ptr(s_out), ptr(z_out),
        torch.cuda.current_stream(W.device).cuda_stream,
    )
    _build.check(rc, "gptq_whole_solve")
    _build.LAUNCHES["gptq_whole_solve"] += 1
    return Q, Dq, L, s_out, z_out
