"""GPTQ packed-weight formats (v1/v2 interchange, planar gptq_p), on torch tensors.

The on-disk layouts of GPTQ checkpoints:

- ``qweight``: int32 ``[in_features*bits/32, out_features]``. For 2, 4 and 8
  bits the word at row ``r`` holds the codes of input rows ``r*pf + j`` at
  bit offset ``bits*j`` (little-endian within the word), ``pf = 32 // bits``.
  At 3 bits (the stitched layout) each unit of 32 rows is 3 words read as
  one 96-bit little-endian stream: row ``j`` of the unit at bit ``3*j``, so
  rows 10 and 21 straddle words.
- The planar layout (format ``gptq_p``, the only one for 5, 6 and 7 bits):
  each unit of 32 rows is ``bits`` words, one plane per set bit of ``bits``
  from the widest (3 = 2+1, 5 = 4+1, 6 = 4+2, 7 = 4+2+1); the plane of
  width ``w`` at bit offset ``off`` takes words ``off .. off+w-1`` of the
  unit, and row ``i*(32/w) + j`` of the unit at shift ``w*j`` of its word
  ``i``. A code is ``Σ plane << off``. Single-plane widths (2, 4, 8) are
  the layout above.
- ``qzeros``: int32 ``[n_groups, out_features*bits/32]``, the zero points of
  each group packed the same way along the output columns. v1 stores
  ``(zero - 1) mod 2^bits``; v2 stores the true zeros. v1 is the interchange
  format on disk, v2 the runtime format; planar zeros are always v2.
- ``scales``: float16 ``[n_groups, out_features]``.

Dequantization: ``w[i, o] = scales[g(i), o] * (codes[i, o] - zeros[g(i), o])``
with ``y = x @ w``.

The port's CUDA kernels read these layouts directly (``csrc/qmm_common.cuh``,
``csrc/qmatmul_planes.cu``), so there is no runtime repack and nothing to
undo before an export.
"""

from __future__ import annotations

import torch

SUPPORTED_BITS = (2, 3, 4, 8)  # widths with a continuous (or stitched) layout
# bits -> ((plane_width, bit_offset), ...), widest first; a plane of width w
# takes w words of a 32-row unit, from word ``bit_offset``
_PLANAR_PLANES = {
    2: ((2, 0),),
    3: ((2, 0), (1, 2)),
    4: ((4, 0),),
    5: ((4, 0), (1, 4)),
    6: ((4, 0), (2, 4)),
    7: ((4, 0), (2, 4), (1, 6)),
    8: ((8, 0),),
}
PLANAR_ONLY_BITS = (5, 6, 7)  # widths with no continuous layout


def pack_factor(bits: int) -> int:
    """Codes per word, or at 3 bits codes per 3-word unit."""
    if bits not in SUPPORTED_BITS:
        raise NotImplementedError(
            f"bits={bits}: the continuous layout packs 2, 3, 4 and 8 bits; 5, 6 and 7 "
            "are planar only (planar=True)")
    return 32 if bits == 3 else 32 // bits


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the two's complement int32 view."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pack_axis0(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer codes ``[n, m]`` -> int32 ``[n*bits/32, m]`` packed along axis 0."""
    pf = pack_factor(bits)
    n, m = codes.shape
    if n % pf:
        raise ValueError(f"rows {n} not divisible by pack factor {pf}")
    c = codes.to(torch.int64) & ((1 << bits) - 1)
    if bits == 3:  # each 32-row unit is one 96-bit stream of 3 words
        c = c.reshape(n // 32, 32, m)
        words = torch.zeros((n // 32, 3, m), dtype=torch.int64, device=codes.device)
        for j in range(32):
            w, sh = divmod(3 * j, 32)
            words[:, w] |= (c[:, j] << sh) & 0xFFFFFFFF
            if sh > 29:  # the code's high bits open the next word
                words[:, w + 1] |= c[:, j] >> (32 - sh)
        return _to_int32(words.reshape(n * 3 // 32, m))
    c = c.reshape(n // pf, pf, m)
    shifts = (torch.arange(pf, device=codes.device, dtype=torch.int64) * bits)
    words = (c << shifts[None, :, None]).sum(dim=1)  # fields are disjoint
    return _to_int32(words)


def _unpack_axis0(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 ``[p, m]`` -> int32 codes ``[p*32/bits, m]`` (inverse of _pack_axis0)."""
    pf = pack_factor(bits)
    p, m = packed.shape
    u = packed.to(torch.int64) & 0xFFFFFFFF
    if bits == 3:
        if p % 3:
            raise ValueError(f"3-bit rows {p} not divisible by 3")
        w = u.reshape(p // 3, 3, m)
        out = torch.empty((p // 3, 32, m), dtype=torch.int64, device=packed.device)
        for j in range(32):
            i, sh = divmod(3 * j, 32)
            v = w[:, i] >> sh
            if sh > 29:
                v = v | (w[:, i + 1] << (32 - sh))
            out[:, j] = v & 7
        return out.reshape(p * 32 // 3, m).to(torch.int32)
    shifts = torch.arange(pf, device=packed.device, dtype=torch.int64) * bits
    vals = (u[:, None, :] >> shifts[None, :, None]) & ((1 << bits) - 1)
    return vals.reshape(p * pf, m).to(torch.int32)


def planar_pack_axis0(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Codes ``[n, m]`` -> planar words ``[n*bits/32, m]`` (module docstring)."""
    n, m = codes.shape
    if n % 32:
        raise ValueError(f"planar packing needs rows % 32 == 0, got {n}")
    x = codes.to(torch.int64).reshape(n // 32, 32, m)
    out = torch.zeros((n // 32, bits, m), dtype=torch.int64, device=codes.device)
    for w, off in _PLANAR_PLANES[bits]:
        pf = 32 // w
        plane = ((x >> off) & ((1 << w) - 1)).reshape(n // 32, w, pf, m)
        shifts = torch.arange(pf, device=codes.device, dtype=torch.int64) * w
        out[:, off:off + w] = (plane << shifts[None, None, :, None]).sum(dim=2)
    return _to_int32(out.reshape(n * bits // 32, m))


def planar_unpack_axis0(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of ``planar_pack_axis0``: ``[n*bits/32, m]`` -> codes ``[n, m]`` int32."""
    p, m = packed.shape
    if p % bits:
        raise ValueError(f"planar rows {p} not divisible by bits {bits}")
    words = (packed.to(torch.int64) & 0xFFFFFFFF).reshape(p // bits, bits, m)
    out = torch.zeros((p // bits, 32, m), dtype=torch.int64, device=packed.device)
    for w, off in _PLANAR_PLANES[bits]:
        pf = 32 // w
        shifts = torch.arange(pf, device=packed.device, dtype=torch.int64) * w
        vals = (words[:, off:off + w, None] >> shifts[None, None, :, None]) & ((1 << w) - 1)
        out |= vals.reshape(p // bits, 32, m) << off
    return out.reshape(p // bits * 32, m).to(torch.int32)


def pack_qweight(codes_in_out: torch.Tensor, bits: int, planar: bool = False) -> torch.Tensor:
    """Integer codes ``[in, out]`` -> qweight int32 ``[in*bits/32, out]``."""
    if planar:
        return planar_pack_axis0(codes_in_out, bits)
    return _pack_axis0(codes_in_out, bits)


def unpack_qweight(qweight: torch.Tensor, bits: int, planar: bool = False) -> torch.Tensor:
    """qweight int32 ``[in*bits/32, out]`` -> codes int32 ``[in, out]``."""
    if planar:
        return planar_unpack_axis0(qweight, bits)
    return _unpack_axis0(qweight, bits)


def pack_qzeros(zeros_g_out: torch.Tensor, bits: int, v1: bool = False,
                planar: bool = False) -> torch.Tensor:
    """Integer zero points ``[groups, out]`` -> qzeros int32 ``[groups, out*bits/32]``.

    ``v1=True`` stores ``(zero - 1) mod 2^bits``, the GPTQ v1 quirk; planar
    zeros are always v2."""
    z = zeros_g_out.to(torch.int64)
    if v1:
        if planar:
            raise ValueError("planar (gptq_p) zeros are always v2")
        z = (z - 1) & ((1 << bits) - 1)
    return pack_qweight(z.T.contiguous(), bits, planar=planar).T.contiguous()


def unpack_qzeros(qzeros: torch.Tensor, bits: int, v1: bool = False,
                  planar: bool = False) -> torch.Tensor:
    """qzeros int32 ``[groups, out*bits/32]`` -> zero points int32 ``[groups, out]``."""
    z = unpack_qweight(qzeros.T.contiguous(), bits, planar=planar).T
    if v1 and not planar:
        z = (z + 1) & ((1 << bits) - 1)
    return z.contiguous()


def convert_qzeros_v1_to_v2(qzeros: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed v1 zeros -> packed v2 zeros (adds 1 to each field, in-field wrap)."""
    return pack_qzeros(unpack_qzeros(qzeros, bits, v1=True), bits, v1=False)
