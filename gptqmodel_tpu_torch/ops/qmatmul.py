"""K1, K3, K7, K6, K4 and K5: dequant-matmul ``y = x @ dequant(qweight)`` on the card.

K1, K3 and K7 (``csrc/qmatmul.cu``, arithmetic in ``csrc/qmm_common.cuh``)
read the GPTQ interchange layout directly and take contiguous groups of a
multiple of 128, 2, 4 or 8 bits, bf16 activations and fp16 scales. At
M <= 16 they run the decode kernel (``csrc/qmm_decode.cuh``: a
shared-memory ring, K split across a thread-block cluster), as do K4 and
K5, both passes of K2 (``ops/qmlp.py``) and K6 where its groups divide 128
(``qmm_decode_supported``); its launch plan, ``decode_plan``, is computed
here and handed to the C entry.

- K1 (``qmatmul``) replaces the TPU kernel ``_qmm_rt_sym_kernel``
  (``gptqmodel_tpu/ops/pallas_qmatmul.py:198``, reached through ``qmatmul``
  :557 with ``rt=True, zero_const>=0``): one uniform zero point.
- K3 (``qmatmul_asym``) replaces ``_qmm_rt_kernel`` (``:117``, reached with
  ``rt=True, zero_const<0``): a zero point per group and column, read from
  the module's v2 ``qzeros`` words as they are.

- K7 (``qmatmul_fused``) replaces ``_qmm_rt_sym_fused_kernel`` (``:263``),
  the variant of K1 that the JAX package runs under ``GPTQ_TPU_RT_FUSED=1``
  (``:669-673``): K1's operands, each code dequantized to ``bf16(c * s)``
  before the product, then one zero correction ``X1_g * (zc * s_g)`` per
  group.
- K6 (``qmm``, ``csrc/qmm.cu``) replaces ``_qmm_kernel`` (``:55``, reached
  with ``rt=False``): contiguous groups of any size that holds whole words
  (``qmm_supported``), ``w = bf16(bf16(c - z) * bf16(s))`` element by
  element, then a product with float32 sums. The zero points are the v2
  ``qzeros`` words as stored, or the module's one ``zero_const``. At
  M <= 16, with a group that divides 128 and K a multiple of 128, it runs
  the decode kernel (``Z = DequantFirst``: each weight dequantized before
  the mma, the cluster splitting K in 128-row chunks); every other shape
  runs its register tile.

- K4 (``qmatmul_planes``, ``csrc/qmatmul_planes.cu``) replaces
  ``_qmm_rtp_sym_kernel`` (``:385``, with ``_rtp_accumulate`` ``:345``;
  reached with ``rt=True, zero_const>=0`` at 3, 5, 6 and 7 bits): one
  uniform zero point. K5 (``qmatmul_planes_asym``) replaces
  ``_qmm_rtp_kernel`` (``:421``): a zero point per group and column, read
  from the v2 ``qzeros`` words in the module's layout. Both read the codes in
  their storage layout, 3-bit stitched or planar (``pack.py``), in place;
  the TPU kernels read a plane-split runtime repack of them
  (``pack.repack_rt_planes``), which the port has not. Their arithmetic is
  K1's and K3's: per-group partial dots of the codes, then the zero-point
  correction. At M <= 16 they run the decode kernel on 32-row units of
  ``bits`` words (``Z = Units``), above it ``csrc/qmatmul_planes.cu``'s
  register tile.

The TPU kernels' ``rt_supported`` (``:456``) also asks ``K % (8*g) == 0``,
for their 8-group K tiles, and ``K % (16*g) == 0`` at 3, 5, 6 and 7 bits,
for 16-group tiles; the CUDA kernels split K by whole groups, so they need
only ``K % g == 0``: the same arithmetic, on another tile. K1, K3, K7, K4 and
K5 keep the fp16 scales as stored, where the TPU kernels round them (and
K5's zeros) to bf16 (``:656``, ``:666-667``, ``:683``, ``:692``). K6 rounds
them to bf16, as its TPU kernel and the dequantize-then-matmul reference do.

Each wrapper launches its kernel for a CUDA tensor and uses its plain version
only for a tensor on the CPU. The plain versions compute the kernels' sums
in float32 (K1, K3, K4 and K5: per-group partial dots, then the zero-point
correction; K7 and K6: products of bf16 weights, K7 then its correction), in
another order; the kernels' products are exact, so the two differ by float32
summation order before the final rounding to the activation type. K7's and
K6's plain versions round x to bf16 first, as their TPU kernels do, so a
float32 model on the CPU follows the JAX package's kernels.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gptqmodel_tpu_torch.ops import _build
from gptqmodel_tpu_torch.ops.pack import unpack_qweight, unpack_qzeros

KERNEL_BITS = (2, 4, 8)
PLANE_BITS = (3, 5, 6, 7)  # K4 and K5

# The decode kernel of K1, K3, K4, K5, K6, K7 and K2 (csrc/qmm_decode.cuh)
# at M <= DECODE_MAX_M: a block owns DECODE_COLS columns and a share of K in
# whole groups (K6's groups that divide DECODE_CHUNK: in whole chunks); the
# blocks of one column tile form a cluster of at most DECODE_MAX_SPLIT (the
# header's kDecodeMaxM, kDecodeCols, kChunk and kDecodeMaxSplit). The kernel
# sizes its own shared memory; the plan gives it only the cluster size.
DECODE_MAX_M = 16
DECODE_COLS = 64
DECODE_CHUNK = 128  # K-rows of a stage of the ring
DECODE_MAX_SPLIT = 8
# the plan's largest cluster: on an H100, clusters of 8 ran the o and down
# projections 4-10% slower than clusters of 7 (scripts/decode_sweep.py, PERF.md)
DECODE_PLAN_SPLIT = 7
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How the decode kernel covers an ``[M, K] x [K, N]`` product: ``tiles``
    column tiles of ``DECODE_COLS``, each a cluster of ``split`` blocks
    along K, which it splits in units of ``per_unit`` of its ``groups``
    groups: one, or for groups smaller than a chunk (K6) a chunk's worth."""

    tiles: int
    split: int
    groups: int
    per_unit: int = 1

    @property
    def blocks(self) -> int:
        return self.tiles * self.split

    def groups_of(self, rank: int) -> range:
        """The groups that cluster rank ``rank`` sums, in whole units (the
        kernel's own rule)."""
        units, u = self.groups // self.per_unit, self.per_unit
        return range(rank * units // self.split * u, (rank + 1) * units // self.split * u)


def decode_blocks_per_sm(M: int) -> int:
    """The blocks per SM the plan aims at: about as many as are resident at
    once (registers and shared memory; measured on an H100 with chip_smoke's
    K3 cases, PERF.md), so that the last ones do not run alone."""
    return 4 if M <= 8 else 2


def decode_plan(M: int, K: int, N: int, group_size: int, sms: int = H100_SMS) -> DecodePlan:
    """The decode kernel's launch: the fewest cluster blocks (at most
    ``DECODE_PLAN_SPLIT``, at most one per unit: a group, or a chunk of
    groups smaller than ``DECODE_CHUNK``) that give ``decode_blocks_per_sm(M)``
    blocks per SM."""
    g = group_size if group_size > 0 else K
    per_unit = max(1, DECODE_CHUNK // g)
    units = K // (g * per_unit)
    tiles = -(-N // DECODE_COLS)
    split = max(1, min(DECODE_PLAN_SPLIT, units, -(-decode_blocks_per_sm(M) * sms // tiles)))
    return DecodePlan(tiles, split, K // g, per_unit)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_split(x, qweight, scales, *, group_size, name) -> int:
    """The decode plan's split for the C entry of K1, K3, K4, K5, K6, K7 or
    one pass of K2 (``x [M, K] @ qweight [., N]``), or 0 above
    ``DECODE_MAX_M`` rows, where their register tiles run. A weight or scale
    pointer that the decode kernel cannot copy in 16-byte pieces raises."""
    M, K = x.shape
    if M > DECODE_MAX_M:
        return 0
    if qweight.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError(f"{name} copies weights and scales in 16-byte pieces at M <= "
                         f"{DECODE_MAX_M}: both must be 16-byte aligned")
    return decode_plan(M, K, qweight.shape[1], group_size, _sm_count(x.device.index or 0)).split


def qmatmul_supported(bits: int, group_size: int, K: int, N: int) -> bool:
    """K1's contract on shapes: 2/4/8 bits, contiguous groups of a multiple of
    128 (the TPU kernel's ``rt_supported`` asks the same), N a multiple of 8."""
    g = group_size if group_size > 0 else K
    return bits in KERNEL_BITS and g % 128 == 0 and K % g == 0 and N % 8 == 0


def qmatmul_planes_supported(bits: int, group_size: int, K: int, N: int) -> bool:
    """K4's and K5's contract: 3, 5, 6 or 7 bits, contiguous groups of a
    multiple of 128 (whole 32-row units; the TPU kernel's ``rt_supported``
    asks the same), ``K % g == 0``, and N a multiple of 32, so that a row of
    3-bit zeros holds whole 3-word units."""
    g = group_size if group_size > 0 else K
    return bits in PLANE_BITS and g % 128 == 0 and K % g == 0 and N % 32 == 0


def grouped_dot_f32(x, qweight, scales, *, bits, group_size, zero_const=None, zeros=None,
                    planar=False):
    """float32 ``x @ dequant(qweight)`` as the kernels sum it:
    ``Σ_g (x_g @ codes_g)·s_g − (Σ x_g)·(z_g·s_g)``, with ``z_g`` the uniform
    ``zero_const`` (K1, K4) or row ``g`` of the ``[G, N]`` v2 ``zeros`` (K3,
    K5); ``planar`` reads gptq_p words."""
    M, K = x.shape
    g = group_size if group_size > 0 else K
    codes = unpack_qweight(qweight, bits, planar=planar).to(torch.float32)  # [K, N]
    xf = x.to(torch.float32)
    sf = scales.to(torch.float32)
    zs = sf * (zero_const if zeros is None else zeros.to(torch.float32))  # exact
    acc = torch.zeros((M, codes.shape[1]), dtype=torch.float32, device=x.device)
    for gi in range(K // g):
        xg = xf[:, gi * g:(gi + 1) * g]
        part = xg @ codes[gi * g:(gi + 1) * g]
        acc += part * sf[gi] - xg.sum(dim=1, keepdim=True) * zs[gi]
    return acc


def qmatmul_plain(x, qweight, scales, *, bits, group_size, zero_const):
    """Plain PyTorch version of K1, rounded to the activation type."""
    return grouped_dot_f32(
        x, qweight, scales, bits=bits, group_size=group_size, zero_const=zero_const
    ).to(x.dtype)


def _check_operands(x, qweight, scales, *, bits, group_size, zero_const=None, qzeros=None,
                    name="K1", supported=None):
    """Raise on what the kernel does not take: K1 and K7 (``zero_const``), K3
    (``qzeros``), K6 (``qzeros``, and ``supported=qmm_supported``), K4 and K5
    (``supported=qmatmul_planes_supported``, with or without ``qzeros``)."""
    M, K = x.shape
    N = qweight.shape[1]
    if not (supported or qmatmul_supported)(bits, group_size, K, N):
        raise ValueError(f"{name} does not take bits={bits} group_size={group_size} K={K} N={N}")
    if qzeros is None and zero_const < 0:
        raise ValueError(f"{name} needs one uniform zero point (symmetric weights)")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bf16 activations, got {x.dtype}")
    g = group_size if group_size > 0 else K
    if qweight.dtype != torch.int32 or tuple(qweight.shape) != (K * bits // 32, N):
        raise ValueError(f"qweight {tuple(qweight.shape)} {qweight.dtype} for K={K} N={N}")
    if scales.dtype != torch.float16 or tuple(scales.shape) != (K // g, N):
        raise ValueError(f"scales {tuple(scales.shape)} {scales.dtype} for K={K} g={g}")
    operands = (x, qweight, scales)
    if qzeros is not None:
        if (qzeros.dtype != torch.int32 or N * bits % 32
                or tuple(qzeros.shape) != (K // g, N * bits // 32)):
            raise ValueError(f"qzeros {tuple(qzeros.shape)} {qzeros.dtype} for K={K} g={g} "
                             f"N={N}")
        operands += (qzeros,)
    for t in operands:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous and on one device")
    if x.data_ptr() % 16 or scales.data_ptr() % 4:
        raise ValueError(f"{name} reads x rows as 16-byte vectors and scales in pairs: "
                         "x must be 16-byte and scales 4-byte aligned")


def qmatmul(x, qweight, scales, *, bits, group_size, zero_const):
    """``x [M, K] @ dequant(qweight)`` -> ``[M, N]`` in x's type.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor to
    ``qmatmul_plain``."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, qweight, scales, bits=bits, group_size=group_size,
                             zero_const=zero_const)
    _check_operands(x, qweight, scales, bits=bits, group_size=group_size,
                    zero_const=zero_const)
    M, K = x.shape
    N = qweight.shape[1]
    g = group_size if group_size > 0 else K
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    lib = _build.lib()
    split = _decode_split(x, qweight, scales, group_size=g, name="K1")
    rc = lib.gqt_qmatmul(
        x.data_ptr(), M, K, qweight.data_ptr(), scales.data_ptr(), N, g,
        float(zero_const), bits, split, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "qmatmul")
    _build.LAUNCHES["qmatmul"] += 1
    return out


def qmatmul_asym_plain(x, qweight, scales, qzeros, *, bits, group_size):
    """Plain PyTorch version of K3, rounded to the activation type."""
    zeros = unpack_qzeros(qzeros, bits)
    return grouped_dot_f32(x, qweight, scales, bits=bits, group_size=group_size,
                           zeros=zeros).to(x.dtype)


def qmatmul_asym(x, qweight, scales, qzeros, *, bits, group_size):
    """``x [M, K] @ dequant(qweight)`` with a zero point per group and column
    (``qzeros``: v2 words ``[K/g, N*bits/32]``) -> ``[M, N]`` in x's type.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor to
    ``qmatmul_asym_plain``."""
    if x.device.type == "cpu":
        return qmatmul_asym_plain(x, qweight, scales, qzeros, bits=bits, group_size=group_size)
    _check_operands(x, qweight, scales, bits=bits, group_size=group_size, qzeros=qzeros,
                    name="K3")
    M, K = x.shape
    N = qweight.shape[1]
    g = group_size if group_size > 0 else K
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    lib = _build.lib()
    split = _decode_split(x, qweight, scales, group_size=g, name="K3")
    rc = lib.gqt_qmatmul_asym(
        x.data_ptr(), M, K, qweight.data_ptr(), scales.data_ptr(), qzeros.data_ptr(), N, g,
        bits, split, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "qmatmul_asym")
    _build.LAUNCHES["qmatmul_asym"] += 1
    return out


def qmatmul_fused_plain(x, qweight, scales, *, bits, group_size, zero_const):
    """Plain PyTorch version of K7: ``x @ bf16(c * s) - X1 @ (zc * s)`` in
    float32 (c * s exact, rounded once), rounded to the activation type."""
    M, K = x.shape
    g = group_size if group_size > 0 else K
    sf = scales.to(torch.float32)
    w = (unpack_qweight(qweight, bits).to(torch.float32) * sf.repeat_interleave(g, dim=0))
    xb = x.to(torch.bfloat16).to(torch.float32)
    x1 = xb.reshape(M, K // g, g).sum(dim=2)  # [M, G]
    y = xb @ w.to(torch.bfloat16).to(torch.float32) - x1 @ (sf * zero_const)
    return y.to(x.dtype)


def qmatmul_fused(x, qweight, scales, *, bits, group_size, zero_const):
    """K7: ``x [M, K] @ dequant(qweight)`` -> ``[M, N]`` in x's type, on K1's
    operands and contract.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor to
    ``qmatmul_fused_plain``."""
    if x.device.type == "cpu":
        return qmatmul_fused_plain(x, qweight, scales, bits=bits, group_size=group_size,
                                   zero_const=zero_const)
    _check_operands(x, qweight, scales, bits=bits, group_size=group_size,
                    zero_const=zero_const, name="K7")
    M, K = x.shape
    N = qweight.shape[1]
    g = group_size if group_size > 0 else K
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    lib = _build.lib()
    split = _decode_split(x, qweight, scales, group_size=g, name="K7")
    rc = lib.gqt_qmatmul_fused(
        x.data_ptr(), M, K, qweight.data_ptr(), scales.data_ptr(), N, g,
        float(zero_const), bits, split, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "qmatmul_fused")
    _build.LAUNCHES["qmatmul_fused"] += 1
    return out


def qmm_supported(bits: int, group_size: int, K: int, N: int) -> bool:
    """K6's contract: the JAX package's ``supports`` (``pallas_qmatmul.py:710``)
    on contiguous groups (2/4/8 bits, ``K % g == 0``, whole words per group
    ``g % (32/bits) == 0``, ``g % 8 == 0``, ``N % 128 == 0``), narrowed by
    ``K % (128/bits) == 0``: the CUDA kernel splits K into steps of four
    words of a column (32 K-rows at 4 bits, 64 at 2, 16 at 8)."""
    g = group_size if group_size > 0 else K
    return (bits in KERNEL_BITS and K % g == 0 and g % (32 // bits) == 0 and g % 8 == 0
            and N % 128 == 0 and K % (128 // bits) == 0)


def qmm_decode_supported(M: int, K: int, group_size: int) -> bool:
    """Whether K6 runs the decode kernel: at most ``DECODE_MAX_M`` rows, a
    group that divides ``DECODE_CHUNK`` and K a whole number of chunks.
    Every other shape in ``qmm_supported`` runs K6's register tile."""
    g = group_size if group_size > 0 else K
    return M <= DECODE_MAX_M and DECODE_CHUNK % g == 0 and K % DECODE_CHUNK == 0


def qmm_plain(x, qweight, scales, qzeros, *, bits, group_size, zero_const):
    """Plain PyTorch version of K6: ``w = bf16(bf16(c - z) * bf16(s))`` (the
    difference exact, the product rounded once), then ``bf16(x) @ w`` with
    float32 sums, in x's type. ``zero_const >= 0`` is the module's one zero
    point, else the zeros are read from the v2 ``qzeros`` words."""
    K = x.shape[1]
    g = group_size if group_size > 0 else K
    codes = unpack_qweight(qweight, bits)
    z = (zero_const if zero_const >= 0
         else unpack_qzeros(qzeros, bits).repeat_interleave(g, dim=0))
    s = scales.to(torch.bfloat16).repeat_interleave(g, dim=0)
    w = (codes - z).to(torch.bfloat16) * s
    y = x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)
    return y.to(x.dtype)


def qmm(x, qweight, scales, qzeros, *, bits, group_size, zero_const):
    """K6: ``x [M, K] @ dequant(qweight)`` -> ``[M, N]`` in x's type, for
    contiguous groups inside ``qmm_supported``: the decode kernel where
    ``qmm_decode_supported``, else the register tile.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor to
    ``qmm_plain``."""
    if x.device.type == "cpu":
        return qmm_plain(x, qweight, scales, qzeros, bits=bits, group_size=group_size,
                         zero_const=zero_const)
    _check_operands(x, qweight, scales, bits=bits, group_size=group_size, qzeros=qzeros,
                    name="K6", supported=qmm_supported)
    M, K = x.shape
    N = qweight.shape[1]
    g = group_size if group_size > 0 else K
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    lib = _build.lib()
    split = (_decode_split(x, qweight, scales, group_size=g, name="K6")
             if qmm_decode_supported(M, K, g) else 0)
    rc = lib.gqt_qmm(
        x.data_ptr(), M, K, qweight.data_ptr(), scales.data_ptr(), qzeros.data_ptr(), N, g,
        float(zero_const), bits, split, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "qmm")
    _build.LAUNCHES["qmm"] += 1
    return out


def _check_planes(x, qweight, scales, *, bits, group_size, planar, zero_const=None,
                  qzeros=None, name):
    _check_operands(x, qweight, scales, bits=bits, group_size=group_size,
                    zero_const=zero_const, qzeros=qzeros, name=name,
                    supported=qmatmul_planes_supported)
    if not planar and bits != 3:
        raise ValueError(f"{name}: {bits}-bit words exist only in the planar layout")


def qmatmul_planes_plain(x, qweight, scales, *, bits, group_size, zero_const, planar):
    """Plain PyTorch version of K4, rounded to the activation type."""
    return grouped_dot_f32(x, qweight, scales, bits=bits, group_size=group_size,
                           zero_const=zero_const, planar=planar).to(x.dtype)


def qmatmul_planes(x, qweight, scales, *, bits, group_size, zero_const, planar):
    """K4: ``x [M, K] @ dequant(qweight)`` -> ``[M, N]`` in x's type, for 3,
    5, 6 or 7-bit words (stitched 3-bit, or ``planar``) with one uniform zero
    point.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor to
    ``qmatmul_planes_plain``."""
    if x.device.type == "cpu":
        return qmatmul_planes_plain(x, qweight, scales, bits=bits, group_size=group_size,
                                    zero_const=zero_const, planar=planar)
    _check_planes(x, qweight, scales, bits=bits, group_size=group_size, planar=planar,
                  zero_const=zero_const, name="K4")
    M, K = x.shape
    N = qweight.shape[1]
    g = group_size if group_size > 0 else K
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    lib = _build.lib()
    split = _decode_split(x, qweight, scales, group_size=g, name="K4")
    rc = lib.gqt_qmatmul_planes(
        x.data_ptr(), M, K, qweight.data_ptr(), scales.data_ptr(), N, g,
        float(zero_const), bits, int(planar), split, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "qmatmul_planes")
    _build.LAUNCHES["qmatmul_planes"] += 1
    return out


def qmatmul_planes_asym_plain(x, qweight, scales, qzeros, *, bits, group_size, planar):
    """Plain PyTorch version of K5, rounded to the activation type."""
    zeros = unpack_qzeros(qzeros, bits, planar=planar)
    return grouped_dot_f32(x, qweight, scales, bits=bits, group_size=group_size,
                           zeros=zeros, planar=planar).to(x.dtype)


def qmatmul_planes_asym(x, qweight, scales, qzeros, *, bits, group_size, planar):
    """K5: K4 with a zero point per group and column (``qzeros``: v2 words
    ``[K/g, N*bits/32]`` in the weights' layout) -> ``[M, N]`` in x's type.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor to
    ``qmatmul_planes_asym_plain``."""
    if x.device.type == "cpu":
        return qmatmul_planes_asym_plain(x, qweight, scales, qzeros, bits=bits,
                                         group_size=group_size, planar=planar)
    _check_planes(x, qweight, scales, bits=bits, group_size=group_size, planar=planar,
                  qzeros=qzeros, name="K5")
    M, K = x.shape
    N = qweight.shape[1]
    g = group_size if group_size > 0 else K
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    lib = _build.lib()
    split = _decode_split(x, qweight, scales, group_size=g, name="K5")
    rc = lib.gqt_qmatmul_planes_asym(
        x.data_ptr(), M, K, qweight.data_ptr(), scales.data_ptr(), qzeros.data_ptr(), N, g,
        bits, int(planar), split, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "qmatmul_planes_asym")
    _build.LAUNCHES["qmatmul_planes_asym"] += 1
    return out
