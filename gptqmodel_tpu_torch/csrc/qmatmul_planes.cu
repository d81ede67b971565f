// K4 and K5: 3, 5, 6 and 7-bit dequant-matmul, y[M,N] = x[M,K] @ dequant(qweight).
//
// K4 replaces the TPU kernel gptqmodel_tpu/ops/pallas_qmatmul.py
// _qmm_rtp_sym_kernel (:385, with _rtp_accumulate :345; reached through
// qmatmul(rt=True, zero_const>=0) at 3/5/6/7 bits): one uniform zero point.
// K5 replaces _qmm_rtp_kernel (:421, zero_const<0): a zero point per group
// and column, read from the module's v2 qzeros words as they are stored.
// Both compute y = sum_g s_g * sum_{i in g} x_i * (c_i - z_g) with f32 sums,
// as K1 and K3 do (qmm_common.cuh):
//   P_g = x_g . codes_g (bf16 x bf16 products, exact, f32 sums),
//   acc += P_g * s_g - X1_g * (z_g * s_g),
// with the fp16 scales used as stored; the TPU kernels round the scales and
// K5's zeros to bf16 first (pallas_qmatmul.py:656, 666-667).
//
// The codes are read in their storage layout, in place (ops/pack.py): each
// 32-row unit of a column is BITS consecutive int32 words, either the
// stitched 3-bit layout (one 96-bit little-endian stream, row r at bit 3r)
// or the planar gptq_p layout (one plane per set bit of BITS, widest first;
// the plane of width w at bit offset off takes words off..off+w-1, row r at
// shift (w*r)%32 of word off + (w*r)/32; the code is sum plane << off). The
// TPU kernels read a plane-split runtime repack (pack.repack_rt_planes) made
// for the TPU's bf16 bitcast extraction and its distributed per-plane dots;
// the port has neither the repack nor its inverse before an export.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode
// (M <= 16) the packed weights, bits/8 bytes each, read once; at prefill
// (M = 1024) the 2*M*N*K operations.
//
// Decode (M <= 16): the decode kernel of qmm_decode.cuh with Z =
// Units<PLANAR, UniformZero> (K4) or Units<PLANAR, PlaneZeros<BITS, PLANAR>>
// (K5), K1's and K3's ring, cluster and arithmetic. A stage holds a 128-row
// chunk: 4 units, 4*BITS word rows of the 64-column tile, the group's scale
// row, K5's 2 units of zeros words, and x's slice. Lane t of a quad takes
// unit t; of its 32 rows each of the two K shares takes 16 (rows 8h + j and
// 8h + 16 + j, j = 0..7), as 8 code pairs whose two rows lie 16 bits apart
// once the lane has rearranged its words: in the planar layout with one
// byte permute per word pair of the 4-bit and 2-bit planes (the 1-bit plane
// has them so already), in the stitched one with two funnel shifts and two
// byte permutes. A pair then takes one shift, one AND-OR with the magic
// 0x4300 and one bf16 subtraction per plane (stitched: per unit), as K1's
// code_pair does; x's B fragment is gathered from the same rows. K5's zeros
// are decoded from the stage at the group's end by unit_code.
//
// Prefill (M > 16): K1's tile and block (qmm_common.cuh, launch_by_m,
// unchanged) with another B operand.
// - Lane t of a quad owns one 32-row unit of each of its columns per 128-row
//   chunk (units k0/32 + t), loads that unit's BITS words (four lanes of a
//   quad and eight quads of a warp read 4*BITS 32-byte sectors) and keeps the
//   next chunk's in flight during the math.
// - The mma's K slots 2t, 2t+1, 2t+8, 2t+9 of step s (8 steps a chunk) are
//   rows 4s .. 4s+3 of lane t's unit, so its A operand is two consecutive
//   32-bit words of x (rows 4s .. 4s+3 of the lane's 32): one 16-byte load
//   per row serves two steps. Each code is shifted out of its words (constant
//   shifts once unrolled) and turned into bf16 exactly by the magic OR
//   0x4300 (128 + code, code <= 127) and one exact bf16 subtraction of 128.
// - A group holds whole chunks (g % 128 == 0), so a chunk never straddles a
//   group, and the per-group correction is K1's.
// - K5's zeros: two columns of one group per lane and group, decoded from
//   their unit's words by the same accessor (a 32-column unit holds both).
// It does not use wgmma or TMA: it is not expected to reach the tensor-core
// bound at prefill.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qmm_common.cuh"
#include "qmm_decode.cuh"

namespace gqt {

// The code of row r (0..31) of a 32-row unit whose BITS words word(0 ..
// BITS-1) returns: the stitched 3-bit layout (PLANAR false) or planar.
template <int BITS, bool PLANAR, class Word>
__device__ __forceinline__ uint32_t unit_code(const Word& word, int r) {
  if constexpr (!PLANAR) {
    static_assert(BITS == 3, "the stitched layout is 3-bit");
    const int bit = 3 * r, i = bit >> 5, sh = bit & 31;
    uint32_t v = word(i) >> sh;
    if (sh > 29) v |= word(i < 2 ? i + 1 : 2) << (32 - sh);  // rows 10 and 21
    return v & 7u;
  } else {
    uint32_t c = 0;
    int off = 0;
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1) {
      if (BITS & w) {
        const int bit = w * r;
        c |= ((word(off + (bit >> 5)) >> (bit & 31)) & ((1u << w) - 1u)) << off;
        off += w;
      }
    }
    return c;
  }
}

// bf16 pair (c0, c1), c0 in the low half, exact for codes <= 127.
__device__ __forceinline__ uint32_t code_pair_of(uint32_t c0, uint32_t c1) {
  uint32_t t = c0 | (c1 << 16) | 0x43004300u;  // bf16(128 + code)
  const __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&t);
  return as_u32(__hsub2(v, __floats2bfloat162_rn(128.f, 128.f)));
}

// K5: the zeros of columns c and c+1 (c even) of group grp, from the v2
// qzeros words [G, N*BITS/32] in the weights' layout; both columns lie in
// one 32-column unit.
template <int BITS, bool PLANAR>
struct PlaneZeros {
  const uint32_t* qz;
  int words;  // words per group: N*BITS/32
  __device__ __forceinline__ float2 operator()(int grp, int c) const {
    const uint32_t* u = qz + (size_t)grp * words + (size_t)(c >> 5) * BITS;
    const auto word = [u](int j) { return __ldg(u + j); };
    const int r = c & 31;
    return make_float2((float)unit_code<BITS, PLANAR>(word, r),
                       (float)unit_code<BITS, PLANAR>(word, r + 1));
  }
};

// acc[mt][nt][i] = the warp's f32 product over K-rows [k_begin, k_end),
// multiples of g (itself a multiple of kChunk), in warp_tile's register
// layout (qmm_common.cuh): rows m0 + 16*mt + lane/4 (+8 for i >= 2), columns
// cols[nt] + 2*(lane%4) + (i&1). qw [K*BITS/32, N] int32; sc [K/g, N] fp16.
template <int BITS, bool PLANAR, int MT, int NT, class Z>
__device__ __forceinline__ void planes_warp_tile(
    const __nv_bfloat16* __restrict__ x, int ldx, int M, int m0,
    const uint32_t* __restrict__ qw, const __half* __restrict__ sc, int N,
    const int (&cols)[NT], int g, int k_begin, int k_end, const Z& zero,
    float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3, gid = lane >> 2;

  float p[MT][NT][4], x1[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    x1[mt][0] = x1[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = p[mt][nt][i] = 0.f;
  }
  if (k_begin >= k_end) return;

  uint32_t w[NT][BITS], wn[NT][BITS];
  auto load_w = [&](int k0, uint32_t (&dst)[NT][BITS]) {
    const size_t row0 = (size_t)(k0 / 32 + t) * BITS;  // this lane's unit
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < BITS; ++j)
        dst[nt][j] = __ldg(qw + (row0 + j) * N + cols[nt] + gid);
  };
  load_w(k_begin, w);

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    if (k0 + kChunk < k_end) load_w(k0 + kChunk, wn);  // in flight during the math
    const int kx = k0 + 32 * t;  // this lane's 32 K-rows
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // rows 8q .. 8q+7 of the unit: two mma steps
      uint32_t xa[MT][4], xb[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int ra = m0 + 16 * mt + gid, rb = ra + 8;
        load_x<4>(x + (size_t)ra * ldx + kx + 8 * q, ra < M, xa[mt]);
        load_x<4>(x + (size_t)rb * ldx + kx + 8 * q, rb < M, xb[mt]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x1[mt][0] += pair_sum(xa[mt][i]);
          x1[mt][1] += pair_sum(xb[mt][i]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r0 = 8 * q + 4 * h;
        uint32_t b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const auto word = [&](int j) { return w[nt][j]; };
          b[nt][0] = code_pair_of(unit_code<BITS, PLANAR>(word, r0),
                                  unit_code<BITS, PLANAR>(word, r0 + 1));
          b[nt][1] = code_pair_of(unit_code<BITS, PLANAR>(word, r0 + 2),
                                  unit_code<BITS, PLANAR>(word, r0 + 3));
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t a[4] = {xa[mt][2 * h], xb[mt][2 * h], xa[mt][2 * h + 1],
                                 xb[mt][2 * h + 1]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(p[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
    if ((k0 + kChunk) % g == 0) {  // the group ends with this chunk
      const int grp = (k0 + kChunk) / g - 1;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {  // the quad's lanes hold disjoint K-rows
          x1[mt][hh] += __shfl_xor_sync(0xffffffffu, x1[mt][hh], 1);
          x1[mt][hh] += __shfl_xor_sync(0xffffffffu, x1[mt][hh], 2);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 s = __half22float2(
              *reinterpret_cast<const __half2*>(sc + (size_t)grp * N + cols[nt] + 2 * t));
          const float2 z = zero(grp, cols[nt] + 2 * t);
          const float zs0 = z.x * s.x, zs1 = z.y * s.y;
          acc[mt][nt][0] += p[mt][nt][0] * s.x - x1[mt][0] * zs0;
          acc[mt][nt][1] += p[mt][nt][1] * s.y - x1[mt][0] * zs1;
          acc[mt][nt][2] += p[mt][nt][2] * s.x - x1[mt][1] * zs0;
          acc[mt][nt][3] += p[mt][nt][3] * s.y - x1[mt][1] * zs1;
#pragma unroll
          for (int i = 0; i < 4; ++i) p[mt][nt][i] = 0.f;
        }
        x1[mt][0] = x1[mt][1] = 0.f;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < BITS; ++j) w[nt][j] = wn[nt][j];
  }
}

// K4's kernel with Z = UniformZero, K5's with Z = PlaneZeros: qmatmul_kernel's
// block (4 warps split K by groups, reduced in warp order) over
// planes_warp_tile.
template <int BITS, bool PLANAR, int MT, int NT, class Z>
__global__ void __launch_bounds__(kThreads)
    planes_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                  const uint32_t* __restrict__ qw, const __half* __restrict__ sc, int N,
                  int g, Z zero, __nv_bfloat16* __restrict__ out) {
  __shared__ float red[(kWarps - 1) * MT * NT * 4 * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * 16 * MT;
  int cols[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) cols[nt] = (blockIdx.y * NT + nt) * 8;
  const int G = K / g;
  const int k_begin = (warp * G / kWarps) * g, k_end = ((warp + 1) * G / kWarps) * g;

  float acc[MT][NT][4];
  planes_warp_tile<BITS, PLANAR, MT, NT, Z>(x, K, M, m0, qw, sc, N, cols, g, k_begin, k_end,
                                            zero, acc);
  block_reduce<MT, NT>(red, acc);
  if (warp != 0) return;
  const int t = lane & 3, gid = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ra = m0 + 16 * mt + gid, rb = ra + 8;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = cols[nt] + 2 * t;
      if (ra < M) store_bf16x2(out + (size_t)ra * N + c, acc[mt][nt][0], acc[mt][nt][1]);
      if (rb < M) store_bf16x2(out + (size_t)rb * N + c, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// The decode kernel at M <= 16 (Units over zero), planes_kernel's tiles
// beyond; launch_by_m's 16-row tile is never launched, so kernel_of maps it
// to Tile<4, 1>'s kernel.
template <int BITS, bool PLANAR, class Z>
int dispatch_planes(const void* x, int M, int K, const void* qw, const void* sc, int N, int g,
                    Z zero, int split, void* out, cudaStream_t stream) {
  const auto kernel_of = [](auto tile) {
    using T = decltype(tile);
    return planes_kernel<BITS, PLANAR, T::MT == 1 ? 4 : T::MT, T::NT, Z>;
  };
  return dispatch_decode_or_tile<BITS, Units<PLANAR, Z>, false>(
      kernel_of, x, M, K, qw, sc, N, g, Units<PLANAR, Z>{zero}, split, out, stream);
}

// f(bits, planar) as compile-time constants for the five layouts K4 and K5
// take: 3-bit stitched, 3, 5, 6 and 7-bit planar; f's result, or -1 for any
// other layout.
template <class F>
int by_layout(int bits, int planar, F f) {
  using P = std::true_type;
  if (bits == 3 && !planar) return f(std::integral_constant<int, 3>{}, std::false_type{});
  if (!planar) return -1;
  switch (bits) {
    case 3: return f(std::integral_constant<int, 3>{}, P{});
    case 5: return f(std::integral_constant<int, 5>{}, P{});
    case 6: return f(std::integral_constant<int, 6>{}, P{});
    case 7: return f(std::integral_constant<int, 7>{}, P{});
    default: return -1;
  }
}

}  // namespace gqt

// The entry points return 0, -1 for an unsupported layout or a decode split
// outside 1 .. min(8, K / g), or the CUDA error of the launch. The caller
// checks the contract: bf16 x [M, K] (16-byte aligned rows), int32 qweight
// [K*bits/32, N], fp16 scales [K/g, N], g % 128 == 0, K % g == 0,
// N % 32 == 0 (K5 also int32 v2 qzeros [K/g, N*bits/32] in the weights'
// layout; at decode 16-byte aligned qweight and scales); and allocates out
// [M, N] bf16. split is the decode plan's cluster size (ops/qmatmul.py), 0
// above 16 rows.
extern "C" int gqt_qmatmul_planes(const void* x, int M, int K, const void* qweight,
                                  const void* scales, int N, int group_size, float zero_const,
                                  int bits, int planar, int split, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const gqt::UniformZero z{zero_const};
  return gqt::by_layout(bits, planar, [&](auto b, auto pl) {
    return gqt::dispatch_planes<decltype(b)::value, decltype(pl)::value>(
        x, M, K, qweight, scales, N, group_size, z, split, out, s);
  });
}

extern "C" int gqt_qmatmul_planes_asym(const void* x, int M, int K, const void* qweight,
                                       const void* scales, const void* qzeros, int N,
                                       int group_size, int bits, int planar, int split,
                                       void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gqt::by_layout(bits, planar, [&](auto b, auto pl) {
    constexpr int BITS = decltype(b)::value;
    constexpr bool PLANAR = decltype(pl)::value;
    const gqt::PlaneZeros<BITS, PLANAR> z{static_cast<const uint32_t*>(qzeros),
                                          N * BITS / 32};
    return gqt::dispatch_planes<BITS, PLANAR>(x, M, K, qweight, scales, N, group_size, z,
                                              split, out, s);
  });
}
