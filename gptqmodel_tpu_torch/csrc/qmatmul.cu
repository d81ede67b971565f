// K1, K3 and K7: 2/4/8-bit dequant-matmul, y[M,N] = x[M,K] @ dequant(qweight).
//
// K1 replaces the TPU kernel gptqmodel_tpu/ops/pallas_qmatmul.py
// _qmm_rt_sym_kernel (reached through qmatmul(rt=True, zero_const>=0)):
// contiguous groups, one uniform zero point. K3 replaces _qmm_rt_kernel
// (:117, reached with rt=True, zero_const<0): a zero point per group and
// column, which it reads from the module's v2 qzeros words as they are
// ([G, N*bits/32] int32, no unpacked copy), beside the scales. K7 replaces
// _qmm_rt_sym_fused_kernel (:263, the opt-in GPTQ_TPU_RT_FUSED=1 variant of
// K1): K1's operands with the scales folded into the weights, bf16(c * s),
// and one zero correction per group; it keeps the fp16 scales where the TPU
// kernel rounds them to bf16 first. All three compute per-group partial dots
// in f32 and round once to bf16 at the end. Act-order modules reach K1 and
// K3 after the caller's x-column gather (ops/registry.py).
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode
// (M <= 16) the packed weights, bits/8 bytes each, read once; at prefill
// (M = 1024) the 2*M*N*K operations.
//
// Decode, K1, K3 and K7 (M <= 16): qmm_decode.cuh. K1's register tile
// (qmm_common.cuh) keeps too few bytes in flight for this card: a lane
// prefetches only its next 128 rows into registers, some 8 KB an SM where
// 25 KB are needed, the 4 warps of a block walk K in long dependent
// chains, zeros and scales are loaded when they are needed, and half of
// every mma is padding. The decode kernel streams a 64-column tile's
// weights, scales, zeros and x through a ring of shared-memory stages,
// filled by two producer warps' cp.async copies so that the consumer warps
// only compute; splits K in whole groups across a thread-block cluster so
// that every projection fills the card; makes the weights the mma's A
// operand so that no row is padding; and adds the cluster's partials
// through distributed shared memory in rank order.
//
// Prefill (M > 16): K1's tile (qmm_common.cuh), a block of 4 warps over one
// column tile; they split K by whole groups and add their results in warp
// order through shared memory. At prefill a warp holds a 32 x 32 output
// tile, so each weight fragment serves 2 row tiles and each x fragment 4
// column tiles; the row blocks of one column tile are neighbours in launch
// order and meet the weights in L2. It uses mma.sync, not wgmma or TMA, so it
// does not reach the tensor-core bound. K3 is the same tile with another
// zero-point source (GroupZeros), K7 the same with FOLD.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"
#include "qmm_decode.cuh"

namespace gqt {

// K3's 32 x 32 prefill tile at 4 bits: qmatmul_kernel's body, bounded so
// that 3 blocks fit an SM (168 registers, no spill; 182 without the bound).
// At 2 and 8 bits the bound spills, so those keep qmatmul_kernel.
// scripts/decode_sweep.py builds with -DGQT_K3_WIDE_BOUND=0 to time it
// against qmatmul_kernel.
#ifndef GQT_K3_WIDE_BOUND
#define GQT_K3_WIDE_BOUND 1
#endif
template <int BITS>
__global__ void __launch_bounds__(kThreads, 3)
    qmatmul_asym_wide_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                             const uint32_t* __restrict__ qw, const __half* __restrict__ sc,
                             int N, int g, GroupZeros<BITS> zero,
                             __nv_bfloat16* __restrict__ out) {
  constexpr int MT = 2, NT = 4;
  __shared__ float red[(kWarps - 1) * MT * NT * 4 * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * 16 * MT;
  int cols[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) cols[nt] = (blockIdx.y * NT + nt) * 8;
  const int G = K / g;
  const int k_begin = (warp * G / kWarps) * g, k_end = ((warp + 1) * G / kWarps) * g;
  float acc[MT][NT][4];
  warp_tile<BITS, MT, NT, GroupZeros<BITS>>(x, K, M, m0, qw, sc, N, cols, g, k_begin, k_end,
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

template <int BITS>
int dispatch_qmatmul(const void* x, int M, int K, const void* qw, const void* sc, int N, int g,
                     float zero_const, int split, void* out, cudaStream_t stream) {
  using Z = UniformZero;
  const auto kernel_of = [](auto tile) {
    using T = decltype(tile);
    return qmatmul_kernel<BITS, T::MT == 1 ? 4 : T::MT, T::NT, Z>;
  };
  return dispatch_decode_or_tile<BITS, Z, false>(kernel_of, x, M, K, qw, sc, N, g, Z{zero_const},
                                                 split, out, stream);
}

template <int BITS>
int dispatch_asym(const void* x, int M, int K, const void* qw, const void* sc, const void* qz,
                  int N, int g, int split, void* out, cudaStream_t stream) {
  using Z = GroupZeros<BITS>;
  const Z zero{static_cast<const uint32_t*>(qz), N * BITS / 32};
  const auto kernel_of = [](auto tile) {
    using T = decltype(tile);
    if constexpr (GQT_K3_WIDE_BOUND && BITS == 4 && T::MT == 2 && T::NT == 4)
      return qmatmul_asym_wide_kernel<BITS>;
    else
      return qmatmul_kernel<BITS, T::MT == 1 ? 4 : T::MT, T::NT, Z>;
  };
  return dispatch_decode_or_tile<BITS, Z, false>(kernel_of, x, M, K, qw, sc, N, g, zero, split,
                                                 out, stream);
}

template <int BITS>
int dispatch_fused(const void* x, int M, int K, const void* qw, const void* sc, int N, int g,
                   float zero_const, int split, void* out, cudaStream_t stream) {
  using Z = UniformZero;
  const auto kernel_of = [](auto tile) {
    using T = decltype(tile);
    return qmatmul_kernel<BITS, T::MT == 1 ? 4 : T::MT, T::NT, Z, true>;
  };
  return dispatch_decode_or_tile<BITS, Z, true>(kernel_of, x, M, K, qw, sc, N, g, Z{zero_const},
                                                split, out, stream);
}

}  // namespace gqt

// The entry points return 0, -1 for unsupported bits or a decode split
// outside 1 .. min(8, K / g), or the CUDA error of the launch. The caller
// checks the contract: bf16 x [M, K] (16-byte aligned rows), int32 qweight
// [K*bits/32, N], fp16 scales [K/g, N], g % 128 == 0, K % g == 0,
// N % 8 == 0 (K3 also int32 v2 qzeros [K/g, N*bits/32]; at decode 16-byte
// aligned qweight and scales); and allocates out [M, N] bf16. K7
// (gqt_qmatmul_fused) takes K1's operands.
extern "C" int gqt_qmatmul(const void* x, int M, int K, const void* qweight,
                           const void* scales, int N, int group_size, float zero_const,
                           int bits, int split, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* w = qweight;
  const float zc = zero_const;
  switch (bits) {
    case 2: return gqt::dispatch_qmatmul<2>(x, M, K, w, scales, N, group_size, zc, split, out, s);
    case 4: return gqt::dispatch_qmatmul<4>(x, M, K, w, scales, N, group_size, zc, split, out, s);
    case 8: return gqt::dispatch_qmatmul<8>(x, M, K, w, scales, N, group_size, zc, split, out, s);
    default: return -1;
  }
}

extern "C" int gqt_qmatmul_asym(const void* x, int M, int K, const void* qweight,
                                const void* scales, const void* qzeros, int N, int group_size,
                                int bits, int split, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = group_size;
  switch (bits) {
    case 2: return gqt::dispatch_asym<2>(x, M, K, qweight, scales, qzeros, N, g, split, out, s);
    case 4: return gqt::dispatch_asym<4>(x, M, K, qweight, scales, qzeros, N, g, split, out, s);
    case 8: return gqt::dispatch_asym<8>(x, M, K, qweight, scales, qzeros, N, g, split, out, s);
    default: return -1;
  }
}

extern "C" int gqt_qmatmul_fused(const void* x, int M, int K, const void* qweight,
                                 const void* scales, int N, int group_size, float zero_const,
                                 int bits, int split, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* w = qweight;
  const float zc = zero_const;
  switch (bits) {
    case 2: return gqt::dispatch_fused<2>(x, M, K, w, scales, N, group_size, zc, split, out, s);
    case 4: return gqt::dispatch_fused<4>(x, M, K, w, scales, N, group_size, zc, split, out, s);
    case 8: return gqt::dispatch_fused<8>(x, M, K, w, scales, N, group_size, zc, split, out, s);
    default: return -1;
  }
}

// The dynamic shared memory of the decode kernel's block at M rows (its
// ring): K1's, K3's, K7's and K2's for g = 0, K6's at group g > 0; at 3, 5,
// 6 and 7 bits K4's and K5's for g = 0; or -1 for unsupported bits, M or g.
extern "C" int gqt_decode_smem_bytes(int bits, int M, int g) {
  const auto of = [&](auto shape) {
    using D = decltype(shape);
    if (g == 0) return D::smem_bytes(M);
    return D::UNITS || g < D::MIN_GROUP || gqt::kChunk % g ? -1 : D::k6_smem_bytes(M, g);
  };
  if (M < 1 || M > gqt::kDecodeMaxM) return -1;
  switch (bits) {
    case 2: return of(gqt::DecodeShape<2>{});
    case 3: return of(gqt::DecodeShape<3>{});
    case 4: return of(gqt::DecodeShape<4>{});
    case 5: return of(gqt::DecodeShape<5>{});
    case 6: return of(gqt::DecodeShape<6>{});
    case 7: return of(gqt::DecodeShape<7>{});
    case 8: return of(gqt::DecodeShape<8>{});
    default: return -1;
  }
}
