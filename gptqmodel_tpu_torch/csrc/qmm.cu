// K6: 2/4/8-bit dequant-matmul on groups of any size, y[M,N] = x[M,K] @ W.
//
// Replaces the TPU kernel gptqmodel_tpu/ops/pallas_qmatmul.py _qmm_kernel
// (:55, reached through qmatmul(rt=False)), which the reference runs for
// contiguous modules outside the rt kernels' contract (groups of 16, 32 or
// 64) at M <= 256. Its arithmetic, element by element:
//   w[k][n] = bf16( bf16(c[k][n] - z[g][n]) * bf16(s[g][n]) ),  g = k / group_size
//   y[m][n] = bf16( sum_k x[m][k] * w[k][n] )                    f32 sums
// The difference c - z is exact in bf16 (both at most 255); the scale is the
// fp16 scale rounded to bf16, as the TPU kernel takes it (s.astype(bf16));
// the product is rounded once. This is also the dequantize-then-matmul
// reference in bf16 (ops/qlinear.py), so the two routes of one module differ
// only in the order of the f32 sums. Unlike K1, K3 and K7, which keep the fp16
// scales, K6 rounds them to bf16, as the reference does.
//
// The weights are read in the GPTQ interchange layout, with no repack and
// without the TPU kernel's plane permutation of x (_plane_permute_x): the
// tile is K1's (qmm_common.cuh), lane l loads the word of column n0 + l/4 and
// word row 4*i + l%4, and the mma's K index is mapped onto the word's bf16
// pairs, with x gathered by the same mapping. A group holds whole words
// (group_size % (32/bits) == 0), so every field of a word lies in the group
// of its word row, (4*i + l%4) * PF / group_size: each lane dequantizes its
// own word with its own group's scale and zero before the mma, however the
// groups fall across the four lanes of an mma step. No per-group partial
// dots, so any group size that holds whole words works.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode the
// packed weights, the scales (2 bytes per group and column: 1/8 of the
// 4-bit weight bytes at group 32) and, for per-group zeros, the qzeros words,
// read once.
//
// Decode (M <= 16, a group that divides 128, K % 128 == 0): the decode
// kernel of K1, K3 and K7 (qmm_decode.cuh) with Z = DequantFirst<zeros>:
// the tile's weights, every scale and qzeros row of a 128-row chunk and x
// stream through its shared-memory ring, K splits across a cluster in whole
// chunks, the weights are the mma's A operand, and each lane dequantizes
// its word row with its group's scales and zeros from the stage before the
// mma (dq_pair, qmm_common.cuh). The launch plan (ops/qmatmul.py) passes the
// cluster split, or 0 for a shape outside that contract.
//
// Otherwise, and above 16 rows, the register tile below (at M <= 16 its
// 64-row tile), simple first:
// mma.sync m16n8k16 with B fragments built in registers (one and, one or,
// one bf16x2 subtraction and one bf16x2 multiplication per pair of 2/4-bit
// codes: dq_pair); 4 warps a block split K by 4-word steps and add their
// results in warp order through shared memory (no atomics, the same bits
// every run); each lane keeps the next four steps' words, scales and zero
// words in flight while it works on the current ones; the B fragments of a
// step serve every row tile of the block. No wgmma or TMA: it is not
// expected to reach the tensor-core bound at M = 256.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"
#include "qmm_decode.cuh"

namespace gqt {

constexpr int kSteps = 4;  // 4-word steps per lane whose loads are in flight together

// A block of kWarps warps owns rows m0 .. m0+16*MT-1 and columns
// blockIdx.y*8*NT .. +8*NT-1; the warps split K by 4-word steps (KI rows).
template <int BITS, int MT, int NT, class Z>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
               const uint32_t* __restrict__ qw, const __half* __restrict__ sc, int N, int g,
               Z zero, __nv_bfloat16* __restrict__ out) {
  constexpr int PF = 32 / BITS;
  constexpr int KI = 4 * PF;  // K-rows per step: 4 words of a column
  constexpr int NX = PF / 2;  // x words per row per lane per step
  constexpr int NS = PF / 4;  // mma steps per 4-word step
  constexpr float kOff = BITS == 8 ? 0.f : 128.f;
  __shared__ float red[(kWarps - 1) * MT * NT * 4 * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, gid = lane >> 2;
  const int m0 = blockIdx.x * 16 * MT;  // row tiles vary fastest: they share weights
  int cols[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) cols[nt] = (blockIdx.y * NT + nt) * 8 + gid;
  const int steps = K / KI;
  const int i_begin = warp * steps / kWarps, i_end = (warp + 1) * steps / kWarps;
  const unsigned short* sc16 = reinterpret_cast<const unsigned short*>(sc);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // this lane's word, fp16 scale and zero word of each column, for kSteps steps
  uint32_t w[kSteps][NT], s[kSteps][NT], z[kSteps][NT];
  uint32_t wn[kSteps][NT], sn[kSteps][NT], zn[kSteps][NT];
  auto load = [&](int i0, uint32_t (&dw)[kSteps][NT], uint32_t (&ds)[kSteps][NT],
                  uint32_t (&dz)[kSteps][NT]) {
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const int row = (i0 + it) * 4 + t;  // word row
      const int grp = row * PF / g;       // every field of the word is in it
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bool ok = i0 + it < i_end;
        dw[it][nt] = ok ? __ldg(qw + (size_t)row * N + cols[nt]) : 0u;
        ds[it][nt] = ok ? __ldg(sc16 + (size_t)grp * N + cols[nt]) : 0u;
        dz[it][nt] = ok ? zero.word(grp, cols[nt]) : 0u;
      }
    }
  };
  if (i_begin < i_end) load(i_begin, w, s, z);

  for (int i0 = i_begin; i0 < i_end; i0 += kSteps) {
    if (i0 + kSteps < i_end) load(i0 + kSteps, wn, sn, zn);  // in flight during the math
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      if (i0 + it >= i_end) break;  // the same for every lane of the warp
      uint32_t b[NT][NS][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float sf = __half2float(__ushort_as_half((unsigned short)s[it][nt]));
        const __nv_bfloat162 s2 = __float2bfloat162_rn(sf);  // bf16(s), as the TPU kernel
        const __nv_bfloat162 z2 = __float2bfloat162_rn(zero.one(z[it][nt], cols[nt]) + kOff);
#pragma unroll
        for (int ss = 0; ss < NS; ++ss) {
          b[nt][ss][0] = dq_pair<BITS>(w[it][nt], 2 * ss, z2, s2);
          b[nt][ss][1] = dq_pair<BITS>(w[it][nt], 2 * ss + 1, z2, s2);
        }
      }
      const int kx = (i0 + it) * KI + t * PF;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int ra = m0 + 16 * mt + gid, rb = ra + 8;
        uint32_t xa[NX], xb[NX];
        load_x<NX>(x + (size_t)ra * K + kx, ra < M, xa);
        load_x<NX>(x + (size_t)rb * K + kx, rb < M, xb);
#pragma unroll
        for (int ss = 0; ss < NS; ++ss) {
          const uint32_t a[4] = {
              __byte_perm(xa[ss], xa[ss + NS], 0x5410), __byte_perm(xb[ss], xb[ss + NS], 0x5410),
              __byte_perm(xa[ss], xa[ss + NS], 0x7632), __byte_perm(xb[ss], xb[ss + NS], 0x7632)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt][ss][0], b[nt][ss][1]);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kSteps; ++it)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        w[it][nt] = wn[it][nt];
        s[it][nt] = sn[it][nt];
        z[it][nt] = zn[it][nt];
      }
  }

  block_reduce<MT, NT>(red, acc);
  if (warp != 0) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ra = m0 + 16 * mt + gid, rb = ra + 8;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = cols[nt] - gid + 2 * t;  // the accumulator's column pair
      if (ra < M) store_bf16x2(out + (size_t)ra * N + c, acc[mt][nt][0], acc[mt][nt][1]);
      if (rb < M) store_bf16x2(out + (size_t)rb * N + c, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// The decode kernel for a split > 0, else the tiles by M as K1
// (launch_by_m in qmm_common.cuh). A shape off the decode kernel's contract
// at M <= 16 runs the Tile<4, 1> kernel (launch_by_m's Tile<1, 1> mapped to
// it, as K1's kernel_of does), so no 16-row tile of K6 is built.
template <int BITS, class Z>
int dispatch_qmm(const void* x, int M, int K, const void* qw, const void* sc, int N, int g,
                 Z zero, int split, void* out, cudaStream_t stream) {
  if (split > 0)
    return launch_decode<BITS, DequantFirst<Z>, false>(x, M, K, qw, sc, N, g,
                                                       DequantFirst<Z>{zero}, split, out, stream);
  const auto kernel_of = [](auto tile) {
    using T = decltype(tile);
    return qmm_kernel<BITS, T::MT == 1 ? 4 : T::MT, T::NT, Z>;
  };
  launch_by_m(kernel_of, x, M, K, qw, sc, N, g, zero, out, stream);
  return (int)cudaGetLastError();
}

template <int BITS>
int dispatch_zero(const void* x, int M, int K, const void* qw, const void* sc, const void* qz,
                  int N, int g, float zero_const, int split, void* out, cudaStream_t stream) {
  if (zero_const >= 0.f)
    return dispatch_qmm<BITS>(x, M, K, qw, sc, N, g, UniformZero{zero_const}, split, out,
                              stream);
  const GroupZeros<BITS> zero{static_cast<const uint32_t*>(qz), N * BITS / 32};
  return dispatch_qmm<BITS>(x, M, K, qw, sc, N, g, zero, split, out, stream);
}

}  // namespace gqt

// Returns 0, -1 for unsupported bits or a decode split the decode kernel
// does not take (qmm_decode.cuh, launch_decode), or the CUDA error of the
// launch. The caller checks the contract (ops/qmatmul.py qmm_supported):
// bf16 x [M, K] (16-byte aligned rows), int32 qweight [K*bits/32, N], fp16
// scales [K/g, N], int32 v2 qzeros [K/g, N*bits/32], g % (32/bits) == 0,
// g % 8 == 0, K % g == 0, K % (128/bits) == 0, N % 128 == 0 (at a split > 0
// also 16-byte aligned qweight and scales); zero_const >= 0 is the module's
// one zero point (qzeros are then not read); split is the decode plan's
// cluster size, or 0 for the register tile; and allocates out [M, N] bf16.
extern "C" int gqt_qmm(const void* x, int M, int K, const void* qweight, const void* scales,
                       const void* qzeros, int N, int group_size, float zero_const, int bits,
                       int split, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* z = qzeros;
  const int g = group_size;
  const float zc = zero_const;
  switch (bits) {
    case 2: return gqt::dispatch_zero<2>(x, M, K, qweight, scales, z, N, g, zc, split, out, s);
    case 4: return gqt::dispatch_zero<4>(x, M, K, qweight, scales, z, N, g, zc, split, out, s);
    case 8: return gqt::dispatch_zero<8>(x, M, K, qweight, scales, z, N, g, zc, split, out, s);
    default: return -1;
  }
}
