// K2: fused quantized MLP, y = down(bf16(act(x @ dq(W_gate)) * (x @ dq(W_up)))),
// for symmetric 2/4/8-bit weights at decode sizes (M <= 64).
//
// Replaces the TPU kernel gptqmodel_tpu/ops/pallas_qmlp.py _qmlp_kernel
// (via qmlp): there the grid walks F tiles in order and carries one [M, D]
// f32 accumulator from tile to tile. Blocks on an H100 run in no order, so
// the reduction of down over F is a second pass instead:
// - pass 1 computes gate and up of the fused gate_up weight ([D/pf, 2F],
//   gate first) in f32 and writes inner = bf16(silu(g) * u), the TPU
//   kernel's rounding, to a scratch [M, F] bf16 that the wrapper allocates
//   (M*F*2 bytes: 229 KB at M = 8, F = 14336, so it stays in the 50 MB L2).
// - pass 2: down = K1 on inner.
// At M <= 16 both passes are the decode kernel (qmm_decode.cuh), each with
// the cluster split of its own launch plan (ops/qmlp.py): pass 1 with
// GateUpPairs, whose 64-column tiles hold 32 gate columns and their 32 up
// columns, so that the block that sums a gate column also sums its up
// column and writes inner; pass 2 is K1's decode launch. At M = 17..64 both
// passes run K1's register tile (qmm_common.cuh) with four row tiles: pass
// 1's block owns 8 gate columns and the 8 matching up columns, its 4 warps
// split D by groups and add in warp order, and warp 0 writes inner; pass 2
// is K1's kernel, its 4 warps splitting F by groups.
// No float atomics: the result is the same from run to run.
//
// What bounds it on an H100: the three packed weights, 3*D*F*bits/8 bytes
// (88 MB at Llama-3-8B widths, 4-bit), over 3.35 TB/s; the operations are
// 6*M*D*F, far below the tensor-core bound at M <= 64. Each weight word is
// read once per call, and g and u stay in f32 until inner is written.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.0553 ms
// at M = 8 against a 0.0272 ms byte bound.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"
#include "qmm_decode.cuh"

namespace gqt {

template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads)
    qmlp_gate_up_kernel(const __nv_bfloat16* __restrict__ x, int M, int D, int F,
                        const uint32_t* __restrict__ qw, const __half* __restrict__ sc,
                        int g, float zc, __nv_bfloat16* __restrict__ inner) {
  __shared__ float red[(kWarps - 1) * MT * 2 * 4 * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * 16 * MT;
  const int f0 = blockIdx.y * 8;
  const int cols[2] = {f0, F + f0};  // gate columns, then the matching up columns
  const int G = D / g;
  const int k_begin = (warp * G / kWarps) * g, k_end = ((warp + 1) * G / kWarps) * g;

  float acc[MT][2][4];
  warp_tile<BITS, MT, 2, UniformZero>(x, D, M, m0, qw, sc, 2 * F, cols, g, k_begin, k_end,
                                      UniformZero{zc}, acc);
  block_reduce<MT, 2>(red, acc);
  if (warp != 0) return;
  const int t = lane & 3, gid = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float gt = acc[mt][0][i];
      v[i] = gt / (1.f + expf(-gt)) * acc[mt][1][i];  // silu(g) * u, f32
    }
    const int ra = m0 + 16 * mt + gid, rb = ra + 8, c = f0 + 2 * t;
    if (ra < M) store_bf16x2(inner + (size_t)ra * F + c, v[0], v[1]);
    if (rb < M) store_bf16x2(inner + (size_t)rb * F + c, v[2], v[3]);
  }
}

template <int BITS>
int dispatch_qmlp(const void* x, int M, int D, int F, const void* qw_gu, const void* s_gu,
                  float zc_gu, const void* qw_d, const void* s_d, float zc_d, int g,
                  int split_gu, int split_d, void* inner, void* out, cudaStream_t stream) {
  if (M <= kDecodeMaxM) {
    const int rc = launch_decode<BITS, GateUpPairs, false>(
        x, M, D, qw_gu, s_gu, 2 * F, g, GateUpPairs{{zc_gu}}, split_gu, inner, stream);
    if (rc != 0) return rc;
    return launch_decode<BITS, UniformZero, false>(inner, M, F, qw_d, s_d, D, g,
                                                   UniformZero{zc_d}, split_d, out, stream);
  }
  constexpr int MT = 4;
  const int mb = (M + 16 * MT - 1) / (16 * MT);
  qmlp_gate_up_kernel<BITS, MT><<<dim3(mb, F / 8), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), M, D, F, static_cast<const uint32_t*>(qw_gu),
      static_cast<const __half*>(s_gu), g, zc_gu, static_cast<__nv_bfloat16*>(inner));
  qmatmul_kernel<BITS, MT, 1, UniformZero><<<dim3(mb, D / 8), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(inner), M, F, static_cast<const uint32_t*>(qw_d),
      static_cast<const __half*>(s_d), D, g, UniformZero{zc_d},
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace gqt

// Returns 0, -1 for unsupported bits or, at M <= 16, a split outside
// 1 .. min(8, D / g) (split_gu) or 1 .. min(8, F / g) (split_d), or the CUDA
// error of the launches. The caller checks the contract (bf16 x [M, D] with
// M <= 64; qw_gu [D*bits/32, 2F] and s_gu [D/g, 2F] fp16; qw_d [F*bits/32, D]
// and s_d [F/g, D] fp16; g % 128 == 0, D % g == 0, F % g == 0; at M <= 16
// 16-byte aligned weights and scales) and allocates inner [M, F] and
// out [M, D], both bf16. The splits are read only at M <= 16.
extern "C" int gqt_qmlp(const void* x, int M, int D, int F, const void* qw_gu,
                        const void* s_gu, float zc_gu, const void* qw_d, const void* s_d,
                        float zc_d, int group_size, int bits, int split_gu, int split_d,
                        void* inner, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = group_size;
  switch (bits) {
    case 2: return gqt::dispatch_qmlp<2>(x, M, D, F, qw_gu, s_gu, zc_gu, qw_d, s_d, zc_d, g, split_gu, split_d, inner, out, s);
    case 4: return gqt::dispatch_qmlp<4>(x, M, D, F, qw_gu, s_gu, zc_gu, qw_d, s_d, zc_d, g, split_gu, split_d, inner, out, s);
    case 8: return gqt::dispatch_qmlp<8>(x, M, D, F, qw_gu, s_gu, zc_gu, qw_d, s_d, zc_d, g, split_gu, split_d, inner, out, s);
    default: return -1;
  }
}
