// K1, K3 and K7: 2/4/8-bit dequant-matmul, y[M,N] = x[M,K] @ dequant(qweight).
//
// K1 replaces the TPU kernel gptqmodel_tpu/ops/pallas_qmatmul.py
// _qmm_rt_sym_kernel (reached through qmatmul(rt=True, zero_const>=0)):
// contiguous groups, one uniform zero point. K3 replaces _qmm_rt_kernel
// (:117, reached with rt=True, zero_const<0): a zero point per group and
// column, which it reads from the module's v2 qzeros words as they are
// ([G, N*bits/32] int32, no unpacked copy), one word per group and column
// pair, beside the scales. Both compute per-group partial dots in f32 and
// round once to bf16 at the end; the arithmetic is in qmm_common.cuh, and K3
// is the same tile with another zero-point source (GroupZeros), so K1's
// instantiations do not change. Act-order modules reach both after the
// caller's x-column gather (ops/registry.py). K7 replaces
// _qmm_rt_sym_fused_kernel (:263, the opt-in GPTQ_TPU_RT_FUSED=1 variant of
// K1): K1's tile and contract with the scales folded into the B operand,
// bf16(c * s) (FOLD in qmm_common.cuh), and one zero correction per group;
// it keeps the fp16 scales where the TPU kernel rounds them to bf16 first.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode
// (M <= 16) the packed weights, bits/8 bytes each, read once; at prefill
// (M = 1024) the 2*M*N*K operations. The design, simple first:
// - The tensor cores take the products (mma.sync m16n8k16, bf16 in, f32
//   out), fed from registers that unpack the codes in place, so the
//   instruction count per weight byte stays far below the memory rate at
//   decode.
// - A block is 4 warps over one column tile; they split K by whole groups
//   and add their results in warp order through shared memory, so the grid
//   has N/8 (decode) or N/32 x M/32 (prefill) blocks and no pass after it.
//   The sum never depends on timing: no atomics.
// - Each lane keeps the next 128 K-rows of its weight words in flight while
//   it works on the current ones.
// - At prefill a warp holds a 32 x 32 output tile, so each weight fragment
//   serves 2 row tiles and each x fragment 4 column tiles; the row blocks of
//   one column tile are neighbours in launch order and meet the weights in L2.
//   It does not use wgmma or TMA: it is not expected to reach the
//   tensor-core bound.
// - K3 adds G*N*bits/8 bytes of zeros to K1's weights and scales (1/128 of
//   the weight bytes at g = 128), and one word load and two field extracts
//   per group and column pair.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, 4-bit:
// K1 on qkv (4096 x 6144) at M = 8 takes 0.019 ms against a 0.0039 ms byte
// bound, at M = 1024 0.38 ms against a 0.052 ms operation bound; K3 0.021 ms
// and 0.54 ms. ptxas gives K3's 32 x 32 tile 182 registers to K1's 168, so
// 2 blocks fit an SM where K1 has 3: the likely cause of K3's 40-66% over K1
// at M = 1024, the first target of a later performance change.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"

namespace gqt {

template <int BITS, class Z, bool FOLD = false>
void dispatch_qmatmul(const void* x, int M, int K, const void* qw, const void* sc, int N,
                      int g, Z zero, void* out, cudaStream_t stream) {
  const auto kernel_of = [](auto tile) {
    using T = decltype(tile);
    return qmatmul_kernel<BITS, T::MT, T::NT, Z, FOLD>;
  };
  launch_by_m(kernel_of, x, M, K, qw, sc, N, g, zero, out, stream);
}

template <int BITS>
void dispatch_asym(const void* x, int M, int K, const void* qw, const void* sc,
                   const void* qz, int N, int g, void* out, cudaStream_t stream) {
  const GroupZeros<BITS> zero{static_cast<const uint32_t*>(qz), N * BITS / 32};
  dispatch_qmatmul<BITS, GroupZeros<BITS>>(x, M, K, qw, sc, N, g, zero, out, stream);
}

}  // namespace gqt

// The entry points return 0, -1 for unsupported bits, or the CUDA error of
// the launch. The caller checks the contract: bf16 x [M, K] (16-byte aligned
// rows), int32 qweight [K*bits/32, N], fp16 scales [K/g, N], g % 128 == 0,
// K % g == 0, N % 8 == 0 (K3 also int32 v2 qzeros [K/g, N*bits/32]); and
// allocates out [M, N] bf16. K7 (gqt_qmatmul_fused) takes K1's operands.
extern "C" int gqt_qmatmul(const void* x, int M, int K, const void* qweight,
                           const void* scales, int N, int group_size, float zero_const,
                           int bits, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const gqt::UniformZero z{zero_const};
  switch (bits) {
    case 2: gqt::dispatch_qmatmul<2>(x, M, K, qweight, scales, N, group_size, z, out, s); break;
    case 4: gqt::dispatch_qmatmul<4>(x, M, K, qweight, scales, N, group_size, z, out, s); break;
    case 8: gqt::dispatch_qmatmul<8>(x, M, K, qweight, scales, N, group_size, z, out, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int gqt_qmatmul_asym(const void* x, int M, int K, const void* qweight,
                                const void* scales, const void* qzeros, int N, int group_size,
                                int bits, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: gqt::dispatch_asym<2>(x, M, K, qweight, scales, qzeros, N, group_size, out, s); break;
    case 4: gqt::dispatch_asym<4>(x, M, K, qweight, scales, qzeros, N, group_size, out, s); break;
    case 8: gqt::dispatch_asym<8>(x, M, K, qweight, scales, qzeros, N, group_size, out, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int gqt_qmatmul_fused(const void* x, int M, int K, const void* qweight,
                                 const void* scales, int N, int group_size, float zero_const,
                                 int bits, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Z = gqt::UniformZero;
  const Z z{zero_const};
  const void* w = qweight;
  switch (bits) {
    case 2: gqt::dispatch_qmatmul<2, Z, true>(x, M, K, w, scales, N, group_size, z, out, s); break;
    case 4: gqt::dispatch_qmatmul<4, Z, true>(x, M, K, w, scales, N, group_size, z, out, s); break;
    case 8: gqt::dispatch_qmatmul<8, Z, true>(x, M, K, w, scales, N, group_size, z, out, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
