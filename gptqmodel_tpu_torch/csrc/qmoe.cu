// K10-K13: the MoE kernels over stacked packed experts, symmetric 2/4/8-bit.
//
// Replace the TPU kernels of gptqmodel_tpu/ops/pallas_qmoe.py:
//   K13 _qmoe_kernel           (:224, qmoe_matmul)         gqt_qmoe_matmul
//   K12 _qmoe_mlp_kernel       (:362, qmoe_mlp_matmul)     gqt_qmoe_mlp, n_used == NULL
//   K11 _qmoe_mlp_dyn_kernel   (:534, qmoe_mlp_matmul_dyn) gqt_qmoe_mlp, n_used given
//   K10 _qmoe_mlp_e2e_kernel   (:678, qmoe_mlp_e2e)        gqt_qmoe_e2e
//
// Layout (ops/qmoe.py): routed rows live in slots of at most bm rows, slot s
// owning rows [s*bm, s*bm + count_s) and one expert ids[s]; the used slots
// are a prefix of the static bound S. Weights qw [E, K/PF, N] int32 in the
// interchange layout, scales [E, Gp, N] bf16.
//
// Two contracts:
//   rt: raw codes, per-group partial dots P_g, acc += P_g*s_g - X1_g*zc*s_g
//       (K1's arithmetic, the scales bf16-valued in f32);
//   ic: each weight dequantized to bf16((q - zc)*s) (the product is exact in
//       f32, rounded once), bf16 x bf16 products summed in f32.
// The TPU kernels permute x to the planes' order; here the mma's K index is
// mapped onto the packed fields and x gathered with the same map, so no
// permute is needed and the sums are the same products.
//
// Every pass of the four runs on the decode ring of qmm_decode.cuh (K1's
// producers, ring, consumers and rank-order cluster reduction), one block
// per (slot, 64-column tile, cluster rank), bm = 8 .. 32 rows a slot as
// bm / 8 n-tiles of 8 tokens, the weights the mma's A operand. K10:
//   gate|up (MoeGateUp) -> inner [S*bm, F] = bf16(silu(g)*u): 32 gate columns
//              and their 32 up columns a tile, as K2's GateUpPairs; the
//              producers gather x rows through tok, -1 a zero row;
//   down (MoeDown)    -> ybuf [S*bm, D] f32 = __fmul_rn(y, w[row]): x the
//              slot rows of inner, 64 columns of D a tile;
//   combine           -> out[n] = sum of ybuf over token n's slot rows, from
//              0 in ascending slot (= expert) order in f32, rounded once: the
//              TPU kernel's accumulation order, with no float atomics.
// K11 and K12 (gqt_qmoe_mlp), over slot-sorted rows x [S*bm, D]:
//   gate|up (MoeSlotGateUp) -> inner as K10's, the slot's rows of x read in
//              place (row m of slot s is x[s*bm + m]);
//   down (MoeSlotDown) -> out [S*bm, D] = y in f32 or bf16, rows at or past
//              the slot's count 0; no combine.
// K13 (gqt_qmoe_matmul) is that down pass alone, on any slot-sorted rows
// x [S*bm, K] and any N % 8 == 0 columns (a last 64-column tile may be
// partial): one projection per slot, skipping by count as K12 does.
// A block reads its slot's expert and *n_used on the device and exits at
// once past the used slots, with its whole cluster (one slot), so the
// routing plan never visits the host (K12 and K13, n_used NULL: a slot of
// count 0). The slot passes' down first writes a skipped slot's rows 0
// (rank 0 of its cluster), so the output needs no memset. rt is K1's zero
// type (UniformZero), ic is K6's (DequantFirst<UniformZero>): bf16(bf16(c -
// zc) * s) equals bf16((q - zc) * s) for bf16 scales, as c - zc is exact in
// bf16 and the product exact in f32 before its one rounding. K11-K13
// compute the ic contract. The groups are multiples of 128, so a stage
// holds one bf16 scale row. The launch plans (cluster split over K, grid)
// come from shapes only (ops/qmoe.py, e2e_plan): K10's from the routed rows,
// K, N and the SM count, never bm, so a row's sums do not depend on bm
// either; K11's, K12's and K13's from the slot bound S in place of the rows,
// so that K11 and K12, which differ only in which slots they skip, give
// equal bits, and K13 on K12's inner gives K12's output. Two runs of any of
// them do too.
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode the
// routed experts' packed weights, read once each (K10 at B = 8, top-8 of
// 128: about 51 distinct experts, 120 MB a layer, 0.037 ms); at prefill the
// routed rows' operations. The ring keeps 20 KB or more of weights in flight
// a block; no wgmma, TMA or persistent scheduling. Measured by chip_smoke.py
// on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): K10 0.083 ms a layer at
// B = 8 against its 0.037 ms byte bound, 0.94 ms at the prefill of 1024
// tokens against 0.095 ms; K11 and K12 0.067 ms at N = 8 against 0.034 ms
// and 0.23 ms at N = 128 against 0.095 ms; K13's gate|up and down together
// 0.073-0.075 ms at N = 8 against 0.041 ms and 0.216 ms at N = 128 against
// 0.097 ms (scripts/slot_mlp_cases.py's routing; 0.171 and 0.534 ms on
// the register-tile kernel, qmoe_pass_kernel, that K13 ran before).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"
#include "qmm_decode.cuh"

namespace gqt {

constexpr int kMaxTopk = 16;

__device__ __forceinline__ void store2(void* out, size_t i, int f32, float a, float b) {
  if (f32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(a, b);
  else
    store_bf16x2(static_cast<__nv_bfloat16*>(out) + i, a, b);
}

// K10's combine: out[n, :] = sum over token n's slot rows, ascending, from 0.
// Block (n, j) takes token n's columns j*4*blockDim.x .., every
// 4*blockDim.x*gridDim.y.
__global__ void qmoe_combine_kernel(const float* __restrict__ y, const int* __restrict__ tok_pos,
                                    int topk, int D, int out_f32, void* __restrict__ out) {
  const int n = blockIdx.x;
  int pos[kMaxTopk];
  for (int j = 0; j < topk; ++j) {  // insertion sort: slot order
    const int v = tok_pos[(size_t)n * topk + j];
    int i = j;
    for (; i > 0 && pos[i - 1] > v; --i) pos[i] = pos[i - 1];
    pos[i] = v;
  }
  for (int d = 4 * (blockIdx.y * blockDim.x + threadIdx.x); d < D;
       d += 4 * blockDim.x * gridDim.y) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < topk; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(y + (size_t)pos[j] * D + d);
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    const size_t o = (size_t)n * D + d;
    store2(out, o, out_f32, acc.x, acc.y);
    store2(out, o + 2, out_f32, acc.z, acc.w);
  }
}

// A cluster split that a pass over K rows in groups of g takes.
bool split_ok(int split, int K, int g) {
  return split >= 1 && split <= kDecodeMaxSplit && split <= K / g;
}

}  // namespace gqt

// Each entry point returns 0, -1 for an unsupported configuration or
// cluster split, or the CUDA error of its launches. The caller
// (ops/qmoe.py) checks the contract: bf16 rows of K with 16-byte aligned
// rows, bm a multiple of 8 up to 32, g % 128 == 0 and K % g == 0, N % 8 ==
// 0, int32 plan arrays on the device, 1 <= S <= 65535, 16-byte aligned
// weights and scales (the ring copies them in 16-byte pieces), for K10 also
// D % 128 == 0; and allocates the outputs and scratch.

// K13: out [S*bm, N] (f32 or bf16) = each slot's rows x dequant(qw[ids[s]]),
// rows at or past counts[s] 0, on the ring's MoeSlotDown pass with the
// launch plan's cluster split (ops/qmoe.py, e2e_plan for the slot bound).
// Also -1, before any launch, for a split outside 1 .. min(8, K / g).
extern "C" int gqt_qmoe_matmul(const void* x, const void* ids, const void* counts, int S,
                               int bm, int K, int N, const void* qw, const void* sc, int Gp,
                               int g, float zc, int bits, int split, int out_f32, void* out,
                               void* stream) {
  if (!gqt::split_ok(split, K, g)) return -1;
  gqt::MoeSlotDown<gqt::DequantFirst<gqt::UniformZero>> pass{};
  pass.zc = zc;
  pass.plan = {static_cast<const int*>(ids), nullptr, nullptr, nullptr, Gp};
  pass.rows = {static_cast<const int*>(counts), out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return gqt::launch_moe_pass<2>(x, bm, K, qw, sc, N, g, pass, split, S, out, st);
    case 4: return gqt::launch_moe_pass<4>(x, bm, K, qw, sc, N, g, pass, split, S, out, st);
    case 8: return gqt::launch_moe_pass<8>(x, bm, K, qw, sc, N, g, pass, split, S, out, st);
    default: return -1;
  }
}

namespace gqt {

// K10's zeros of one pass: K1's arithmetic (rt) or each weight dequantized
// before the mma (ic).
template <bool RT>
using E2eZeros = typename std::conditional<RT, UniformZero, DequantFirst<UniformZero>>::type;

// K10's operands: x [N, D] bf16, the passes' plans, weights, groups, zero
// points and cluster splits, and the scratch inner [S*bm, F], ybuf [S*bm, D].
struct E2eArgs {
  const void* x;
  SlotPlan p_gu, p_d;
  int S, bm, D, F;
  const void *qw_gu, *s_gu, *qw_d, *s_d;
  int g_gu, g_d;
  float zc_gu, zc_d;
  int split_gu, split_d;
  void *inner, *ybuf;
  cudaStream_t st;
};

template <int BITS, bool RT_GU, bool RT_D>
int e2e_passes(const E2eArgs& a) {
  MoeGateUp<E2eZeros<RT_GU>> gu{};
  gu.zc = a.zc_gu;
  gu.plan = a.p_gu;
  MoeDown<E2eZeros<RT_D>> dn{};
  dn.zc = a.zc_d;
  dn.plan = a.p_d;
  const int rc = launch_moe_pass<BITS>(a.x, a.bm, a.D, a.qw_gu, a.s_gu, 2 * a.F, a.g_gu, gu,
                                       a.split_gu, a.S, a.inner, a.st);
  if (rc != 0) return rc;
  return launch_moe_pass<BITS>(a.inner, a.bm, a.F, a.qw_d, a.s_d, a.D, a.g_d, dn, a.split_d,
                               a.S, a.ybuf, a.st);
}

template <int BITS>
int e2e_bits(int rt_gu, int rt_d, const E2eArgs& a) {
  if (rt_gu) return rt_d ? e2e_passes<BITS, true, true>(a) : e2e_passes<BITS, true, false>(a);
  return rt_d ? e2e_passes<BITS, false, true>(a) : e2e_passes<BITS, false, false>(a);
}

// K11's and K12's operands: x [S*bm, D] slot-sorted bf16 rows, the passes'
// zeros and plans, weights, cluster splits, inner [S*bm, F] scratch and out.
struct SlotMlpArgs {
  const void* x;
  MoeSlotGateUp<DequantFirst<UniformZero>> gu;
  MoeSlotDown<DequantFirst<UniformZero>> dn;
  int S, bm, D, F, g;
  const void *qw_gu, *s_gu, *qw_d, *s_d;
  int split_gu, split_d;
  void *inner, *out;
  cudaStream_t st;
};

template <int BITS>
int slot_mlp_passes(const SlotMlpArgs& a) {
  const int rc = launch_moe_pass<BITS>(a.x, a.bm, a.D, a.qw_gu, a.s_gu, 2 * a.F, a.g, a.gu,
                                       a.split_gu, a.S, a.inner, a.st);
  if (rc != 0) return rc;
  return launch_moe_pass<BITS>(a.inner, a.bm, a.F, a.qw_d, a.s_d, a.D, a.g, a.dn, a.split_d,
                               a.S, a.out, a.st);
}

}  // namespace gqt

// K11 (n_used given) and K12 (n_used NULL): the expert MLP per slot in the
// ic contract, inner [S*bm, F] bf16 scratch, out [S*bm, D] (f32 or bf16),
// both passes on the decode ring with the launch plan's cluster splits
// (ops/qmoe.py, slot_mlp_plan). Also -1, before any launch, for a split
// outside 1 .. min(8, K / g) of either pass.
extern "C" int gqt_qmoe_mlp(const void* x, const void* ids, const void* counts,
                            const void* n_used, int S, int bm, int D, int F, const void* qw_gu,
                            const void* s_gu, int Gp_gu, const void* qw_d, const void* s_d,
                            int Gp_d, int g, float zc_gu, float zc_d, int bits, int split_gu,
                            int split_d, int out_f32, void* inner, void* out, void* stream) {
  if (!gqt::split_ok(split_gu, D, g) || !gqt::split_ok(split_d, F, g)) return -1;
  gqt::SlotMlpArgs a{x, {}, {}, S, bm, D, F, g, qw_gu, s_gu, qw_d, s_d, split_gu, split_d,
                     inner, out, static_cast<cudaStream_t>(stream)};
  const int* idp = static_cast<const int*>(ids);
  const int* up = static_cast<const int*>(n_used);
  const gqt::SlotRows rows{static_cast<const int*>(counts), out_f32};
  a.gu.zc = zc_gu;
  a.gu.plan = {idp, up, nullptr, nullptr, Gp_gu};
  a.gu.rows = rows;
  a.dn.zc = zc_d;
  a.dn.plan = {idp, up, nullptr, nullptr, Gp_d};
  a.dn.rows = rows;
  switch (bits) {
    case 2: return gqt::slot_mlp_passes<2>(a);
    case 4: return gqt::slot_mlp_passes<4>(a);
    case 8: return gqt::slot_mlp_passes<8>(a);
    default: return -1;
  }
}

// K10: out [N, D] (f32 or bf16) = per token, the sum in slot order of
// w * expert_mlp(x[token]) over its slot rows; inner [S*bm, F] bf16 and
// ybuf [S*bm, D] f32 are scratch. tok/w [S*bm] per slot row, tok_pos [N, topk].
// Both passes run the decode ring with the launch plan's cluster splits
// (ops/qmoe.py, e2e_plan), then the combine. Also -1, before any launch,
// for a split outside 1 .. min(8, K / g) of either pass.
extern "C" int gqt_qmoe_e2e(const void* x, const void* ids, const void* n_used,
                            const void* tok, const void* w, const void* tok_pos, int S, int bm,
                            int N, int topk, int D, int F, const void* qw_gu, const void* s_gu,
                            int Gp_gu, const void* qw_d, const void* s_d, int Gp_d, int g_gu,
                            int g_d, float zc_gu, float zc_d, int rt_gu, int rt_d, int bits,
                            int split_gu, int split_d, int out_f32, void* inner, void* ybuf,
                            void* out, void* stream) {
  // both splits before either pass launches
  if (topk < 1 || topk > gqt::kMaxTopk || D % 128 || !gqt::split_ok(split_gu, D, g_gu) ||
      !gqt::split_ok(split_d, F, g_d))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* idp = static_cast<const int*>(ids);
  const int* up = static_cast<const int*>(n_used);
  const gqt::E2eArgs a{x, {idp, up, static_cast<const int*>(tok), nullptr, Gp_gu},
                       {idp, up, nullptr, static_cast<const float*>(w), Gp_d},
                       S, bm, D, F, qw_gu, s_gu, qw_d, s_d, g_gu, g_d, zc_gu, zc_d,
                       split_gu, split_d, inner, ybuf, st};
  int rc;
  switch (bits) {
    case 2: rc = gqt::e2e_bits<2>(rt_gu, rt_d, a); break;
    case 4: rc = gqt::e2e_bits<4>(rt_gu, rt_d, a); break;
    case 8: rc = gqt::e2e_bits<8>(rt_gu, rt_d, a); break;
    default: return -1;
  }
  if (rc != 0) return rc;
  gqt::qmoe_combine_kernel<<<dim3(N, (D + 511) / 512), 128, 0, st>>>(
      static_cast<const float*>(ybuf), static_cast<const int*>(tok_pos), topk, D, out_f32, out);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a K10, K11 or K12 pass's block at bm rows a
// slot (its ring), or -1 for unsupported bits or bm.
extern "C" int gqt_qmoe_smem_bytes(int bits, int bm) {
  if (bm < 8 || bm > gqt::kDecodeMoeMaxM || bm % 8) return -1;
  switch (bits) {
    case 2: return gqt::DecodeShape<2>::smem_bytes(bm);
    case 4: return gqt::DecodeShape<4>::smem_bytes(bm);
    case 8: return gqt::DecodeShape<8>::smem_bytes(bm);
    default: return -1;
  }
}
