// K8 and K9: the GPTQ error-feedback solve, float32 throughout.
//
// K8 (gptq_whole_solve_kernel) replaces the TPU kernel
// gptqmodel_tpu/ops/pallas_gptq.py _mega_kernel (through gptq_whole_solve):
// the whole solve of W [out, in] in one launch. For each block of B = 128
// columns, in order:
//   1. minmax group parameters from the current, trailing-updated weights
//      (degenerate groups become (-1, 1); s = (xmax - xmin) * f32(1/maxq),
//      the product XLA makes of the division by a constant; symmetric zero
//      (maxq+1)/2, asymmetric round(-xmin/s)), or static per-column tables;
//   2. the column loop: q = clip(round(w/s) + z, 0, maxq), dq = s(q - z),
//      err = (w - dq)/Hinv[i,i], L = (w - dq)^2/(2 Hinv[i,i]^2), then
//      W[:, j > i] -= err * Hinv[i, j] inside the block;
//   3. the trailing update W[:, later] -= E @ Hinv[block, later].
// K9 (gptq_block_inner_kernel) replaces _kernel (through gptq_block_inner):
// step 2 alone on one [out, B] block, returning E as well.
//
// What bounds K8 on an H100: the float32 operations of the trailing update,
// out * B^2 * nb * (nb - 1) with nb = in/B (0.10 TFLOP for Llama-3-8B's qkv
// group, 0.83 TFLOP for down), over the 67 TFLOP/s of the non-tensor FP32
// units: no TF32 and no bf16 mma, so the sums keep float32 as the TPU
// kernel's HIGHEST-precision dot does. K9 is bound by its bytes (four
// [out, B] inputs and four outputs).
//
// The invariant. Every element of W receives, in this order:
//   1. for each earlier block a, ascending: w = w - acc_a (__fsub_rn), where
//      acc_a is fmaf over k = 0..127 ascending, starting from 0, of
//      E_a[row, k] * Hinv[a*B + k, col];
//   2. in its own block, for each earlier column i, ascending:
//      w = __fsub_rn(w, __fmul_rn(e_i, Hinv[i, col])).
// and then its column step (half-to-even rintf, IEEE __fdiv_rn, and
// __fmul_rn/__fsub_rn so that nvcc fuses no multiply-add). Any schedule,
// layout or tiling that keeps each element's sequence gives the same bits;
// the plain version differs only in the order of the trailing product's sums
// (torch.matmul's), and no atomics are used, so two runs give equal codes.
//
// Design. A thread block owns 32 rows for the whole solve (the TPU's
// sequential block axis becomes a loop inside the block); the row tile stays
// in device memory, and the Dq output is the working copy of W (block 0
// reads W, every later read and trailing write goes to Dq, whose columns of
// a block are final once that block is solved).
// - Column loop, K8 and K9 alike: the block's [32, 128] tile sits in shared
//   memory transposed (Ws[col][row]), so a lane owns a row and the chain from
//   one column's error to the next column's step stays inside one thread: no
//   shuffle, no divergent branch, all 32 lanes busy. The 128 columns run as
//   4 sub-blocks of 32. Warp 0 takes a sub-block's columns in registers
//   (fully unrolled, the next column updated first, Hinv's row read as
//   broadcast float4s) and writes each column's code, dq, error and w - dq
//   to shared buffers, nothing to device memory; meanwhile warps 1-7 apply
//   the previous sub-block's errors to the sub-blocks after this one. Then
//   all 8 warps turn w - dq into the losses (the loss's division off the
//   chain) and apply the errors to the next sub-block, column by column in
//   ascending i. Deferring an update changes no element's sequence. Q, Dq
//   and L leave in coalesced rows.
// - Trailing update (K8): Hinv streams through a ring of 4 stages of
//   [16 k, 512 columns] (32 KB), filled by TMA tensor copies (two [16, 256]
//   boxes a stage; the diagonal block takes two stages of one [64, 128] box)
//   and completed on mbarriers. Thread 0 refills a stage once all 8 warps
//   have released it: no producer warp, so that 8 warps keep 255 registers
//   a thread (PERF.md: one-row bulk copies were slow to issue, and the warps
//   taking turns at the refills was slower than thread 0 alone).
//   The 8 warps compute a [32, 512] pass of E @ Hinv register-blocked, 8
//   rows x 8 columns a thread: a warp's 8 rows of E are two broadcast
//   float4 loads a k and its Hinv loads 2 x 512 contiguous bytes, against
//   64 FFMA; the pass's W tile is loaded into registers before its k loop
//   and written back after it.
// No wgmma or 3xTF32: they would change the bits.

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gqt {

constexpr int kB = 128;                    // columns per block
constexpr int kRows = 32;                  // rows per thread block, one a lane
constexpr int kSub = 32;                   // columns per sub-block of the column loop
constexpr int kSubs = kB / kSub;
constexpr int kWarps = 8;                  // compute warps
constexpr int kThreads = 32 * kWarps;
constexpr int kWsLd = kRows + 1;           // Ws[col][row]: conflict-free transposes
constexpr int kEsLd = kRows + 4;           // Es[k][row]: float4 rows for the product
constexpr int kPass = 512;                 // trailing columns a pass (a warp: 8 x 256)
constexpr int kBox = 256;                  // a TMA box's columns (its limit), half a pass
constexpr int kKc = 16;                    // k rows a ring stage
constexpr int kStages = 4;
constexpr int kStageFloats = kKc * kPass;  // 32 KB
constexpr int kDiagStages = kB * kB / kStageFloats;
constexpr int kWsFloats = kB * kWsLd, kEsFloats = kB * kEsLd;
constexpr int kTables = 2 * (kB / 16) * kRows;  // scale and zero rows of up to 8 groups
constexpr size_t kSmemWhole =
    (size_t)(kStages * kStageFloats + 3 * kWsFloats + kEsFloats + kTables) * sizeof(float) +
    2 * kStages * sizeof(uint64_t);
constexpr size_t kSmemInner = (size_t)(kB * kB + 3 * kWsFloats + kEsFloats) * sizeof(float);
constexpr size_t kSmemLimit = 232448;  // an H100 block's dynamic shared memory
static_assert(kSmemWhole <= kSmemLimit && kSmemInner <= kSmemLimit, "K8/K9 must fit a block");
static_assert(kB % kKc == 0 && kStageFloats * kDiagStages == kB * kB &&
                  kStages % kDiagStages == 0 && (kB / kKc) % kDiagStages == 0,
              "the diagonal block must take whole, adjacent ring stages");
static_assert((kEsLd * 4) % 16 == 0 && (kStageFloats * 4) % 1024 == 0 && 2 * kBox == kPass &&
                  kPass * kRows == 8 * 8 * 32 * kWarps && kB / kDiagStages <= 256,
              "float4 rows of E, 1024-byte stages of two TMA boxes, boxes of at most 256");

// min / max that keep a NaN, as torch.amin / torch.clamp do
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// the box of map at (column x, row y) to shared dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar) : "memory");
}

// One column of one row up to its error; w becomes dq.
__device__ __forceinline__ void column_step(float& w, float s, float z, float d, float maxq,
                                            float& q, float& diff, float& err) {
  const float v = __fadd_rn(rintf(__fdiv_rn(w, s)), z);
  q = v < 0.f ? 0.f : (v > maxq ? maxq : v);  // NaN passes through
  const float dq = __fmul_rn(s, __fsub_rn(q, z));
  diff = __fsub_rn(w, dq);
  err = __fdiv_rn(diff, d);
  w = dq;
}

__device__ __forceinline__ float column_loss(float diff, float d) {
  return __fdiv_rn(__fmul_rn(__fmul_rn(0.5f, diff), diff), __fmul_rn(d, d));
}

// Where the column loop reads its scales and zeros.
struct ColumnIO {
  const float* S;   // static per-column tables (global), or null
  const float* Z;
  const float* St;  // else the block's group tables in shared memory, [group][row]
  const float* Zt;
  size_t at;        // this lane's row * ld + the block's first column
  bool valid;       // this lane's row exists
};

// The column loop's shared buffers, [B][kWsLd] (Es: [B][kEsLd]), column
// major: a lane's row is a column of banks. Ws holds the block's weights,
// then w - dq, then the losses; Qs and Ds the codes and dq.
struct ColumnBufs {
  float* Ws;
  float* Es;
  float* Qs;
  float* Ds;
};

// The column loop of sub-block s0 .. s0 + 31 on one warp, a lane a row: the
// sub-block's weights and its scales and zeros in registers, then the chain
// (each column's step, then its error into the later columns, the next
// first); code, dq, error and w - dq go to shared memory as they come, none
// to device memory.
template <int STATIC, int GPB>
__device__ __forceinline__ void chain(int s0, const ColumnBufs& sb, const float* Hd, float maxq,
                                      int lane, const ColumnIO& io) {
  float* Ws = sb.Ws;
  constexpr int g = kB / GPB;
  constexpr int kGroups = g >= kSub ? 1 : kSub / g;  // groups a sub-block holds
  float w[kSub];
#pragma unroll
  for (int c = 0; c < kSub; ++c) w[c] = Ws[(s0 + c) * kWsLd + lane];
  float sv[STATIC ? kSub : kGroups], zv[STATIC ? kSub : kGroups];
  if (STATIC) {
    const float4* S4 = reinterpret_cast<const float4*>(io.S + io.at + s0);
    const float4* Z4 = reinterpret_cast<const float4*>(io.Z + io.at + s0);
#pragma unroll
    for (int m = 0; m < kSub / 4; ++m) {
      const float4 a = io.valid ? S4[m] : make_float4(1.f, 1.f, 1.f, 1.f);
      const float4 b = io.valid ? Z4[m] : make_float4(0.f, 0.f, 0.f, 0.f);
      sv[4 * m] = a.x, sv[4 * m + 1] = a.y, sv[4 * m + 2] = a.z, sv[4 * m + 3] = a.w;
      zv[4 * m] = b.x, zv[4 * m + 1] = b.y, zv[4 * m + 2] = b.z, zv[4 * m + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < kGroups; ++t) {
      sv[t] = io.St[((s0 + t * g) / g) * kRows + lane];
      zv[t] = io.Zt[((s0 + t * g) / g) * kRows + lane];
    }
  }
#pragma unroll
  for (int c = 0; c < kSub; ++c) {
    const int i = s0 + c;
    const int t = STATIC ? c : (kGroups == 1 ? 0 : c / g);
    float q, diff, e;
    column_step(w[c], sv[t], zv[t], Hd[i * (kB + 1)], maxq, q, diff, e);
    const float4* h4 = reinterpret_cast<const float4*>(Hd + i * kB + s0);
#pragma unroll
    for (int m = (c + 1) / 4; m < kSub / 4; ++m) {
      const float4 h = h4[m];
      const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * m + u > c) w[4 * m + u] = __fsub_rn(w[4 * m + u], __fmul_rn(e, hv[u]));
    }
    Ws[i * kWsLd + lane] = diff;
    sb.Es[i * kEsLd + lane] = e;
    sb.Qs[i * kWsLd + lane] = q;
    sb.Ds[i * kWsLd + lane] = w[c];
  }
}

// Sub-block s0's 32 errors applied to the block's columns j0 .. j1 - 1, in
// ascending i: quads of columns spread over warps w0, w0 + nw, ...
__device__ __forceinline__ void apply_errors(int s0, int j0, int j1, float* Ws, const float* Es,
                                             const float* Hd, int warp, int w0, int nw,
                                             int lane) {
  for (int j = j0 + 4 * (warp - w0); j < j1; j += 4 * nw) {
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = Ws[(j + t) * kWsLd + lane];
#pragma unroll 8
    for (int c = 0; c < kSub; ++c) {
      const int i = s0 + c;
      const float e = Es[i * kEsLd + lane];
      const float4 h = *reinterpret_cast<const float4*>(Hd + i * kB + j);
      v[0] = __fsub_rn(v[0], __fmul_rn(e, h.x));
      v[1] = __fsub_rn(v[1], __fmul_rn(e, h.y));
      v[2] = __fsub_rn(v[2], __fmul_rn(e, h.z));
      v[3] = __fsub_rn(v[3], __fmul_rn(e, h.w));
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) Ws[(j + t) * kWsLd + lane] = v[t];
  }
}

// The column loop of one block on the compute warps; Ws holds the block's
// current weights, Hd its [B, B] diagonal block of Hinv. For each
// sub-block: warp 0's chain while warps 1-7 apply the sub-block before it to
// the sub-blocks after this one; then all 8 warps turn its w - dq into
// losses and apply it to the next sub-block. A column gets its sub-blocks'
// errors in ascending order all the same. Ends at a barrier: Qs, Ds, Es and
// the losses in Ws are complete.
template <int STATIC, int GPB>
__device__ __forceinline__ void column_phase(const ColumnBufs& sb, const float* Hd, float maxq,
                                             int warp, int lane, const ColumnIO& io) {
  float* Ws = sb.Ws;
  if (STATIC && warp == 0 && io.valid)  // the row's tables into L1 for the chains
    for (int m = 0; m < kB; m += 32) {
      prefetch_l1(io.S + io.at + m);
      prefetch_l1(io.Z + io.at + m);
    }
  for (int b = 0; b < kSubs; ++b) {
    const int s0 = b * kSub;
    if (warp == 0)
      chain<STATIC, GPB>(s0, sb, Hd, maxq, lane, io);
    else if (b > 0)
      apply_errors(s0 - kSub, s0 + kSub, kB, Ws, sb.Es, Hd, warp, 1, kWarps - 1, lane);
    compute_sync();
    for (int c = warp; c < kSub; c += kWarps) {  // losses from w - dq
      const int i = s0 + c;
      Ws[i * kWsLd + lane] = column_loss(Ws[i * kWsLd + lane], Hd[i * (kB + 1)]);
    }
    if (b + 1 < kSubs)
      apply_errors(s0, s0 + kSub, s0 + 2 * kSub, Ws, sb.Es, Hd, warp, 0, kWarps, lane);
    compute_sync();
  }
}

// rows row0 .. row0 + 31 of columns c0 .. c0 + 127 of src (leading dim ld)
// into Ws[col][row], zeros past out_f; compute threads only
__device__ __forceinline__ void load_tile(float* Ws, const float* src, size_t ld, int row0,
                                          int c0, int out_f) {
  for (int e = threadIdx.x; e < kRows * kB; e += kThreads) {
    const int r = e / kB, c = e % kB;
    Ws[c * kWsLd + r] = row0 + r < out_f ? src[(size_t)(row0 + r) * ld + c0 + c] : 0.f;
  }
}

// the transpose of a [B, 32] shared buffer (leading dim sld) to rows of dst
__device__ __forceinline__ void store_tile(float* dst, const float* buf, int sld, size_t ld,
                                           int row0, int c0, int out_f) {
  for (int e = threadIdx.x; e < kRows * kB; e += kThreads) {
    const int r = e / kB, c = e % kB;
    if (row0 + r < out_f) dst[(size_t)(row0 + r) * ld + c0 + c] = buf[c * sld + r];
  }
}

// Group parameters of block b from Ws: warp j < GPB takes group j, a lane a row.
template <int GPB>
__device__ __forceinline__ void group_params(const float* Ws, float* St, float* Zt, float maxq,
                                             int sym, int warp, int lane, int row, int out_f,
                                             int b, float* s_out, float* z_out) {
  constexpr int g = kB / GPB;
  if (warp >= GPB) return;
  float mn = INFINITY, mx = -INFINITY;
#pragma unroll 8
  for (int c = 0; c < g; ++c) {
    const float v = Ws[(warp * g + c) * kWsLd + lane];
    mn = nan_min(mn, v);
    mx = nan_max(mx, v);
  }
  float xmin = nan_min(mn, 0.f), xmax = nan_max(mx, 0.f);
  if (sym) {
    xmax = nan_max(fabsf(xmin), xmax);
    xmin = xmin < 0.f ? -xmax : xmin;
  }
  if (xmin == 0.f && xmax == 0.f) {
    xmin = -1.f;
    xmax = 1.f;
  }
  // XLA's form of (xmax - xmin) / maxq: times the f32 reciprocal
  const float scale = __fmul_rn(__fsub_rn(xmax, xmin), __fdiv_rn(1.f, maxq));
  const float zero = sym ? 0.5f * (maxq + 1.f) : rintf(__fdiv_rn(-xmin, scale));
  St[warp * kRows + lane] = scale;
  Zt[warp * kRows + lane] = zero;
  if (row < out_f) {
    s_out[(size_t)(b * GPB + warp) * out_f + row] = scale;
    z_out[(size_t)(b * GPB + warp) * out_f + row] = zero;
  }
}

// The ring's stage and phase as the consumers advance them.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// The order in which the ring is filled, kStages stages ahead of the
// consumers, with TMA tensor copies of Hinv: for each block, its
// diagonal block (kDiagStages stages, one [64, 128] box each), then each
// pass's [128, <= 512] panel of the block's rows in stages of kKc rows, as
// [kKc, 256] boxes side by side ([2][kKc][256] in the stage; columns past
// in_f read as zeros and are never stored).
struct RingFill {
  const CUtensorMap* diag;  // boxes [64 rows, 128 columns]
  const CUtensorMap* pass;  // boxes [kKc rows, 256 columns]
  int in_f;
  int i1 = 0, d = 0, j0 = -1, kc = 0;  // j0 < 0: the diagonal block's stage d
  __device__ __forceinline__ bool done() const { return i1 >= in_f; }
  __device__ __forceinline__ void issue(float* ring, int slot, uint32_t full) {
    const uint32_t dst = smem_u32(ring + slot * kStageFloats);
    if (j0 < 0) {
      mbar_expect(full, kStageFloats * 4);
      tma_load(dst, diag, i1, i1 + d * (kB / kDiagStages), full);
    } else {
      const int boxes = in_f - j0 > kBox ? 2 : 1;
      mbar_expect(full, boxes * kKc * kBox * 4);
      for (int h = 0; h < boxes; ++h)
        tma_load(dst + h * kKc * kBox * 4, pass, j0 + h * kBox, i1 + kc, full);
    }
    if (j0 < 0) {
      if (++d < kDiagStages) return;
      d = 0;
      j0 = i1 + kB;
    } else if ((kc += kKc) < kB) {
      return;
    } else {
      kc = 0;
      j0 += kPass;
    }
    if (j0 >= in_f) {
      i1 += kB;
      j0 = -1;
    }
  }
};

template <int STATIC, int GPB>
__global__ void __launch_bounds__(kThreads, 1)
    gptq_whole_solve_kernel(const float* W, const __grid_constant__ CUtensorMap tm_diag,
                            const __grid_constant__ CUtensorMap tm_pass,
                            const float* __restrict__ SP, const float* __restrict__ ZP,
                            int out_f, int in_f, float maxq, int sym,
                            float* __restrict__ Qo, float* Dq, float* __restrict__ Lo,
                            float* __restrict__ s_out, float* __restrict__ z_out) {
  extern __shared__ __align__(1024) float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* Ws = ring + kStages * kStageFloats;  // [B][kWsLd], the block's tile transposed
  float* Es = Ws + kWsFloats;                 // [B][kEsLd], its errors transposed
  const ColumnBufs bufs{Ws, Es, Es + kEsFloats, Es + kEsFloats + kWsFloats};
  float* St = bufs.Ds + kWsFloats;            // [GPB][32] scales, then zeros
  float* Zt = St + kTables / 2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(St + kTables);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const size_t ld = (size_t)in_f;
  const int nb = in_f / kB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  RingFill fill{&tm_diag, &tm_pass, in_f};  // thread 0's
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages && !fill.done(); ++s) fill.issue(ring, s, full0 + 8 * s);
  // thread 0, once its warp has released a stage: wait for the other warps,
  // refill it
  auto refill = [&](int slot, uint32_t phase) {
    if (threadIdx.x != 0 || fill.done()) return;
    mbar_wait(empty0 + 8 * slot, phase);
    fill.issue(ring, slot, full0 + 8 * slot);
  };

  // this thread's place in a trailing pass: rows 8 rg .. 8 rg + 7 (the
  // warp's; E's rows are broadcast loads) and columns colw .. colw + 3 and
  // colw + 128 .. colw + 131 (a warp's H loads are 512 contiguous bytes)
  const int rg = warp % 4, colw = 256 * (warp / 4) + 4 * lane;
  int rows8[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) rows8[r] = row0 + 8 * rg + r;
  RingPos p;
  ColumnIO io{SP, ZP, St, Zt, (size_t)(row0 + lane) * ld, row0 + lane < out_f};

  for (int b = 0; b < nb; ++b) {
    const int i1 = b * kB;
    const float* src = b == 0 ? W : Dq;  // Dq is the working copy after block 0
    io.at = (size_t)(row0 + lane) * ld + i1;
    load_tile(Ws, src, ld, row0, i1, out_f);
    compute_sync();
    if (!STATIC) {
      group_params<GPB>(Ws, St, Zt, maxq, sym, warp, lane, row0 + lane, out_f, b, s_out, z_out);
      compute_sync();
    }
    const float* Hd = ring + p.stage * kStageFloats;
    for (int d = 0; d < kDiagStages; ++d) mbar_wait(full0 + 8 * (p.stage + d), p.phase);
    column_phase<STATIC, GPB>(bufs, Hd, maxq, warp, lane, io);
    if (lane == 0)
      for (int d = 0; d < kDiagStages; ++d) mbar_arrive(empty0 + 8 * (p.stage + d));
    for (int d = 0; d < kDiagStages; ++d) {
      refill(p.stage, p.phase);
      p.next();
    }
    store_tile(Qo, bufs.Qs, kWsLd, ld, row0, i1, out_f);
    store_tile(Dq, bufs.Ds, kWsLd, ld, row0, i1, out_f);
    store_tile(Lo, Ws, kWsLd, ld, row0, i1, out_f);

    // trailing update, one [32, <= 512] pass at a time
    for (int j0 = i1 + kB; j0 < in_f; j0 += kPass) {
      const int cols = min(kPass, in_f - j0);
      const bool active = colw < cols, active2 = colw + 128 < cols;
      float4 wv[8][2];  // the pass's W tile, in flight while the product runs
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4* at =
            reinterpret_cast<const float4*>(src + (size_t)rows8[r] * ld + j0 + colw);
        if (active && rows8[r] < out_f) wv[r][0] = at[0];
        if (active2 && rows8[r] < out_f) wv[r][1] = at[32];
      }
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      for (int kc = 0; kc < kB; kc += kKc) {
        mbar_wait(full0 + 8 * p.stage, p.phase);
        if (active) {
          // this warp's half of the pass: one [kKc, 256] box
          const float* Hst = ring + p.stage * kStageFloats + (warp / 4) * kKc * kBox;
#pragma unroll 4
          for (int kk = 0; kk < kKc; ++kk) {
            const float* er = Es + (kc + kk) * kEsLd + 8 * rg;
            const float4 e0 = *reinterpret_cast<const float4*>(er);
            const float4 e1 = *reinterpret_cast<const float4*>(er + 4);
            const float4 h0 = *reinterpret_cast<const float4*>(Hst + kk * kBox + 4 * lane);
            const float4 h1 = *reinterpret_cast<const float4*>(Hst + kk * kBox + 4 * lane + 128);
            const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
            const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ev[r], hv[c], acc[r][c]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * p.stage);
        refill(p.stage, p.phase);
        p.next();
      }
      if (active) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (rows8[r] >= out_f) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h == 1 && !active2) continue;
            const size_t at = (size_t)rows8[r] * ld + j0 + colw + 128 * h;
            float4 v = wv[r][h];
            v.x = __fsub_rn(v.x, acc[r][4 * h + 0]);
            v.y = __fsub_rn(v.y, acc[r][4 * h + 1]);
            v.z = __fsub_rn(v.z, acc[r][4 * h + 2]);
            v.w = __fsub_rn(v.w, acc[r][4 * h + 3]);
            *reinterpret_cast<float4*>(Dq + at) = v;
          }
        }
      }
    }
    compute_sync();  // the next block's columns are in Dq; the buffers are free
  }
}

// K9: the diagonal block Hbb in shared memory beside the column loop's
// buffers, one block an SM (PERF.md: Hbb read through L1 by two blocks an SM
// was slower).
__global__ void __launch_bounds__(kThreads, 1)
    gptq_block_inner_kernel(const float* __restrict__ Wb, const float* __restrict__ Hbb,
                            const float* __restrict__ S, const float* __restrict__ Z,
                            int out_f, float maxq, float* __restrict__ Qo,
                            float* __restrict__ Dqo, float* __restrict__ Eo,
                            float* __restrict__ Lo) {
  extern __shared__ __align__(1024) float4 smem4[];
  float* Hd = reinterpret_cast<float*>(smem4);  // [B][B]
  float* Ws = Hd + kB * kB;
  const ColumnBufs bufs{Ws, Ws + kWsFloats, Ws + kWsFloats + kEsFloats,
                        Ws + 2 * kWsFloats + kEsFloats};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  for (int t = threadIdx.x; t < kB * kB / 4; t += kThreads)
    reinterpret_cast<float4*>(Hd)[t] = reinterpret_cast<const float4*>(Hbb)[t];
  load_tile(Ws, Wb, kB, row0, 0, out_f);
  compute_sync();
  const ColumnIO io{S, Z, nullptr, nullptr, (size_t)(row0 + lane) * kB, row0 + lane < out_f};
  column_phase<1, 1>(bufs, Hd, maxq, warp, lane, io);
  store_tile(Qo, bufs.Qs, kWsLd, kB, row0, 0, out_f);
  store_tile(Dqo, bufs.Ds, kWsLd, kB, row0, 0, out_f);
  store_tile(Eo, bufs.Es, kEsLd, kB, row0, 0, out_f);
  store_tile(Lo, Ws, kWsLd, kB, row0, 0, out_f);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A TMA map of the float32 matrix H [n, n] (row-major) in boxes of
// [rows, cols]; false if the encoder is missing or refuses the map.
inline bool tensor_map(CUtensorMap* map, const float* H, int n, int rows, int cols) {
  static EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                   &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)rows}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(H), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int STATIC, int GPB>
cudaError_t launch_whole_solve(const float* W, const float* H, const float* SP,
                               const float* ZP, int out_f, int in_f, float maxq, int sym,
                               float* Q, float* Dq, float* L, float* s_out, float* z_out,
                               cudaStream_t stream) {
  auto kern = gptq_whole_solve_kernel<STATIC, GPB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemWhole);
  if (e != cudaSuccess) return e;
  CUtensorMap tm_diag, tm_pass;
  if (!tensor_map(&tm_diag, H, in_f, kB / kDiagStages, kB) ||
      !tensor_map(&tm_pass, H, in_f, kKc, kBox))
    return cudaErrorInvalidValue;
  const dim3 grid((out_f + kRows - 1) / kRows);
  kern<<<grid, kThreads, kSmemWhole, stream>>>(W, tm_diag, tm_pass, SP, ZP, out_f, in_f, maxq,
                                                sym, Q, Dq, L, s_out, z_out);
  return cudaGetLastError();
}

}  // namespace gqt

// Returns 0, -1 for an unsupported configuration, or the CUDA error of the
// launch. The caller checks the contract: contiguous float32 W [out, in] and
// Hinv_u [in, in] (16-byte aligned), in % 128 == 0, static SP/ZP [out, in] or
// groups_per_block in {1, 2, 4, 8}; and allocates Q, Dq, L [out, in] and,
// without static tables, s_out, z_out [in / group_size, out].
extern "C" int gqt_gptq_whole_solve(const void* W, const void* Hinv_u, const void* SP,
                                    const void* ZP, int out_f, int in_f,
                                    int groups_per_block, int is_static, float maxq, int sym,
                                    void* Q, void* Dq, void* L, void* s_out, void* z_out,
                                    void* stream) {
  if (in_f % gqt::kB != 0 || out_f <= 0) return -1;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GQT_SOLVE(ST, G)                                                                  \
  return (int)gqt::launch_whole_solve<ST, G>(f(W), f(Hinv_u), f(SP), f(ZP), out_f, in_f, \
                                             maxq, sym, m(Q), m(Dq), m(L), m(s_out),     \
                                             m(z_out), s)
  if (is_static) GQT_SOLVE(1, 1);
  switch (groups_per_block) {
    case 1: GQT_SOLVE(0, 1);
    case 2: GQT_SOLVE(0, 2);
    case 4: GQT_SOLVE(0, 4);
    case 8: GQT_SOLVE(0, 8);
    default: return -1;
  }
#undef GQT_SOLVE
}

// Returns 0 or the CUDA error of the launch. The caller checks the contract:
// contiguous float32 Wb, S, Z [out, 128] and Hbb [128, 128], 16-byte
// aligned; and allocates Q, Dq, E, L [out, 128].
extern "C" int gqt_gptq_block_inner(const void* Wb, const void* Hbb, const void* S,
                                    const void* Z, int out_f, float maxq, void* Q, void* Dq,
                                    void* E, void* L, void* stream) {
  if (out_f <= 0) return -1;
  cudaError_t e = cudaFuncSetAttribute(gqt::gptq_block_inner_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)gqt::kSmemInner);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((out_f + gqt::kRows - 1) / gqt::kRows);
  gqt::gptq_block_inner_kernel<<<grid, gqt::kThreads, gqt::kSmemInner,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Wb), static_cast<const float*>(Hbb),
      static_cast<const float*>(S), static_cast<const float*>(Z), out_f, maxq,
      static_cast<float*>(Q), static_cast<float*>(Dq), static_cast<float*>(E),
      static_cast<float*>(L));
  return (int)cudaGetLastError();
}
