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
// Design. Rows are independent given Hinv, so a thread block owns a tile of
// 32 rows for the whole solve; the TPU's sequential block axis becomes a loop
// inside the block. The TPU holds the [rt, in] row tile in VMEM; 227 KB of
// shared memory cannot, so the tile stays in device memory and the kernel
// uses the Dq output as its working copy of W (block 0 reads W, every later
// read and every trailing write goes to Dq, whose columns of a block are
// final once that block is solved). Shared memory holds one [B, B] slab of
// Hinv (64 KB: the diagonal block in the column loop, then each [B, 128]
// tile of the trailing product) and the block's errors E transposed.
// - Column loop: each warp owns 4 rows and keeps their 128 columns in
//   registers, 4 per lane (column 32c + lane). For column i the owning lane
//   quantizes its 4 rows, shuffles the 4 errors to the warp, and every lane
//   updates its later columns. No block-wide barrier in the loop.
// - Trailing update: a warp computes its 4 rows x 128 columns of E @ Hinv
//   with plain FMAs (lane: 4 columns), then subtracts from the tile.
// - The column loop rounds as the plain PyTorch version does: half-to-even
//   (rintf), IEEE division, and __fmul_rn/__fsub_rn so that nvcc fuses no
//   multiply-add there; only the trailing product's sums are ordered
//   differently from torch.matmul's. No atomics: two runs give the same codes.
// Simple first: no wgmma, TMA or 3xTF32, and the trailing update streams the
// row tile through device memory once per block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gqt {

constexpr int kB = 128;                    // columns per block
constexpr int kTileRows = 32;              // rows per thread block
constexpr int kSolveWarps = 8;
constexpr int kRowsPerWarp = kTileRows / kSolveWarps;  // 4
constexpr int kSolveThreads = 32 * kSolveWarps;
constexpr int kChunks = kB / 32;           // columns per lane in a block
constexpr int kEtStride = kTileRows + 4;   // float4 rows, no bank conflicts
constexpr size_t kSmemWhole = (size_t)(kB * kB + kB * kEtStride) * sizeof(float);
constexpr size_t kSmemInner = (size_t)kB * kB * sizeof(float);
constexpr unsigned kFull = 0xffffffffu;

// min / max that keep a NaN, as torch.amin / torch.clamp do
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// One column of one row. w becomes dq.
__device__ __forceinline__ void column_step(float& w, float s, float z, float d, float maxq,
                                            float& q, float& loss, float& err) {
  const float v = __fadd_rn(rintf(__fdiv_rn(w, s)), z);
  q = v < 0.f ? 0.f : (v > maxq ? maxq : v);  // NaN passes through
  const float dq = __fmul_rn(s, __fsub_rn(q, z));
  const float diff = __fsub_rn(w, dq);
  err = __fdiv_rn(diff, d);
  loss = __fdiv_rn(__fmul_rn(__fmul_rn(0.5f, diff), diff), __fmul_rn(d, d));
  w = dq;
}

// The column loop of one block on a warp's 4 rows; Hs is the block's
// [B, B] diagonal block of Hinv in shared memory.
__device__ __forceinline__ void column_loop(float (&w)[kRowsPerWarp][kChunks],
                                            const float (&s)[kRowsPerWarp][kChunks],
                                            const float (&z)[kRowsPerWarp][kChunks],
                                            const float* Hs, float maxq, int lane,
                                            float (&qv)[kRowsPerWarp][kChunks],
                                            float (&lv)[kRowsPerWarp][kChunks],
                                            float (&ev)[kRowsPerWarp][kChunks]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll 1
    for (int l0 = 0; l0 < 32; ++l0) {
      const int i = 32 * c + l0;
      const float d = Hs[i * kB + i];
      float e[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
      if (lane == l0) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          column_step(w[r][c], s[r][c], z[r][c], d, maxq, qv[r][c], lv[r][c], e[r]);
          ev[r][c] = e[r];
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) e[r] = __shfl_sync(kFull, e[r], l0);
#pragma unroll
      for (int cc = c; cc < kChunks; ++cc) {
        const int j = lane + 32 * cc;
        if (j > i) {
          const float h = Hs[i * kB + j];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            w[r][cc] = __fsub_rn(w[r][cc], __fmul_rn(e[r], h));
        }
      }
    }
  }
}

// [B, B] slab of a row-major matrix with leading dimension ld -> Hs.
__device__ __forceinline__ void load_slab(float* Hs, const float* src, size_t ld) {
  for (int t = threadIdx.x; t < kB * kB / 4; t += kSolveThreads) {
    const int k = t / (kB / 4), c4 = t % (kB / 4);
    reinterpret_cast<float4*>(Hs)[t] =
        *reinterpret_cast<const float4*>(src + (size_t)k * ld + 4 * c4);
  }
}

template <int STATIC, int GPB>
__global__ void __launch_bounds__(kSolveThreads)
    gptq_whole_solve_kernel(const float* W, const float* __restrict__ H,
                            const float* __restrict__ SP, const float* __restrict__ ZP,
                            int out_f, int in_f, float maxq, int sym,
                            float* __restrict__ Qo, float* Dq, float* __restrict__ Lo,
                            float* __restrict__ s_out, float* __restrict__ z_out) {
  extern __shared__ float4 smem4[];
  float* Hs = reinterpret_cast<float*>(smem4);  // [B][B]
  float* Et = Hs + kB * kB;                     // [B][kEtStride], E transposed
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTileRows + warp * kRowsPerWarp;
  const size_t ld = (size_t)in_f;
  const int nb = in_f / kB;
  constexpr int g = kB / GPB;

  for (int b = 0; b < nb; ++b) {
    const int i1 = b * kB;
    const float* src = b == 0 ? W : Dq;  // Dq is the working copy after block 0
    __syncthreads();  // the previous block's trailing update is done and visible
    load_slab(Hs, H + (size_t)i1 * ld + i1, ld);

    float w[kRowsPerWarp][kChunks], s[kRowsPerWarp][kChunks], z[kRowsPerWarp][kChunks];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      const bool valid = row < out_f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const size_t at = (size_t)row * ld + i1 + lane + 32 * c;
        w[r][c] = valid ? src[at] : 0.f;
        if (STATIC) {
          s[r][c] = valid ? SP[at] : 1.f;
          z[r][c] = valid ? ZP[at] : 0.f;
        }
      }
      if (!STATIC) {
#pragma unroll
        for (int j = 0; j < GPB; ++j) {
          float mn = INFINITY, mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < kChunks; ++c)
            if ((lane + 32 * c) / g == j) {
              mn = nan_min(mn, w[r][c]);
              mx = nan_max(mx, w[r][c]);
            }
#pragma unroll
          for (int o = 16; o; o >>= 1) {
            mn = nan_min(mn, __shfl_xor_sync(kFull, mn, o));
            mx = nan_max(mx, __shfl_xor_sync(kFull, mx, o));
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
#pragma unroll
          for (int c = 0; c < kChunks; ++c)
            if ((lane + 32 * c) / g == j) {
              s[r][c] = scale;
              z[r][c] = zero;
            }
          if (lane == 0 && valid) {
            s_out[(size_t)(b * GPB + j) * out_f + row] = scale;
            z_out[(size_t)(b * GPB + j) * out_f + row] = zero;
          }
        }
      }
    }
    __syncthreads();  // Hs holds the diagonal block

    float qv[kRowsPerWarp][kChunks], lv[kRowsPerWarp][kChunks], ev[kRowsPerWarp][kChunks];
    column_loop(w, s, z, Hs, maxq, lane, qv, lv, ev);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      if (row < out_f) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const size_t at = (size_t)row * ld + i1 + lane + 32 * c;
          Qo[at] = qv[r][c];
          Dq[at] = w[r][c];
          Lo[at] = lv[r][c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      *reinterpret_cast<float4*>(Et + (lane + 32 * c) * kEtStride + warp * kRowsPerWarp) =
          make_float4(ev[0][c], ev[1][c], ev[2][c], ev[3][c]);

    // trailing update, one [B, 128] tile of Hinv at a time
    for (int j0 = i1 + kB; j0 < in_f; j0 += kB) {
      __syncthreads();  // Et complete; every warp is done with Hs
      load_slab(Hs, H + (size_t)i1 * ld + j0, ld);
      __syncthreads();
      float acc[kRowsPerWarp][4] = {};
#pragma unroll 8
      for (int k = 0; k < kB; ++k) {
        const float4 e4 = *reinterpret_cast<const float4*>(Et + k * kEtStride + warp * kRowsPerWarp);
        const float4 h4 = *reinterpret_cast<const float4*>(Hs + k * kB + 4 * lane);
        const float ek[kRowsPerWarp] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          acc[r][0] = fmaf(ek[r], h4.x, acc[r][0]);
          acc[r][1] = fmaf(ek[r], h4.y, acc[r][1]);
          acc[r][2] = fmaf(ek[r], h4.z, acc[r][2]);
          acc[r][3] = fmaf(ek[r], h4.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = row0 + r;
        if (row < out_f) {
          const size_t at = (size_t)row * ld + j0 + 4 * lane;
          float4 v = *reinterpret_cast<const float4*>(src + at);
          v.x = __fsub_rn(v.x, acc[r][0]);
          v.y = __fsub_rn(v.y, acc[r][1]);
          v.z = __fsub_rn(v.z, acc[r][2]);
          v.w = __fsub_rn(v.w, acc[r][3]);
          *reinterpret_cast<float4*>(Dq + at) = v;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kSolveThreads)
    gptq_block_inner_kernel(const float* __restrict__ Wb, const float* __restrict__ Hbb,
                            const float* __restrict__ S, const float* __restrict__ Z,
                            int out_f, float maxq, float* __restrict__ Qo,
                            float* __restrict__ Dqo, float* __restrict__ Eo,
                            float* __restrict__ Lo) {
  extern __shared__ float4 smem4[];
  float* Hs = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTileRows + warp * kRowsPerWarp;
  load_slab(Hs, Hbb, kB);
  float w[kRowsPerWarp][kChunks], s[kRowsPerWarp][kChunks], z[kRowsPerWarp][kChunks];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const bool valid = row0 + r < out_f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const size_t at = (size_t)(row0 + r) * kB + lane + 32 * c;
      w[r][c] = valid ? Wb[at] : 0.f;
      s[r][c] = valid ? S[at] : 1.f;
      z[r][c] = valid ? Z[at] : 0.f;
    }
  }
  __syncthreads();
  float qv[kRowsPerWarp][kChunks], lv[kRowsPerWarp][kChunks], ev[kRowsPerWarp][kChunks];
  column_loop(w, s, z, Hs, maxq, lane, qv, lv, ev);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (row0 + r >= out_f) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const size_t at = (size_t)(row0 + r) * kB + lane + 32 * c;
      Qo[at] = qv[r][c];
      Dqo[at] = w[r][c];
      Eo[at] = ev[r][c];
      Lo[at] = lv[r][c];
    }
  }
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
  const dim3 grid((out_f + kTileRows - 1) / kTileRows);
  kern<<<grid, kSolveThreads, kSmemWhole, stream>>>(W, H, SP, ZP, out_f, in_f, maxq, sym, Q,
                                                    Dq, L, s_out, z_out);
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
  const dim3 grid((out_f + gqt::kTileRows - 1) / gqt::kTileRows);
  gqt::gptq_block_inner_kernel<<<grid, gqt::kSolveThreads, gqt::kSmemInner,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Wb), static_cast<const float*>(Hbb),
      static_cast<const float*>(S), static_cast<const float*>(Z), out_f, maxq,
      static_cast<float*>(Q), static_cast<float*>(Dq), static_cast<float*>(E),
      static_cast<float*>(L));
  return (int)cudaGetLastError();
}
