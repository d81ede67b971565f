// Device code shared by the port's dequant-matmul kernels (qmatmul.cu, qmlp.cu, qmm.cu).
//
// The weights are read in the GPTQ interchange layout, with no repack: the
// int32 word at row r of column n holds the codes of K-rows r*PF .. r*PF+PF-1,
// PF = 32/BITS, field j at bit BITS*j.
//
// A warp computes 16-row by 8-column tiles with the bf16 tensor-core
// instruction mma.sync.m16n8k16 (f32 accumulate). Its B operand is built in
// registers straight from the packed words: lane l loads one word, of column
// n0 + l/4 and word row base + l%4, so four lanes cover four neighbouring
// words of one column and a warp reads 4 rows x 8 columns = four 32-byte
// sectors. A word's PF codes become PF/2 bf16 pairs (field a, field a+PF/2):
// for 2 and 4 bits with the magic OR 0x43004300 (bf16 128+code, exact) and
// one exact bf16 subtraction of 128, for 8 bits with an exact int->float
// conversion. The mma's K index is mapped onto those pairs, and the A operand
// (x) is gathered with the same mapping from one 2*PF-byte load per row, so
// each mma is an exact dot over 16 logical K-rows whatever their order.
//
// Arithmetic, per group g of group_size K-rows (contiguous groups):
//   P_g  = x_g . codes_g          bf16 x bf16 products, f32 sums
//   X1_g = sum(x_g)               f32
//   acc += P_g * s_g - X1_g * (z_g * s_g)     s_g the fp16 scale, exactly in f32
// with z_g one uniform zero point zc (K1, as the TPU kernel
// _qmm_rt_sym_kernel) or the zero point of the group and column read from the
// packed v2 qzeros words (K3, as _qmm_rt_kernel); z_g * s_g is exact in f32
// (z <= 255, s has 11 significant bits). The scales are used as stored
// (fp16), not rounded to bf16 as the TPU kernels do; the plain versions
// (ops/qmatmul.py) compute the same sums in another order.
//
// K7 (FOLD, as _qmm_rt_sym_fused_kernel) folds the scale into the B operand
// instead: each code becomes bf16(c * s_g), c * s_g exact in f32 and rounded
// once, the mma sums x * bf16(c * s_g) straight into acc, and the group's end
// subtracts X1_g * (zc * s_g). The TPU kernel rounds s_g to bf16 before the
// product; the port keeps the fp16 scale, as K1 does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gqt {

constexpr int kWarps = 4;             // warps per block; they split K by groups
constexpr int kThreads = 32 * kWarps;
// K-rows per step: K1's groups are multiples of it, K6's decode groups divide it
constexpr int kChunk = 128;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16 pair (code of field a, code of field a + PF/2) of a packed word.
template <int BITS>
__device__ __forceinline__ uint32_t code_pair(uint32_t w, int a) {
  if constexpr (BITS == 8) {
    const uint32_t lo = (w >> (8 * a)) & 0xFFu, hi = (w >> (8 * a + 16)) & 0xFFu;
    return as_u32(__floats2bfloat162_rn((float)lo, (float)hi));
  } else {
    constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x00010001u;
    uint32_t t = ((w >> (BITS * a)) & kMask) | 0x43004300u;  // bf16(128 + code)
    const __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&t);
    return as_u32(__hsub2(v, __floats2bfloat162_rn(128.f, 128.f)));  // exact
  }
}

// NX 32-bit words of x (2*NX bf16 values) from p, or zeros for a padding row.
template <int NX>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, bool ok,
                                       uint32_t (&v)[NX]) {
  if (!ok) {
#pragma unroll
    for (int i = 0; i < NX; ++i) v[i] = 0u;
    return;
  }
  if constexpr (NX % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NX / 4; ++i) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
      v[4 * i + 0] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
    }
  } else {
    static_assert(NX == 2, "8-bit rows are 8 bytes");
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
}

// The zero points of columns c and c+1 (c even) of group grp: a functor that
// warp_tile calls once per group and column pair.
struct UniformZero {  // K1: one value for every group and column
  float zc;
  __device__ __forceinline__ float2 operator()(int, int) const {
    return make_float2(zc, zc);
  }
  // K6 reads one column's zero in two steps: word() where it loads the
  // weights, one() where it uses them
  __device__ __forceinline__ uint32_t word(int, int) const { return 0u; }
  __device__ __forceinline__ float one(uint32_t, int) const { return zc; }
};

// K3: the module's v2 qzeros words as stored, [G, N*BITS/32] int32; column
// c's zero is field c % PF of word c / PF, so c and c+1 (c even, PF >= 4)
// share one word.
template <int BITS>
struct GroupZeros {
  static constexpr int PF = 32 / BITS;
  static constexpr uint32_t kMask = (1u << BITS) - 1u;
  const uint32_t* qz;
  int words;  // words per group: N*BITS/32
  __device__ __forceinline__ uint32_t word(int grp, int c) const {
    return __ldg(qz + (size_t)grp * words + c / PF);
  }
  __device__ __forceinline__ float one(uint32_t w, int c) const {
    return (float)((w >> (BITS * (c % PF))) & kMask);
  }
  __device__ __forceinline__ float2 operator()(int grp, int c) const {
    const uint32_t w = __ldg(qz + (size_t)grp * words + c / PF);
    const int sh = BITS * (c % PF);
    return make_float2((float)((w >> sh) & kMask), (float)((w >> (sh + BITS)) & kMask));
  }
};

// K7's B pair: bf16(c * s) for the codes of code_pair(w, a), c * s exact in
// f32 (at most 8 + 11 significant bits) and rounded once.
template <int BITS>
__device__ __forceinline__ uint32_t fold_pair(uint32_t w, int a, float s) {
  const uint32_t c = code_pair<BITS>(w, a);
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&c));
  return as_u32(__floats2bfloat162_rn(f.x * s, f.y * s));
}

// K6's A or B pair (qmm.cu, and qmm_decode.cuh's DequantFirst):
// (bf16((c_a - z) * s), bf16((c_{a+PF/2} - z) * s)) of a packed word; zoff
// is bf16(128 + z) twice for 2 and 4 bits (the codes come out of the magic
// OR as bf16(128 + c)), bf16(z) twice for 8 bits; s is bf16(s) twice.
template <int BITS>
__device__ __forceinline__ uint32_t dq_pair(uint32_t w, int a, __nv_bfloat162 zoff,
                                            __nv_bfloat162 s) {
  uint32_t c;
  if constexpr (BITS == 8) {
    c = code_pair<8>(w, a);
  } else {
    constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x00010001u;
    c = ((w >> (BITS * a)) & kMask) | 0x43004300u;
  }
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&c), zoff);
  return as_u32(__hmul2(d, s));  // d exact; one rounding of d * s
}

__device__ __forceinline__ float pair_sum(uint32_t v) {
  const __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat162float(b.x) + __bfloat162float(b.y);
}

// acc[mt][nt][i] = the warp's f32 product over K-rows [k_begin, k_end), both
// multiples of g (itself a multiple of kChunk), for rows
// m0 + 16*mt + lane/4 (+8 for i >= 2) and columns cols[nt] + 2*(lane%4) + (i&1).
// x is [M, ldx] bf16; qw [K/PF, N] int32; sc [K/g, N] fp16; zero gives the
// zero points (UniformZero or GroupZeros). FOLD: K7's arithmetic (above).
template <int BITS, int MT, int NT, class Z, bool FOLD = false>
__device__ __forceinline__ void warp_tile(
    const __nv_bfloat16* __restrict__ x, int ldx, int M, int m0,
    const uint32_t* __restrict__ qw, const __half* __restrict__ sc, int N,
    const int (&cols)[NT], int g, int k_begin, int k_end, const Z& zero,
    float (&acc)[MT][NT][4]) {
  constexpr int PF = 32 / BITS;
  constexpr int KI = 4 * PF;       // K-rows per iteration: 4 words of a column
  constexpr int IT = kChunk / KI;  // iterations per chunk
  constexpr int NX = PF / 2;       // x words per row per lane per iteration
  constexpr int NS = PF / 4;       // mma steps per iteration
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

  uint32_t w[IT][NT], wn[IT][NT];
  auto load_w = [&](int k0, uint32_t (&dst)[IT][NT]) {
#pragma unroll
    for (int it = 0; it < IT; ++it)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        dst[it][nt] = __ldg(qw + (size_t)(k0 / PF + it * 4 + t) * N + cols[nt] + gid);
  };
  load_w(k_begin, w);

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    if (k0 + kChunk < k_end) load_w(k0 + kChunk, wn);  // in flight during the math
    float sb[NT];  // FOLD: the scale of this lane's B column; a chunk is in one group
    if constexpr (FOLD) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        sb[nt] = __half2float(sc[(size_t)(k0 / g) * N + cols[nt] + gid]);
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int kx = k0 + it * KI + t * PF;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int ra = m0 + 16 * mt + gid, rb = ra + 8;
        uint32_t xa[NX], xb[NX];
        load_x<NX>(x + (size_t)ra * ldx + kx, ra < M, xa);
        load_x<NX>(x + (size_t)rb * ldx + kx, rb < M, xb);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          x1[mt][0] += pair_sum(xa[i]);
          x1[mt][1] += pair_sum(xb[i]);
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const uint32_t a[4] = {
              __byte_perm(xa[s], xa[s + NS], 0x5410), __byte_perm(xb[s], xb[s + NS], 0x5410),
              __byte_perm(xa[s], xa[s + NS], 0x7632), __byte_perm(xb[s], xb[s + NS], 0x7632)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if constexpr (FOLD)
              mma_bf16(acc[mt][nt], a, fold_pair<BITS>(w[it][nt], 2 * s, sb[nt]),
                       fold_pair<BITS>(w[it][nt], 2 * s + 1, sb[nt]));
            else
              mma_bf16(p[mt][nt], a, code_pair<BITS>(w[it][nt], 2 * s),
                       code_pair<BITS>(w[it][nt], 2 * s + 1));
          }
        }
      }
    }
    if ((k0 + kChunk) % g == 0) {  // the group ends with this chunk
      const int grp = (k0 + kChunk) / g - 1;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the quad's lanes hold disjoint K-rows
          x1[mt][h] += __shfl_xor_sync(0xffffffffu, x1[mt][h], 1);
          x1[mt][h] += __shfl_xor_sync(0xffffffffu, x1[mt][h], 2);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 s = __half22float2(
              *reinterpret_cast<const __half2*>(sc + (size_t)grp * N + cols[nt] + 2 * t));
          const float2 z = zero(grp, cols[nt] + 2 * t);
          const float zs0 = z.x * s.x, zs1 = z.y * s.y;
          if constexpr (FOLD) {  // the products are in acc already
            acc[mt][nt][0] -= x1[mt][0] * zs0;
            acc[mt][nt][1] -= x1[mt][0] * zs1;
            acc[mt][nt][2] -= x1[mt][1] * zs0;
            acc[mt][nt][3] -= x1[mt][1] * zs1;
          } else {
            acc[mt][nt][0] += p[mt][nt][0] * s.x - x1[mt][0] * zs0;
            acc[mt][nt][1] += p[mt][nt][1] * s.y - x1[mt][0] * zs1;
            acc[mt][nt][2] += p[mt][nt][2] * s.x - x1[mt][1] * zs0;
            acc[mt][nt][3] += p[mt][nt][3] * s.y - x1[mt][1] * zs1;
#pragma unroll
            for (int i = 0; i < 4; ++i) p[mt][nt][i] = 0.f;
          }
        }
        x1[mt][0] = x1[mt][1] = 0.f;
      }
    }
#pragma unroll
    for (int it = 0; it < IT; ++it)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) w[it][nt] = wn[it][nt];
  }
}

// Adds the accumulators of warps 1.. into warp 0's, in warp order, through
// shared memory red[(kWarps-1) * MT*NT*4 * 32]. Every thread calls it.
template <int MT, int NT>
__device__ __forceinline__ void block_reduce(float* red, float (&acc)[MT][NT][4]) {
  constexpr int V = MT * NT * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* flat = &acc[0][0][0];
  if (warp > 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) red[((warp - 1) * V + i) * 32 + lane] = flat[i];
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 0; w < kWarps - 1; ++w)
#pragma unroll
      for (int i = 0; i < V; ++i) flat[i] += red[(w * V + i) * 32 + lane];
  }
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// K1's kernel with Z = UniformZero, K3's with Z = GroupZeros, K7's with
// UniformZero and FOLD (qmatmul.cu); the fused MLP's down pass (qmlp.cu)
// launches K1's too.
// A block of kWarps warps owns rows m0 .. m0+16*MT-1 and columns
// blockIdx.y*8*NT .. +8*NT-1; the warps split K by groups.
template <int BITS, int MT, int NT, class Z, bool FOLD = false>
__global__ void __launch_bounds__(kThreads)
    qmatmul_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                   const uint32_t* __restrict__ qw, const __half* __restrict__ sc,
                   int N, int g, Z zero, __nv_bfloat16* __restrict__ out) {
  __shared__ float red[(kWarps - 1) * MT * NT * 4 * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * 16 * MT;  // row tiles vary fastest: they share weights
  int cols[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) cols[nt] = (blockIdx.y * NT + nt) * 8;
  const int G = K / g;
  const int k_begin = (warp * G / kWarps) * g, k_end = ((warp + 1) * G / kWarps) * g;

  float acc[MT][NT][4];
  warp_tile<BITS, MT, NT, Z, FOLD>(x, K, M, m0, qw, sc, N, cols, g, k_begin, k_end, zero,
                                   acc);
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

template <int MT_, int NT_>
struct Tile {
  static constexpr int MT = MT_, NT = NT_;
};

// The tile by M, for qmatmul_kernel (K1, K3, K7), qmm_kernel (K6) and the
// planes kernels (K4, K5): decode (M <= 16) one row tile and 8 columns a
// block, which none of them launches (their decode kernel is
// qmm_decode.cuh; their kernel_of maps this tile to Tile<4, 1>'s kernel);
// up to 64 rows four row tiles; beyond, 32 x 32 tiles when N allows.
// kernel_of(Tile<MT, NT>{}) gives the kernel of that tile; the kernels take
// these operands.
template <class KernelOf, class Z>
void launch_by_m(KernelOf kernel_of, const void* x, int M, int K, const void* qw,
                 const void* sc, int N, int g, Z zero, void* out, cudaStream_t stream) {
  auto launch = [&](auto tile) {
    using T = decltype(tile);
    const dim3 grid((M + 16 * T::MT - 1) / (16 * T::MT), N / (8 * T::NT));
    kernel_of(tile)<<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, static_cast<const uint32_t*>(qw),
        static_cast<const __half*>(sc), N, g, zero, static_cast<__nv_bfloat16*>(out));
  };
  if (M <= 16)
    launch(Tile<1, 1>{});
  else if (M <= 64 || N % 32 != 0)
    launch(Tile<4, 1>{});
  else
    launch(Tile<2, 4>{});
}

}  // namespace gqt
