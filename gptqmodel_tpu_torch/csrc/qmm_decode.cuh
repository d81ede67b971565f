// The decode kernel of K1, K3, K4, K5, K6 and K7, and of both passes of K2
// (M <= 16 rows): y[M, N] = x[M, K] @ dequant(qweight); and of both passes
// of K10, K11 and K12 (qmoe.cu), a slot of up to 32 routed rows a block.
//
// At decode the packed weights are the whole cost: each is read once and
// used for at most 16 rows, so the card's 3.35 TB/s bounds the kernel and
// every SM has to keep some 25 KB of loads in flight (about 25 bytes/ns
// each over a microsecond of latency), while its warps turn each word into
// tensor-core operands fast enough to keep up. The design answers both:
//
// - A block owns kDecodeCols = 64 columns, 256 contiguous bytes of every
//   4-bit word row, and a share of K in whole groups. The blocks of one
//   column tile form a thread-block cluster along K (at most 8); the launch
//   plan (ops/qmatmul.py, decode_plan) picks the cluster size so that each
//   Llama-3-8B projection launches two to four blocks per SM, about what
//   is resident at once. Rank r takes groups [r*G/S, (r+1)*G/S) (K6's
//   small groups: 128-row chunks, below).
// - The block's weights, the group's fp16 scale row, K3's qzeros words and
//   x's slice arrive through a ring of DecodeShape::STAGES stages in shared
//   memory, one 128-row chunk (inside one group) per stage. Two producer
//   warps fill the ring with 16-byte cp.async copies (4-byte for the zeros,
//   whose rows need not be 16-byte aligned) whose completion arrives on the
//   stage's full mbarrier (cp.async.mbarrier.arrive.noinc), so the four
//   consumer warps spend no instruction on loads from device memory and
//   never wait on one another: a stage is refilled when its empty barrier
//   says all four are done. One producer warp could not issue fast enough,
//   and one 256-byte cp.async.bulk per row was slower still (PERF.md).
//   STAGES - 1 chunks are in flight while the consumers work on one: 20 KB
//   a block at 4 bits, two to five blocks an SM. Scales and zeros are read
//   from the stage, never by a load from device memory on the way to the
//   mma.
// - The weights are the mma's A operand (16 output columns x 16 K-rows) and
//   x is B (8 tokens), so at M <= 8 no mma row is padding; M = 9..16 takes
//   a second n-tile that shares every A fragment. Consumer warp w owns
//   columns 32*(w&1) .. +31 of the tile and every other 4-word-row step of
//   each chunk (w>>1 picks which: kDecodeKParts shares of K). Lane (gid, t)
//   reads one 16-byte word of shared memory: the words of 4 neighbouring
//   columns at word row 4*it + t,
//   which are A rows gid and gid+8 of two m-tiles, and whose PF codes become
//   the pairs of code_pair (qmm_common.cuh) exactly as in K1's tile; x's B
//   fragment is gathered from the same PF K-rows of token gid. x comes from
//   device memory once per block, and the group sums X1 come out of the
//   tensor cores: one mma of x's fragment against an all-ones A tile serves
//   both m-tiles.
// - The shared-memory rows are padded (weights by 8 words, x by
//   DecodeShape::XPAD) so that a warp's loads fall in distinct banks.
// - The K shares of a column half add their partials in a fixed order,
//   then rank 0 adds its peers' float32 partials through distributed shared
//   memory, in rank order, and rounds once to bf16: no atomics, the same
//   bits on every run.
//
// The arithmetic is K1's tile's (qmm_common.cuh): K1 and K3 add, per group
// g, P_g * s_g - X1_g * (z_g * s_g) in float32 (K1's z_g the one zero point
// zc); K7 (FOLD) sums x * bf16(c * s_g) straight into the accumulator and
// subtracts X1_g * (zc * s_g) when the group ends. A warp sees half of each
// group's K-rows, so it applies the correction with the X1 of its own half;
// the halves add up to the group.
//
// K2 (qmlp.cu) launches it twice. Its gate/up pass takes Z = GateUpPairs:
// K1's one zero point over the fused gate_up weight ([D/PF, 2F], gate
// first), a tile's 64 columns being gate columns f0 .. f0 + 31 (half 0) and
// their up columns F + f0 .. F + f0 + 31 (half 1), so that consumer lane
// (gid, t) of half 1 holds the up sums of the columns whose gate sums its
// twin of half 0 holds. Only the producers' column map and the last store
// differ: after the cluster's reduction, rank 0's half 1 hands its float32
// sums to half 0 through shared memory, and half 0 writes
// inner = bf16(silu(g) * u), the TPU kernel's rounding, to [M, F]. The down
// pass is K1's launch on inner.
//
// K6 (qmm.cu) takes Z = DequantFirst<UniformZero> or
// DequantFirst<GroupZeros<BITS>>: groups of g = 8 to 128 rows that divide
// the 128-row chunk, K a multiple of 128. A stage then holds its chunk's
// 128/g rows of the tile's fp16 scales and of its v2 qzeros words (up to
// 2 KB and 1 KB at g = 8), and the cluster splits K in whole chunks: rank r
// takes chunks [r*C/S, (r+1)*C/S), C = K/128. A lane's word row lies inside
// one group (g % PF == 0): it reads that group's 4 scales, rounded to bf16,
// and its 4 zeros from the stage and builds each A pair as
// bf16(bf16(c - z) * bf16(s)) (dq_pair, K6's rounding), which the mma sums
// straight into the accumulator. No X1 mma, no correction when a group
// ends; reduction and store are K1's.
//
// K10 (qmoe.cu) launches it twice per MoE layer with Z = MoeGateUp<ZS> and
// MoeDown<ZS>, ZS = UniformZero (rt: K1's arithmetic) or
// DequantFirst<UniformZero> (ic), over a grid whose y is the S slots of the
// routing plan (SlotPlan). Block row s reads ids[s] and *n_used on the
// device: a slot at or past n_used returns before its first barrier, with
// its whole cluster (which shares s); otherwise its producers offset qw and
// the bf16 scales to expert ids[s] ([E, K/PF, N], [E, Gp, N]), and the
// consumers hold no offset pointer across their loop (the epilogue offsets
// inner by the slot's rows). M = bm = 8 .. 32 rows a slot, bm / 8 n-tiles.
// Gate|up is K2's pass on 32 gate and
// their 32 up columns, x's rows gathered by the producers through tok (a
// row of -1 becomes 16-byte zero copies, cp.async's src-size 0), inner
// written for the slot's rows; down reads the slot's rows of inner and
// writes ybuf = __fmul_rn(y, w[row]) in f32 for qmoe.cu's combine. K10's
// groups are multiples of 128, so a stage holds one scale row as K1's does,
// and the cluster splits K in whole groups; its ic weight
// bf16(bf16(c - zc) * s) is K10's bf16((q - zc) * s), as c - zc is exact in
// bf16 and the product exact in f32 before its one rounding.
//
// K11 and K12 (qmoe.cu, gqt_qmoe_mlp) run the same two passes on the same
// ring with Z = MoeSlotGateUp<DequantFirst<UniformZero>> and
// MoeSlotDown<...> (the ic contract) over slot-sorted rows: both read slot
// s's rows in place (row m is x[s*bm + m], as K10's down reads inner), a
// slot at or past *n_used (K11) or, with n_used NULL, of count 0 (K12)
// leaves with its whole cluster, and down writes y itself to out [S*bm, D]
// in f32 or bf16, rows at or past counts[s] 0. Rank 0 of a skipped slot's
// down cluster first writes its tile's rows 0, so that no row of the output
// is left unwritten. Every difference from K10's passes is a compile-time
// branch on moe_pass<Z>::slot, so K10's instantiations are as before. K13
// (qmoe.cu, gqt_qmoe_matmul) is the MoeSlotDown pass alone, on any rows and
// any N % 8 == 0 (the last 64-column tile may be partial).
//
// K4 and K5 (qmatmul_planes.cu) take Z = Units<PLANAR, UniformZero> or
// Units<PLANAR, PlaneZeros<BITS, PLANAR>>: 3, 5, 6 or 7-bit codes in 32-row
// units of BITS words, stitched (3-bit) or planar, K1's and K3's arithmetic.
// A stage holds 4 units (4*BITS word rows), a depth of DecodeShape::STAGES
// keeps about 20 KB of weights in flight at every width, and x's slice has 4
// words of pad after each unit. Lane t takes unit t of the chunk and, of its
// 32 rows, the 16 of its K share kp: rows 8kp + j and 8kp + 16 + j, j =
// 0..7, which unit_words rearranges so that each pair's two codes lie 16
// bits apart (unit_pair: one shift and one AND-OR a plane, then code_pair's
// bf16 subtraction). K5's zeros are the group's 2 units of BITS qzeros
// words in the stage, a lane's 4 decoded at once by unit_quad when the
// group ends. K4's and K5's one-n-tile instantiations hold 64 registers, so
// that 5 blocks reside an SM (below).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qmm_common.cuh"

namespace gqt {

constexpr int kDecodeMaxM = 16;
constexpr int kDecodeMoeMaxM = 32;  // K10's slot rows: one n-tile per 8
constexpr int kDecodeCols = 64;                   // columns per block
constexpr int kDecodeRowWords = kDecodeCols + 8;  // a word row in shared memory
constexpr int kDecodeMaxSplit = 8;                // blocks per cluster (portable limit)
constexpr int kDecodeMaxSmem = 232448;  // the dynamic shared memory a block may take (H100)
// The warps of a block. scripts/decode_sweep.py builds other counts with -D
// to time them against these.
#ifndef GQT_DECODE_KPARTS
#define GQT_DECODE_KPARTS 2
#endif
#ifndef GQT_DECODE_PRODUCERS
#define GQT_DECODE_PRODUCERS 2
#endif
// consumer warps per 32-column half, each a share of K
constexpr int kDecodeKParts = GQT_DECODE_KPARTS;
constexpr int kDecodeConsumers = 2 * kDecodeKParts;
constexpr int kDecodeProducers = GQT_DECODE_PRODUCERS;  // warps that fill the ring
constexpr int kDecodeThreads = 32 * (kDecodeConsumers + kDecodeProducers);
constexpr int kDecodeBarBytes = 128;  // the ring's mbarriers, ahead of the ring

// Sizes of one stage of the ring (one 128-row chunk) at BITS bits. At 3, 5,
// 6 and 7 bits (UNITS: K4's and K5's widths) a chunk is 4 units of 32 rows,
// each BITS consecutive word rows (stitched or planar, qmatmul_planes.cu).
template <int BITS>
struct DecodeShape {
  static constexpr bool UNITS = 32 % BITS != 0;
  static constexpr int PF = 32 / BITS;
  static constexpr int WR = kChunk * BITS / 32;  // word rows per chunk
  static constexpr int ITS = WR / 4;      // 4-word-row steps per chunk
  // STAGES - 1 chunks in flight: about 20 KB of weights a block at every
  // width (3 bits: 18 KB, so that at M = 8 the ring leaves 5 blocks an SM)
  static constexpr int STAGES =
      BITS == 2 ? 8 : BITS == 3 ? 7 : BITS == 4 ? 6 : BITS == 5 ? 5 : 4;
  // a word row in shared memory: 64 words and a pad, so that the rows a
  // quarter warp reads fall in distinct banks (at 6 bits the 4 units of a
  // chunk start 6 rows apart, so 4 words of pad and not 8)
  static constexpr int ROWW = BITS == 6 ? kDecodeCols + 4 : kDecodeRowWords;
  // x row in words: 64 (128 bf16) + a pad that spreads a warp's loads over
  // the banks; at 3, 5, 6 and 7 bits 4 words after each 32-row unit (XUNIT
  // words a unit), so that the 4 lanes of a quad, one unit each, and the
  // next token's lanes read distinct banks
  static constexpr int XPAD = BITS == 2 ? 4 : BITS == 8 ? 8 : 16;
  static constexpr int XROW = kChunk / 2 + XPAD;
  static constexpr int XUNIT = XROW / 4;
  static constexpr int W_BYTES = WR * ROWW * 4;
  static constexpr int S_BYTES = kDecodeCols * 2;  // the group's fp16 scales
  static constexpr int Z_BYTES = 64;               // the group's qzeros words (K3, K5)
  __host__ __device__ static constexpr int stage_bytes(int M) {
    return W_BYTES + S_BYTES + Z_BYTES + M * XROW * 4;
  }
  __host__ __device__ static constexpr int smem_bytes(int M) {
    return kDecodeBarBytes + STAGES * stage_bytes(M);
  }
  // K6 (DequantFirst): a stage holds the scale row and the qzeros row of
  // each of its chunk's 128/g groups; the smallest group K6 takes holds
  // whole words and 8 rows
  static constexpr int ZROW_BYTES = kDecodeCols * BITS / 8;  // the tile's qzeros of a group
  static constexpr int MIN_GROUP = PF > 8 ? PF : 8;
  // At 4 bits one stage fewer than K1's, so that at M = 8 and g = 32 five
  // blocks reside on an SM where K1's six stages leave four. Other widths
  // keep K1's depth.
  static constexpr int K6_STAGES = BITS == 4 ? 5 : STAGES;
  __host__ __device__ static constexpr int groups_bytes(int g) {
    return (kChunk / g) * (S_BYTES + ZROW_BYTES);
  }
  __host__ __device__ static constexpr int k6_stage_bytes(int M, int g) {
    return W_BYTES + groups_bytes(g) + M * XROW * 4;
  }
  __host__ __device__ static constexpr int k6_smem_bytes(int M, int g) {
    return kDecodeBarBytes + K6_STAGES * k6_stage_bytes(M, g);
  }
  // A block's ring at the most rows (K6's at its smallest group, K10's at
  // 32 rows a slot; K4's and K5's at 16) fits what a block may take; and at
  // the two blocks an SM that the launch plan gives at least, the ring's
  // depth less one chunks of weights in flight (K1's, K4's and K6's) make
  // 24 KB or more an SM. A stage holds K5's zeros: 2 units of BITS words.
  static constexpr bool fits() {
    return smem_bytes(kDecodeMaxM) <= kDecodeMaxSmem &&
           2 * (STAGES - 1) * WR * kDecodeCols * 4 >= 24 * 1024 &&
           (UNITS ? 2 * BITS * 4 <= Z_BYTES && XUNIT == 20
                  : smem_bytes(kDecodeMoeMaxM) <= kDecodeMaxSmem &&
                        k6_smem_bytes(kDecodeMaxM, MIN_GROUP) <= kDecodeMaxSmem &&
                        2 * (K6_STAGES - 1) * WR * kDecodeCols * 4 >= 24 * 1024);
  }
};
static_assert(DecodeShape<2>::fits() && DecodeShape<3>::fits() && DecodeShape<4>::fits() &&
                  DecodeShape<5>::fits() && DecodeShape<6>::fits() && DecodeShape<7>::fits() &&
                  DecodeShape<8>::fits(),
              "the decode ring must fit a block and keep 24 KB an SM in flight");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// bar's pending count drops by one when this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kDecodeConsumers) : "memory");
}

// NX words of x for a token of a stage (zeros for a token past M).
template <int NX>
__device__ __forceinline__ void lds_x(const uint32_t* p, bool ok, uint32_t (&v)[NX]) {
  if (!ok) {
#pragma unroll
    for (int i = 0; i < NX; ++i) v[i] = 0u;
    return;
  }
  if constexpr (NX % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NX / 4; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      v[4 * i + 0] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
    }
  } else {
    static_assert(NX == 2, "8-bit rows are 8 bytes");
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

// K2's gate/up pass: K1's uniform zero point; the kernel reads the weight's
// columns in gate/up pairs and writes bf16(silu(g) * u) (above).
struct GateUpPairs : UniformZero {};

// K6: the zero points of Z (UniformZero or GroupZeros<BITS>) under K6's
// arithmetic, on groups that divide the chunk (above).
template <class Z>
struct DequantFirst : Z {};

// Whether Z is K6's, and the zero points it carries.
template <class Z>
struct dequant_first : std::false_type {
  using zeros = Z;
};
template <class Z>
struct dequant_first<DequantFirst<Z>> : std::true_type {
  using zeros = Z;
};

// K10 (qmoe.cu): the routing plan that a MoE pass reads on the device. Block
// row blockIdx.y is slot s of the plan; its M = bm rows are slot rows
// s*bm .. s*bm + bm - 1 and its weights expert ids[s]'s.
struct SlotPlan {
  const int* ids;     // [S] expert of each slot
  const int* n_used;  // [1] the used slots, a prefix of the S
  const int* tok;     // gate|up: [S*bm] token row of each slot row, -1 a zero row
  const float* w;     // down: [S*bm] routing weight of each slot row
  int Gp;             // scale rows per expert: scales [E, Gp, N]
};
// K10's gate|up pass (the columns paired as GateUpPairs', x rows gathered
// through tok, inner written per slot row) and its down pass (x the slot
// rows of inner, ybuf = y * w written in f32), over the zeros Z:
// UniformZero (rt) or DequantFirst<UniformZero> (ic).
template <class Z>
struct MoeGateUp : Z {
  SlotPlan plan;
};
template <class Z>
struct MoeDown : Z {
  SlotPlan plan;
};

// K11's and K12's passes (above): the plan's ids, n_used (NULL for K12) and
// Gp (tok and w unused), and the slots' row counts; down's output type.
struct SlotRows {
  const int* counts;  // [S] rows of each slot
  int out_f32;        // down: out float32 (1) or bf16 (0)
};
template <class Z>
struct MoeSlotGateUp : Z {
  SlotPlan plan;
  SlotRows rows;
};
template <class Z>
struct MoeSlotDown : Z {
  SlotPlan plan;
  SlotRows rows;
};

// Whether Z is a MoE pass, which one, whether K11's and K12's, and its zeros.
template <class Z>
struct moe_pass : std::false_type {
  using zeros = Z;
  static constexpr bool gate_up = false;
  static constexpr bool slot = false;
};
template <class Z>
struct moe_pass<MoeGateUp<Z>> : std::true_type {
  using zeros = Z;
  static constexpr bool gate_up = true;
  static constexpr bool slot = false;
};
template <class Z>
struct moe_pass<MoeDown<Z>> : std::true_type {
  using zeros = Z;
  static constexpr bool gate_up = false;
  static constexpr bool slot = false;
};
template <class Z>
struct moe_pass<MoeSlotGateUp<Z>> : std::true_type {
  using zeros = Z;
  static constexpr bool gate_up = true;
  static constexpr bool slot = true;
};
template <class Z>
struct moe_pass<MoeSlotDown<Z>> : std::true_type {
  using zeros = Z;
  static constexpr bool gate_up = false;
  static constexpr bool slot = true;
};

// K4 and K5 (qmatmul_planes.cu): the codes in 32-row units of BITS words,
// the stitched 3-bit layout (PLANAR false) or the planar one, over the
// zeros Z: UniformZero (K4) or PlaneZeros<BITS, PLANAR> (K5, whose qzeros
// words the stage holds: 2 units of BITS words a group).
template <bool PLANAR, class Z>
struct Units : Z {};

// Whether Z is K4's or K5's, its layout and its zeros.
template <class Z>
struct units : std::false_type {
  using zeros = Z;
  static constexpr bool planar = false;
};
template <bool PLANAR, class Z>
struct units<Units<PLANAR, Z>> : std::true_type {
  using zeros = Z;
  static constexpr bool planar = PLANAR;
};

// The words unit_pair reads of one column: K4's and K5's lane owns 16 rows
// of a 32-row unit, rows 8h + j and 8h + 16 + j (j = 0..7, h its K share),
// which it takes as 8 pairs (row 8h + j, row 8h + 16 + j). The words hold
// pair j's two codes 16 bits apart, so that one mask and one OR of 0x4300
// make both bf16 at once, as code_pair does. Stitched: 2 words (pairs 0-4
// at bit 3j, 5-7 at 3(j - 5)); planar: 2 for the 4-bit plane (pairs 0-3,
// 4-7 at 4j), 1 for the 2-bit plane, 1 for the 1-bit plane.
template <int BITS, bool PLANAR>
struct UnitShape {
  static constexpr int NW =
      PLANAR ? ((BITS & 4) ? 2 : 0) + ((BITS & 2) ? 1 : 0) + (BITS & 1) : 2;
  static constexpr int I2 = (BITS & 4) ? 2 : 0;     // the 2-bit plane's word
  static constexpr int O2 = (BITS & 4) ? 4 : 0;     // its bit offset in the code
  static constexpr int I1 = I2 + ((BITS & 2) ? 1 : 0);  // the 1-bit plane's
  static constexpr int O1 = O2 + ((BITS & 2) ? 2 : 0);
  static_assert(PLANAR || BITS == 3, "the stitched layout is 3-bit");
};

// m[i] = the UnitShape words of column i of 4 neighbouring columns: u the
// unit's first word row at those columns in shared memory, rw the row
// stride in words, h the lane's K share (0 or 1).
template <int BITS, bool PLANAR>
__device__ __forceinline__ void unit_words(const uint32_t* u, int rw, int h,
                                           uint32_t (&m)[4][UnitShape<BITS, PLANAR>::NW]) {
  using U = UnitShape<BITS, PLANAR>;
  const auto row = [&](int r, uint32_t (&v)[4]) {  // word row r of the 4 columns
    const uint4 q = *reinterpret_cast<const uint4*>(u + r * rw);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  };
  if constexpr (!PLANAR) {  // one 96-bit stream, row r at bit 3r
    uint32_t w0[4], w1[4], w2[4];
    row(0, w0); row(1, w1); row(2, w2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // rows 8h .. 8h + 7 from bit 0 of L, rows 8h + 16 .. 8h + 23 from bit 0 of H
      const uint32_t L = __funnelshift_r(w0[i], w1[i], 24 * h);
      const uint32_t H = __funnelshift_r(h ? w2[i] : w1[i], w2[i], 16 - 8 * h);
      m[i][0] = __byte_perm(L, H, 0x5410);
      m[i][1] = __byte_perm(L >> 15, H >> 15, 0x5410);
    }
  } else {
    uint32_t a[4], b[4];
    if constexpr ((BITS & 4) != 0) {  // words 0-3: rows 8w .. 8w + 7 at 4(r - 8w)
      row(h, a); row(2 + h, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m[i][0] = __byte_perm(a[i], b[i], 0x5410);
        m[i][1] = __byte_perm(a[i], b[i], 0x7632);
      }
    }
    if constexpr ((BITS & 2) != 0) {  // 2 words from O2: rows 16w .. 16w + 15 at 2(r - 16w)
      row(U::O2, a); row(U::O2 + 1, b);
      const uint32_t sel = h ? 0x7632u : 0x5410u;
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i][U::I2] = __byte_perm(a[i], b[i], sel);
    }
    if constexpr ((BITS & 1) != 0) {  // word O1: row r at bit r
      row(U::O1, a);
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i][U::I1] = a[i] >> (8 * h);
    }
  }
}

// v >> s, or v << -s for s < 0 (s a constant once unrolled).
__device__ __forceinline__ uint32_t shift_down(uint32_t v, int s) {
  return s >= 0 ? v >> s : v << -s;
}

// bf16 pair (code of row 8h + j, code of row 8h + 16 + j) from unit_words'
// words of one column, exact (codes <= 127). magic is 0x43004300 (bf16 128
// twice) in a register, so that each plane's mask and OR is one LOP3.
template <int BITS, bool PLANAR>
__device__ __forceinline__ uint32_t unit_pair(const uint32_t (&m)[UnitShape<BITS, PLANAR>::NW],
                                              int j, uint32_t magic) {
  using U = UnitShape<BITS, PLANAR>;
  uint32_t c;
  if constexpr (!PLANAR) {
    c = ((m[j < 5 ? 0 : 1] >> (3 * (j < 5 ? j : j - 5))) & 0x00070007u) | magic;
  } else {
    c = magic;  // bf16(128 + code)
    if constexpr ((BITS & 4) != 0) c |= (m[j >> 2] >> (4 * (j & 3))) & 0x000F000Fu;
    if constexpr ((BITS & 2) != 0)
      c |= shift_down(m[U::I2], 2 * j - U::O2) & (0x00030003u << U::O2);
    if constexpr ((BITS & 1) != 0)
      c |= shift_down(m[U::I1], j - U::O1) & (0x00010001u << U::O1);
  }
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&c);
  return as_u32(__hsub2(v, __floats2bfloat162_rn(128.f, 128.f)));  // exact
}

// The codes of rows r0 .. r0 + 3 (r0 % 4 == 0) of a 32-row unit whose BITS
// words are w[0 .. BITS-1], row r0 + i in byte i: K5's zeros of a lane's 4
// neighbouring columns, each plane's (stitched: the unit's) 4 fields read
// with one shift.
template <int BITS, bool PLANAR>
__device__ __forceinline__ uint32_t unit_quad(const uint32_t* w, int r0) {
  const auto bytes = [](uint32_t v, int width) {  // 4 fields of width bits to 4 bytes
    const uint32_t mask = (1u << width) - 1u;
    return (v & mask) | ((v >> width) & mask) << 8 | ((v >> 2 * width) & mask) << 16 |
           ((v >> 3 * width) & mask) << 24;
  };
  if constexpr (!PLANAR) {  // 12 bits from bit 3 r0 of the 96-bit stream
    const int bit = 3 * r0, i = bit >> 5;
    return bytes(__funnelshift_r(w[i], w[i < 2 ? i + 1 : 2], bit & 31), 3);
  } else {
    uint32_t q = 0;
    int off = 0;
#pragma unroll
    for (int width = 4; width >= 1; width >>= 1) {
      if (BITS & width) {  // 4 width fields from bit width r0 of the plane, in one word
        const int bit = width * r0;
        q |= bytes(w[off + (bit >> 5)] >> (bit & 31), width) << off;
        off += width;
      }
    }
    return q;
  }
}

// The scales' type: fp16 as the modules store them (K1, K2, K3, K6, K7),
// bf16 in K10's expert stacks.
template <class Z>
using decode_scale_t =
    typename std::conditional<moe_pass<Z>::value, __nv_bfloat16, __half>::type;

// A pair of scales, and the pair as float.
template <class SC>
using scale_pair_t =
    typename std::conditional<std::is_same<SC, __half>::value, __half2, __nv_bfloat162>::type;
__device__ __forceinline__ float2 to_float2(__half2 v) { return __half22float2(v); }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) { return __bfloat1622float2(v); }

// 16 bytes from src, or 16 zero bytes where zero is set (cp.async's
// src-size 0): K10's padding rows.
__device__ __forceinline__ void cp_async16_or_zero(uint32_t dst, const void* src, bool zero) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(zero ? 0 : 16)
               : "memory");
}

// K11's and K12's down pass at a skipped slot: rows blockIdx.y*M .. + M - 1
// of out [S*M, N] (f32 or bf16) at the tile's columns c0 .. c0 + 63 written
// 0 by the block's threads, in 16-byte pieces (4 f32 or 8 bf16 columns;
// N % 8 == 0, so a piece is whole or absent).
__device__ __forceinline__ void zero_slot_tile(void* out, int f32, int M, int N, int c0) {
  const int per = f32 ? 4 : 8, pieces = kDecodeCols / per, size = f32 ? 4 : 2;
  for (int i = threadIdx.x; i < M * pieces; i += blockDim.x) {
    const int m = i / pieces, c = c0 + (i % pieces) * per;
    if (c < N) {
      char* p = static_cast<char*>(out) + (((size_t)blockIdx.y * M + m) * N + c) * size;
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Where tile column c lies past the tile's first column: c itself, or for
// K2's gate/up tile (GATE_UP, N = 2F) the up columns' offset past F.
template <bool GATE_UP>
__device__ __forceinline__ int tile_offset(int c, int N) {
  return GATE_UP && c >= kDecodeCols / 2 ? N / 2 + c - kDecodeCols / 2 : c;
}

// Z is GroupZeros<BITS> (K3), UniformZero (K1; K7 with FOLD), Units<...>
// (K4, K5 at 3, 5, 6 and 7 bits), GateUpPairs
// (K2's gate/up pass, out [M, N/2]), DequantFirst<either zeros> (K6),
// MoeGateUp / MoeDown of UniformZero or DequantFirst<UniformZero> (K10's
// passes: M = bm rows of the slot blockIdx.y, scales bf16), or MoeSlotGateUp
// / MoeSlotDown of DequantFirst<UniformZero> (K11's and K12's, down also
// K13's; out of down f32 or bf16 by SlotRows::out_f32); NT n-tiles of 8
// tokens (M <= 8 * NT). Grid: (column tiles) x split blocks, clusters of
// split along x (K10: by S slots along y); dynamic shared memory
// DecodeShape<BITS>::smem_bytes(M) (K6: k6_smem_bytes(M, g)).
//
// K4's and K5's one-n-tile instantiations ask for 5 blocks an SM (at most 64
// registers; 5 to 7 bits would take 68-80 and leave 4): at M <= 8 the plan
// gives Llama-3-8B's qkv projection 576 blocks, one wave of 5 an SM. Every
// other instantiation asks for none (0), as before K4 and K5 ran here.
template <int BITS, int NT, class Z, bool FOLD>
__global__ void __launch_bounds__(kDecodeThreads, units<Z>::value && NT == 1 ? 5 : 0)
    qmm_decode_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                      const uint32_t* __restrict__ qw, const decode_scale_t<Z>* __restrict__ sc,
                      int N, int g, Z zero, __nv_bfloat16* __restrict__ out) {
  using D = DecodeShape<BITS>;
  using SC = decode_scale_t<Z>;
  using SC2 = scale_pair_t<SC>;
  constexpr bool kMoe = moe_pass<Z>::value;
  constexpr bool kSlot = moe_pass<Z>::slot;  // K11's and K12's passes: slot rows in place
  using ZS = typename moe_pass<Z>::zeros;  // the zeros (under K10's slot plan)
  constexpr bool kDequantFirst = dequant_first<ZS>::value;
  // K6's stage holds every group of its chunk; K10's groups are whole chunks
  constexpr bool kChunkGroups = kDequantFirst && !kMoe;
  constexpr int PF = D::PF, ST = kChunkGroups ? D::K6_STAGES : D::STAGES;
  constexpr int NX = PF / 2;  // x words per token per lane per step
  constexpr int NS = PF / 4;  // mma steps per 4-word-row step
  constexpr bool kPerGroupZeros =
      std::is_same<typename dequant_first<ZS>::zeros, GroupZeros<BITS>>::value;
  constexpr bool kGateUp = std::is_same<Z, GateUpPairs>::value || moe_pass<Z>::gate_up;
  static_assert(!(FOLD && (kPerGroupZeros || kGateUp || kDequantFirst || kMoe)),
                "K7 takes K1's operands");
  // K4 and K5: 32-row units of BITS words; K5 reads its zeros from the stage
  constexpr bool kUnits = units<Z>::value, kPlanar = units<Z>::planar;
  constexpr bool kUnitZeros =
      kUnits && !std::is_same<typename units<Z>::zeros, UniformZero>::value;
  static_assert(kUnits == D::UNITS, "3, 5, 6 and 7 bits are K4's and K5's units");
  constexpr int KP = kDecodeKParts < D::ITS ? kDecodeKParts : D::ITS;  // K shares in use
  static_assert(!kUnits || KP == 2, "K4's and K5's lanes take half of each unit");
  extern __shared__ __align__(128) unsigned char smem[];

  // K10: the slot's expert; a slot past the used ones leaves with its whole
  // cluster, which shares the slot
  int expert = 0;
  if constexpr (kSlot) {  // K11: a slot past *n_used; K12 (n_used NULL): of count 0
    expert = zero.plan.ids[blockIdx.y];
    const int* n_used = zero.plan.n_used;
    if (n_used ? (int)blockIdx.y >= *n_used : zero.rows.counts[blockIdx.y] == 0) {
      if constexpr (!kGateUp) {  // down: rank 0 writes the tile's rows 0
        const cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
        if (cl.block_rank() == 0)
          zero_slot_tile(out, zero.rows.out_f32, M, N,
                         (int)(blockIdx.x / cl.num_blocks()) * kDecodeCols);
      }
      return;
    }
  } else if constexpr (kMoe) {
    expert = zero.plan.ids[blockIdx.y];  // both loads in flight at once
    if ((int)blockIdx.y >= *zero.plan.n_used) return;
  }

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  // the tile's first column; K2's gate/up tile pairs 32 gate columns with their up columns
  const int c0 = (blockIdx.x / split) * (kGateUp ? kDecodeCols / 2 : kDecodeCols);
  // the cluster splits K in units of a group, K6's in units of a chunk
  const int unit = kChunkGroups ? kChunk : g;
  const int G = K / unit;
  const int k_begin = (rank * G / split) * unit;
  const int n_chunks = ((rank + 1) * G / split - rank * G / split) * (unit / kChunk);
  const int stage_bytes = kChunkGroups ? D::k6_stage_bytes(M, g) : D::stage_bytes(M);
  // a stage: weights, then the scale and qzeros rows, then x
  const int x_at = kChunkGroups ? D::W_BYTES + D::groups_bytes(g)
                                : D::W_BYTES + D::S_BYTES + D::Z_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t bars = smem_addr(smem);  // full[s] at 8s, empty[s] at 8(ST + s)
  unsigned char* ring = smem + kDecodeBarBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 32 * kDecodeProducers);  // each producer lane's copies
      mbar_init(bars + 8 * (ST + s), 2 * KP);  // the consumer warps that read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kDecodeConsumers) {  // the producers: each lane copies 16-byte pieces
    const int pl = threadIdx.x - 32 * kDecodeConsumers;  // 0 .. 32 * kDecodeProducers - 1
    constexpr int PT = 32 * kDecodeProducers;
    if constexpr (kMoe) {  // K10: the expert's words and scales (down: the slot's rows of inner)
      qw += (size_t)expert * (K / PF) * N;
      sc += (size_t)expert * zero.plan.Gp * N;
      if constexpr (!kGateUp || kSlot) x += (size_t)blockIdx.y * M * K;  // K11, K12: in place
    }
    // the chunk's group and its chunks still to copy (not K6's: whole groups a chunk)
    int grp = k_begin / g, left = g / kChunk;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % ST;
      if (c >= ST) mbar_wait(bars + 8 * (ST + s), ((c / ST) - 1) & 1);
      const uint32_t st = smem_addr(ring + s * stage_bytes);
      const int k0 = k_begin + c * kChunk;
      const int wr0 = kUnits ? k0 / 32 * BITS : k0 / PF;  // the chunk's first word row
      static_assert(D::WR * (kDecodeCols / 4) % PT == 0, "whole rounds of pieces");
#pragma unroll
      for (int i0 = 0; i0 < D::WR * (kDecodeCols / 4); i0 += PT) {  // 4 columns of a word row
        const int r = (i0 + pl) / (kDecodeCols / 4), q = (i0 + pl) % (kDecodeCols / 4);
        const int dq = tile_offset<kGateUp>(4 * q, N);
        if (c0 + dq < N)  // N % 8 == 0: a 4-column piece is whole or absent
          cp_async16(st + 4 * (r * D::ROWW + 4 * q), qw + (size_t)(wr0 + r) * N + c0 + dq);
      }
      if constexpr (kChunkGroups) {  // the chunk's 128/g scale rows, then its qzeros rows
        const int rows = kChunk / g, g0 = k0 / g;
        for (int i = pl; i < rows * (kDecodeCols / 8); i += PT) {  // 8 scales of a row
          const int r = i / (kDecodeCols / 8), q = i % (kDecodeCols / 8);
          if (c0 + 8 * q < N)
            cp_async16(st + D::W_BYTES + r * D::S_BYTES + 16 * q,
                       sc + (size_t)(g0 + r) * N + c0 + 8 * q);
        }
        if constexpr (kPerGroupZeros) {
          constexpr int ZW = kDecodeCols / PF;  // qzeros words of the tile's row
          for (int i = pl; i < rows * ZW; i += PT) {
            const int r = i / ZW, wi = i % ZW;
            if (c0 / PF + wi < N / PF)
              cp_async4(st + D::W_BYTES + rows * D::S_BYTES + r * D::ZROW_BYTES + 4 * wi,
                        zero.qz + (size_t)(g0 + r) * zero.words + c0 / PF + wi);
          }
        }
      } else {
        if (pl < kDecodeCols / 8 && c0 + tile_offset<kGateUp>(8 * pl, N) < N)
          cp_async16(st + D::W_BYTES + 16 * pl,
                     sc + (size_t)grp * N + c0 + tile_offset<kGateUp>(8 * pl, N));
        if constexpr (kUnitZeros) {  // the tile's 2 units of BITS words
          const int wi = pl - kDecodeCols / 8, w0 = c0 / 32 * BITS;
          if (wi >= 0 && wi < 2 * BITS && w0 + wi < zero.words)
            cp_async4(st + D::W_BYTES + D::S_BYTES + 4 * wi,
                      zero.qz + (size_t)grp * zero.words + w0 + wi);
        }
        if constexpr (kPerGroupZeros) {
          const int wi = pl - kDecodeCols / 8;
          if (wi >= 0 && wi < kDecodeCols / PF && c0 / PF + wi < N / PF)
            cp_async4(st + D::W_BYTES + D::S_BYTES + 4 * wi,
                      zero.qz + (size_t)grp * zero.words + c0 / PF + wi);
        }
      }
      for (int i = pl; i < M * (kChunk / 8); i += PT) {  // 8 values of an x row
        const int m = i / (kChunk / 8), q = i % (kChunk / 8);
        if constexpr (kMoe && kGateUp && !kSlot) {  // K10's gate|up: the slot row's token, -1 zeros
          const int r = zero.plan.tok[(size_t)blockIdx.y * M + m];
          cp_async16_or_zero(st + x_at + 4 * (m * D::XROW + 4 * q),
                             x + (size_t)(r < 0 ? 0 : r) * K + k0 + 8 * q, r < 0);
        } else {
          // K4, K5: a 32-row unit (4 pieces) every XUNIT words
          const int xq = kUnits ? q + q / 4 : q;
          cp_async16(st + x_at + 4 * (m * D::XROW + 4 * xq), x + (size_t)m * K + k0 + 8 * q);
        }
      }
      cp_async_arrive(bars + 8 * s);
      if constexpr (!kChunkGroups) {  // K6's stage holds every group of its chunk
        if (--left == 0) {
          ++grp;
          left = g / kChunk;
        }
      }
    }
    return;
  }

  // consumers
  const int t = lane & 3, gid = lane >> 2;
  const int half = warp & 1, kp = warp >> 1;  // kp >= KP: no K share at this width
  const int cw = 32 * half + 4 * gid;  // this lane's 4 columns in the tile: cw .. cw + 3
  constexpr uint32_t kOnes = 0x3F803F80u;  // bf16 (1, 1)
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
  // m-tile j: A row gid is column cw + 2j, A row gid + 8 column cw + 2j + 1
  float acc[2][NT][4], p[2][NT][4], x1[NT][4];
  int left = g / kChunk;  // chunks of the current group still to come
  // K6: log2(g) (g divides 128; K10's g >= 128: group 0 of the stage), and
  // bf16(z + 128) (8 bits: bf16(z)) of a uniform zero
  const int g_shift = __ffs(g) - 1;
  constexpr float kZeroOffset = BITS == 8 ? 0.f : 128.f;
  __nv_bfloat162 zoff_c;
  if constexpr (kDequantFirst) zoff_c = __float2bfloat162_rn(zero.one(0u, 0) + kZeroOffset);
  // K4, K5: bf16 (128, 128) as unit_pair ORs it in, in a register, so that
  // one LOP3 masks a pair and sets it; with both the mask and 0x43004300 as
  // immediates it takes two. A constant would be folded by ptxas even behind
  // inline asm (a mov in the PTX it reads); a kernel argument cannot be, so
  // the high bit of M (M >= 1: 0) is ORed in. chip_smoke.py's build phase
  // fails if the 3-bit loop's LOP3 count grows back.
  const uint32_t magic = 0x43004300u | ((uint32_t)M >> 31);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[0][nt][i] = acc[1][nt][i] = p[0][nt][i] = p[1][nt][i] = x1[nt][i] = 0.f;
    }

#pragma unroll 1
  for (int c = 0; c < (kp < KP ? n_chunks : 0); ++c) {
    const int s = c % ST;
    mbar_wait(bars + 8 * s, (c / ST) & 1);
    const unsigned char* st = ring + s * stage_bytes;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const SC* ss = reinterpret_cast<const SC*>(st + D::W_BYTES);
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(st + x_at);
    float sf[4];  // the scales of this lane's 4 columns; a chunk is in one group
    if constexpr (!kDequantFirst) {
      const uint2 h2 = *reinterpret_cast<const uint2*>(ss + cw);
      const float2 lo = to_float2(*reinterpret_cast<const SC2*>(&h2.x));
      const float2 hi = to_float2(*reinterpret_cast<const SC2*>(&h2.y));
      sf[0] = lo.x; sf[1] = lo.y; sf[2] = hi.x; sf[3] = hi.y;
    }
    if constexpr (kUnits) {
      // lane t: unit t of the chunk, K-rows 32t + 8kp + j and 32t + 8kp + 16 + j
      // (pair j, j = 0..7) of its 4 columns; mma step s2 takes pairs 2s2 (K-slots
      // 2t, 2t+1) and 2s2 + 1 (2t+8, 2t+9), and x's B fragment the same rows
      uint32_t mw[4][UnitShape<BITS, kPlanar>::NW];
      unit_words<BITS, kPlanar>(ws + t * BITS * D::ROWW + cw, D::ROWW, kp, mw);
      uint32_t xa[NT][4], xb[NT][4];  // rows 8kp .. 8kp + 7 and 8kp + 16 .. of unit t
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = 8 * nt + gid;
        const uint32_t* xr = xs + m * D::XROW + t * D::XUNIT + 4 * kp;
        lds_x<4>(xr, m < M, xa[nt]);
        lds_x<4>(xr + 8, m < M, xb[nt]);
      }
#pragma unroll
      for (int s2 = 0; s2 < 4; ++s2) {
        uint32_t b0[NT], b1[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          b0[nt] = __byte_perm(xa[nt][s2], xb[nt][s2], 0x5410);
          b1[nt] = __byte_perm(xa[nt][s2], xb[nt][s2], 0x7632);
          mma_bf16(x1[nt], ones, b0[nt], b1[nt]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t a[4] = {unit_pair<BITS, kPlanar>(mw[2 * j], 2 * s2, magic),
                                 unit_pair<BITS, kPlanar>(mw[2 * j + 1], 2 * s2, magic),
                                 unit_pair<BITS, kPlanar>(mw[2 * j], 2 * s2 + 1, magic),
                                 unit_pair<BITS, kPlanar>(mw[2 * j + 1], 2 * s2 + 1, magic)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(p[j][nt], a, b0[nt], b1[nt]);
        }
      }
    } else {
#pragma unroll
      for (int i2 = 0; i2 < D::ITS / KP; ++i2) {
        // the lane's word row: K-rows wr*PF .. wr*PF + PF - 1
        const int wr = 4 * (KP * i2 + kp) + t;
        const uint4 q4 = *reinterpret_cast<const uint4*>(ws + wr * kDecodeRowWords + cw);
        const uint32_t q[4] = {q4.x, q4.y, q4.z, q4.w};
        __nv_bfloat162 s6[4], z6[4];  // K6: bf16(s) and the zero offset of the 4 columns
        if constexpr (kDequantFirst) {
          const int gi = (wr * PF) >> g_shift;  // the word row's group in the chunk
          const uint2 h2 = *reinterpret_cast<const uint2*>(ss + gi * kDecodeCols + cw);
          const float2 lo = to_float2(*reinterpret_cast<const SC2*>(&h2.x));
          const float2 hi = to_float2(*reinterpret_cast<const SC2*>(&h2.y));
          s6[0] = __float2bfloat162_rn(lo.x); s6[1] = __float2bfloat162_rn(lo.y);
          s6[2] = __float2bfloat162_rn(hi.x); s6[3] = __float2bfloat162_rn(hi.y);
          if constexpr (kPerGroupZeros) {
            const uint32_t zw = reinterpret_cast<const uint32_t*>(
                st + D::W_BYTES + (kChunk >> g_shift) * D::S_BYTES + gi * D::ZROW_BYTES)[cw / PF];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              z6[i] = __float2bfloat162_rn(zero.one(zw, cw + i) + kZeroOffset);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) z6[i] = zoff_c;
          }
        }
        uint32_t xv[NT][NX];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int m = 8 * nt + gid;
          lds_x<NX>(xs + m * D::XROW + wr * NX, m < M, xv[nt]);
        }
#pragma unroll
        for (int s2 = 0; s2 < NS; ++s2) {
          uint32_t b0[NT], b1[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // K-slots 2t, 2t+1 hold fields 2s2, 2s2 + PF/2; 2t+8, 2t+9 fields 2s2+1, +PF/2
            b0[nt] = __byte_perm(xv[nt][s2], xv[nt][s2 + NS], 0x5410);
            b1[nt] = __byte_perm(xv[nt][s2], xv[nt][s2 + NS], 0x7632);
            if constexpr (!kDequantFirst) mma_bf16(x1[nt], ones, b0[nt], b1[nt]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t a[4];
            if constexpr (FOLD) {
              a[0] = fold_pair<BITS>(q[2 * j], 2 * s2, sf[2 * j]);
              a[1] = fold_pair<BITS>(q[2 * j + 1], 2 * s2, sf[2 * j + 1]);
              a[2] = fold_pair<BITS>(q[2 * j], 2 * s2 + 1, sf[2 * j]);
              a[3] = fold_pair<BITS>(q[2 * j + 1], 2 * s2 + 1, sf[2 * j + 1]);
            } else if constexpr (kDequantFirst) {
              a[0] = dq_pair<BITS>(q[2 * j], 2 * s2, z6[2 * j], s6[2 * j]);
              a[1] = dq_pair<BITS>(q[2 * j + 1], 2 * s2, z6[2 * j + 1], s6[2 * j + 1]);
              a[2] = dq_pair<BITS>(q[2 * j], 2 * s2 + 1, z6[2 * j], s6[2 * j]);
              a[3] = dq_pair<BITS>(q[2 * j + 1], 2 * s2 + 1, z6[2 * j + 1], s6[2 * j + 1]);
            } else {
              a[0] = code_pair<BITS>(q[2 * j], 2 * s2);
              a[1] = code_pair<BITS>(q[2 * j + 1], 2 * s2);
              a[2] = code_pair<BITS>(q[2 * j], 2 * s2 + 1);
              a[3] = code_pair<BITS>(q[2 * j + 1], 2 * s2 + 1);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if constexpr (FOLD || kDequantFirst)
                mma_bf16(acc[j][nt], a, b0[nt], b1[nt]);
              else
                mma_bf16(p[j][nt], a, b0[nt], b1[nt]);
            }
          }
        }
      }
    }
    if (!kDequantFirst && --left == 0) {  // the group ends with this chunk
      left = g / kChunk;
      float zs[4];  // z * s of the 4 columns, exact in f32
      if constexpr (kUnitZeros) {  // rows 4 gid .. 4 gid + 3 of the half's unit
        const uint32_t q = unit_quad<BITS, kPlanar>(
            reinterpret_cast<const uint32_t*>(st + D::W_BYTES + D::S_BYTES) + half * BITS,
            4 * gid);
#pragma unroll
        for (int i = 0; i < 4; ++i) zs[i] = (float)((q >> (8 * i)) & 0xFFu) * sf[i];
      } else if constexpr (kPerGroupZeros) {
        const uint32_t zw =
            reinterpret_cast<const uint32_t*>(st + D::W_BYTES + D::S_BYTES)[cw / PF];
#pragma unroll
        for (int i = 0; i < 4; ++i) zs[i] = zero.one(zw, cw + i) * sf[i];
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) zs[i] = zero.zc * sf[i];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // D fragment: [0], [1] column cw + 2j, tokens 8nt + 2t, +1; [2], [3] column + 1
            const int col = 2 * j + (i >> 1);
            if constexpr (FOLD)
              acc[j][nt][i] -= x1[nt][i] * zs[col];
            else
              acc[j][nt][i] += p[j][nt][i] * sf[col] - x1[nt][i] * zs[col];
            p[j][nt][i] = 0.f;
          }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) x1[nt][i] = 0.f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (ST + s));  // this warp is done with the stage
  }

  // the K shares of a column half, then the cluster's ranks, in order
  float* red = reinterpret_cast<float*>(ring);
  const auto slot_of = [&](int share, int hf, int j, int nt, int i) {
    return ((((share * 2 + hf) * 2 + j) * NT + nt) * 4 + i) * 32 + lane;
  };
  const auto slot = [&](int share, int j, int nt, int i) {
    return slot_of(share, half, j, nt, i);
  };
  consumers_sync();  // every consumer is done with the ring: it takes the partials
  if (kp >= 1 && kp < KP) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) red[slot(kp - 1, j, nt, i)] = acc[j][nt][i];
  }
  consumers_sync();
  if (kp == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          for (int share = 0; share < KP - 1; ++share) acc[j][nt][i] += red[slot(share, j, nt, i)];
          if (rank != 0) red[slot(0, j, nt, i)] = acc[j][nt][i];
        }
  }
  if (split > 1) {
    cluster.sync();
    if (rank == 0 && kp == 0) {
      for (int r = 1; r < split; ++r) {
        const float* peer = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][nt][i] += peer[slot(0, j, nt, i)];
      }
    }
    cluster.sync();  // the peers' shared memory lives until rank 0 has read it
  }
  if constexpr (kGateUp) {
    if (rank != 0 || kp != 0) return;
    // half 1 hands its up sums to half 0 in its own K-share slots, which
    // only its lanes have read, each its own
    if (half == 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) red[slot(0, j, nt, i)] = acc[j][nt][i];
    }
    asm volatile("bar.sync 2, 64;\n" ::: "memory");  // the kp == 0 warps of both halves
    if (half == 1) return;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // silu(g) * u in f32, as qmlp.cu's MT = 4 pass
          const float gt = acc[j][nt][i];
          acc[j][nt][i] = gt / (1.f + expf(-gt)) * red[slot_of(0, 1, j, nt, i)];
        }
    N /= 2;  // inner [M, F]: gate column f0 + cw is inner's column
    if constexpr (kMoe) out += (size_t)blockIdx.y * M * N;  // K10: the slot's rows of inner
  } else if (rank != 0 || kp != 0 || c0 + cw >= N) {
    return;
  }
  if constexpr (kSlot && !kGateUp) {  // K11's and K12's down: y, rows at or past the count 0
    const int keep = zero.rows.counts[blockIdx.y];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * nt + 2 * t + h;
        if (m < M) {
          const bool k = m < keep;
          const float v[4] = {k ? acc[0][nt][h] : 0.f, k ? acc[0][nt][2 + h] : 0.f,
                              k ? acc[1][nt][h] : 0.f, k ? acc[1][nt][2 + h] : 0.f};
          const size_t o = ((size_t)blockIdx.y * M + m) * N + c0 + cw;
          if (zero.rows.out_f32) {
            *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
            const __nv_bfloat162 b[2] = {__floats2bfloat162_rn(v[0], v[1]),
                                         __floats2bfloat162_rn(v[2], v[3])};
            *reinterpret_cast<uint2*>(out + o) = *reinterpret_cast<const uint2*>(b);
          }
        }
      }
    return;
  }
  if constexpr (kMoe && !kGateUp) {  // K10's down: ybuf = y * w[row] in f32, per slot row
    float* y = reinterpret_cast<float*>(out);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * nt + 2 * t + h;
        if (m < M) {
          const size_t row = (size_t)blockIdx.y * M + m;
          const float wr = zero.plan.w[row];
          *reinterpret_cast<float4*>(y + row * N + c0 + cw) =
              make_float4(__fmul_rn(acc[0][nt][h], wr), __fmul_rn(acc[0][nt][2 + h], wr),
                          __fmul_rn(acc[1][nt][h], wr), __fmul_rn(acc[1][nt][2 + h], wr));
        }
      }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // tokens 8nt + 2t + h: 4 neighbouring columns
      const int m = 8 * nt + 2 * t + h;
      if (m < M) {
        __nv_bfloat162 v[2] = {__floats2bfloat162_rn(acc[0][nt][h], acc[0][nt][2 + h]),
                               __floats2bfloat162_rn(acc[1][nt][h], acc[1][nt][2 + h])};
        *reinterpret_cast<uint2*>(out + (size_t)m * N + c0 + cw) =
            *reinterpret_cast<const uint2*>(v);
      }
    }
}

// The decode kernel's dynamic shared memory is set once per instantiation,
// to what M = 8 * NT takes (K6: at its smallest group).
template <int BITS, int NT, class Z, bool FOLD>
cudaError_t decode_smem_attribute() {
  using D = DecodeShape<BITS>;
  static const cudaError_t e = cudaFuncSetAttribute(
      qmm_decode_kernel<BITS, NT, Z, FOLD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dequant_first<Z>::value ? D::k6_smem_bytes(8 * NT, D::MIN_GROUP) : D::smem_bytes(8 * NT));
  return e;
}

// Launches kernel (an instantiation of qmm_decode_kernel, its dynamic
// shared memory set by attr) over grid, in clusters of split blocks along x.
template <class Kernel, class Z>
int launch_clusters(Kernel kernel, cudaError_t attr, dim3 grid, int split, int smem,
                    cudaStream_t stream, const void* x, int M, int K, const void* qw,
                    const void* sc, int N, int g, Z zero, void* out) {
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr_[1];
  attr_[0].id = cudaLaunchAttributeClusterDimension;
  attr_[0].val.clusterDim.x = (unsigned)split;
  attr_[0].val.clusterDim.y = 1;
  attr_[0].val.clusterDim.z = 1;
  cfg.attrs = attr_;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x), M, K,
      static_cast<const uint32_t*>(qw), static_cast<const decode_scale_t<Z>*>(sc), N, g, zero,
      static_cast<__nv_bfloat16*>(out));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Launches the decode kernel with the plan's cluster size: ceil(N / 64) column
// tiles, which for GateUpPairs (N = 2F) are F / 32 tiles of 32 pairs. Returns
// 0, -1 when the split is outside 1 .. min(kDecodeMaxSplit, K / g) (K6:
// K / 128, and a group of DecodeShape::MIN_GROUP .. 128 rows that divides
// 128, K a multiple of 128), or the CUDA error.
template <int BITS, class Z, bool FOLD>
int launch_decode(const void* x, int M, int K, const void* qw, const void* sc, int N, int g,
                  Z zero, int split, void* out, cudaStream_t stream) {
  using D = DecodeShape<BITS>;
  constexpr bool kDequantFirst = dequant_first<Z>::value;
  const int unit = kDequantFirst ? kChunk : g;  // the kernel's unit of the cluster's split
  if (kDequantFirst && (g < D::MIN_GROUP || kChunk % g || K % kChunk)) return -1;
  const int smem = kDequantFirst ? D::k6_smem_bytes(M, g) : D::smem_bytes(M);
  if (M < 1 || M > kDecodeMaxM || split < 1 || split > kDecodeMaxSplit || split > K / unit)
    return -1;
  const dim3 grid((unsigned)(((N + kDecodeCols - 1) / kDecodeCols) * split));
  return M <= 8 ? launch_clusters(qmm_decode_kernel<BITS, 1, Z, FOLD>,
                                  decode_smem_attribute<BITS, 1, Z, FOLD>(), grid, split, smem,
                                  stream, x, M, K, qw, sc, N, g, zero, out)
                : launch_clusters(qmm_decode_kernel<BITS, 2, Z, FOLD>,
                                  decode_smem_attribute<BITS, 2, Z, FOLD>(), grid, split, smem,
                                  stream, x, M, K, qw, sc, N, g, zero, out);
}

// K1, K3, K4, K5 and K7: the decode kernel at M <= 16 (split from the launch
// plan), launch_by_m's tiles, from kernel_of, beyond (K4 and K5: on zero,
// Units' zeros). launch_by_m picks Tile<1, 1> only at M <= 16, so the
// callers' kernel_of maps that tile to Tile<4, 1>'s kernel, which it never
// launches, and emits no decode tile of its own.
template <int BITS, class Z, bool FOLD, class KernelOf>
int dispatch_decode_or_tile(KernelOf kernel_of, const void* x, int M, int K, const void* qw,
                            const void* sc, int N, int g, Z zero, int split, void* out,
                            cudaStream_t stream) {
  if (M <= kDecodeMaxM)
    return launch_decode<BITS, Z, FOLD>(x, M, K, qw, sc, N, g, zero, split, out, stream);
  launch_by_m(kernel_of, x, M, K, qw, sc, N, g, zero, out, stream);
  return (int)cudaGetLastError();
}

// Launches one of K10's passes (Z = MoeGateUp<...> or MoeDown<...>), or of
// K11's and K12's (MoeSlotGateUp<...>, MoeSlotDown<...>; K13's), over the
// S slots of the plan, bm = 8 * NT rows a slot: ceil(N / 64) column tiles
// (gate|up: F / 32 tiles of 32 pairs) x split blocks along x, the slots
// along y. Returns 0, -1 for bm outside 8, 16, 24, 32, S outside
// 1 .. 65535 or a split outside 1 .. min(kDecodeMaxSplit, K / g), or the
// CUDA error.
template <int BITS, class Z>
int launch_moe_pass(const void* x, int bm, int K, const void* qw, const void* sc, int N, int g,
                    Z zero, int split, int S, void* out, cudaStream_t stream) {
  static_assert(moe_pass<Z>::value, "the MoE passes take a slot plan");
  using D = DecodeShape<BITS>;
  if (bm < 8 || bm > kDecodeMoeMaxM || bm % 8 || S < 1 || S > 65535 || split < 1 ||
      split > kDecodeMaxSplit || split > K / g)
    return -1;
  const dim3 grid((unsigned)(((N + kDecodeCols - 1) / kDecodeCols) * split), (unsigned)S);
  const int smem = D::smem_bytes(bm);
  const auto launch = [&](auto kernel, cudaError_t attr) {
    return launch_clusters(kernel, attr, grid, split, smem, stream, x, bm, K, qw, sc, N, g,
                           zero, out);
  };
  switch (bm / 8) {
    case 1: return launch(qmm_decode_kernel<BITS, 1, Z, false>,
                          decode_smem_attribute<BITS, 1, Z, false>());
    case 2: return launch(qmm_decode_kernel<BITS, 2, Z, false>,
                          decode_smem_attribute<BITS, 2, Z, false>());
    case 3: return launch(qmm_decode_kernel<BITS, 3, Z, false>,
                          decode_smem_attribute<BITS, 3, Z, false>());
    default: return launch(qmm_decode_kernel<BITS, 4, Z, false>,
                           decode_smem_attribute<BITS, 4, Z, false>());
  }
}

}  // namespace gqt
