// Backward of the masked flash attention, and the distance-weighted sum of
// spatial ALiBi's backward.
//
// Replaces:
//   * stamp_tpu/ops/flash_attention.py:236 `_flash_core_bwd` (pallas_calls
//     :257 and :278, bodies `_flash_bwd_dq_kernel` :143 and
//     `_flash_bwd_dkv_kernel` :178), the backward of `flash_mha`;
//   * stamp_tpu/ops/flash_attention.py:867 `_alibi_core_bwd` (pallas_calls
//     :887 and :908, the same two bodies), the softmax branch of the
//     backward of `flash_alibi_mha`;
//   * stamp_tpu/ops/flash_attention.py:702 `_dist_weighted_sum` (pallas_call
//     :712, body `_dws_kernel` :661), which `_alibi_core_bwd` calls for the
//     bias branch's dV (:936).
//
// The flash backward, per (batch·head) sequence of f32 q [Tq, d], k and v
// [Tk, d], dO and the forward's output O [Tq, d] and its lse [Tq], with
// s = q·kᵀ·scale (−1e30 on masked keys), P = exp(s − lse) and
// D = rowsum(dO∘O):
//   dP = dO·Vᵀ,  dS = P∘(dP − D)·scale,
//   dQ = dS·K,   dV = Pᵀ·dO,  dK = dSᵀ·Q.
// The distance-weighted sum: out_a = Σ_b ‖c_a − c_b‖·val_b over the b that
// the b-mask keeps.
//
// What bounds them on the H100: operations.  At the whole-slide training
// shapes ([8, T, 64], T = 4,097 … 16,385) one product of 2·BH·T²·d is
// 275 GFLOP at T = 16,385; the flash backward needs five per (query, valid
// key) pair and runs seven (s and dP in both of its kernels), at the
// 495 TFLOP/s TF32 rate; the distance-weighted sum one that must stay
// f32-accurate (67 TFLOP/s), against a few hundred MB of inputs, outputs
// and copies (about 0.1 ms at 3.35 TB/s).
//
// The flash backward is four launches on the caller's stream:
//   1. flash_bwd_prepass_kernel, one pass over q, k, v, dO and O, 128 rows
//      a block: TF32-rounded (cvt.rna) copies of q, k, v and dO; the
//      transposed, rounded copies qᵀ, kᵀ, dOᵀ [d, T] (see "K-major" below);
//      D; lse and D padded with +inf and 0; the key mask as f32; and one
//      liveness flag per 32 rows: the rows hold a valid key (key side), or a
//      dO row that is not all zero (query side).  The copies of q and dO are
//      made only for 128 rows with a nonzero dO row: no kernel reads others;
//   2. flash_bwd_lists_kernel: per sequence, the increasing lists of live
//      key tiles and live query tiles;
//   3. flash_bwd_dq_kernel: dQ for 64·kGroups queries a block, looping over
//      the live key tiles;
//   4. flash_bwd_dkv_kernel: dK and dV for 64·kGroups keys a block, looping
//      over the live query tiles, on the transposed scores Sᵀ = k·qᵀ.
// Two reduction kernels and no atomics, as on the TPU: every output
// element is summed by one thread in a fixed order, so the result is
// bitwise repeatable.
//
// Kernels 3 and 4 are warp-specialized (hopper.cuh): one producer thread
// keeps a ring of shared-memory stages filled by TMA, each stage paced by a
// "full" and an "empty" mbarrier; consumer warpgroups of 64 rows run TF32
// wgmma.mma_async (m64nNk8, f32 accumulate).  A warpgroup reads the other
// side's tile from shared memory once per 64 rows.  The block's own rows
// (q and dO for dQ, k and v for dK/dV), the score products' A operands, are
// loaded once into shared memory by TMA: as register fragments they would
// push a consumer past 168 registers, and ptxas then serializes the
// wgmmas.  In kernel 3 the dQ product of one tile runs on while the next
// tile's scores are issued.
//
// K-major.  TF32 wgmma takes both operands K-major (PTX allows the transpose
// bits for 16-bit types only).  The score products contract over d and are
// K-major as stored.  dQ += dS·k, dV += Pᵀ·dO and dK += dSᵀ·q contract over
// the sequence, so their B operands are the transposed copies kᵀ, dOᵀ, qᵀ
// with the sequence contiguous.  Their A operand is dS or Pᵀ straight from
// the score accumulators: a warp's accumulator rows are mma.sync's C layout
// and the TF32 A registers its A layout (tf32_tiles.cuh), so a = (c0, c2,
// c1, c3) chains them when the depth runs in the order (0, 2, 4, 6, 1, 3,
// 5, 7) within each 8; the pre-pass bakes that order into every 8
// consecutive positions of the transposed copies.
//
// Tiles whose contribution is exactly zero are skipped (the lists of 2):
//   * a key tile with no valid key: there s = −1e30, and with the finite lse
//     of a sequence that has a valid key P = exp(−1e30 − lse) = 0, so dS = 0.
//     A sequence with no valid key keeps every tile (lse ≈ −1e30, P = 1, as
//     in the plain version);
//   * a query tile whose dO rows are all zero: dP = 0 and D = 0, so dS = 0
//     and Pᵀ·dO = 0.  The MIL model reads only the CLS row, so in its last
//     layer every row but row 0 has a zero dO, and in its first layer every
//     padded row does.
// A dQ block whose queries all have a zero dO, and a dK/dV block whose keys
// are all masked (in a sequence with a valid key) or that meets no live
// query tile, store zeros and exit; a warpgroup of a live block whose 64
// rows are such only passes the ring's stages on.  The result equals the
// full loop's up to the sign of zeros.
//
// Arithmetic: the products in TF32 with both operands rounded by cvt.rna,
// f32 accumulation, as the Pallas bodies run them at default precision;
// scale, mask, exp and the dS formula are f32 in the Pallas bodies' order,
// exp(x) taken as exp2f(x·log2 e).
// A masked key has P = 0 exactly, so exactly zero dK and dV.  Rows past T
// are zero (TMA's fill and the pre-pass's padding), queries past Tq have
// lse = +inf.  Head widths d ∈ {32, 64, 128}.
//
// The distance-weighted sum (kernel 5, launched alone): 64 rows a per
// block, looping over 64-column tiles of b, four warps of 16 rows; the
// Pallas kernel runs it at Precision.HIGHEST, so it reuses the forward's
// 3×TF32 D·V (per-tile sums added in rounded f32).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "tf32_tiles.cuh"

namespace {

using namespace sm90;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2^(x·log2 e)

// ---- TF32 wgmma: m64nNk8, D (f32) += A·B --------------------------------------
// Accumulator (per warp w of the warpgroup, g = lane / 4, t = lane % 4):
// d[4j + 2h + e] is row 16w + g + 8h, column 8j + 2t + e.  A in registers
// (rs): warp w holds rows 16w..16w+15 as mma.sync m16n8k8's TF32 A
// fragment, a = (A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]).  A in shared
// memory (ss) and B: descriptors of K-major 128-byte-swizzled boxes.  With
// scale_d = 0 the accumulator's old value is ignored.

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---- tiling -----------------------------------------------------------------

constexpr int kUnit = 32;       // rows per liveness flag
constexpr int kPad = 128;       // padding of the transposed copies and the vectors
constexpr int kPreRows = 128;   // rows per pre-pass block
constexpr int kHalf = 64;       // rows per pass through its tile
constexpr int kPreThreads = 256;
constexpr int kBoxRowBytes = 128;  // a swizzled box row: 32 f32

// Per head width: kGroups consumer warpgroups (64 rows each) per dQ or
// dK/dV block, kTile rows of the other side per loop step, and the ring's
// stages.  A consumer's registers stay within 65,536 / 384 = 168 (the
// block's own rows are wgmma A operands in shared memory, not registers):
// past that ptxas serializes the wgmmas.  Shared memory per block at d = 64:
// 217 KB (dQ: 3 stages of k, v, kᵀ) and 200 KB (dK/dV: 2 stages of q, dO,
// qᵀ, dOᵀ).
template <int D>
struct Cfg;
template <>
struct Cfg<32> {
  static constexpr int kGroups = 2, kTile = 64, kDqStages = 4, kDkvStages = 4;
};
template <>
struct Cfg<64> {
  static constexpr int kGroups = 2, kTile = 64, kDqStages = 3, kDkvStages = 2;
};
template <>
struct Cfg<128> {
  static constexpr int kGroups = 1, kTile = 32, kDqStages = 3, kDkvStages = 2;
};

// A [kRows, kCols] f32 block in shared memory as TMA writes it: kCols / 32
// boxes of [kRows, 32] (128-byte rows, 128-byte swizzle), box b holding
// columns 32b … 32b + 31.
template <int kRows, int kCols>
struct Boxes {
  static constexpr int kBoxBytes = kRows * kBoxRowBytes;
  static constexpr int kBytes = kBoxBytes * (kCols / 32);
  static_assert(kBoxBytes % 1024 == 0, "swizzled boxes need 1024-byte alignment");
};

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Descriptor of k-step j (columns 8j … 8j + 7) of a block of kRows-row boxes.
template <int kRows>
__device__ __forceinline__ uint64_t kstep_desc(const uint8_t* block, int j) {
  return smem_desc_sw128(block + (j / 4) * kRows * kBoxRowBytes) + 2 * (j % 4);
}

struct BwdParams {
  const float* q;       // [bh, tq, d]
  const float* k;       // [bh, tk, d]
  const float* v;       // [bh, tk, d]
  const uint8_t* mask;  // [bh, tk], nonzero = valid key
  const float* dout;    // [bh, tq, d]
  const float* out;     // [bh, tq, d], the forward's output
  const float* lse;     // [bh, tq]
  float* dq;            // [bh, tq, d]
  float* dk;            // [bh, tk, d]
  float* dv;            // [bh, tk, d]
  // the workspace (written by the pre-pass and the lists kernel)
  float* qr;            // [bh, tq, d] q, TF32
  float* kr;            // [bh, tk, d] k, TF32
  float* vr;            // [bh, tk, d] v, TF32
  float* dor;           // [bh, tq, d] dO, TF32
  float* qt;            // [bh, d, tq_pad] qᵀ, TF32, depth order within 8s
  float* kt;            // [bh, d, tk_pad] kᵀ
  float* dot;           // [bh, d, tq_pad] dOᵀ
  float* lse_pad;       // [bh, tq_pad], +inf past tq
  float* dvec;          // [bh, tq_pad] D = rowsum(dO∘O), 0 past tq
  float* kval;          // [bh, tk_pad] 1 = valid key, 0 masked or past tk
  int* qlive;           // [bh, tq_pad / 32] a dO row of the 32 is not all zero
  int* klive;           // [bh, tk_pad / 32] one of the 32 keys is valid
  int* qlist;           // [bh, tq_pad / 32] live query tiles, increasing
  int* klist;           // [bh, tk_pad / 32] live key tiles
  int* qcount;          // [bh]
  int* kcount;          // [bh]
  int* any_valid;       // [bh] the sequence has a valid key
  int tq, tk, tq_pad, tk_pad;
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- 1. the pre-pass --------------------------------------------------------------

// Rows [r0, r0 + 64) of src [n, D], TF32-rounded, into dst (rows < n) and,
// with kToTile, into `tile` (zero past n).
template <int D, bool kToTile>
__device__ __forceinline__ void round_rows(float (*tile)[D + 1], const float* __restrict__ src,
                                           float* __restrict__ dst, int r0, int n) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < kHalf * kVecs; i += kPreThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    const long row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) x = *reinterpret_cast<const float4*>(src + row * D + c);
    x.x = __uint_as_float(to_tf32(x.x));
    x.y = __uint_as_float(to_tf32(x.y));
    x.z = __uint_as_float(to_tf32(x.z));
    x.w = __uint_as_float(to_tf32(x.w));
    if (row < n) *reinterpret_cast<float4*>(dst + row * D + c) = x;
    if constexpr (kToTile) {
      tile[r][c] = x.x;
      tile[r][c + 1] = x.y;
      tile[r][c + 2] = x.z;
      tile[r][c + 3] = x.w;
    }
  }
}

// The tile's columns as rows of dst [D, n_pad], positions r0 … r0 + 63:
// position 8m + i holds row 8m + (0, 2, 4, 6, 1, 3, 5, 7)[i], the depth
// order in which a score accumulator is an A fragment.
template <int D>
__device__ __forceinline__ void write_transposed(const float (*tile)[D + 1], float* __restrict__ dst, int r0,
                                                 int n_pad) {
  for (int i = threadIdx.x; i < D * kHalf; i += kPreThreads) {
    const int c = i / kHalf, pos = i % kHalf, j = pos & 7;
    const int r = (pos & ~7) | (j < 4 ? 2 * j : 2 * j - 7);
    dst[(long)c * n_pad + r0 + pos] = tile[r][c];
  }
}

// One block per 128 rows of a sequence (two halves of 64 through `tile`).
// Query side: D, the padded lse and the liveness flags first; the TF32 and
// transposed copies of q and dO only where one of the 128 dO rows is not
// zero (the dQ and dK/dV kernels read no other rows of them).  Key side:
// the copies of k, v and kᵀ, the key mask as f32 and its flags.
template <int D>
__global__ void __launch_bounds__(kPreThreads) flash_bwd_prepass_kernel(const BwdParams p) {
  __shared__ float tile[kHalf][D + 1];
  const int bh = blockIdx.y, r0 = blockIdx.x * kPreRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r0 < p.tq_pad) {  // uniform in the block
    const long qb = (long)bh * p.tq;
    int units = 0;  // lane 0: bit u set where this warp met a nonzero dO row in rows r0 + 32u …
    for (int r = warp; r < kPreRows; r += kPreThreads / 32) {  // one warp a row
      const int row = r0 + r;
      bool nonzero = false;
      float s = 0.f;  // D = rowsum(dO∘O)
      if (row < p.tq) {
        for (int c = lane; c < D; c += 32) {
          const float x = p.dout[(qb + row) * D + c];
          nonzero |= x != 0.f;
          s += x * p.out[(qb + row) * D + c];
        }
      }
      nonzero = __any_sync(0xffffffffu, nonzero);
      s = warp_sum(s);
      if (lane == 0) {
        p.dvec[(long)bh * p.tq_pad + row] = s;
        p.lse_pad[(long)bh * p.tq_pad + row] = row < p.tq ? p.lse[qb + row] : __int_as_float(0x7f800000);
        units |= nonzero << (r / kUnit);
      }
    }
    int any = 0;
    for (int u = 0; u < kPreRows / kUnit; ++u) {
      const int live = __syncthreads_or((units >> u) & 1);
      if (threadIdx.x == 0) p.qlive[(long)bh * (p.tq_pad / kUnit) + r0 / kUnit + u] = live != 0;
      any |= live;
    }
    if (any) {
      float* qt = p.qt + (long)bh * D * p.tq_pad;
      float* dot = p.dot + (long)bh * D * p.tq_pad;
      for (int h0 = r0; h0 < r0 + kPreRows; h0 += kHalf) {
        round_rows<D, true>(tile, p.q + qb * D, p.qr + qb * D, h0, p.tq);
        __syncthreads();
        write_transposed<D>(tile, qt, h0, p.tq_pad);
        __syncthreads();
        round_rows<D, true>(tile, p.dout + qb * D, p.dor + qb * D, h0, p.tq);
        __syncthreads();
        write_transposed<D>(tile, dot, h0, p.tq_pad);
        __syncthreads();
      }
    }
  }
  if (r0 < p.tk_pad) {
    const long kb = (long)bh * p.tk;
    for (int h0 = r0; h0 < r0 + kPreRows; h0 += kHalf) {
      round_rows<D, true>(tile, p.k + kb * D, p.kr + kb * D, h0, p.tk);
      __syncthreads();
      write_transposed<D>(tile, p.kt + (long)bh * D * p.tk_pad, h0, p.tk_pad);
      round_rows<D, false>(nullptr, p.v + kb * D, p.vr + kb * D, h0, p.tk);
      bool valid = false;
      if (threadIdx.x < kHalf) {
        const int row = h0 + threadIdx.x;
        valid = row < p.tk && p.mask[kb + row] != 0;
        p.kval[(long)bh * p.tk_pad + row] = valid ? 1.f : 0.f;
      }
      const int lo = __syncthreads_or(valid && threadIdx.x < kUnit);
      const int hi = __syncthreads_or(valid && threadIdx.x >= kUnit);
      if (threadIdx.x == 0) {
        int* flags = p.klive + (long)bh * (p.tk_pad / kUnit) + h0 / kUnit;
        flags[0] = lo != 0;
        flags[1] = hi != 0;
      }
    }
  }
}

// ---- 2. the tile lists ------------------------------------------------------------

// One block per sequence: warp 0 lists the key tiles of kTile rows that hold
// a valid key (every tile when the sequence has none), warp 1 the query
// tiles whose dO is not all zero; each list in increasing order.
template <int kTile>
__global__ void __launch_bounds__(64) flash_bwd_lists_kernel(const BwdParams p) {
  constexpr int kPer = kTile / kUnit;
  const int bh = blockIdx.x, lane = threadIdx.x % 32;
  const bool keys = threadIdx.x < 32;
  const int n = keys ? p.tk : p.tq;
  const int units = (keys ? p.tk_pad : p.tq_pad) / kUnit;
  const int* live = (keys ? p.klive : p.qlive) + (long)bh * units;
  int* list = (keys ? p.klist : p.qlist) + (long)bh * units;
  bool every = false;
  if (keys) {
    int any = 0;
    for (int u = lane; u < units; u += 32) any |= live[u];
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) p.any_valid[bh] = any;
    every = !any;
  }
  const int tiles = (n + kTile - 1) / kTile;
  int count = 0;
  for (int base = 0; base < tiles; base += 32) {
    const int i = base + lane;
    bool on = false;
    if (i < tiles) {
      on = every;
      for (int u = 0; u < kPer; ++u) on |= live[i * kPer + u] != 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (on) list[count + __popc(ballot & ((1u << lane) - 1))] = i;
    count += __popc(ballot);
  }
  if (lane == 0) (keys ? p.kcount : p.qcount)[bh] = count;
}

// ---- 3 and 4. dQ and dK/dV --------------------------------------------------------

// Keep A fragments in their registers until the wgmmas that read them
// completed: the compiler sees them read and written here, after the wait.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
  }
}

// Rows row0 + g and row0 + g + 8 of an [n, D] output from a warp's m64nD
// accumulator.
template <int D>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, const float (&acc)[D / 2], int row0, int n,
                                          int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dst + (long)row * D + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// Zeros into rows [row0, row0 + rows) ∩ [0, n) of an [n, D] output, by the
// whole block.
template <int D>
__device__ __forceinline__ void store_zero_rows(float* __restrict__ dst, int row0, int rows, int n) {
  const int end = min(row0 + rows, n);
  for (long i = (long)row0 * D / 4 + threadIdx.x; i < (long)end * D / 4; i += blockDim.x)
    reinterpret_cast<float4*>(dst)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Shared memory of kernel 3, in 1024-byte-aligned blocks: the block's own
// rows (q and dO: A of the score products), then the ring's stages (k and
// v: B of the score products, N = kTile; kᵀ: B of dQ += dS·k, N = d; the key
// mask), then the barriers.
template <int D>
struct DqLayout {
  using C = Cfg<D>;
  using Own = Boxes<64 * C::kGroups, D>;
  using Rows = Boxes<C::kTile, D>;
  using Cols = Boxes<D, C::kTile>;
  static constexpr int kV = Rows::kBytes, kKt = 2 * Rows::kBytes, kVal = kKt + Cols::kBytes;
  static constexpr uint32_t kTx = kVal + C::kTile * 4;
  static constexpr int kStage = round_up(kTx, 1024);
  static constexpr int kOwnBytes = 2 * Own::kBytes;
  static constexpr int kSmem = kOwnBytes + C::kDqStages * kStage + (2 * C::kDqStages + 1) * 8 + 1024;
};

// Kernel 4's: k and v (A of the score products), then stages of q and dO
// (B of the score products), qᵀ and dOᵀ (B of dK += dSᵀ·q and dV += Pᵀ·dO),
// lse and D.
template <int D>
struct DkvLayout {
  using C = Cfg<D>;
  using Own = Boxes<64 * C::kGroups, D>;
  using Rows = Boxes<C::kTile, D>;
  using Cols = Boxes<D, C::kTile>;
  static constexpr int kDo = Rows::kBytes, kQt = 2 * Rows::kBytes, kDot = kQt + Cols::kBytes;
  static constexpr int kLse = kDot + Cols::kBytes, kDvec = kLse + C::kTile * 4;
  static constexpr uint32_t kTx = kDvec + C::kTile * 4;
  static constexpr int kStage = round_up(kTx, 1024);
  static constexpr int kOwnBytes = 2 * Own::kBytes;
  static constexpr int kSmem = kOwnBytes + C::kDkvStages * kStage + (2 * C::kDkvStages + 1) * 8 + 1024;
};

// The block's shared memory from a 1024-byte boundary: its own rows, the
// ring, then the barriers (full[S], empty[S], and one for its own rows).
struct Ring {
  uint8_t* own;
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own_bar;
};

template <int kOwnBytes, int kStages, int kStageBytes, int kGroups>
__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw) {
  Ring r;
  // aligned by an offset from the shared array, so that the compiler still
  // knows every pointer below is shared memory
  r.own = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  r.stages = r.own + kOwnBytes;
  r.full = reinterpret_cast<uint64_t*>(r.stages + kStages * kStageBytes);
  r.empty = r.full + kStages;
  r.own_bar = r.empty + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], kGroups);
    }
    mbar_init(r.own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The block's own rows [row0, row0 + 64·kGroups) of two [bh, n, d] copies
// into shared memory, on `bar`.
template <int D, class Own>
__device__ __forceinline__ void load_own(uint8_t* own, const CUtensorMap* a_map, const CUtensorMap* b_map,
                                         uint64_t* bar, int row0, int bh) {
  mbar_expect_tx(bar, 2 * Own::kBytes);
  for (int b = 0; b < D / 32; ++b) {
    tma_load_3d(own + b * Own::kBoxBytes, a_map, bar, 32 * b, row0, bh);
    tma_load_3d(own + Own::kBytes + b * Own::kBoxBytes, b_map, bar, 32 * b, row0, bh);
  }
}

// Kernel 3: dQ for 64·kGroups queries of one (batch·head), looping over the
// live key tiles.  Maps: q and dO rows (TF32 copies, boxes [64·kGroups, 32]),
// k and v rows (boxes [kTile, 32]), kᵀ ([bh, d, tk_pad], boxes [d, 32]) and
// the key mask as f32 ([bh, tk_pad], boxes [kTile]).
template <int D>
__global__ void __launch_bounds__(128 * (Cfg<D>::kGroups + 1), 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap kt_map, const __grid_constant__ CUtensorMap kval_map,
                    const BwdParams p) {
  using C = Cfg<D>;
  using L = DqLayout<D>;
  constexpr int S = C::kDqStages, kRows = 64 * C::kGroups, kT = C::kTile;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  float* dq = p.dq + (long)bh * p.tq * D;

  // queries whose dO rows are all zero have dQ = 0
  bool live = false;
  for (int u = q0 / kUnit; u < (q0 + kRows) / kUnit; ++u) live |= p.qlive[(long)bh * (p.tq_pad / kUnit) + u] != 0;
  if (!live) {
    store_zero_rows<D>(dq, q0, kRows, p.tq);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring<L::kOwnBytes, S, L::kStage, C::kGroups>(smem_raw);
  const int count = p.kcount[bh];
  const int* list = p.klist + (long)bh * (p.tk_pad / kUnit);

  const int wg = threadIdx.x / 128;
  if (wg == C::kGroups) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == C::kGroups * 128) {
      load_own<D, typename L::Own>(ring.own, &q_map, &do_map, ring.own_bar, q0, bh);
      for (int n = 0; n < count; ++n) {
        const int s = n % S;
        mbar_wait(&ring.empty[s], ((n / S) & 1) ^ 1);  // round 0 passes: the ring starts empty
        mbar_expect_tx(&ring.full[s], L::kTx);
        const int k0 = list[n] * kT;
        uint8_t* st = ring.stages + s * L::kStage;
        for (int b = 0; b < D / 32; ++b) {
          tma_load_3d(st + b * L::Rows::kBoxBytes, &k_map, &ring.full[s], 32 * b, k0, bh);
          tma_load_3d(st + L::kV + b * L::Rows::kBoxBytes, &v_map, &ring.full[s], 32 * b, k0, bh);
        }
        for (int b = 0; b < kT / 32; ++b)
          tma_load_3d(st + L::kKt + b * L::Cols::kBoxBytes, &kt_map, &ring.full[s], k0 + 32 * b, 0, bh);
        tma_load_2d(st + L::kVal, &kval_map, &ring.full[s], k0, bh);
      }
    }
    return;
  }

  // consumers: 64 queries a warpgroup
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4);  // this warp's first query
  float lse[2], dvec[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse[h] = p.lse_pad[(long)bh * p.tq_pad + row0 + g + 8 * h];
    dvec[h] = p.dvec[(long)bh * p.tq_pad + row0 + g + 8 * h];
  }
  const int wg_rows = (64 * wg * kBoxRowBytes) >> 4;  // this warpgroup's rows in an own box (16-byte units)
  // a warpgroup whose 64 queries all have a zero dO only passes the stages on
  const int* units = p.qlive + (long)bh * (p.tq_pad / kUnit) + q0 / kUnit;
  const bool wg_live = units[2 * wg] || units[2 * wg + 1];
  const uint8_t* q_own = ring.own;
  const uint8_t* do_own = ring.own + L::Own::kBytes;
  const bool signals = threadIdx.x % 128 == 0;  // one arrival per warpgroup on "empty"
  mbar_wait(ring.own_bar, 0);

  // dQ += dS·k of tile n runs on while tile n + 1's scores are issued: its
  // A fragments stay reserved (fence_frags), and its stage is released
  // after the next wait
  float acc[D / 2];
  uint32_t a[kT / 8][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int n = 0; n < count; ++n) {
    const int s = n % S;
    mbar_wait(&ring.full[s], (n / S) & 1);
    if (!wg_live) {
      if (signals) mbar_arrive(&ring.empty[s]);
      continue;
    }
    const uint8_t* st = ring.stages + s * L::kStage;

    float sc[kT / 2], dp[kT / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // s = q·kᵀ
      wgmma_tf32_ss(sc, kstep_desc<kRows>(q_own, j) + wg_rows, kstep_desc<kT>(st, j), j);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // dP = dO·vᵀ
      wgmma_tf32_ss(dp, kstep_desc<kRows>(do_own, j) + wg_rows, kstep_desc<kT>(st + L::kV, j), j);
    wgmma_commit();
    wgmma_wait<0>();  // this tile's scores, and the previous tile's dQ product
    fence_operands(sc);
    fence_operands(dp);
    fence_operands(acc);
    fence_frags(a);
    if (n > 0 && signals) mbar_arrive(&ring.empty[(n - 1) % S]);

    // dS, as TF32 A fragments of dQ += dS·k (depth order within each 8)
    const float* kval = reinterpret_cast<const float*>(st + L::kVal);
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float2 valid = *reinterpret_cast<const float2*>(kval + 8 * j + 2 * t);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = ((e & 1) ? valid.y : valid.x) > 0.f ? sc[4 * j + e] * p.scale : kNegInf;
        const float pr = exp2f((sv - lse[e >> 1]) * kLog2e);
        ds[e] = pr * (dp[4 * j + e] - dvec[e >> 1]) * p.scale;
      }
      a[j][0] = to_tf32(ds[0]);
      a[j][1] = to_tf32(ds[2]);
      a[j][2] = to_tf32(ds[1]);
      a[j][3] = to_tf32(ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) wgmma_tf32_rs(acc, a[j], kstep_desc<D>(st + L::kKt, j), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);
  fence_frags(a);
  if (wg_live && count > 0 && signals) mbar_arrive(&ring.empty[(count - 1) % S]);
  store_acc<D>(dq, acc, row0, p.tq, g, t);
}

// Kernel 4: dK and dV for 64·kGroups keys of one (batch·head), looping over
// the live query tiles, on the transposed scores Sᵀ = k·qᵀ.  Maps: k and v
// rows (boxes [64·kGroups, 32]), q and dO rows (boxes [kTile, 32]), qᵀ and
// dOᵀ (boxes [d, 32]), lse and D padded ([bh, tq_pad], boxes [kTile]).
template <int D>
__global__ void __launch_bounds__(128 * (Cfg<D>::kGroups + 1), 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap qt_map, const __grid_constant__ CUtensorMap dot_map,
                     const __grid_constant__ CUtensorMap lse_map, const __grid_constant__ CUtensorMap dvec_map,
                     const BwdParams p) {
  using C = Cfg<D>;
  using L = DkvLayout<D>;
  constexpr int S = C::kDkvStages, kRows = 64 * C::kGroups, kT = C::kTile;
  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  float* dk = p.dk + (long)bh * p.tk * D;
  float* dv = p.dv + (long)bh * p.tk * D;

  // no live query tile, or (in a sequence with a valid key) no valid key
  // here: dK = dV = 0
  const int count = p.qcount[bh];
  bool live = count > 0;
  if (live && p.any_valid[bh]) {
    bool any = false;
    for (int u = k0 / kUnit; u < (k0 + kRows) / kUnit; ++u) any |= p.klive[(long)bh * (p.tk_pad / kUnit) + u] != 0;
    live = any;
  }
  if (!live) {
    store_zero_rows<D>(dk, k0, kRows, p.tk);
    store_zero_rows<D>(dv, k0, kRows, p.tk);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring<L::kOwnBytes, S, L::kStage, C::kGroups>(smem_raw);
  const int* list = p.qlist + (long)bh * (p.tq_pad / kUnit);

  const int wg = threadIdx.x / 128;
  if (wg == C::kGroups) {
    if (threadIdx.x == C::kGroups * 128) {
      load_own<D, typename L::Own>(ring.own, &k_map, &v_map, ring.own_bar, k0, bh);
      for (int n = 0; n < count; ++n) {
        const int s = n % S;
        mbar_wait(&ring.empty[s], ((n / S) & 1) ^ 1);
        mbar_expect_tx(&ring.full[s], L::kTx);
        const int q0 = list[n] * kT;
        uint8_t* st = ring.stages + s * L::kStage;
        for (int b = 0; b < D / 32; ++b) {
          tma_load_3d(st + b * L::Rows::kBoxBytes, &q_map, &ring.full[s], 32 * b, q0, bh);
          tma_load_3d(st + L::kDo + b * L::Rows::kBoxBytes, &do_map, &ring.full[s], 32 * b, q0, bh);
        }
        for (int b = 0; b < kT / 32; ++b) {
          tma_load_3d(st + L::kQt + b * L::Cols::kBoxBytes, &qt_map, &ring.full[s], q0 + 32 * b, 0, bh);
          tma_load_3d(st + L::kDot + b * L::Cols::kBoxBytes, &dot_map, &ring.full[s], q0 + 32 * b, 0, bh);
        }
        tma_load_2d(st + L::kLse, &lse_map, &ring.full[s], q0, bh);
        tma_load_2d(st + L::kDvec, &dvec_map, &ring.full[s], q0, bh);
      }
    }
    return;
  }

  // consumers: 64 keys a warpgroup
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = k0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4);  // this warp's first key
  bool key_valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key_valid[h] = p.kval[(long)bh * p.tk_pad + row0 + g + 8 * h] > 0.f;
  const int wg_rows = (64 * wg * kBoxRowBytes) >> 4;
  // a warpgroup whose 64 keys are all masked (in a sequence with a valid
  // key) only passes the stages on
  const int* units = p.klive + (long)bh * (p.tk_pad / kUnit) + k0 / kUnit;
  const bool wg_live = !p.any_valid[bh] || units[2 * wg] || units[2 * wg + 1];
  const uint8_t* k_own = ring.own;
  const uint8_t* v_own = ring.own + L::Own::kBytes;
  const bool signals = threadIdx.x % 128 == 0;
  mbar_wait(ring.own_bar, 0);

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  for (int n = 0; n < count; ++n) {
    const int s = n % S;
    mbar_wait(&ring.full[s], (n / S) & 1);
    if (!wg_live) {
      if (signals) mbar_arrive(&ring.empty[s]);
      continue;
    }
    const uint8_t* st = ring.stages + s * L::kStage;

    float sc[kT / 2], dp[kT / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // sᵀ = k·qᵀ
      wgmma_tf32_ss(sc, kstep_desc<kRows>(k_own, j) + wg_rows, kstep_desc<kT>(st, j), j);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // dPᵀ = v·dOᵀ
      wgmma_tf32_ss(dp, kstep_desc<kRows>(v_own, j) + wg_rows, kstep_desc<kT>(st + L::kDo, j), j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);

    // Pᵀ and dSᵀ (element e: key row g + 8·(e / 2), query column 8j + 2t + e % 2)
    const float* lse = reinterpret_cast<const float*>(st + L::kLse);
    const float* dvec = reinterpret_cast<const float*>(st + L::kDvec);
    uint32_t pa[kT / 8][4], da[kT / 8][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dvec + 8 * j + 2 * t);
      float pt[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = key_valid[e >> 1] ? sc[4 * j + e] * p.scale : kNegInf;
        pt[e] = exp2f((sv - ((e & 1) ? l2.y : l2.x)) * kLog2e);
        ds[e] = pt[e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * p.scale;
      }
      pa[j][0] = to_tf32(pt[0]);
      pa[j][1] = to_tf32(pt[2]);
      pa[j][2] = to_tf32(pt[1]);
      pa[j][3] = to_tf32(pt[3]);
      da[j][0] = to_tf32(ds[0]);
      da[j][1] = to_tf32(ds[2]);
      da[j][2] = to_tf32(ds[1]);
      da[j][3] = to_tf32(ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) wgmma_tf32_rs(acc_dv, pa[j], kstep_desc<D>(st + L::kDot, j), 1);  // dV += Pᵀ·dO
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) wgmma_tf32_rs(acc_dk, da[j], kstep_desc<D>(st + L::kQt, j), 1);  // dK += dSᵀ·q
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_dv);
    fence_operands(acc_dk);
    if (signals) mbar_arrive(&ring.empty[s]);
  }
  store_acc<D>(dk, acc_dk, row0, p.tk, g, t);
  store_acc<D>(dv, acc_dv, row0, p.tk, g, t);
}

// ---- 5. the distance-weighted sum -------------------------------------------------

constexpr int kTile = 64;  // rows a block owns; columns per loop step
constexpr int kWarps = 4;  // 16 rows each
constexpr int kThreads = kWarps * 32;

// floats of one [64][D + 4] tile in shared memory
template <int D>
constexpr int kTileFloats = kTile * (D + 4);

// rows row0 + g and row0 + g + 8 of an [n, D] output from C fragments
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[D / 8][4], int row0,
                                           int n, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<float2*>(dst + (long)row * D + c * 8 + 2 * t) =
          make_float2(acc[c][2 * i], acc[c][2 * i + 1]);
    }
  }
}

struct DwsParams {
  const float* ca;      // [bh, ta, 2] µm, output side
  const float* cb;      // [bh, tb, 2] µm, summation side
  const float* val;     // [bh, tb, d]
  const uint8_t* mask;  // [bh, tb] nonzero = include b, or NULL (all)
  float* out;           // [bh, ta, d]
  int ta;
  int tb;
};

// out_a = Σ_b ‖c_a − c_b‖·val_b for 64 rows a of one
// (batch·head), looping over 64-column tiles of b.
template <int D>
__global__ void __launch_bounds__(kThreads) dist_weighted_sum_kernel(const DwsParams p) {
  constexpr int kLd = D + 4;
  constexpr int kN = D / 8;
  constexpr int kChunk = kN < 8 ? kN : 8;  // column tiles per pass (registers)
  extern __shared__ __align__(16) float smem[];
  float* vs = smem;                     // [64][D+4] val, f32
  float* valid = vs + kTileFloats<D>;  // [64]
  float* cbs = valid + kTile;            // [64][2]

  const int bh = blockIdx.y;
  const int a0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long aoff = (long)bh * p.ta;
  const long boff = (long)bh * p.tb;

  float cx[2] = {0.f, 0.f}, cy[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = a0 + warp * 16 + g + 8 * i;
    if (row < p.ta) {
      cx[i] = p.ca[(aoff + row) * 2];
      cy[i] = p.ca[(aoff + row) * 2 + 1];
    }
  }
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int b0 = 0; b0 < p.tb; b0 += kTile) {
    __syncthreads();
    load_rows<D, kTile, kThreads>(vs, p.val + boff * D, b0, p.tb, false);
    if (threadIdx.x < kTile) {
      const int b = b0 + threadIdx.x;
      const bool in_range = b < p.tb;
      valid[threadIdx.x] = in_range && (p.mask == nullptr || p.mask[boff + b] != 0) ? 1.f : 0.f;
      cbs[2 * threadIdx.x] = in_range ? p.cb[(boff + b) * 2] : 0.f;
      cbs[2 * threadIdx.x + 1] = in_range ? p.cb[(boff + b) * 2 + 1] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int n0 = 0; n0 < kN; n0 += kChunk) {
      float tile[kChunk][4];
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) tile[n][e] = 0.f;
      }
      dist_dv_tile<kLd, kChunk>(tile, cx, cy, cbs, valid, vs, n0, g, t);
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + n][e] = __fadd_rn(acc[n0 + n][e], tile[n][e]);
      }
    }
  }
  store_rows<D>(p.out + aoff * D, acc, a0 + warp * 16, p.ta, g, t);
}

// ---- host side --------------------------------------------------------------------

// The workspace, carved from `base` (or from address 0, to size it) in
// 256-byte-aligned arrays; returns its bytes.
inline size_t carve_workspace(BwdParams* p, uint8_t* base, int bh, int tq, int tk, int d) {
  const size_t tq_pad = round_up(tq, kPad), tk_pad = round_up(tk, kPad);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    uint8_t* ptr = base == nullptr ? nullptr : base + at;
    at = (at + bytes + 255) / 256 * 256;
    return ptr;
  };
  const size_t f = sizeof(float), i = sizeof(int);
  p->qr = reinterpret_cast<float*>(take(f * bh * tq * d));
  p->dor = reinterpret_cast<float*>(take(f * bh * tq * d));
  p->kr = reinterpret_cast<float*>(take(f * bh * tk * d));
  p->vr = reinterpret_cast<float*>(take(f * bh * tk * d));
  p->qt = reinterpret_cast<float*>(take(f * bh * d * tq_pad));
  p->dot = reinterpret_cast<float*>(take(f * bh * d * tq_pad));
  p->kt = reinterpret_cast<float*>(take(f * bh * d * tk_pad));
  p->lse_pad = reinterpret_cast<float*>(take(f * bh * tq_pad));
  p->dvec = reinterpret_cast<float*>(take(f * bh * tq_pad));
  p->kval = reinterpret_cast<float*>(take(f * bh * tk_pad));
  p->qlive = reinterpret_cast<int*>(take(i * bh * (tq_pad / kUnit)));
  p->klive = reinterpret_cast<int*>(take(i * bh * (tk_pad / kUnit)));
  p->qlist = reinterpret_cast<int*>(take(i * bh * (tq_pad / kUnit)));
  p->klist = reinterpret_cast<int*>(take(i * bh * (tk_pad / kUnit)));
  p->qcount = reinterpret_cast<int*>(take(i * bh));
  p->kcount = reinterpret_cast<int*>(take(i * bh));
  p->any_valid = reinterpret_cast<int*>(take(i * bh));
  return at;
}

// A map of rank 2 or 3 over f32 (dims and byte strides innermost first),
// boxes of `box` (128-byte rows with `swizzled`), zero fill past the edges.
inline cudaError_t encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                          const cuuint64_t* strides, const cuuint32_t* box, bool swizzled) {
  PFN_cuTensorMapEncodeTiled fn;
  cudaError_t err = tensor_map_encoder(&fn);
  if (err != cudaSuccess) return err;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// rows of [bh, n, d] in boxes of [rows, 32]
inline cudaError_t encode_rows(CUtensorMap* map, const float* ptr, int bh, int n, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)n * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  return encode(map, ptr, 3, dims, strides, box, true);
}

// a transposed copy [bh, d, n_pad] in boxes of [d, 32]
inline cudaError_t encode_cols(CUtensorMap* map, const float* ptr, int bh, int n_pad, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)n_pad, (cuuint64_t)d, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)n_pad * 4, (cuuint64_t)n_pad * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)d, 1};
  return encode(map, ptr, 3, dims, strides, box, true);
}

// a padded vector [bh, n_pad] in boxes of `len`
inline cudaError_t encode_vec(CUtensorMap* map, const float* ptr, int bh, int n_pad, int len) {
  const cuuint64_t dims[2] = {(cuuint64_t)n_pad, (cuuint64_t)bh};
  const cuuint64_t strides[1] = {(cuuint64_t)n_pad * 4};
  const cuuint32_t box[2] = {(cuuint32_t)len, 1};
  return encode(map, ptr, 2, dims, strides, box, false);
}

// The pre-pass and the lists go first; the host encodes the tensor maps of
// kernels 3 and 4 while the card runs them.
template <int D>
cudaError_t launch_bwd(const BwdParams& p, int bh, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr int kRows = 64 * C::kGroups;
  constexpr int kBlockThreads = 128 * (C::kGroups + 1);
  constexpr int kDqSmem = DqLayout<D>::kSmem, kDkvSmem = DkvLayout<D>::kSmem;
  cudaError_t err;
  flash_bwd_prepass_kernel<D><<<dim3((p.tq_pad > p.tk_pad ? p.tq_pad : p.tk_pad) / kPreRows, bh), kPreThreads, 0,
                                stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_lists_kernel<C::kTile><<<bh, 64, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // rows of the other side (boxes [kTile, 32]), a block's own rows (boxes
  // [64·kGroups, 32]), the transposed copies and the vectors
  CUtensorMap q_map, do_map, k_map, v_map, q_own, do_own, k_own, v_own, qt_map, dot_map, kt_map, lse_map,
      dvec_map, kval_map;
  if ((err = encode_rows(&q_map, p.qr, bh, p.tq, D, C::kTile)) != cudaSuccess ||
      (err = encode_rows(&do_map, p.dor, bh, p.tq, D, C::kTile)) != cudaSuccess ||
      (err = encode_rows(&k_map, p.kr, bh, p.tk, D, C::kTile)) != cudaSuccess ||
      (err = encode_rows(&v_map, p.vr, bh, p.tk, D, C::kTile)) != cudaSuccess ||
      (err = encode_rows(&q_own, p.qr, bh, p.tq, D, kRows)) != cudaSuccess ||
      (err = encode_rows(&do_own, p.dor, bh, p.tq, D, kRows)) != cudaSuccess ||
      (err = encode_rows(&k_own, p.kr, bh, p.tk, D, kRows)) != cudaSuccess ||
      (err = encode_rows(&v_own, p.vr, bh, p.tk, D, kRows)) != cudaSuccess ||
      (err = encode_cols(&qt_map, p.qt, bh, p.tq_pad, D)) != cudaSuccess ||
      (err = encode_cols(&dot_map, p.dot, bh, p.tq_pad, D)) != cudaSuccess ||
      (err = encode_cols(&kt_map, p.kt, bh, p.tk_pad, D)) != cudaSuccess ||
      (err = encode_vec(&lse_map, p.lse_pad, bh, p.tq_pad, C::kTile)) != cudaSuccess ||
      (err = encode_vec(&dvec_map, p.dvec, bh, p.tq_pad, C::kTile)) != cudaSuccess ||
      (err = encode_vec(&kval_map, p.kval, bh, p.tk_pad, C::kTile)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kDqSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kDkvSmem)) != cudaSuccess)
    return err;
  flash_bwd_dq_kernel<D><<<dim3(p.tq_pad / kRows, bh), kBlockThreads, kDqSmem, stream>>>(
      q_own, do_own, k_map, v_map, kt_map, kval_map, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D><<<dim3(p.tk_pad / kRows, bh), kBlockThreads, kDkvSmem, stream>>>(
      k_own, v_own, q_map, do_map, qt_map, dot_map, lse_map, dvec_map, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dws(const DwsParams& p, int bh, cudaStream_t stream) {
  constexpr int smem = (kTileFloats<D> + 3 * kTile) * 4;
  cudaError_t err = cudaFuncSetAttribute(dist_weighted_sum_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dist_weighted_sum_kernel<D><<<dim3((p.ta + kTile - 1) / kTile, bh), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool bwd_shape_ok(int bh, int tq, int tk, int head_dim) {
  return (head_dim == 32 || head_dim == 64 || head_dim == 128) && bh > 0 && bh <= 65535 && tq > 0 && tk > 0 &&
         tq <= (1 << 30) - kPad && tk <= (1 << 30) - kPad;
}

}  // namespace

extern "C" {

// Bytes of the workspace stamp_flash_attn_bwd needs for these shapes,
// written as an int64 to *bytes.  Returns a cudaError_t.
int stamp_flash_attn_bwd_workspace(int bh, int tq, int tk, int head_dim, void* bytes) {
  if (!bwd_shape_ok(bh, tq, tk, head_dim)) return cudaErrorInvalidValue;
  BwdParams p;
  *static_cast<long long*>(bytes) = (long long)carve_workspace(&p, nullptr, bh, tq, tk, head_dim);
  return cudaSuccess;
}

// q [bh, tq, d], k and v [bh, tk, d], dout and out (the forward's output)
// [bh, tq, d] f32; mask [bh, tk] bytes; lse [bh, tq] f32 in; workspace of
// stamp_flash_attn_bwd_workspace bytes; dq [bh, tq, d], dk and dv
// [bh, tk, d] f32 out.  Scores are scaled by `scale` after the dot.  Every
// array contiguous and 16-byte aligned.  Launches the pre-pass, the tile
// lists, the dQ and the dK/dV kernels on `stream`.  Returns a cudaError_t.
int stamp_flash_attn_bwd(const void* q, const void* k, const void* v, const void* mask, const void* dout,
                         const void* out, const void* lse, void* workspace, void* dq, void* dk, void* dv, int bh,
                         int tq, int tk, int head_dim, float scale, int device, void* stream) {
  if (!bwd_shape_ok(bh, tq, tk, head_dim)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BwdParams p;
  carve_workspace(&p, static_cast<uint8_t*>(workspace), bh, tq, tk, head_dim);
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.dout = static_cast<const float*>(dout);
  p.out = static_cast<const float*>(out);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.tq = tq;
  p.tk = tk;
  p.tq_pad = round_up(tq, kPad);
  p.tk_pad = round_up(tk, kPad);
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_bwd<32>(p, bh, s);
    case 64:
      return launch_bwd<64>(p, bh, s);
    default:
      return launch_bwd<128>(p, bh, s);
  }
}

// ca [bh, ta, 2], cb [bh, tb, 2], val [bh, tb, d] f32; mask [bh, tb] bytes
// or NULL (every b); out [bh, ta, d] f32.  Every array contiguous and
// 16-byte aligned.  Returns a cudaError_t.
int stamp_dist_weighted_sum(const void* ca, const void* cb, const void* val, const void* mask,
                            void* out, int bh, int ta, int tb, int head_dim, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  DwsParams p;
  p.ca = static_cast<const float*>(ca);
  p.cb = static_cast<const float*>(cb);
  p.val = static_cast<const float*>(val);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<float*>(out);
  p.ta = ta;
  p.tb = tb;
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dws<32>(p, bh, s);
    case 64:
      return launch_dws<64>(p, bh, s);
    case 128:
      return launch_dws<128>(p, bh, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
