// The Hopper core shared by ln_dense.cu and ln_quant_dense.cu: a GEMM
//   out[M, N] = epilogue(A[M, K] · W[N, K]ᵀ),  A = transform(LayerNorm(x))
// whose A operand (the LayerNorm of x, and for int8 its quantization) is
// formed once per element, by a pass that issues no wgmma, and read by the
// GEMM from shared memory.
//
// Two kernels, launched on the caller's stream by the op's C entry point:
//   1. ln_normalize_kernel<Op::Norm>: one warp per row, 8 rows a block.  μ
//      and 1/σ of the row in f32, two passes (μ, then mean((x − μ)²), then
//      rsqrt(σ² + eps)), the row held in registers up to K = 4,096; then the
//      row's A: each 8 columns of raw x normalized with γ, β in f32 and cast
//      (Norm::apply8: bf16, or bf16 then int8), written to the A buffer
//      [M, a_ld bytes] of the scratch the wrapper allocates:
//      [μ (M), 1/σ (M)] f32, then A 16-byte aligned.  A caller that holds the
//      rows' statistics already (tensor parallelism: SwiGLU's inner
//      LayerNorm over a K sharded across ranks, its sums all-reduced) passes
//      them as [μ (M), 1/σ (M)] f32 and the kernel normalizes with those.
//      Each A element is formed once, where the GEMM would form it again for
//      every output tile (N / 256 times).
//   2. ln_gemm_kernel<Op>: persistent (one block per SM, gridDim.x =
//      min(tiles, SMs)), warp-specialized, 384 threads:
//      * warpgroup 2 is the producer (40 registers, setmaxnreg): one thread
//        issues TMA loads of A boxes [128, 128 bytes] and W boxes [256, BK]
//        (128-byte rows, 128-byte swizzle) into a ring of kStages
//        shared-memory stages, each paced by a "full" (TMA bytes landed)
//        and an "empty" (both consumers done) mbarrier;
//      * warpgroups 0 and 1 are the consumers (232 registers), 64 rows of the
//        128 × 256 tile each: wgmma.mma_async with both operands from shared
//        memory (SS), the k-steps of a stage as one wgmma group; a stage is
//        released once the next stage's group is issued and its own
//        completed;
//      * Op::epilogue writes the tile straight from the accumulator
//        registers with masked 16-byte stores (store_tile): no
//        shared-memory tile.  An op's partial-sum form (its kPartial
//        template parameter) writes the f32 or i32 accumulators themselves,
//        no bias, no scale, no cast (store_acc): the partial sums of a K
//        slice, which the caller all-reduces across ranks before the
//        epilogue's arithmetic.
// Output tiles are walked in a grouped order (kGroupM row tiles at a time,
// the row tile fastest), so the blocks in flight share W tiles and A rows in
// L2.  TMA zero-fills everything past M, N and K, so an A element past K is
// exactly 0.
//
// The two swizzle agreements: TMA writes every box with
// CU_TENSOR_MAP_SWIZZLE_128B (16-byte chunk c of row r stored at chunk
// c ^ (r % 8) of a 128-byte row, in 1024-byte-aligned boxes);
// smem_desc_sw128() tells wgmma the same layout (layout type 1, 8-row groups
// 1024 bytes apart).
//
// fused_qkv_attn.cu and fused_qkv_long.cu include this header for its
// fragment helpers only (swz, ldmatrix_x4, pack_bf16, quad_transpose).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {
namespace ln_gemm {

using namespace sm90;  // smem_addr, mbarriers, TMA loads, wgmma fences, descriptors

constexpr int kBM = 128;        // rows per output tile
constexpr int kBN = 256;        // columns per output tile (128 was slower at every UNI2 site)
constexpr int kConsumers = 2;   // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kGroupM = 8;      // row tiles walked together
constexpr int kRowBytes = 128;  // one swizzled box row
constexpr int kABytes = kBM * kRowBytes;  // an A box: [128, 64] bf16 or [128, 128] int8
constexpr int kWBytes = kBN * kRowBytes;  // a W box
constexpr int kStages = 4;                // 48 KB a stage
constexpr int kConsumerRegs = 232, kProducerRegs = 40;  // 2·128·232 + 128·40 ≤ 65,536

// ---- the normalization pass ---------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// A lane keeps the first kRowVecs of its 16-byte vectors of the row in
// registers (the whole row up to K = 4,096), so the second pass and the
// normalization read x again only past that.
constexpr int kRowVecs = 16;

// Norm supplies: kElemBytes (of an A element: 2 or 1), Params (the op's)
// and
//   float factor(const Params&);
//   void apply8(uint8_t* a, uint4 raw, const bf16* gamma, const bf16* beta, float mean, float rstd, float factor);
// a_ld: bytes from one A row to the next (16-byte aligned); k a multiple of
// 8.  stats_out ([μ (m), 1/σ (m)]) is written only where the caller gives
// no statistics.
template <class Norm>
__global__ void __launch_bounds__(256)
ln_normalize_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gamma,
                    const __nv_bfloat16* __restrict__ beta, const float* __restrict__ given,
                    float* __restrict__ stats_out, uint8_t* __restrict__ a, int a_ld, int m, int k, float eps,
                    const typename Norm::Params params) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const __nv_bfloat16* xr = x + (size_t)row * k;
  uint4 held[kRowVecs];
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int c = (i * 32 + lane) * 8;
    held[i] = c < k ? *reinterpret_cast<const uint4*>(xr + c) : make_uint4(0, 0, 0, 0);
  }
  float mean, rstd;
  if (given != nullptr) {
    mean = given[row];
    rstd = given[m + row];
  } else {
    float f[8];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      unpack8(held[i], f);  // zeros past k add nothing
      for (int e = 0; e < 8; ++e) s += f[e];
    }
    for (int c = (kRowVecs * 32 + lane) * 8; c < k; c += 32 * 8) {
      unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
      for (int e = 0; e < 8; ++e) s += f[e];
    }
    mean = warp_sum(s) / (float)k;
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      if ((i * 32 + lane) * 8 < k) {
        unpack8(held[i], f);
        for (int e = 0; e < 8; ++e) {
          const float d = f[e] - mean;
          v += d * d;
        }
      }
    }
    for (int c = (kRowVecs * 32 + lane) * 8; c < k; c += 32 * 8) {
      unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
      for (int e = 0; e < 8; ++e) {
        const float d = f[e] - mean;
        v += d * d;
      }
    }
    rstd = rsqrtf(warp_sum(v) / (float)k + eps);
    if (lane == 0) {
      stats_out[row] = mean;
      stats_out[m + row] = rstd;
    }
  }
  const float factor = Norm::factor(params);
  uint8_t* ar = a + (size_t)row * a_ld;
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int c = (i * 32 + lane) * 8;
    if (c < k) Norm::apply8(ar + c * Norm::kElemBytes, held[i], gamma + c, beta + c, mean, rstd, factor);
  }
  for (int c = (kRowVecs * 32 + lane) * 8; c < k; c += 32 * 8)
    Norm::apply8(ar + c * Norm::kElemBytes, *reinterpret_cast<const uint4*>(xr + c), gamma + c, beta + c, mean, rstd,
                 factor);
}

// γ, β of 8 columns, bf16 → f32
__device__ __forceinline__ void affine8(const __nv_bfloat16* gamma, const __nv_bfloat16* beta, float g[8],
                                        float b[8]) {
  unpack8(*reinterpret_cast<const uint4*>(gamma), g);
  unpack8(*reinterpret_cast<const uint4*>(beta), b);
}

// ---- swizzled boxes ---------------------------------------------------------------

// byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a
// 1024-byte-aligned box that TMA wrote with 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// ---- wgmma --------------------------------------------------------------------

// Accumulator layout of both wgmmas below (m64n256, per warp w of the
// warpgroup, g = lane / 4, t = lane % 4): d[4j + 2h + e] is row 16w + g + 8h,
// column 8j + 2t + e.  Both operands come from shared memory by descriptor
// (K-major, 128-byte swizzle): A [64, k16 bf16 or k32 int8], B [256, same].

__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129,"
      " p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129,"
      " p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---- the epilogue's stores -----------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane t of each quad holds w[i], the bf16 pair of columns 2t, 2t + 1 of
// 8-column block i (i = 0..3) of one row.  A 4 × 4 transpose within the
// quad (two shuffle rounds) leaves lane t the eight columns of block t, in
// order.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int lane) {
  const bool b0 = lane & 1, b1 = lane & 2;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, b0 ? w[0] : w[1], 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, b0 ? w[2] : w[3], 1);
  // even lanes now hold blocks 0 and 2 of lanes t, t + 1; odd ones 1 and 3 of t − 1, t
  const uint32_t h0 = b0 ? r0 : w[0], h1 = b0 ? w[1] : r0, h2 = b0 ? r1 : w[2], h3 = b0 ? w[3] : r1;
  r0 = __shfl_xor_sync(0xffffffffu, b1 ? h0 : h2, 2);
  r1 = __shfl_xor_sync(0xffffffffu, b1 ? h1 : h3, 2);
  w[0] = b1 ? r0 : h0;
  w[1] = b1 ? r1 : h1;
  w[2] = b1 ? h2 : r0;
  w[3] = b1 ? h3 : r1;
}

// Write a consumer thread's share of a 128 × 256 bf16 output tile straight
// from its accumulators.  value(j, col) gives the f32 results at columns
// col, col + 1 (col = n0 + 8j + 2·(lane % 4)) of rows `row` ({x, y}) and
// `row` + 8 ({z, w}); each is cast once to bf16.  Where N is a multiple of
// 8, quad_transpose gives every lane 8 consecutive columns of one row,
// stored as one 16-byte vector (a quad writes 64 contiguous bytes);
// otherwise columns are stored in pairs or one by one.  Rows past m and
// columns past n are not stored.
template <class Value>
__device__ __forceinline__ void store_tile(const Value& value, __nv_bfloat16* __restrict__ out, int row, int n0,
                                           int m, int n, int lane) {
  const int t = lane % 4;
  if (n % 8 == 0) {
#pragma unroll
    for (int q = 0; q < kBN / 32; ++q) {
      uint32_t w[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = value(4 * q + i, n0 + 32 * q + 8 * i + 2 * t);
        w[0][i] = pack_bf16(v.x, v.y);
        w[1][i] = pack_bf16(v.z, v.w);
      }
      const int col = n0 + 32 * q + 8 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        quad_transpose(w[h], lane);
        if (row + 8 * h < m && col < n)
          *reinterpret_cast<uint4*>(out + (size_t)(row + 8 * h) * n + col) =
              make_uint4(w[h][0], w[h][1], w[h][2], w[h][3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= n) continue;
      const float4 v = value(j, col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row + 8 * h >= m) continue;
        __nv_bfloat16* dst = out + (size_t)(row + 8 * h) * n + col;
        dst[0] = __float2bfloat16_rn(h ? v.z : v.x);
        if (col + 1 < n) dst[1] = __float2bfloat16_rn(h ? v.w : v.y);
      }
    }
  }
}

// The partial-sum epilogue: a consumer thread's f32 or i32 accumulators of
// a 128 × 256 tile stored as they are (row `row`: d[4j + e], row + 8:
// d[4j + 2 + e], columns n0 + 8j + 2·(lane % 4) + e), in pairs of 8 bytes
// where N is even, else one by one.  Rows past m and columns past n are not
// stored.
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
__device__ __forceinline__ void store_pair(int* p, int lo, int hi) { *reinterpret_cast<int2*>(p) = make_int2(lo, hi); }

template <class T>
__device__ __forceinline__ void store_acc(const T (&acc)[kBN / 2], T* __restrict__ out, int row, int n0, int m, int n,
                                          int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + 8 * h >= m) continue;
      T* dst = out + (size_t)(row + 8 * h) * n + col;
      if (n % 2 == 0) {  // col is even, so col + 1 < n and the pair is 8-byte aligned
        store_pair(dst, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        dst[0] = acc[4 * j + 2 * h];
        if (col + 1 < n) dst[1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

// ---- the kernel ---------------------------------------------------------------

// origin of output tile `tile` in the grouped order: kGroupM row tiles at
// a time, the row tile fastest, so the blocks in flight share W tiles
__device__ __forceinline__ void tile_origin(int tile, int m_tiles, int n_tiles, int& m0, int& n0) {
  const int per_group = kGroupM * n_tiles;
  const int first_m = (tile / per_group) * kGroupM;
  const int rows = min(m_tiles - first_m, kGroupM);
  const int in_group = tile % per_group;
  m0 = (first_m + in_group % rows) * kBM;
  n0 = (in_group / rows) * kBN;
}

constexpr int smem_bytes() {  // the ring, its 2·kStages barriers, 1024 of alignment slack
  return kStages * (kABytes + kWBytes) + 2 * kStages * 8 + 1024;
}

// Op supplies: kBK (K per stage: 128 bytes of A), kKSteps (wgmma k-steps per
// stage), Norm (its normalization, above), Acc (float or int), Params (the
// epilogue's arguments, Norm's too) and
//   void mma(Acc (&acc)[kBN / 2], uint64_t desc_a, uint64_t desc_b);
//   void epilogue(const Acc (&acc)[kBN / 2], const Params&, int row, int n0, int m, int n, int lane);
template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
ln_gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
               const typename Op::Params params, int m, int n, int k) {
  constexpr int S = kStages;
  static_assert(kABytes % 1024 == 0 && kWBytes % 1024 == 0, "swizzled boxes need 1024-byte alignment");

  extern __shared__ uint8_t smem_raw[];
  // aligned by an offset from the shared array, so that the compiler still
  // knows every pointer below is shared memory
  uint8_t* a_ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* w_ring = a_ring + S * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(w_ring + S * kWBytes);
  uint64_t* empty = full + S;

  const int m_tiles = (m + kBM - 1) / kBM;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int tiles = m_tiles * n_tiles;
  const int num_kb = (k + Op::kBK - 1) / Op::kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      uint32_t c = 0;  // K blocks issued so far, across tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, m_tiles, n_tiles, m0, n0);
        for (int kb = 0; kb < num_kb; ++kb, ++c) {
          const int s = c % S;
          mbar_wait(&empty[s], ((c / S) & 1) ^ 1);  // round 0 passes: the ring starts empty
          mbar_expect_tx(&full[s], kABytes + kWBytes);
          tma_load_2d(a_ring + s * kABytes, &a_map, &full[s], kb * Op::kBK, m0);
          tma_load_2d(w_ring + s * kWBytes, &w_map, &full[s], kb * Op::kBK, n0);
        }
      }
    }
  } else {
    // consumers: SS wgmma on the stage's A and W boxes, epilogue
    reg_alloc<kConsumerRegs>();
    const int lane = threadIdx.x % 32;
    const int r0 = 64 * wg + 16 * ((threadIdx.x / 32) % 4);  // the warp's first row of the tile
    const bool signals = threadIdx.x % 128 == 0;  // one arrival per warpgroup on "empty"
    uint32_t c = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, m_tiles, n_tiles, m0, n0);
      typename Op::Acc acc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
      for (int kb = 0; kb < num_kb; ++kb, ++c) {
        const int s = c % S;
        mbar_wait(&full[s], (c / S) & 1);
        const uint64_t desc_a = smem_desc_sw128(a_ring + s * kABytes + wg * 64 * kRowBytes);
        const uint64_t desc_b = smem_desc_sw128(w_ring + s * kWBytes);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < Op::kKSteps; ++ks) Op::mma(acc, desc_a + 2 * ks, desc_b + 2 * ks);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operands(acc);
        // the previous stage's wgmmas completed: release it to the producer
        if (kb > 0 && signals) mbar_arrive(&empty[(c - 1) % S]);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (signals) mbar_arrive(&empty[(c - 1) % S]);
      Op::epilogue(acc, params, m0 + r0 + lane / 4, n0, m, n, lane);
    }
  }
}

// ---- host side ------------------------------------------------------------------

// map of the first `cols` columns of a row-major [rows, ld] matrix (ld ·
// elem_bytes a multiple of 16) read in [box_rows, box_cols] boxes with
// 128-byte swizzle (box_cols · elem_bytes == 128); zero fill past the edges
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
                             int rows, int cols, int ld, int box_rows, int box_cols) {
  PFN_cuTensorMapEncodeTiled encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Bytes of the scratch the wrapper allocates: [μ (m), 1/σ (m)] f32, then
// the A buffer [m, a_ld] 16-byte aligned (a_ld: 2k for bf16, k rounded up to
// 16 for int8).
inline size_t a_offset(int m) { return ((size_t)8 * m + 15) / 16 * 16; }

// The normalization pass, then the GEMM, on `stream`.  x: [m, k] bf16
// (k % 8 == 0), w: [n, w_ld] with w_type (w_ld >= k, a 16-byte row; columns
// past k are not read), gamma/beta: [k] bf16, stats: [μ (m), 1/σ (m)] f32 of
// the caller or NULL, scratch: as a_offset says.
template <class Op>
cudaError_t launch(const void* x, const void* gamma, const void* beta, const void* w,
                   CUtensorMapDataType w_type, int w_ld, const float* stats, void* scratch,
                   const typename Op::Params& params, int m, int n, int k, float eps, int device,
                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (m <= 0 || n <= 0 || k <= 0 || tiles > 0x7fffffff) return cudaErrorInvalidValue;
  using Norm = typename Op::Norm;
  constexpr int kElem = Norm::kElemBytes;
  const int a_ld = kElem == 2 ? 2 * k : (k + 15) / 16 * 16;  // bytes
  uint8_t* a = static_cast<uint8_t*>(scratch) + a_offset(m);
  const int w_elem = w_type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 1;
  const CUtensorMapDataType a_type = kElem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap a_map, w_map;
  if ((err = encode_2d(&a_map, a_type, kElem, a, m, k, a_ld / kElem, kBM, kRowBytes / kElem)) != cudaSuccess ||
      (err = encode_2d(&w_map, w_type, w_elem, w, n, k, w_ld, kBN, kRowBytes / w_elem)) != cudaSuccess)
    return err;
  constexpr int kSmem = smem_bytes();
  err = cudaFuncSetAttribute(ln_gemm_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  ln_normalize_kernel<Norm><<<(m + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta), stats, static_cast<float*>(scratch), a, a_ld, m, k, eps, params);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_gemm_kernel<Op><<<(int)(tiles < sms ? tiles : sms), kThreads, kSmem, stream>>>(a_map, w_map, params, m, n, k);
  return cudaGetLastError();
}

}  // namespace ln_gemm
}  // namespace
