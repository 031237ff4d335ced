// Device helpers shared by the flash-attention kernels (flash_attn.cu,
// flash_attn_bwd.cu): TF32 conversion, the m16n8k8 TF32 tensor-core
// product, staging a row tile in shared memory, and the f32-accurate
// distance-weighted value sum D·V of spatial ALiBi.
//
// Fragment layout of mma.sync m16n8k8 (g = lane / 4, t = lane % 4):
//   a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];  b = B[t][g], B[t+4][g];
//   c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
// A C fragment over 8 columns becomes the A fragment of a product whose
// depth runs over those columns when the depth is taken in the order
// (0, 2, 4, 6, 1, 3, 5, 7): a = (c0, c2, c1, c3), and B rows are read in
// that order (rows 2t and 2t + 1 of the 8-step).  Every kernel here uses
// this to chain a score tile into the next product without a shuffle.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += a·b for one 16×8×8 TF32 tile.
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// rows [row0, row0 + kRows) of an [n, D] f32 matrix into shared memory with
// row stride D + 4 floats (so that the fragment loads above are free of
// bank conflicts), 16 bytes a thread; rows >= n are zero.  With `tf32`,
// values are stored rounded to TF32.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n,
                                          bool tf32) {
  constexpr int kLd = D + 4;
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (long)(row0 + r) * D + c);
    if (tf32) {
      val.x = __uint_as_float(to_tf32(val.x));
      val.y = __uint_as_float(to_tf32(val.y));
      val.z = __uint_as_float(to_tf32(val.z));
      val.w = __uint_as_float(to_tf32(val.w));
    }
    *reinterpret_cast<float4*>(dst + r * kLd + c) = val;
  }
}

// tile[n] += Σ_key ‖(cx, cy)[row] − c_key‖ · V[key][(n0 + n)·8 + g] over the
// 64 keys staged in shared memory (cks [64][2], valid [64], vs [64][kLd],
// f32 not rounded), for this thread's rows (row g and g + 8 of its warp's
// 16).  Distances come from per-axis differences with no contraction into
// FMA, so they equal a plain f32 evaluation; a key with valid == 0 weighs 0.
// The product is a 3×TF32 split (D_hi·V_hi + D_hi·V_lo + D_lo·V_hi), with D
// laid out as a score fragment (see the top of this file).  The caller sums
// `tile` over one key tile only and adds it to its total with rounded f32
// adds: the tensor cores' f32 accumulation does not round to nearest, so
// over a whole key loop its error would grow with the key count.
template <int kLd, int kChunk>
__device__ __forceinline__ void dist_dv_tile(float (&tile)[kChunk][4], const float (&cx)[2],
                                             const float (&cy)[2], const float* cks,
                                             const float* valid, const float* vs, int n0,
                                             int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * t + (e & 1);
      const float dx = cx[e >> 1] - cks[2 * key];
      const float dy = cy[e >> 1] - cks[2 * key + 1];
      const float dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      const float d = valid[key] > 0.f ? dist : 0.f;
      hi[e] = to_tf32(d);
      lo[e] = to_tf32(d - __uint_as_float(hi[e]));
    }
    const float* v0 = vs + (j * 8 + 2 * t) * kLd;
    const float* v1 = v0 + kLd;
#pragma unroll
    for (int n = 0; n < kChunk; ++n) {
      const float x0 = v0[(n0 + n) * 8 + g], x1 = v1[(n0 + n) * 8 + g];
      const uint32_t h0 = to_tf32(x0), h1 = to_tf32(x1);
      const uint32_t l0 = to_tf32(x0 - __uint_as_float(h0));
      const uint32_t l1 = to_tf32(x1 - __uint_as_float(h1));
      mma_tf32(tile[n], hi[0], hi[2], hi[1], hi[3], h0, h1);
      mma_tf32(tile[n], hi[0], hi[2], hi[1], hi[3], l0, l1);
      mma_tf32(tile[n], lo[0], lo[2], lo[1], lo[3], h0, h1);
    }
  }
}

}  // namespace
