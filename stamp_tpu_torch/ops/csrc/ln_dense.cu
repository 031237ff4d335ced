// LayerNorm fused into the matmul that consumes it:
//   out = cast(cast(LN_f32(x)·γ + β) @ Wᵀ + dense_bias)
//
// Replaces: stamp_tpu/ops/ln_dense.py:185 `ln_dense` (Pallas call in
// `_ln_dense_pallas`, :87) and its body `_ln_dense_kernel` (:70).
//
// What bounds it on the H100: tensor-core operations.  At the UNI2 sites
// (M = 64·265 = 16,960 rows; K×N = 1536×4608, 1536×8192, 4096×1536) the
// product is 2·M·K·N = 213 to 427 GFLOP against 200 to 360 MB of operands
// and output, about 1,000 FLOP per byte: far above the ~295 at which bf16
// turns compute-bound.  The unfused form adds a LayerNorm pass that writes
// the normalized activation [M, K] to device memory and reads it back.
//
// What the design does about it (ln_gemm_sm90.cuh): the Pallas kernel
// normalizes a row block once into VMEM and reuses it for every output
// tile; a 128 × K normalized block does not fit an H100 block's shared
// memory, so the LayerNorm is applied again per output tile, in registers,
// to the wgmma A fragment: a few FMAs per element while the previous wgmma
// runs.  Row statistics are reduced once per row by a small kernel.  TMA
// feeds raw x [128, 64] and W [256, 64] bf16 boxes (128-byte swizzle) to a
// 4-stage ring; two consumer warpgroups run
// wgmma m64n256k16 bf16 → f32 with A from registers; the epilogue adds the
// dense bias in f32 and casts once to bf16 from the accumulators.  The
// LayerNorm is (x·(1/σ) − μ/σ)·γ + β in two FMAs; the plain version rounds
// x − μ and the product separately, which moves y by an f32 ulp or two,
// far below the bf16 cast that follows.

#include "ln_gemm_sm90.cuh"

namespace {

// f32 LayerNorm of a pair of raw bf16 values of one row, cast to bf16x2:
// (x − μ)·(1/σ) as one FMA, x·(1/σ) + (−μ/σ) (shift = −μ/σ of the row)
__device__ __forceinline__ uint32_t ln_pair(uint32_t raw, float rstd, float shift, float2 g, float2 b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  return ln_gemm::pack_bf16(fmaf(fmaf(x.x, rstd, shift), g.x, b.x), fmaf(fmaf(x.y, rstd, shift), g.y, b.y));
}

struct LnDenseOp {
  static constexpr int kBK = 64;      // one 128-byte box row of bf16
  static constexpr int kKSteps = 4;   // wgmma k16 steps per stage
  static constexpr int kXBoxes = 1;
  static constexpr int kStages = 4;  // 48 KB a stage
  using Acc = float;
  struct Params {
    const __nv_bfloat16* bias;  // [n] or NULL
    __nv_bfloat16* out;         // [m, n]
  };

  __device__ static float factor(const Params&) { return 0.0f; }

  // A fragment of k-step ks (columns 16·ks ..): ldmatrix.x4 of the raw x
  // (lane l addresses row r0 + l % 16, 16-byte chunk 2·ks + l / 16, so the
  // four matrices are mma's a0..a3), then the LayerNorm in f32
  __device__ static void load_a(uint32_t (&a)[4], const uint8_t* xs, const float* gb, int ks,
                                const ln_gemm::Frag& f) {
    uint32_t raw[4];
    ln_gemm::ldmatrix_x4(raw, xs + ln_gemm::swz(f.r0 + (f.lane & 15), 2 * ks + (f.lane >> 4)));
    const int c = 16 * ks + 2 * (f.lane % 4);
    const float2 g_lo = *reinterpret_cast<const float2*>(gb + c), g_hi = *reinterpret_cast<const float2*>(gb + c + 8);
    const float2 b_lo = *reinterpret_cast<const float2*>(gb + kBK + c);
    const float2 b_hi = *reinterpret_cast<const float2*>(gb + kBK + c + 8);
    const float shift[2] = {-f.mean[0] * f.rstd[0], -f.mean[1] * f.rstd[1]};
    a[0] = ln_pair(raw[0], f.rstd[0], shift[0], g_lo, b_lo);
    a[1] = ln_pair(raw[1], f.rstd[1], shift[1], g_lo, b_lo);
    a[2] = ln_pair(raw[2], f.rstd[0], shift[0], g_hi, b_hi);
    a[3] = ln_pair(raw[3], f.rstd[1], shift[1], g_hi, b_hi);
  }

  __device__ static void mma(float (&acc)[ln_gemm::kBN / 2], const uint32_t (&a)[4], uint64_t desc) {
    ln_gemm::wgmma_bf16_n256(acc, a, desc, 1);
  }

  // f32 accumulators + f32 dense bias, one cast to bf16
  __device__ static void epilogue(const float (&acc)[ln_gemm::kBN / 2], const Params& p, int row, int n0, int m, int n,
                                  int lane) {
    ln_gemm::store_tile(
        [&](int j, int col) {
          float2 b = make_float2(0.0f, 0.0f);
          if (p.bias != nullptr && col < n) {
            b.x = __bfloat162float(p.bias[col]);
            if (col + 1 < n) b.y = __bfloat162float(p.bias[col + 1]);
          }
          return make_float4(acc[4 * j] + b.x, acc[4 * j + 1] + b.y, acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
        },
        p.out, row, n0, m, n, lane);
  }
};

}  // namespace

extern "C" {

// x: [m, k] bf16; gamma, beta: [k] bf16; w: [n, k] bf16 (nn.Linear layout);
// dense_bias: [n] bf16 or NULL; scratch: [2k + 2m] f32; out: [m, n] bf16.
// All contiguous, 16-byte aligned, k a multiple of 8.  Launches the row
// statistics and the GEMM on `stream`.  Returns a cudaError_t.
int stamp_ln_dense(const void* x, const void* gamma, const void* beta, const void* w,
                   const void* dense_bias, void* scratch, void* out, int m, int n, int k, float eps,
                   int device, void* stream) {
  if (k % 8 != 0) return cudaErrorInvalidValue;
  return ln_gemm::launch<LnDenseOp>(
      x, gamma, beta, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, static_cast<float*>(scratch),
      {static_cast<const __nv_bfloat16*>(dense_bias), static_cast<__nv_bfloat16*>(out)}, m, n, k, eps, device,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
