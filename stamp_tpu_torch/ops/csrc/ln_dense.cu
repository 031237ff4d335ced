// LayerNorm and the matmul that consumes it, as one op:
//   out = cast(cast(LN_f32(x)·γ + β) @ Wᵀ + dense_bias)
//
// Replaces: stamp_tpu/ops/ln_dense.py:185 `ln_dense` (Pallas call in
// `_ln_dense_pallas`, :87) and its body `_ln_dense_kernel` (:70).
//
// What bounds it on the H100: tensor-core operations.  At the UNI2 sites
// (M = 64·265 = 16,960 rows; K×N = 1536×4608, 1536×8192, 4096×1536) the
// product is 2·M·K·N = 213 to 427 GFLOP against 200 to 360 MB of operands
// and output, about 1,000 FLOP per byte: far above the ~295 at which bf16
// turns compute-bound.  A LayerNorm apart from the statistics would read x
// once more; here the pass that reads x for μ and 1/σ writes A (2·M·K
// bytes) from the same registers, and the GEMM reads A where it read x.
//
// What the design does about it (ln_gemm_sm90.cuh): the Pallas kernel
// normalizes a row block once into VMEM and reuses it for every output
// tile; a 128 × K normalized block does not fit an H100 block's shared
// memory, and normalizing it again per output tile repeats the LayerNorm
// N / 256 times (18 at qkv, 32 at fc1).  So the row-statistics pass, which
// holds each row in registers, normalizes it once, in f32, and writes the
// bf16 A [M, K] to a scratch; the GEMM reads it by TMA.  The GEMM: A
// [128, 64] and W [256, 64] bf16 boxes (128-byte swizzle) in a 4-stage
// ring, two consumer warpgroups running wgmma m64n256k16 bf16 → f32 with
// both operands from shared memory; the epilogue adds the dense bias in
// f32 and casts once to bf16 from the accumulators.  The LayerNorm is
// (x·(1/σ) − μ/σ)·γ + β in two FMAs; the plain version rounds x − μ and
// the product separately, which moves y by an f32 ulp or two, far below the
// bf16 cast that follows.
//
// Two more entry forms serve tensor parallelism (parallel/tp_extractor.py),
// at SwiGLU's fc2, whose inner LayerNorm runs over a K sharded across
// ranks: the rows' μ and 1/σ given by the caller (all-reduced sums of the
// K slices), and the partial-sum epilogue (LnDenseOp<true>), which writes
// the f32 accumulators of this K slice with no bias and no cast, for the
// caller to all-reduce before adding the bias and casting once.

#include "ln_gemm_sm90.cuh"

namespace {

// f32 LayerNorm of a pair of raw bf16 values of one row, cast to bf16x2:
// (x − μ)·(1/σ) as one FMA, x·(1/σ) + (−μ/σ) (shift = −μ/σ of the row)
__device__ __forceinline__ uint32_t ln_pair(uint32_t raw, float rstd, float shift, float2 g, float2 b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  return ln_gemm::pack_bf16(fmaf(fmaf(x.x, rstd, shift), g.x, b.x), fmaf(fmaf(x.y, rstd, shift), g.y, b.y));
}

struct LnDenseParams {
  const __nv_bfloat16* bias;  // [n] or NULL (NULL in the partial-sum form)
  void* out;                  // [m, n]: bf16, or the f32 accumulators in the partial-sum form
};

// the normalization pass's part: 8 columns of a row of A, raw x
// normalized in f32 and cast to bf16
struct LnDenseNorm {
  static constexpr int kElemBytes = 2;
  using Params = LnDenseParams;

  __device__ static float factor(const Params&) { return 0.0f; }

  __device__ static void apply8(uint8_t* a, uint4 raw, const __nv_bfloat16* gamma, const __nv_bfloat16* beta,
                                float mean, float rstd, float) {
    float g[8], b[8];
    ln_gemm::affine8(gamma, beta, g, b);
    const float shift = -mean * rstd;
    const uint32_t pairs[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      y[i] = ln_pair(pairs[i], rstd, shift, make_float2(g[2 * i], g[2 * i + 1]), make_float2(b[2 * i], b[2 * i + 1]));
    *reinterpret_cast<uint4*>(a) = make_uint4(y[0], y[1], y[2], y[3]);
  }
};

template <bool kPartial>
struct LnDenseOp {
  static constexpr int kBK = 64;     // one 128-byte box row of bf16
  static constexpr int kKSteps = 4;  // wgmma k16 steps per stage
  using Norm = LnDenseNorm;
  using Acc = float;
  using Params = LnDenseParams;

  __device__ static void mma(float (&acc)[ln_gemm::kBN / 2], uint64_t desc_a, uint64_t desc_b) {
    ln_gemm::wgmma_bf16_n256(acc, desc_a, desc_b, 1);
  }

  // f32 accumulators + f32 dense bias, one cast to bf16 (the partial-sum
  // form: the f32 accumulators as they are)
  __device__ static void epilogue(const float (&acc)[ln_gemm::kBN / 2], const Params& p, int row, int n0, int m, int n,
                                  int lane) {
    if constexpr (kPartial) {
      ln_gemm::store_acc(acc, static_cast<float*>(p.out), row, n0, m, n, lane);
      return;
    }
    ln_gemm::store_tile(
        [&](int j, int col) {
          float2 b = make_float2(0.0f, 0.0f);
          if (p.bias != nullptr && col < n) {
            b.x = __bfloat162float(p.bias[col]);
            if (col + 1 < n) b.y = __bfloat162float(p.bias[col + 1]);
          }
          return make_float4(acc[4 * j] + b.x, acc[4 * j + 1] + b.y, acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
        },
        static_cast<__nv_bfloat16*>(p.out), row, n0, m, n, lane);
  }
};

}  // namespace

extern "C" {

// x: [m, k] bf16; gamma, beta: [k] bf16; w: [n, k] bf16 (nn.Linear layout);
// dense_bias: [n] bf16 or NULL; stats: [μ (m), 1/σ (m)] f32 or NULL (then
// computed here and written to the scratch's head); scratch: [μ (m), 1/σ
// (m)] f32, then the normalized A [m, k] bf16 at byte 8m rounded up to 16;
// out: [m, n] bf16, or with `partial` the f32 accumulators (dense_bias
// NULL).  All contiguous, 16-byte aligned, k a multiple of 8.  Launches the
// normalization pass and the GEMM on `stream`.  Returns a cudaError_t.
int stamp_ln_dense(const void* x, const void* gamma, const void* beta, const void* w,
                   const void* dense_bias, const void* stats, void* scratch, void* out, int partial, int m, int n,
                   int k, float eps, int device, void* stream) {
  if (k % 8 != 0 || (partial && dense_bias != nullptr)) return cudaErrorInvalidValue;
  const LnDenseParams p{static_cast<const __nv_bfloat16*>(dense_bias), out};
  const float* given = static_cast<const float*>(stats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr CUtensorMapDataType kW = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return partial
             ? ln_gemm::launch<LnDenseOp<true>>(x, gamma, beta, w, kW, k, given, scratch, p, m, n, k, eps, device, s)
             : ln_gemm::launch<LnDenseOp<false>>(x, gamma, beta, w, kW, k, given, scratch, p, m, n, k, eps, device, s);
}

}  // extern "C"
