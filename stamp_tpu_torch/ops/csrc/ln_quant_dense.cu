// LayerNorm → int8 quantize → int8 matmul → dequantize, as one op (W8A8):
//   y   = cast_bf16(LN_f32(x)·γ + β)
//   q   = clip(rint(y · (127 / s_x)), −127, 127)              (int8)
//   out = cast_bf16(Σ_k q·W_q (i32) · (s_x / 127) · w_scale[n] + dense_bias[n])
//
// Replaces: stamp_tpu/ops/ln_dense.py:377 `ln_quant_dense` (Pallas call in
// `_ln_quant_dense_pallas`, :312) and its body `_ln_quant_dense_kernel`
// (:255), forward only.
//
// What bounds it on the H100: int8 tensor-core operations.  At the UNI2
// sites (M = 64·265 = 16,960 rows; K×N = 1536×4608, 1536×8192, 4096×1536)
// the product is 2·M·K·N = 213 to 427 G int8 operations, 0.11 to 0.22 ms at
// the 1,979 TOPS peak, against 200 to 340 MB of bf16 x, int8 weights and
// bf16 output (0.06 to 0.10 ms at 3.35 TB/s).  The int8 A the statistics
// pass writes (M·K bytes) halves the activation bytes the GEMM reads.
//
// What the design does about it: ln_dense.cu's Hopper core
// (ln_gemm_sm90.cuh) with an int8 A.  The row-statistics pass quantizes each
// element once: it normalizes the row's raw x in f32 with every step
// rounded on its own (no FMA contraction, as the plain version's separate
// operations), rounds to bf16, multiplies by 127/s_x (formed in f32 first),
// clamps to ±127, rounds half to even (as jnp.round and torch.round: see
// quantize4) and writes the int8 A [M, K] (rows padded to 16 bytes) to a
// scratch.  The GEMM reads A [128, 128] and W_q [256, 128] int8 boxes
// (128-byte swizzle) into a 4-stage ring and runs wgmma m64n256k32
// s8·s8 → s32 with both operands from shared memory (K-major).  The i32
// sums are exact.  The epilogue converts them to f32 (rounded), multiplies
// by s_x/127 and w_scale, adds the dense bias in f32 and casts once to
// bf16.  s_x is read on the device: the host never waits for it.
//
// As ln_dense.cu, two more entry forms serve tensor parallelism: the rows'
// μ and 1/σ given by the caller, and the partial-sum epilogue
// (LnQuantDenseOp<true>), which writes this K slice's exact i32 sums with
// no scale, no bias and no cast; the caller all-reduces them (still exact)
// and dequantizes once.

#include "ln_gemm_sm90.cuh"

namespace {

__device__ __forceinline__ float bf16_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t pair) { return __uint_as_float(pair & 0xffff0000u); }

// Four raw bf16 x of one row → LayerNorm in f32 → bf16 → int8, packed low
// column first.  Rounding half to even and the clamp to ±127 without a
// float-to-int conversion (a quarter-rate instruction): clamped to
// [−127, 127] first (the same result as rounding first), v + 1.5·2²³ is
// rounded to an integer by the f32 add itself, and the low byte of its bit
// pattern is the two's-complement int8.
__device__ __forceinline__ uint32_t quantize4(uint2 raw, const float* g, const float* b, float mean, float rstd,
                                              float inv) {
  const float x[4] = {bf16_lo(raw.x), bf16_hi(raw.x), bf16_lo(raw.y), bf16_hi(raw.y)};
  float y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) y[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x[e], mean), rstd), g[e]), b[e]);
  uint32_t q[4];
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    __nv_bfloat162 yb = __floats2bfloat162_rn(y[e], y[e + 1]);  // the cast to x.dtype
    const uint32_t pair = *reinterpret_cast<uint32_t*>(&yb);
    const float yy[2] = {bf16_lo(pair), bf16_hi(pair)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = fminf(fmaxf(__fmul_rn(yy[i], inv), -127.0f), 127.0f);
      q[e + i] = __float_as_uint(__fadd_rn(v, 12582912.0f));
    }
  }
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

struct LnQuantDenseParams {
  const float* s_x;           // [1], on the device
  const float* w_scale;       // [n]
  const __nv_bfloat16* bias;  // [n] or NULL (NULL in the partial-sum form)
  void* out;                  // [m, n]: bf16, or the i32 sums in the partial-sum form
};

// the normalization pass's part: 8 columns of a row of A, two quantize4,
// low column first
struct LnQuantNorm {
  static constexpr int kElemBytes = 1;
  using Params = LnQuantDenseParams;

  __device__ static float factor(const Params& p) { return __fdiv_rn(127.0f, p.s_x[0]); }

  __device__ static void apply8(uint8_t* a, uint4 raw, const __nv_bfloat16* gamma, const __nv_bfloat16* beta,
                                float mean, float rstd, float inv) {
    float g[8], b[8];
    ln_gemm::affine8(gamma, beta, g, b);
    *reinterpret_cast<uint2*>(a) = make_uint2(quantize4(make_uint2(raw.x, raw.y), g, b, mean, rstd, inv),
                                              quantize4(make_uint2(raw.z, raw.w), g + 4, b + 4, mean, rstd, inv));
  }
};

template <bool kPartial>
struct LnQuantDenseOp {
  static constexpr int kBK = 128;    // one 128-byte box row of int8
  static constexpr int kKSteps = 4;  // wgmma k32 steps per stage
  using Norm = LnQuantNorm;
  using Acc = int;
  using Params = LnQuantDenseParams;

  __device__ static void mma(int (&acc)[ln_gemm::kBN / 2], uint64_t desc_a, uint64_t desc_b) {
    ln_gemm::wgmma_s8_n256(acc, desc_a, desc_b, 1);
  }

  // exact i32 sums → f32 · s_x/127 · w_scale + dense bias, one cast (the
  // partial-sum form: the i32 sums as they are)
  __device__ static void epilogue(const int (&acc)[ln_gemm::kBN / 2], const Params& p, int row, int n0, int m, int n,
                                  int lane) {
    if constexpr (kPartial) {
      ln_gemm::store_acc(acc, static_cast<int*>(p.out), row, n0, m, n, lane);
      return;
    }
    const float dequant = __fdiv_rn(p.s_x[0], 127.0f);
    ln_gemm::store_tile(
        [&](int j, int col) {
          float s[2] = {0.0f, 0.0f}, b[2] = {0.0f, 0.0f};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e < n) {
              s[e] = p.w_scale[col + e];
              if (p.bias != nullptr) b[e] = __bfloat162float(p.bias[col + e]);
            }
          }
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + i]), dequant), s[i % 2]);
            if (p.bias != nullptr) v[i] = __fadd_rn(v[i], b[i % 2]);
          }
          return make_float4(v[0], v[1], v[2], v[3]);
        },
        static_cast<__nv_bfloat16*>(p.out), row, n0, m, n, lane);
  }
};

}  // namespace

extern "C" {

// x: [m, k] bf16; gamma, beta: [k] bf16; s_x: [1] f32 (device); w:
// [n, k16] int8 (nn.Linear layout, its rows padded to k16 = k rounded up to
// 16, the 16-byte row TMA needs; the columns past k are not read);
// w_scale: [n] f32; dense_bias: [n] bf16 or NULL; stats: [μ (m), 1/σ (m)]
// f32 or NULL (then computed here and written to the scratch's head);
// scratch: [μ (m), 1/σ (m)] f32, then the int8 A [m, k16] at byte 8m
// rounded up to 16; out: [m, n] bf16, or with `partial` the i32 sums
// (dense_bias NULL).  All contiguous, 16-byte aligned, k a multiple of 8.
// Launches the normalization pass and the GEMM on `stream`.  Returns a
// cudaError_t.
int stamp_ln_quant_dense(const void* x, const void* gamma, const void* beta, const void* s_x,
                         const void* w, const void* w_scale, const void* dense_bias, const void* stats,
                         void* scratch, void* out, int partial, int m, int n, int k, float eps, int device,
                         void* stream) {
  if (k % 8 != 0 || (partial && dense_bias != nullptr)) return cudaErrorInvalidValue;
  const LnQuantDenseParams p{static_cast<const float*>(s_x), static_cast<const float*>(w_scale),
                             static_cast<const __nv_bfloat16*>(dense_bias), out};
  const float* given = static_cast<const float*>(stats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr CUtensorMapDataType kW = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const int w_ld = (k + 15) / 16 * 16;
  return partial ? ln_gemm::launch<LnQuantDenseOp<true>>(x, gamma, beta, w, kW, w_ld, given, scratch, p, m, n, k, eps,
                                                         device, s)
                 : ln_gemm::launch<LnQuantDenseOp<false>>(x, gamma, beta, w, kW, w_ld, given, scratch, p, m, n, k,
                                                          eps, device, s);
}

}  // extern "C"
