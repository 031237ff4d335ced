// LayerNorm → int8 quantize → int8 matmul → dequantize, as one kernel (W8A8):
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
// bf16 output (0.06 to 0.10 ms at 3.35 TB/s).  The unfused form adds a
// LayerNorm pass and an int8 round trip of the activation through device
// memory.
//
// What the design does about it: ln_dense.cu's Hopper core
// (ln_gemm_sm90.cuh) with an int8 A transform.  A stage holds a 128-wide K
// block: two raw x boxes [128, 64] bf16 and one W_q box [256, 128] int8
// (128-byte swizzle), 3 stages.  Per wgmma k32 step a
// consumer thread reads its 16 raw x values (8-byte loads from the swizzled
// box), normalizes them in f32 with every step rounded on its own (no FMA
// contraction, as the plain version's separate operations), rounds to bf16,
// multiplies by 127/s_x (formed in f32 first), clamps to ±127, rounds half
// to even (as jnp.round and torch.round: see quantize4) and packs four int8
// into each A register of wgmma m64n256k32 s8·s8 → s32 (both
// operands K-major).  The i32 sums are exact.  The epilogue converts them
// to f32 (rounded), multiplies by s_x/127 and w_scale, adds the dense bias
// in f32 and casts once to bf16.  s_x is read on the device: the host never
// waits for it.
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
__device__ __forceinline__ uint32_t quantize4(uint2 raw, const float (&g)[4], const float (&b)[4], float mean,
                                              float rstd, float inv) {
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

template <bool kPartial>
struct LnQuantDenseOp {
  static constexpr int kBK = 128;     // one 128-byte box row of int8 W
  static constexpr int kKSteps = 4;   // wgmma k32 steps per stage
  static constexpr int kXBoxes = 2;   // two 64-column bf16 boxes of raw x
  static constexpr int kStages = 3;  // 65 KB a stage
  using Acc = int;
  using Params = LnQuantDenseParams;

  __device__ static float factor(const Params& p) { return __fdiv_rn(127.0f, p.s_x[0]); }

  // A fragment of k-step ks (columns 32·ks .. of the stage): register
  // h + 2·half holds row g + 8h, columns 32·ks + 16·half + 4t .. +3, read as
  // 8 bytes from x box ks / 2 (g = lane / 4, t = lane % 4)
  __device__ static void load_a(uint32_t (&a)[4], const uint8_t* xs, const float* gb, int ks,
                                const ln_gemm::Frag& f) {
    const uint8_t* box = xs + (ks >> 1) * ln_gemm::kXBoxBytes;
    const int t = f.lane % 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = (ks & 1) * 32 + 16 * half + 4 * t;  // within the 64-column box
      const int kcol = 32 * ks + 16 * half + 4 * t;       // within the stage
      const float4 g4 = *reinterpret_cast<const float4*>(gb + kcol);
      const float4 b4 = *reinterpret_cast<const float4*>(gb + kBK + kcol);
      const float g[4] = {g4.x, g4.y, g4.z, g4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.r0 + f.lane / 4 + 8 * h;
        const uint2 raw = *reinterpret_cast<const uint2*>(box + ln_gemm::swz(row, col / 8) + (col % 8) * 2);
        a[h + 2 * half] = quantize4(raw, g, b, f.mean[h], f.rstd[h], f.factor);
      }
    }
  }

  __device__ static void mma(int (&acc)[ln_gemm::kBN / 2], const uint32_t (&a)[4], uint64_t desc) {
    ln_gemm::wgmma_s8_n256(acc, a, desc, 1);
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
// f32 or NULL (then computed here); scratch: [2k] f32 with stats, else
// [2k + 2m]; out: [m, n] bf16, or with `partial` the i32 sums (dense_bias
// NULL).  All contiguous, 16-byte aligned, k a multiple of 8.  Launches the
// row statistics (or γ, β's conversion alone) and the GEMM on `stream`.
// Returns a cudaError_t.
int stamp_ln_quant_dense(const void* x, const void* gamma, const void* beta, const void* s_x,
                         const void* w, const void* w_scale, const void* dense_bias, const void* stats,
                         void* scratch, void* out, int partial, int m, int n, int k, float eps, int device,
                         void* stream) {
  if (k % 8 != 0 || (partial && dense_bias != nullptr)) return cudaErrorInvalidValue;
  const LnQuantDenseParams p{static_cast<const float*>(s_x), static_cast<const float*>(w_scale),
                             static_cast<const __nv_bfloat16*>(dense_bias), out};
  const float* given = static_cast<const float*>(stats);
  float* f32_scratch = static_cast<float*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr CUtensorMapDataType kW = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const int w_ld = (k + 15) / 16 * 16;
  return partial ? ln_gemm::launch<LnQuantDenseOp<true>>(x, gamma, beta, w, kW, w_ld, given, f32_scratch, p, m, n,
                                                         k, eps, device, s)
                 : ln_gemm::launch<LnQuantDenseOp<false>>(x, gamma, beta, w, kW, w_ld, given, f32_scratch, p, m,
                                                          n, k, eps, device, s);
}

}  // extern "C"
