// Multi-head softmax attention read straight off a packed qkv projection.
//
// Replaces: stamp_tpu/ops/flash_attention.py:589 `fused_qkv_mha`, whose
// Pallas bodies are `_fused_qkv_attn_kernel` (:535) and
// `_fused_qkv_attn_kernel_interleaved` (:501).
//
// What it computes (the Pallas kernel's order of operations): s = q·kᵀ
// summed in f32, scaled by d^-1/2 in f32 after the dot; the exact softmax
// over all N keys (the true row max m, l = Σ exp(s − m) in f32, p =
// exp(s − m) / l in f32); p cast to bf16 before P·V; P·V summed in f32 and
// cast once.  Keys >= N contribute 0.
//
// What bounds it on the H100: device-memory bytes.  At UNI2's shape (batch
// 64, N = 265, 24 heads of 64) the kernel must read the packed qkv
// [B, N, 3·H·d] once and write [B, N, H·d] once: 156 MB + 52 MB, 0.062 ms
// at 3.35 TB/s.  Its products are 4·B·H·N²·d = 27.6 GFLOP, 0.028 ms at
// 989 TFLOP/s bf16.
//
// What the design does about it (the one-pass form, N <= kMaxKeys = 272):
//   * one block of 4 warps per (batch, head).  It stages its head's K and V
//     rows in shared memory once, with 16-byte cp.async copies straight out
//     of the packed tensor (rows past N zero-filled), K in 64-key groups,
//     then V.  So each byte of qkv is read from device memory once.
//   * a warp owns 16 query rows at a time (tiles w, w + 4, ... of the
//     head's ceil(N/16)), its q rows loaded from global memory into
//     mma.sync A fragments; the next tile's q is loaded while this one's
//     softmax and P·V run.  In its first tile the warp multiplies each
//     64-key group as soon as that group has landed, while the rest (and V)
//     are still in flight.
//   * the scores stay in registers: S = q·kᵀ for all keys of the 16 rows
//     (mma.sync m16n8k16 bf16, f32 accumulate; K fragments by ldmatrix),
//     136 f32 a thread at 272 keys.  Row max and sum by quad shuffles over
//     four partial chains; one exp a score; p = exp(s − m) · (1 / l) in f32
//     (the reciprocal taken once a row: within an ulp of the divide, before
//     a bf16 rounding) packed to bf16 straight into the A fragments of P·V
//     (the m16n8k16 accumulator layout is its A layout); V fragments by
//     ldmatrix.trans.  One pass over the keys; no score or probability in
//     shared memory.
//   * the exponent is exp2(s·(d^-1/2·log2 e) − m·(d^-1/2·log2 e)), one FMA
//     and one ex2 a score.
//   * the kernel is built for 4, 8, 13 and 17 key steps of 16 (kStepCounts;
//     N = 197 takes 13, N = 257–265 takes 17), so every loop over keys has a
//     count the compiler knows and no branch splits the products.
//   * O is cast to bf16 and written with 16-byte stores after a quad
//     transpose (ln_gemm_sm90.cuh), pairs for d = 80's last 16 columns.
//   Occupancy: __launch_bounds__(128, 2), two blocks an SM (78 KB of shared
//   memory a block at 17 steps, d = 64; 96 KB at d = 80).  What bounds it
//   now is shared memory: every 16-row warp tile reads all of its head's K
//   and V through ldmatrix (70 KB a tile at UNI2's shape), which
//   scripts/fused_qkv_attn_probe.py shows as most of its time.
//
// Longer sequences (N > kMaxKeys, at d = 64 and 80; CONCH's and CONCH1.5's
// 785 tokens) are fused_qkv_long.cu's: a TMA-fed bf16 wgmma kernel in
// two passes over key tiles, the same semantics.  The wrapper
// (ops/flash_attention.py) picks the entry point by N; this one refuses
// N > kMaxKeys.

#include <cmath>

#include "ln_gemm_sm90.cuh"

namespace {

// ---- the one-pass form ----------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxKeys = 272;   // the one-pass limit: 17 key steps of 16
constexpr int kGroupSteps = 4;  // key steps per cp.async group (64 keys)
constexpr float kLog2e = 1.4426950408889634f;

// The kernel is built for these key-step counts (keys = 16·steps; 208 and
// 272 are the zoo's N = 197 and N = 257–265); an N runs on the first that
// holds it, its keys past N zero rows of K and V whose scores are masked.
// So every loop over keys has a count known to the compiler: no branch
// splits the products, the softmax or P·V.
constexpr int kStepCounts[] = {4, 8, 13, 17};

template <int D, int STEPS>
struct OnePass {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static_assert(16 * STEPS <= kMaxKeys, "more keys than the one-pass limit");
  // bf16 row stride of the K and V tiles: an odd number of 16-byte chunks,
  // so the 8 rows an ldmatrix reads fall in distinct bank groups
  static constexpr int kLd = D + 8;
  static constexpr int kKeys = 16 * STEPS;
  static constexpr int kGroups = (STEPS + kGroupSteps - 1) / kGroupSteps;
  static constexpr int kSmemBytes = 2 * kKeys * kLd * 2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(ln_gemm::smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most `pending` of this thread's groups are in flight (a
// constant once the caller's loop is unrolled)
__device__ __forceinline__ void cp_async_wait_at_most(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<5>(); break;
  }
}
static_assert((kMaxKeys / 16 + kGroupSteps - 1) / kGroupSteps <= 5, "cp_async_wait_at_most covers the K groups");

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(ln_gemm::smem_addr(p)));
}

// d += a·b on one m16n8k16 tile, bf16 in, f32 accumulate.  Layouts (g =
// lane / 4, t = lane % 4): a[0] rows g, columns 2t, 2t+1; a[1] row g + 8;
// a[2], a[3] the same at columns + 8; b0 rows (k) 2t, 2t+1 of column g, b1
// at k + 8; d[0], d[1] row g, columns 2t, 2t+1; d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// q of rows row0 + g and row0 + g + 8 (zero past n) as m16n8k16 A fragments
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4], const __nv_bfloat16* base, long row_stride,
                                       int row0, int n, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const int col = 16 * kk + 8 * (i >> 1) + 2 * t;
      qa[kk][i] = row < n ? __ldg(reinterpret_cast<const unsigned*>(base + row * row_stride + col)) : 0u;
    }
  }
}

template <int D, int STEPS>
__global__ void __launch_bounds__(kThreads, 2)
fused_qkv_attn_one_pass_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int n,
                               float scale) {
  using L = OnePass<D, STEPS>;
  constexpr int kLd = L::kLd, kKeys = L::kKeys, kGroups = L::kGroups;
  constexpr int kVecs = D / 8;  // 16-byte vectors a row of one head
  // keys below this are valid for every N the instance runs: such an N is
  // above the previous instance's 16·steps keys (kStepCounts)
  constexpr int kValidKeys = STEPS <= 4 ? 1 : 16 * (STEPS <= 8 ? 4 : STEPS <= 13 ? 8 : 13);
  static_assert(kStepCounts[0] == 4 && kStepCounts[1] == 8 && kStepCounts[2] == 13, "kValidKeys follows them");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* k_tile = reinterpret_cast<__nv_bfloat16*>(smem);  // [kKeys][kLd]
  __nv_bfloat16* v_tile = k_tile + kKeys * kLd;                     // [kKeys][kLd]

  const int h = blockIdx.x;
  const int dim = gridDim.x * D;
  const long row_stride = 3L * dim;
  const __nv_bfloat16* base = qkv + (long)blockIdx.y * n * row_stride + h * D;

  // stage K in groups of 64 keys, then V; rows past n are zero-filled
  auto stage = [&](__nv_bfloat16* tile, const __nv_bfloat16* src, int key0, int count) {
    for (int i = threadIdx.x; i < count * kVecs; i += kThreads) {
      const int r = key0 + i / kVecs, c = (i % kVecs) * 8;
      const bool valid = r < n;
      cp_async16(tile + r * kLd + c, src + (valid ? r : 0) * row_stride + c, valid);
    }
  };
#pragma unroll
  for (int grp = 0; grp < kGroups; ++grp) {
    stage(k_tile, base + dim, 16 * kGroupSteps * grp, min(16 * kGroupSteps, kKeys - 16 * kGroupSteps * grp));
    cp_async_commit();
  }
  stage(v_tile, base + 2 * dim, 0, kKeys);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float c = scale * kLog2e;
  // the ldmatrix row address of this lane: matrix lane / 8, row lane % 8
  const int mat = lane / 8, mrow = lane % 8;
  uint32_t qa[D / 16][4];
  load_q<D>(qa, base, row_stride, 16 * warp, n, lane);

  float s[2 * STEPS][4];
  // S for key step js (tiles 2js, 2js + 1): matrices of keys 16js + [0, 8)
  // at columns 16kk and 16kk + 8 (tile 2js's b0, b1), then keys 16js +
  // [8, 16) (tile 2js + 1's)
  auto scores = [&](int js) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * js][e] = s[2 * js + 1][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ln_gemm::ldmatrix_x4(b, k_tile + (16 * js + 8 * (mat >> 1) + mrow) * kLd + 16 * kk + 8 * (mat & 1));
      mma_bf16(s[2 * js], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * js + 1], qa[kk], b[2], b[3]);
    }
  };

  // query tiles of 16 rows: warp w takes tiles w, w + 4, ...
  for (int row0 = 16 * warp, round = 0; round == 0 || row0 < n; row0 += 16 * kWarps, ++round) {
    if (round == 0) {  // multiply each K group as it lands, then wait for V
#pragma unroll
      for (int js = 0; js < STEPS; ++js) {
        if (js % kGroupSteps == 0) {  // K groups 0 .. js / 4 have landed: the later ones and V may not
          cp_async_wait_at_most(kGroups - js / kGroupSteps);
          __syncthreads();
        }
        scores(js);
      }
      cp_async_wait<0>();
      __syncthreads();
      if (row0 >= n) break;  // fewer query tiles than warps
    } else {
#pragma unroll
      for (int js = 0; js < STEPS; ++js) scores(js);
    }
    // this warp's next tile's q, in flight during the softmax and P·V
    load_q<D>(qa, base, row_stride, row0 + 16 * kWarps, n, lane);

    // the exact softmax of rows g ([0], [1]) and g + 8 ([2], [3]) in f32;
    // max and sum over four partials a row, to shorten their chains
    float mp[2][4], lp[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) mp[r][i] = -INFINITY, lp[r][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * STEPS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * j + 8 > kValidKeys && 8 * j + 2 * t + (e & 1) >= n) s[j][e] = -INFINITY;  // keys past n
        mp[e >> 1][j & 3] = fmaxf(mp[e >> 1][j & 3], s[j][e]);
      }
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) mc[r] = quad_max(fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]))) * c;
#pragma unroll
    for (int j = 0; j < 2 * STEPS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], c, -mc[e >> 1]));
        lp[e >> 1][j & 3] += s[j][e];
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.0f / quad_sum((lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]));
    // p = e · (1 / l) packed to bf16 as the A fragments of P·V, before any
    // product: the f32 scores die here (half the registers for P·V)
    uint32_t pa[STEPS][4];
#pragma unroll
    for (int js = 0; js < STEPS; ++js) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // score tile 2js + i / 2, row g + 8·(i % 2)
        const int j = 2 * js + (i >> 1), e = 2 * (i & 1);
        pa[js][i] = ln_gemm::pack_bf16(s[j][e] * inv[i & 1], s[j][e + 1] * inv[i & 1]);
      }
    }

    // O = Σ bf16(p) · v
    float o[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
#pragma unroll
    for (int js = 0; js < STEPS; ++js) {
#pragma unroll
      for (int i = 0; i < D / 8; i += 2) {
        // matrices: keys 16js + [0, 8) and + [8, 16) at columns 8i (tile
        // i's b0, b1), then at 8i + 8 (tile i + 1's), transposed
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_tile + (16 * js + 8 * (mat & 1) + mrow) * kLd + 8 * i + 8 * (mat >> 1));
        mma_bf16(o[i], pa[js], b[0], b[1]);
        mma_bf16(o[i + 1], pa[js], b[2], b[3]);
      }
    }

    // rows row0 + g and row0 + g + 8: 16-byte stores of 8 columns after a
    // quad transpose, four n8 tiles at a time; d = 80's last two as pairs
    __nv_bfloat16* out_base = out + (long)blockIdx.y * n * dim + h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
#pragma unroll
      for (int q = 0; q < D / 32; ++q) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = ln_gemm::pack_bf16(o[4 * q + i][2 * r], o[4 * q + i][2 * r + 1]);
        ln_gemm::quad_transpose(w, lane);
        if (row < n)
          *reinterpret_cast<uint4*>(out_base + (long)row * dim + 32 * q + 8 * t) = make_uint4(w[0], w[1], w[2], w[3]);
      }
#pragma unroll
      for (int i = 4 * (D / 32); i < D / 8; ++i) {
        if (row < n)
          *reinterpret_cast<uint32_t*>(out_base + (long)row * dim + 8 * i + 2 * t) =
              ln_gemm::pack_bf16(o[i][2 * r], o[i][2 * r + 1]);
      }
    }
  }
}

template <int D, int STEPS>
cudaError_t launch_steps(const void* qkv, void* out, int batch, int n, int heads, float scale,
                         cudaStream_t stream) {
  auto kernel = fused_qkv_attn_one_pass_kernel<D, STEPS>;
  constexpr int smem = OnePass<D, STEPS>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // two blocks an SM need the largest shared-memory carveout
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(heads, batch), kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv),
                                                          static_cast<__nv_bfloat16*>(out), n, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_one_pass(const void* qkv, void* out, int batch, int n, int heads, float scale,
                            cudaStream_t stream) {
  const int steps = (n + 15) / 16;
  if (steps <= kStepCounts[0]) return launch_steps<D, kStepCounts[0]>(qkv, out, batch, n, heads, scale, stream);
  if (steps <= kStepCounts[1]) return launch_steps<D, kStepCounts[1]>(qkv, out, batch, n, heads, scale, stream);
  if (steps <= kStepCounts[2]) return launch_steps<D, kStepCounts[2]>(qkv, out, batch, n, heads, scale, stream);
  return launch_steps<D, kStepCounts[3]>(qkv, out, batch, n, heads, scale, stream);
}
static_assert(16 * kStepCounts[3] == kMaxKeys, "the last instance holds the one-pass limit");

template <int D>
cudaError_t launch(const void* qkv, void* out, int batch, int n, int heads, cudaStream_t stream) {
  if (n <= 0 || n > kMaxKeys) return cudaErrorInvalidValue;  // a longer n is stamp_fused_qkv_long's
  return launch_one_pass<D>(qkv, out, batch, n, heads, 1.0f / sqrtf((float)D), stream);
}

}  // namespace

extern "C" {

// qkv: [batch, n, 3·heads·head_dim] bf16, contiguous, 16-byte aligned;
// out: [batch, n, heads·head_dim] bf16; 1 <= n <= 272 (a longer n is
// stamp_fused_qkv_long's, fused_qkv_long.cu).  Returns a cudaError_t.
int stamp_fused_qkv_attn(const void* qkv, void* out, int batch, int n, int heads, int head_dim, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(qkv, out, batch, n, heads, s);
    case 80:
      return launch<80>(qkv, out, batch, n, heads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* stamp_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
