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
// turns compute-bound.  The unfused form adds a full LayerNorm pass that
// writes the normalized activation [M, K] to device memory and reads it
// back.
//
// What the design does about it: the normalized activation never reaches
// device memory, and the tensor cores are kept fed.  A block owns 128 rows
// and a run of G consecutive 128-column output tiles (G chosen by the host
// so the grid still fills the card).  It reduces the mean and variance of
// its rows over K once (two passes over x in f32: μ, then
// σ² = mean((x−μ)²)), then for each output tile walks K in chunks of 32,
// software-pipelined with one barrier per chunk:
//   * raw x [128, 32], W [128, 32] and γ/β of a chunk arrive by cp.async,
//     three chunks ahead of the tensor cores (four stages);
//   * while the tensor cores work on chunk k, the block normalizes the
//     landed chunk k+1 in f32 (γ, β, μ, 1/σ), casts it to bf16 and stores it
//     into the other of two shared-memory A buffers;
//   * 8 warps, each 64×32 of the tile, multiply on bf16 tensor cores
//     (WMMA 16×16×16, f32 accumulate).
// The epilogue adds the dense bias in f32 before the single cast to bf16
// and stores 16 bytes a thread.  Ragged M, N and K are masked (rows past M
// read zeros and are not stored), so every M launches — no divisibility
// gate as on the TPU.  wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kBM = 128;    // rows per block
constexpr int kBN = 128;    // columns per output tile
constexpr int kBK = 32;     // K per chunk
constexpr int kStages = 4;  // raw x / W / γβ chunks in flight
constexpr int kWarpsM = 2, kWarpsN = 4;  // 8 warps, each 64×32 of the tile
constexpr int kMinBlocks = 2;            // blocks per SM the registers are sized for
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kFragsM = kBM / kWarpsM / 16;  // 16×16 accumulators per warp
constexpr int kFragsN = kBN / kWarpsN / 16;
constexpr int kVecs = kBM * kBK / 8 / kThreads;  // 16-B vectors a thread moves per chunk
constexpr int kLd = kBK + 8;   // bf16 row stride of the x, A and W chunks
constexpr int kLdC = kBN + 4;  // f32 row stride of the epilogue tile
constexpr int kChunkElems = kBM * kLd;  // == kBN * kLd
// one pipeline stage: raw x chunk, W chunk, then γ and β of the chunk
constexpr int kStageElems = 2 * kChunkElems + 2 * kBK;
constexpr int kPipeBytes = (2 * kChunkElems + kStages * kStageElems) * 2;
constexpr int kEpilogueBytes = kBM * kLdC * 4;
constexpr int kTileBytes = kPipeBytes > kEpilogueBytes ? kPipeBytes : kEpilogueBytes;
constexpr int kSmemBytes = kTileBytes + 2 * kBM * 4;  // + row mean and 1/σ
static_assert(kBM == kBN, "A and W chunks share one layout");
static_assert(kVecs * kThreads * 8 == kBM * kBK, "chunk vectors must split evenly");
static_assert(kStages >= 3, "the pipeline keeps two chunks in flight");
static_assert((kStageElems * 2) % 32 == 0, "WMMA pointers need 32-byte alignment");

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// 16-byte asynchronous global→shared copy; zero-fills when !pred
__device__ inline void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
ln_dense_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ gamma,
                const __nv_bfloat16* __restrict__ beta,
                const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ dense_bias,
                __nv_bfloat16* __restrict__ out, int m, int n, int k, float eps,
                int tiles_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_buf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][128][kLd] normalized x
  __nv_bfloat16* stages = a_buf + 2 * kChunkElems;                  // [kStages][kStageElems]
  float* c_tile = reinterpret_cast<float*>(smem);                   // [128][kLdC], after the K loop
  float* row_mean = reinterpret_cast<float*>(smem + kTileBytes);
  float* row_rstd = row_mean + kBM;

  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // 1. row statistics, one warp per row, two passes over x in f32
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = m0 + r;
    float mean = 0.0f, rstd = 0.0f;
    if (row < m) {
      const __nv_bfloat16* xr = x + (size_t)row * k;
      float f[8];
      float s = 0.0f;
#pragma unroll 4
      for (int c = lane * 8; c < k; c += 32 * 8) {
        unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
        for (int i = 0; i < 8; ++i) s += f[i];
      }
      mean = warp_sum(s) / (float)k;
      float v = 0.0f;
#pragma unroll 4
      for (int c = lane * 8; c < k; c += 32 * 8) {
        unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
        for (int i = 0; i < 8; ++i) {
          const float d = f[i] - mean;
          v += d * d;
        }
      }
      rstd = rsqrtf(warp_sum(v) / (float)k + eps);
    }
    if (lane == 0) {
      row_mean[r] = mean;
      row_rstd[r] = rstd;
    }
  }
  __syncthreads();

  const int wm = warp / kWarpsN;  // warp tile: rows kFragsM·16·wm, columns kFragsN·16·wn
  const int wn = warp % kWarpsN;
  const int num_k = (k + kBK - 1) / kBK;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * kBN;

    // chunk kt's raw x, W, γ and β into stage kt % kStages; thread vector
    // v covers row v / (kBK/8), columns 8·(v % (kBK/8)) of the chunk
    auto issue = [&](int kt) {
      __nv_bfloat16* st = stages + (kt % kStages) * kStageElems;
      for (int i = 0; i < kVecs; ++i) {
        const int v = tid + i * kThreads;
        const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
        const int col = kt * kBK + c;
        const bool xin = m0 + r < m && col < k, win = n0 + r < n && col < k;
        cp_async16(st + r * kLd + c, xin ? x + (size_t)(m0 + r) * k + col : x, xin);
        cp_async16(st + kChunkElems + r * kLd + c, win ? w + (size_t)(n0 + r) * k + col : w, win);
      }
      if (tid < 2 * (kBK / 8)) {  // γ, then β: kBK/8 vectors each
        const int c = (tid % (kBK / 8)) * 8;
        const __nv_bfloat16* src = tid < kBK / 8 ? gamma : beta;
        const bool in = kt * kBK + c < k;
        cp_async16(st + 2 * kChunkElems + tid * 8, in ? src + kt * kBK + c : src, in);
      }
    };
    // landed chunk kt: normalize in f32, cast to bf16, into A buffer kt % 2
    auto normalize = [&](int kt) {
      const __nv_bfloat16* st = stages + (kt % kStages) * kStageElems;
      __nv_bfloat16* dst = a_buf + (kt % 2) * kChunkElems;
      for (int i = 0; i < kVecs; ++i) {
        const int v = tid + i * kThreads;
        const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
        float xv[8], g[8], b[8];
        unpack8(*reinterpret_cast<const uint4*>(st + 2 * kChunkElems + c), g);
        unpack8(*reinterpret_cast<const uint4*>(st + 2 * kChunkElems + kBK + c), b);
        unpack8(*reinterpret_cast<const uint4*>(st + r * kLd + c), xv);
        const float mean = row_mean[r], rstd = row_rstd[r];
        uint4 packed;
        __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&packed);
        for (int e = 0; e < 4; ++e)
          y[e] = __floats2bfloat162_rn((xv[2 * e] - mean) * rstd * g[2 * e] + b[2 * e],
                                       (xv[2 * e + 1] - mean) * rstd * g[2 * e + 1] + b[2 * e + 1]);
        *reinterpret_cast<uint4*>(dst + r * kLd + c) = packed;
      }
    };

    // 2. K loop.  One commit group per chunk (empty past the end), so
    //    "chunk j landed" is "at most (committed − j − 1) groups pending".
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < num_k) issue(s);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();  // chunk 0
    __syncthreads();
    normalize(0);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragsM][kFragsN];
    for (int i = 0; i < kFragsM; ++i)
      for (int j = 0; j < kFragsN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int kt = 0; kt < num_k; ++kt) {
      cp_async_wait<kStages - 3>();  // chunk kt+1
      // A chunk kt is complete, chunk kt+1 is visible, and everyone is done
      // with chunk kt−1's stage and A buffer
      __syncthreads();
      if (kt + kStages - 1 < num_k) issue(kt + kStages - 1);
      cp_async_commit();

      const __nv_bfloat16* a_cur = a_buf + (kt % 2) * kChunkElems + wm * kFragsM * 16 * kLd;
      const __nv_bfloat16* w_cur =
          stages + (kt % kStages) * kStageElems + kChunkElems + wn * kFragsN * 16 * kLd;
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kFragsM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[kFragsN];
        for (int i = 0; i < kFragsM; ++i)
          wmma::load_matrix_sync(a[i], a_cur + i * 16 * kLd + kk, kLd);
        for (int j = 0; j < kFragsN; ++j)
          wmma::load_matrix_sync(b[j], w_cur + j * 16 * kLd + kk, kLd);
        for (int i = 0; i < kFragsM; ++i)
          for (int j = 0; j < kFragsN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      if (kt + 1 < num_k) normalize(kt + 1);  // into the other A buffer
    }
    cp_async_wait<0>();  // only empty groups remain
    __syncthreads();     // every warp is done with the pipeline buffers

    // 3. epilogue: f32 accumulators + f32 dense bias, one cast, 16-B stores
    for (int i = 0; i < kFragsM; ++i)
      for (int j = 0; j < kFragsN; ++j)
        wmma::store_matrix_sync(
            c_tile + (wm * kFragsM * 16 + i * 16) * kLdC + wn * kFragsN * 16 + j * 16,
            acc[i][j], kLdC, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const int row = m0 + r, col = n0 + c;
      if (row >= m || col >= n) continue;
      const float* src = c_tile + r * kLdC + c;
      __nv_bfloat16* dst = out + (size_t)row * n + col;
      if (col + 8 <= n && n % 8 == 0) {
        float bias[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (dense_bias != nullptr) unpack8(*reinterpret_cast<const uint4*>(dense_bias + col), bias);
        uint4 packed;
        __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&packed);
        for (int e = 0; e < 4; ++e)
          y[e] = __floats2bfloat162_rn(src[2 * e] + bias[2 * e], src[2 * e + 1] + bias[2 * e + 1]);
        *reinterpret_cast<uint4*>(dst) = packed;
      } else {
        for (int e = 0; e < 8 && col + e < n; ++e) {
          const float bias = dense_bias != nullptr ? __bfloat162float(dense_bias[col + e]) : 0.0f;
          dst[e] = __float2bfloat16(src[e] + bias);
        }
      }
    }
    __syncthreads();  // c_tile read before the next tile's loads overwrite it
  }
}

}  // namespace

extern "C" {

// x: [m, k] bf16; gamma, beta: [k] bf16; w: [n, k] bf16 (nn.Linear layout);
// dense_bias: [n] bf16 or NULL; out: [m, n] bf16.  All contiguous, 16-byte
// aligned, k a multiple of 8.  Returns a cudaError_t.
int stamp_ln_dense(const void* x, const void* gamma, const void* beta, const void* w,
                   const void* dense_bias, void* out, int m, int n, int k, float eps,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ln_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // a block computes the row statistics once for G output tiles; take the
  // largest G (up to 8) that still leaves 4 waves of resident blocks
  const int n_tiles = (n + kBN - 1) / kBN;
  const int m_tiles = (m + kBM - 1) / kBM;
  int g = (int)((long)n_tiles * m_tiles / (4L * kMinBlocks * sms));
  g = g < 1 ? 1 : (g > 8 ? 8 : g);
  const dim3 grid((n_tiles + g - 1) / g, m_tiles);
  ln_dense_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(dense_bias), static_cast<__nv_bfloat16*>(out), m,
      n, k, eps, g);
  return cudaGetLastError();
}

}  // extern "C"
