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
// What the design does about it: the normalized and quantized activation
// never reaches device memory.  It is ln_dense.cu's structure with an int8
// core.  A block owns 128 rows and a run of G consecutive 128-column output
// tiles; it reduces the mean and variance of its rows over K once (two
// passes in f32), then for each output tile walks K in chunks of 64:
//   * raw x [128, 64] bf16, W_q [128, 64] int8 and γ/β of a chunk arrive by
//     cp.async two chunks ahead of the tensor cores (three stages);
//   * while the tensor cores work on chunk k, the block normalizes the
//     landed chunk k+1 in f32 (every step rounded on its own, no FMA
//     contraction, as the plain version's separate operations), rounds it
//     to bf16, quantizes it with rint (round half to even, as jnp.round and
//     torch.round) and stores it into the other of two int8 A buffers;
//   * 8 warps, each 64×32 of the tile, multiply with
//     mma.sync m16n8k32 s8·s8 → s32.  Fragments are 4-byte shared-memory
//     loads; the int8 rows are 80 bytes apart, so a warp's 32 loads hit 32
//     distinct banks.
// The i32 sums are exact.  The epilogue converts them to f32 (rounded),
// multiplies by s_x/127 and w_scale, adds the dense bias in f32 and casts
// once to bf16.  s_x is read from device memory: the host never waits for
// it.  Ragged M, N and K are masked (zero-filled loads quantize to 0), so
// every M launches: no tile gate as on the TPU.  ldmatrix, wgmma, TMA and a
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;    // rows per block
constexpr int kBN = 128;    // columns per output tile
constexpr int kBK = 64;     // K per chunk: two m16n8k32 steps
constexpr int kStages = 3;  // raw x / W / γβ chunks in flight
constexpr int kWarpsM = 2, kWarpsN = 4;  // 8 warps, each 64×32 of the tile
constexpr int kMinBlocks = 2;            // blocks per SM the registers are sized for
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kTilesM = kBM / kWarpsM / 16;  // m16 tiles per warp
constexpr int kTilesN = kBN / kWarpsN / 8;   // n8 tiles per warp
constexpr int kXLd = kBK + 8;    // bf16 row stride of the raw x chunk
constexpr int kQLd = kBK + 16;   // byte row stride of the int8 A and W chunks
constexpr int kLdC = kBN + 4;    // i32 row stride of the epilogue tile
constexpr int kXBytes = kBM * kXLd * 2;
constexpr int kWBytes = kBN * kQLd;
constexpr int kStageBytes = kXBytes + kWBytes + 2 * kBK * 2;  // + γ and β of the chunk
constexpr int kABytes = kBM * kQLd;  // one int8 A buffer
constexpr int kPipeBytes = 2 * kABytes + kStages * kStageBytes;
constexpr int kEpilogueBytes = kBM * kLdC * 4;
constexpr int kTileBytes = kPipeBytes > kEpilogueBytes ? kPipeBytes : kEpilogueBytes;
constexpr int kSmemBytes = kTileBytes + 2 * kBM * 4;  // + row mean and 1/σ
constexpr int kXVecs = kBM * kBK / 8 / kThreads;   // 16-B x vectors a thread moves per chunk
constexpr int kWVecs = kBN * kBK / 16 / kThreads;  // 16-B W vectors a thread moves per chunk
static_assert(kXVecs * kThreads * 8 == kBM * kBK, "x chunk vectors must split evenly");
static_assert(kWVecs * kThreads * 16 == kBN * kBK, "W chunk vectors must split evenly");
static_assert(kStages >= 3, "the pipeline keeps two chunks in flight");
static_assert(kStageBytes % 16 == 0 && kABytes % 16 == 0 && kXBytes % 16 == 0,
              "cp.async destinations need 16-byte alignment");
static_assert((kQLd / 4) % 8 == 4, "int8 rows must spread a warp's fragment loads over all banks");

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

__device__ inline uint32_t ld32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// c += a·b for one 16×8×32 int8 tile, i32 accumulate.  Fragments
// (g = lane / 4, t = lane % 4), each register four consecutive K bytes:
//   a = A[g][4t..], A[g+8][4t..], A[g][16+4t..], A[g+8][16+4t..];
//   b = B[4t..][g], B[16+4t..][g] (B column-major: a row of W_q);
//   c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
__device__ inline void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
ln_quant_dense_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ gamma,
                      const __nv_bfloat16* __restrict__ beta,
                      const float* __restrict__ s_x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ w_scale,
                      const __nv_bfloat16* __restrict__ dense_bias,
                      __nv_bfloat16* __restrict__ out, int m, int n, int k, float eps,
                      int tiles_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* a_buf = reinterpret_cast<int8_t*>(smem);  // [2][128][kQLd] quantized x
  unsigned char* stages = smem + 2 * kABytes;       // [kStages][kStageBytes]
  int* c_tile = reinterpret_cast<int*>(smem);       // [128][kLdC], after the K loop
  float* row_mean = reinterpret_cast<float*>(smem + kTileBytes);
  float* row_rstd = row_mean + kBM;

  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float sx = s_x[0];
  const float inv = __fdiv_rn(127.0f, sx);    // quantize factor, formed in f32 first
  const float dequant = __fdiv_rn(sx, 127.0f);

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

  const int wm = warp / kWarpsN;  // warp tile: rows 64·wm, columns 32·wn
  const int wn = warp % kWarpsN;
  const int num_k = (k + kBK - 1) / kBK;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * kBN;

    // chunk kt's raw x, W_q, γ and β into stage kt % kStages
    auto issue = [&](int kt) {
      unsigned char* st = stages + (kt % kStages) * kStageBytes;
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st);
      int8_t* ws = reinterpret_cast<int8_t*>(st + kXBytes);
      __nv_bfloat16* gb = reinterpret_cast<__nv_bfloat16*>(st + kXBytes + kWBytes);
      for (int i = 0; i < kXVecs; ++i) {  // vector v: row v / 8, columns 8·(v % 8)
        const int v = tid + i * kThreads;
        const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
        const int col = kt * kBK + c;
        const bool in = m0 + r < m && col < k;
        cp_async16(xs + r * kXLd + c, in ? x + (size_t)(m0 + r) * k + col : x, in);
      }
      for (int i = 0; i < kWVecs; ++i) {  // vector v: row v / 4, bytes 16·(v % 4)
        const int v = tid + i * kThreads;
        const int r = v / (kBK / 16), c = (v % (kBK / 16)) * 16;
        const int col = kt * kBK + c;
        const bool in = n0 + r < n && col < k;
        cp_async16(ws + r * kQLd + c, in ? w + (size_t)(n0 + r) * k + col : w, in);
      }
      if (tid < 2 * (kBK / 8)) {  // γ, then β: kBK/8 vectors each
        const int c = (tid % (kBK / 8)) * 8;
        const __nv_bfloat16* src = tid < kBK / 8 ? gamma : beta;
        const bool in = kt * kBK + c < k;
        cp_async16(gb + tid * 8, in ? src + kt * kBK + c : src, in);
      }
    };
    // landed chunk kt: normalize in f32, round to bf16, quantize, into A buffer kt % 2
    auto quantize = [&](int kt) {
      const unsigned char* st = stages + (kt % kStages) * kStageBytes;
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
      const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(st + kXBytes + kWBytes);
      int8_t* dst = a_buf + (kt % 2) * kABytes;
      for (int i = 0; i < kXVecs; ++i) {
        const int v = tid + i * kThreads;
        const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
        float xv[8], gv[8], bv[8];
        unpack8(*reinterpret_cast<const uint4*>(gb + c), gv);
        unpack8(*reinterpret_cast<const uint4*>(gb + kBK + c), bv);
        unpack8(*reinterpret_cast<const uint4*>(xs + r * kXLd + c), xv);
        const float mean = row_mean[r], rstd = row_rstd[r];
        uint32_t packed[2] = {0u, 0u};
        for (int e = 0; e < 8; ++e) {
          float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv[e], mean), rstd), gv[e]), bv[e]);
          y = __bfloat162float(__float2bfloat16_rn(y));
          const int q = max(-127, min(127, __float2int_rn(__fmul_rn(y, inv))));
          packed[e / 4] |= (uint32_t)(q & 0xff) << (8 * (e % 4));
        }
        *reinterpret_cast<uint2*>(dst + r * kQLd + c) = make_uint2(packed[0], packed[1]);
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
    quantize(0);

    int acc[kTilesM][kTilesN][4];
    for (int i = 0; i < kTilesM; ++i)
      for (int j = 0; j < kTilesN; ++j)
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int kt = 0; kt < num_k; ++kt) {
      cp_async_wait<kStages - 3>();  // chunk kt+1
      // A chunk kt is complete, chunk kt+1 is visible, and everyone is done
      // with chunk kt−1's stage and A buffer
      __syncthreads();
      if (kt + kStages - 1 < num_k) issue(kt + kStages - 1);
      cp_async_commit();

      const int8_t* a_cur = a_buf + (kt % 2) * kABytes + (wm * kTilesM * 16 + g) * kQLd + 4 * t;
      const int8_t* w_cur =
          reinterpret_cast<const int8_t*>(stages + (kt % kStages) * kStageBytes + kXBytes) +
          (wn * kTilesN * 8 + g) * kQLd + 4 * t;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 32) {
        uint32_t a[kTilesM][4], b[kTilesN][2];
#pragma unroll
        for (int i = 0; i < kTilesM; ++i) {
          const int8_t* p = a_cur + i * 16 * kQLd + kk;
          a[i][0] = ld32(p);
          a[i][1] = ld32(p + 8 * kQLd);
          a[i][2] = ld32(p + 16);
          a[i][3] = ld32(p + 8 * kQLd + 16);
        }
#pragma unroll
        for (int j = 0; j < kTilesN; ++j) {
          const int8_t* p = w_cur + j * 8 * kQLd + kk;
          b[j][0] = ld32(p);
          b[j][1] = ld32(p + 16);
        }
#pragma unroll
        for (int i = 0; i < kTilesM; ++i)
#pragma unroll
          for (int j = 0; j < kTilesN; ++j) mma_s8(acc[i][j], a[i], b[j]);
      }
      if (kt + 1 < num_k) quantize(kt + 1);  // into the other A buffer
    }
    cp_async_wait<0>();  // only empty groups remain
    __syncthreads();     // every warp is done with the pipeline buffers

    // 3. epilogue: i32 sums → f32 · s_x/127 · w_scale + dense bias, one cast
    for (int i = 0; i < kTilesM; ++i)
      for (int j = 0; j < kTilesN; ++j) {
        int* c0 = c_tile + (wm * kTilesM * 16 + i * 16 + g) * kLdC + wn * kTilesN * 8 + j * 8 + 2 * t;
        *reinterpret_cast<int2*>(c0) = make_int2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<int2*>(c0 + 8 * kLdC) = make_int2(acc[i][j][2], acc[i][j][3]);
      }
    __syncthreads();
    for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const int row = m0 + r, col = n0 + c;
      if (row >= m || col >= n) continue;
      const int* src = c_tile + r * kLdC + c;
      __nv_bfloat16* dst = out + (size_t)row * n + col;
      float v[8];
      const int cols = min(8, n - col);
      for (int e = 0; e < cols; ++e) {
        v[e] = __fmul_rn(__fmul_rn(__int2float_rn(src[e]), dequant), w_scale[col + e]);
        if (dense_bias != nullptr) v[e] = __fadd_rn(v[e], __bfloat162float(dense_bias[col + e]));
      }
      if (cols == 8 && n % 8 == 0) {
        uint4 packed;
        __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&packed);
        for (int e = 0; e < 4; ++e) y[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        *reinterpret_cast<uint4*>(dst) = packed;
      } else {
        for (int e = 0; e < cols; ++e) dst[e] = __float2bfloat16_rn(v[e]);
      }
    }
    __syncthreads();  // c_tile read before the next tile's loads overwrite it
  }
}

}  // namespace

extern "C" {

// x: [m, k] bf16; gamma, beta: [k] bf16; s_x: [1] f32 (device); w: [n, k]
// int8 (nn.Linear layout); w_scale: [n] f32; dense_bias: [n] bf16 or NULL;
// out: [m, n] bf16.  All contiguous, 16-byte aligned, k a multiple of 16.
// Returns a cudaError_t.
int stamp_ln_quant_dense(const void* x, const void* gamma, const void* beta, const void* s_x,
                         const void* w, const void* w_scale, const void* dense_bias, void* out,
                         int m, int n, int k, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ln_quant_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  ln_quant_dense_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta), static_cast<const float*>(s_x),
      static_cast<const int8_t*>(w), static_cast<const float*>(w_scale),
      static_cast<const __nv_bfloat16*>(dense_bias), static_cast<__nv_bfloat16*>(out), m, n, k,
      eps, g);
  return cudaGetLastError();
}

}  // extern "C"
