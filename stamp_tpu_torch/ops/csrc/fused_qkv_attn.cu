// Multi-head softmax attention read straight off a packed qkv projection.
//
// Replaces: stamp_tpu/ops/flash_attention.py:589 `fused_qkv_mha`, whose
// Pallas bodies are `_fused_qkv_attn_kernel` (:535) and
// `_fused_qkv_attn_kernel_interleaved` (:501).
//
// What bounds it on the H100: device-memory bytes and latency.  Per ViT
// block the kernel must read the packed qkv [B, N, 3·H·d] once and write
// [B, N, H·d] once (UNI2, batch 64: 156 MB + 52 MB, about 62 us at
// 3.35 TB/s), while its arithmetic (QKᵀ and PV, 2·2·N²·d per head) is a few
// percent of the block's matmul work.  The unfused form adds a
// [B, H, N, d] relayout of q, k and v and a [B, H, N, N] f32 score tensor,
// each written to and read back from device memory — several times the
// bytes above.
//
// What the design does about it: one block owns 64 query rows of one
// (batch, head) and reads q, k and v with strides straight out of the
// packed tensor (no relayout); scores and probabilities live only in
// shared memory, 64 keys at a time, so any N runs and several blocks fit
// on an SM to hide latency.  K and V of a head are re-read from L2 by each
// of the ceil(N/64) query tiles.  Each of the 4 warps owns 16 query rows
// and keeps their q fragments in registers.  The softmax is the exact
// two-pass form, computed in three sweeps over the keys, each recomputing
// the score chunk S = q·kᵀ on bf16 tensor cores (WMMA 16×16×16, f32
// accumulate) rather than storing all N scores:
//   1. m = max over keys of s·d^-1/2 (f32);
//   2. l = Σ exp(s·d^-1/2 − m) (f32);
//   3. p = exp(s·d^-1/2 − m) / l in f32, cast to bf16, O += P·V on tensor
//      cores with f32 accumulation; O is cast to bf16 on the store.
// Keys >= N contribute exp(−1e30 − m) = 0 in the Pallas kernel; here they
// are skipped.  This is the Pallas kernel's order of operations (scores
// scaled in f32 after the dot, divide in f32, P cast before PV).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per chunk
constexpr int kWarps = 4;    // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;

template <int D>
struct Layout {
  static constexpr int kLd = D + 8;  // bf16 row stride of the q, k and v tiles
  // f32 row stride of a warp's [16, 64] score chunk, later its [16, d] output
  static constexpr int kLdS = (D > kBlockK ? D : kBlockK) + 4;
  static constexpr int kLdP = kBlockK + 8;  // bf16 row stride of a warp's P chunk
  static constexpr int kTileBytes = 2 * (kBlockQ + 2 * kBlockK) * kLd;
  static constexpr int kScoreBytes = 4 * kWarps * 16 * kLdS;
  static constexpr int kSmemBytes = kTileBytes + kScoreBytes + 2 * kWarps * 16 * kLdP;
};

// rows [row0, row0 + 64) of one d-wide column slab of the packed tensor
// into shared memory, 16 bytes a thread; rows >= n are zero.
template <int D>
__device__ inline void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                 long row_stride, int row0, int n) {
  constexpr int kLd = Layout<D>::kLd;
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < 64 * kVecs; i += kThreads) {
    const int r = i / kVecs, c = i % kVecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      v = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c * 8) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fused_qkv_attn_kernel(const __nv_bfloat16* __restrict__ qkv,
                      __nv_bfloat16* __restrict__ out, int n, int heads,
                      float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  using L = Layout<D>;
  constexpr int kLd = L::kLd, kLdS = L::kLdS, kLdP = L::kLdP;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_tile = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][kLd]
  __nv_bfloat16* k_tile = q_tile + kBlockQ * kLd;                    // [64][kLd]
  __nv_bfloat16* v_tile = k_tile + kBlockK * kLd;                    // [64][kLd]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this warp's score chunk [16][kLdS] f32 and P chunk [16][kLdP] bf16
  float* s_chunk = reinterpret_cast<float*>(smem + L::kTileBytes) + warp * 16 * kLdS;
  __nv_bfloat16* p_chunk =
      reinterpret_cast<__nv_bfloat16*>(smem + L::kTileBytes + L::kScoreBytes) + warp * 16 * kLdP;
  const int dim = heads * D;
  const long row_stride = 3L * dim;
  const __nv_bfloat16* base = qkv + (long)blockIdx.z * n * row_stride;

  load_rows<D>(q_tile, base + h * D, row_stride, q0, n);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], q_tile + warp * 16 * kLd + kk * 16, kLd);
  }

  // S = q·kᵀ (unscaled, f32) for the 64 keys in k_tile, into s_chunk
  auto scores = [&]() {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBlockK / 16];
    for (int j = 0; j < kBlockK / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < D / 16; ++kk) {
      for (int j = 0; j < kBlockK / 16; ++j) {
        // B(d, key) = k[key][d]: column-major with leading dimension kLd
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, k_tile + j * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(acc[j], qf[kk], b, acc[j]);
      }
    }
    for (int j = 0; j < kBlockK / 16; ++j) {
      wmma::store_matrix_sync(s_chunk + j * 16, acc[j], kLdS, wmma::mem_row_major);
    }
    __syncwarp();
  };
  auto load_k = [&](int k0) {
    __syncthreads();  // every warp is done with the previous chunk
    load_rows<D>(k_tile, base + dim + h * D, row_stride, k0, n);
    __syncthreads();
  };

  // lane → (row, half): row `row` of the warp's 16, keys [32·half, 32·half+32)
  // of the chunk; the two halves of a row are lanes l and l ^ 16
  const int row = lane & 15;
  const int half = lane >> 4;
  const float* my_s = s_chunk + row * kLdS + half * 32;

  // 1. m = max_k s·scale
  float m = -INFINITY;
  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    load_k(k0);
    scores();
    const int valid = n - (k0 + half * 32);
    for (int c = 0; c < 32; c += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(my_s + c);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      for (int e = 0; e < 4; ++e) {
        if (c + e < valid) m = fmaxf(m, sv[e] * scale);
      }
    }
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));

  // 2. l = Σ_k exp(s·scale − m)
  float l = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    load_k(k0);
    scores();
    const int valid = n - (k0 + half * 32);
    for (int c = 0; c < 32; c += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(my_s + c);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      for (int e = 0; e < 4; ++e) {
        if (c + e < valid) l += expf(sv[e] * scale - m);
      }
    }
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 16);

  // 3. O = Σ_k bf16(exp(s·scale − m) / l) · v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[D / 16];
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  __nv_bfloat16* my_p = p_chunk + row * kLdP + half * 32;
  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();
    load_rows<D>(k_tile, base + dim + h * D, row_stride, k0, n);
    load_rows<D>(v_tile, base + 2 * dim + h * D, row_stride, k0, n);
    __syncthreads();
    scores();
    const int valid = n - (k0 + half * 32);
    for (int c = 0; c < 32; c += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(my_s + c);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      float p[4];
      for (int e = 0; e < 4; ++e) p[e] = c + e < valid ? expf(sv[e] * scale - m) / l : 0.0f;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2], p[3]);
      *reinterpret_cast<uint2*>(my_p + c) = make_uint2(
          *reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
    }
    __syncwarp();
    for (int kk = 0; kk < kBlockK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, p_chunk + kk, kLdP);
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, v_tile + kk * kLd + j * 16, kLd);
        wmma::mma_sync(o[j], a, b, o[j]);
      }
    }
    __syncwarp();
  }

  // the warp's score chunk is free: stage the f32 output tile there
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(s_chunk + j * 16, o[j], kLdS, wmma::mem_row_major);
  }
  __syncwarp();
  const int row0 = q0 + warp * 16;
  __nv_bfloat16* out_base = out + ((long)blockIdx.z * n) * dim + h * D;
  for (int i = lane; i < 16 * (D / 2); i += 32) {
    const int r = i / (D / 2), c = 2 * (i % (D / 2));
    if (row0 + r < n) {
      const float* src = s_chunk + r * kLdS + c;
      *reinterpret_cast<__nv_bfloat162*>(out_base + (long)(row0 + r) * dim + c) =
          __floats2bfloat162_rn(src[0], src[1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* qkv, void* out, int batch, int n, int heads,
                   cudaStream_t stream) {
  constexpr int smem = Layout<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_qkv_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  fused_qkv_attn_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), n,
      heads, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv: [batch, n, 3·heads·head_dim] bf16, contiguous, 16-byte aligned;
// out: [batch, n, heads·head_dim] bf16.  Returns a cudaError_t.
int stamp_fused_qkv_attn(const void* qkv, void* out, int batch, int n, int heads,
                         int head_dim, int device, void* stream) {
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

const char* stamp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
