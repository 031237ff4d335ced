// Backward of the masked flash attention, and the distance-weighted sum of
// spatial ALiBi's backward.
//
// Replaces:
//   * stamp_tpu/ops/flash_attention.py:236 `_flash_core_bwd` (pallas_calls
//     :257 and :278, bodies `_flash_bwd_dq_kernel` :143 and
//     `_flash_bwd_dkv_kernel` :178), the backward of `flash_mha`;
//   * stamp_tpu/ops/flash_attention.py:867 `_alibi_core_bwd` (pallas_calls
//     :887 and :908, the same two bodies), the softmax branch of the
//     backward of `flash_alibi_mha`;
//   * stamp_tpu/ops/flash_attention.py:702 `_dist_weighted_sum` (pallas_call
//     :712, body `_dws_kernel` :661), which `_alibi_core_bwd` calls for the
//     bias branch's dV (:936).
//
// The flash backward, per (batch·head) sequence of f32 q [Tq, d], k and v
// [Tk, d], dO [Tq, d], the forward's lse [Tq] and D = rowsum(dO∘O) [Tq]
// (computed by the caller), with s = q·kᵀ·scale (−1e30 on masked keys) and
// P = exp(s − lse):
//   dP = dO·Vᵀ,  dS = P∘(dP − D)·scale,
//   dQ = dS·K  (kernel 1),   dV = Pᵀ·dO,  dK = dSᵀ·Q  (kernel 2).
// The distance-weighted sum: out_a = Σ_b ‖c_a − c_b‖·val_b over the b that
// the b-mask keeps (kernel 3).
//
// What bounds them on the H100: operations.  At the whole-slide training
// shapes ([8, T, 64], T = 4,097 … 16,385) one product of 2·BH·T²·d is
// 275 GFLOP at T = 16,385; dQ does three (s, dP, dS·K: 1.67 ms at the
// 495 TFLOP/s TF32 rate), dK/dV four (s, dP, Pᵀ·dO, dSᵀ·Q: 2.22 ms) and the
// distance-weighted sum one that must stay f32-accurate (4.10 ms at the
// 67 TFLOP/s f32 rate), against a few tens of MB of inputs and outputs
// (about 10 µs at 3.35 TB/s).
//
// What the design does about it:
//   * the TPU grids' sequential ("arbitrary") axis becomes a loop inside one
//     thread block, and the sums it carried in VMEM scratch stay in
//     registers: kernel 1 owns 64 queries of one (batch·head) and loops over
//     64-key tiles; kernel 2 owns 64 keys and loops over 64-query tiles;
//     kernel 3 owns 64 rows a and loops over 64-column tiles b.  Four warps
//     of 16 rows each; at BH = 8 and T ≥ 4,097 that is ≥ 520 blocks for 132
//     SMs.  Two kernels and no atomics, as on the TPU: every output element
//     is summed by one thread in a fixed order, so the result is bitwise
//     deterministic;
//   * kernel 2 computes the transposed score tile Sᵀ = k·qᵀ directly, so Pᵀ
//     and dSᵀ come out in the C layout that chains into dV += Pᵀ·dO and
//     dK += dSᵀ·Q as A operands (the key-order trick of tf32_tiles.cuh),
//     and kernel 1 chains dS into dQ += dS·K the same way;
//   * arithmetic: the five products run in TF32 mma.sync with f32
//     accumulation, as the Pallas bodies run them at default precision;
//     scale, mask, exp and the dS formula are f32 in the Pallas bodies'
//     order.  Kernel 3, which the Pallas kernel runs at Precision.HIGHEST,
//     reuses the forward's 3×TF32 D·V (per-tile sums added in rounded f32);
//   * masking: a masked key has s = −1e30 and so P = 0 exactly, which gives
//     it exactly zero dK and dV; queries and keys past T are masked in the
//     kernels (zero rows in shared memory, lse = +inf for queries past Tq),
//     with no host padding.  Head widths d ∈ {32, 64, 128}.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_tiles.cuh"

namespace {

constexpr int kTile = 64;  // rows a block owns; columns per loop step
constexpr int kWarps = 4;  // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

struct BwdParams {
  const float* q;        // [bh, tq, d]
  const float* k;        // [bh, tk, d]
  const float* v;        // [bh, tk, d]
  const uint8_t* mask;   // [bh, tk], nonzero = valid key
  const float* dout;     // [bh, tq, d]
  const float* lse;      // [bh, tq]
  const float* dvec;     // [bh, tq], rowsum(dO∘O)
  float* dq;             // [bh, tq, d]
  float* dk;             // [bh, tk, d]
  float* dv;             // [bh, tk, d]
  int tq;
  int tk;
  float scale;
};

// floats of one [64][D + 4] tile in shared memory
template <int D>
constexpr int kTileFloats = kTile * (D + 4);

// acc[j] = A·Bᵀ for this warp's 16 rows of A (shared, row stride D + 4,
// TF32-rounded) against the 64 rows of B (same layout): column j·8 + c of
// the result is row j·8 + c of B.
template <int D>
__device__ __forceinline__ void rows_times_rows_t(float (&acc)[8][4], const float* aw,
                                                  const float* b, int g, int t) {
  constexpr int kLd = D + 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t a0 = __float_as_uint(aw[g * kLd + kk * 8 + t]);
    const uint32_t a1 = __float_as_uint(aw[(g + 8) * kLd + kk * 8 + t]);
    const uint32_t a2 = __float_as_uint(aw[g * kLd + kk * 8 + t + 4]);
    const uint32_t a3 = __float_as_uint(aw[(g + 8) * kLd + kk * 8 + t + 4]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* br = b + (j * 8 + g) * kLd + kk * 8;
      mma_tf32(acc[j], a0, a1, a2, a3, __float_as_uint(br[t]), __float_as_uint(br[t + 4]));
    }
  }
}

// out[n] += X·B for X [16, 64] in registers as C fragments (x[j] covers
// columns j·8 … j·8+7) and B [64, D] in shared memory (TF32-rounded): X's
// fragments are the A operands with the depth taken in the order
// (0, 2, 4, 6, 1, 3, 5, 7) within each 8-step, so B's rows are read in that
// order.
template <int D>
__device__ __forceinline__ void frag_times_rows(float (&out)[D / 8][4], const float (&x)[8][4],
                                                const float* b, int g, int t) {
  constexpr int kLd = D + 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t a0 = to_tf32(x[j][0]), a1 = to_tf32(x[j][2]);
    const uint32_t a2 = to_tf32(x[j][1]), a3 = to_tf32(x[j][3]);
    const float* b0 = b + (j * 8 + 2 * t) * kLd;
    const float* b1 = b0 + kLd;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      mma_tf32(out[n], a0, a1, a2, a3, __float_as_uint(b0[n * 8 + g]), __float_as_uint(b1[n * 8 + g]));
    }
  }
}

// rows row0 + g and row0 + g + 8 of an [n, D] output from C fragments
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[D / 8][4], int row0,
                                           int n, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<float2*>(dst + (long)row * D + c * 8 + 2 * t) =
          make_float2(acc[c][2 * i], acc[c][2 * i + 1]);
    }
  }
}

// Kernel 1: dQ for 64 queries of one (batch·head), looping over key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int kN = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [64][D+4] q, TF32
  float* dos = qs + kTileFloats<D>;  // [64][D+4] dO, TF32
  float* ks = dos + kTileFloats<D>;  // [64][D+4] k, TF32
  float* vs = ks + kTileFloats<D>;   // [64][D+4] v, TF32
  float* valid = vs + kTileFloats<D>;  // [64] 1 = valid key

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long qoff = (long)bh * p.tq;
  const long koff = (long)bh * p.tk;

  load_rows<D, kTile, kThreads>(qs, p.q + qoff * D, q0, p.tq, true);
  load_rows<D, kTile, kThreads>(dos, p.dout + qoff * D, q0, p.tq, true);
  float lse[2], dvec[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    lse[i] = row < p.tq ? p.lse[qoff + row] : 0.f;
    dvec[i] = row < p.tq ? p.dvec[qoff + row] : 0.f;
  }
  const float* qw = qs + warp * 16 * (D + 4);
  const float* dow = dos + warp * 16 * (D + 4);

  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int k0 = 0; k0 < p.tk; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<D, kTile, kThreads>(ks, p.k + koff * D, k0, p.tk, true);
    load_rows<D, kTile, kThreads>(vs, p.v + koff * D, k0, p.tk, true);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      valid[threadIdx.x] = key < p.tk && p.mask[koff + key] != 0 ? 1.f : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_times_rows_t<D>(s, qw, ks, g, t);    // q·kᵀ
    rows_times_rows_t<D>(dp, dow, vs, g, t);  // dO·vᵀ
    // element e of tile j: row g + 8·(e / 2), key j·8 + 2t + e % 2
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        const float sv = valid[key] > 0.f ? s[j][e] * p.scale : kNegInf;
        const float pr = expf(sv - lse[e >> 1]);
        s[j][e] = pr * (dp[j][e] - dvec[e >> 1]) * p.scale;  // dS
      }
    }
    frag_times_rows<D>(acc, s, ks, g, t);  // dQ += dS·k
  }
  store_rows<D>(p.dq + qoff * D, acc, q0 + warp * 16, p.tq, g, t);
}

// Kernel 2: dK and dV for 64 keys of one (batch·head), looping over query
// tiles, on the transposed scores Sᵀ = k·qᵀ.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int kN = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [64][D+4] k, TF32
  float* vs = ks + kTileFloats<D>;   // [64][D+4] v, TF32
  float* qs = vs + kTileFloats<D>;   // [64][D+4] q, TF32
  float* dos = qs + kTileFloats<D>;  // [64][D+4] dO, TF32
  float* lse_s = dos + kTileFloats<D>;  // [64] (+inf past tq)
  float* dvec_s = lse_s + kTile;          // [64]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long qoff = (long)bh * p.tq;
  const long koff = (long)bh * p.tk;

  load_rows<D, kTile, kThreads>(ks, p.k + koff * D, k0, p.tk, true);
  load_rows<D, kTile, kThreads>(vs, p.v + koff * D, k0, p.tk, true);
  bool key_valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + g + 8 * i;
    key_valid[i] = key < p.tk && p.mask[koff + key] != 0;
  }
  const float* kw = ks + warp * 16 * (D + 4);
  const float* vw = vs + warp * 16 * (D + 4);

  float acc_dk[kN][4], acc_dv[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;
  }

  for (int q0 = 0; q0 < p.tq; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<D, kTile, kThreads>(qs, p.q + qoff * D, q0, p.tq, true);
    load_rows<D, kTile, kThreads>(dos, p.dout + qoff * D, q0, p.tq, true);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < p.tq ? p.lse[qoff + row] : __int_as_float(0x7f800000);  // +inf
      dvec_s[threadIdx.x] = row < p.tq ? p.dvec[qoff + row] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];
    rows_times_rows_t<D>(st, kw, qs, g, t);    // k·qᵀ
    rows_times_rows_t<D>(dpt, vw, dos, g, t);  // v·dOᵀ
    // element e of tile j: key g + 8·(e / 2), query j·8 + 2t + e % 2
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int query = j * 8 + 2 * t + (e & 1);
        const float sv = key_valid[e >> 1] ? st[j][e] * p.scale : kNegInf;
        const float pt = expf(sv - lse_s[query]);
        st[j][e] = pt;                                            // Pᵀ
        dpt[j][e] = pt * (dpt[j][e] - dvec_s[query]) * p.scale;  // dSᵀ
      }
    }
    frag_times_rows<D>(acc_dv, st, dos, g, t);  // dV += Pᵀ·dO
    frag_times_rows<D>(acc_dk, dpt, qs, g, t);  // dK += dSᵀ·q
  }
  store_rows<D>(p.dk + koff * D, acc_dk, k0 + warp * 16, p.tk, g, t);
  store_rows<D>(p.dv + koff * D, acc_dv, k0 + warp * 16, p.tk, g, t);
}

struct DwsParams {
  const float* ca;      // [bh, ta, 2] µm, output side
  const float* cb;      // [bh, tb, 2] µm, summation side
  const float* val;     // [bh, tb, d]
  const uint8_t* mask;  // [bh, tb] nonzero = include b, or NULL (all)
  float* out;           // [bh, ta, d]
  int ta;
  int tb;
};

// Kernel 3: out_a = Σ_b ‖c_a − c_b‖·val_b for 64 rows a of one
// (batch·head), looping over 64-column tiles of b.
template <int D>
__global__ void __launch_bounds__(kThreads) dist_weighted_sum_kernel(const DwsParams p) {
  constexpr int kLd = D + 4;
  constexpr int kN = D / 8;
  constexpr int kChunk = kN < 8 ? kN : 8;  // column tiles per pass (registers)
  extern __shared__ __align__(16) float smem[];
  float* vs = smem;                     // [64][D+4] val, f32
  float* valid = vs + kTileFloats<D>;  // [64]
  float* cbs = valid + kTile;            // [64][2]

  const int bh = blockIdx.y;
  const int a0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long aoff = (long)bh * p.ta;
  const long boff = (long)bh * p.tb;

  float cx[2] = {0.f, 0.f}, cy[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = a0 + warp * 16 + g + 8 * i;
    if (row < p.ta) {
      cx[i] = p.ca[(aoff + row) * 2];
      cy[i] = p.ca[(aoff + row) * 2 + 1];
    }
  }
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int b0 = 0; b0 < p.tb; b0 += kTile) {
    __syncthreads();
    load_rows<D, kTile, kThreads>(vs, p.val + boff * D, b0, p.tb, false);
    if (threadIdx.x < kTile) {
      const int b = b0 + threadIdx.x;
      const bool in_range = b < p.tb;
      valid[threadIdx.x] = in_range && (p.mask == nullptr || p.mask[boff + b] != 0) ? 1.f : 0.f;
      cbs[2 * threadIdx.x] = in_range ? p.cb[(boff + b) * 2] : 0.f;
      cbs[2 * threadIdx.x + 1] = in_range ? p.cb[(boff + b) * 2 + 1] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int n0 = 0; n0 < kN; n0 += kChunk) {
      float tile[kChunk][4];
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) tile[n][e] = 0.f;
      }
      dist_dv_tile<kLd, kChunk>(tile, cx, cy, cbs, valid, vs, n0, g, t);
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + n][e] = __fadd_rn(acc[n0 + n][e], tile[n][e]);
      }
    }
  }
  store_rows<D>(p.out + aoff * D, acc, a0 + warp * 16, p.ta, g, t);
}

template <int D>
cudaError_t launch_bwd(const BwdParams& p, int bh, cudaStream_t stream) {
  constexpr int smem_dq = (4 * kTileFloats<D> + kTile) * 4;
  constexpr int smem_dkv = (4 * kTileFloats<D> + 2 * kTile) * 4;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3((p.tq + kTile - 1) / kTile, bh), kThreads, smem_dq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D><<<dim3((p.tk + kTile - 1) / kTile, bh), kThreads, smem_dkv, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dws(const DwsParams& p, int bh, cudaStream_t stream) {
  constexpr int smem = (kTileFloats<D> + 3 * kTile) * 4;
  cudaError_t err = cudaFuncSetAttribute(dist_weighted_sum_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dist_weighted_sum_kernel<D><<<dim3((p.ta + kTile - 1) / kTile, bh), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [bh, tq, d], k and v [bh, tk, d], dout [bh, tq, d] f32; mask [bh, tk]
// bytes; lse and dvec [bh, tq] f32 in; dq [bh, tq, d], dk and dv [bh, tk, d]
// f32 out.  Scores are scaled by `scale` after the dot.  Every array
// contiguous and 16-byte aligned.  Launches the dQ kernel, then the dK/dV
// kernel, on `stream`.  Returns a cudaError_t.
int stamp_flash_attn_bwd(const void* q, const void* k, const void* v, const void* mask,
                         const void* dout, const void* lse, const void* dvec, void* dq, void* dk,
                         void* dv, int bh, int tq, int tk, int head_dim, float scale, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BwdParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<const float*>(dvec);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_bwd<32>(p, bh, s);
    case 64:
      return launch_bwd<64>(p, bh, s);
    case 128:
      return launch_bwd<128>(p, bh, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ca [bh, ta, 2], cb [bh, tb, 2], val [bh, tb, d] f32; mask [bh, tb] bytes
// or NULL (every b); out [bh, ta, d] f32.  Every array contiguous and
// 16-byte aligned.  Returns a cudaError_t.
int stamp_dist_weighted_sum(const void* ca, const void* cb, const void* val, const void* mask,
                            void* out, int bh, int ta, int tb, int head_dim, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  DwsParams p;
  p.ca = static_cast<const float*>(ca);
  p.cb = static_cast<const float*>(cb);
  p.val = static_cast<const float*>(val);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<float*>(out);
  p.ta = ta;
  p.tb = tb;
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dws<32>(p, bh, s);
    case 64:
      return launch_dws<64>(p, bh, s);
    case 128:
      return launch_dws<128>(p, bh, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
