// Flash attention with a pre-softmax 2-D ALiBi distance bias (TITAN):
//   s[i, j] = (q_i·k_j)·d^-1/2 − slope·‖c_i − c_j‖,   out = softmax(s)·V
// with no bias on row 0 and column 0 when exempt_first (the CLS token
// attends and is attended without penalty).  One sequence per (batch·head),
// queries and keys share it.
//
// Replaces (forward; the Pallas kernel has no VJP): stamp_tpu/ops/
// flash_attention.py:433 `flash_alibi2d_mha` (pallas_call :476, body
// `_flash_prebias_kernel` :343).
//
// What bounds it on the H100: operations.  At TITAN's shapes ([12, N, 64],
// N = 4,097 … 20,000 tiles + CLS) q·kᵀ and P·V are 4·BH·N²·d flops (825
// GFLOP at N = 16,385: 1.67 ms at the 495 TFLOP/s TF32 rate) against
// 4·BH·N·d·4 bytes of q, k, v and the output (about 0.06 ms at 3.35 TB/s).
// The bias adds a square root and a few f32 operations per (query, key,
// head) pair.
//
// What the design does about it: flash_attn.cu's forward block, with the
// bias computed in the kernel and never stored:
//   * a block owns 64 queries of one (batch·head), four warps of 16 rows,
//     and loops over 64-key tiles; the running max, the running sum and the
//     O accumulator stay in registers;
//   * K and V tiles of 64 keys and their coordinates are staged in shared
//     memory; a thread keeps the coordinates of its two query rows in
//     registers;
//   * q·kᵀ and P·V run on the tensor cores in TF32 (mma.sync m16n8k8, f32
//     accumulate), as the Pallas kernel runs those dots at default
//     precision; the scale, the bias, the mask, max, exp, sum and the final
//     divide run in f32.  The distance comes from per-axis differences
//     (exact for grid coordinates) with no contraction into FMA, and the
//     bias is added before the running max, as in the Pallas body;
//   * the score fragment is the A operand of P·V through the key order
//     (0, 2, 4, 6, 1, 3, 5, 7) of each 8-key step (tf32_tiles.cuh);
//   * keys past N (the ragged last tile) score −1e30 and queries past N are
//     not stored: no padding on the host.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_tiles.cuh"

namespace {

constexpr int kBlockQ = 64;  // queries per block
constexpr int kBlockK = 64;  // keys per tile
constexpr int kWarps = 4;    // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

struct Alibi2dParams {
  const float* q;       // [bh, n, d]
  const float* k;       // [bh, n, d]
  const float* v;       // [bh, n, d]
  const float* coords;  // [bh, n, 2]
  const float* slopes;  // [bh]
  float* out;           // [bh, n, d]
  int n;
  float scale;
  bool exempt_first;
};

template <int D>
struct Alibi2dSmem {
  static constexpr int kLd = D + 4;  // f32 row stride of the q, k and v tiles
  static constexpr int kBytes = (3 * kBlockQ * kLd + 2 * kBlockK) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_alibi2d_kernel(const Alibi2dParams p) {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int kLd = Alibi2dSmem<D>::kLd;
  constexpr int kN = D / 8;  // 8-wide column tiles of O; 8-deep steps of q·kᵀ
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [64][kLd] q, TF32-rounded
  float* ks = qs + kBlockQ * kLd;  // [64][kLd] k, TF32-rounded
  float* vs = ks + kBlockK * kLd;  // [64][kLd] v, f32
  float* cks = vs + kBlockK * kLd;  // [64][2] key coordinates

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float* qw = qs + warp * 16 * kLd;
  const long seq = (long)bh * p.n;
  const float slope = p.slopes[bh];

  load_rows<D, kBlockQ, kThreads>(qs, p.q + seq * D, q0, p.n, true);
  float cqx[2] = {0.f, 0.f}, cqy[2] = {0.f, 0.f};
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row < p.n) {
      cqx[i] = p.coords[(seq + row) * 2];
      cqy[i] = p.coords[(seq + row) * 2 + 1];
    }
  }

  float acc_o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[n][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int k0 = 0; k0 < p.n; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<D, kBlockK, kThreads>(ks, p.k + seq * D, k0, p.n, true);
    load_rows<D, kBlockK, kThreads>(vs, p.v + seq * D, k0, p.n, false);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      const bool in_range = key < p.n;
      cks[2 * threadIdx.x] = in_range ? p.coords[(seq + key) * 2] : 0.f;
      cks[2 * threadIdx.x + 1] = in_range ? p.coords[(seq + key) * 2 + 1] : 0.f;
    }
    __syncthreads();

    // S = q·kᵀ for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kN; ++kk) {
      const uint32_t a0 = __float_as_uint(qw[g * kLd + kk * 8 + t]);
      const uint32_t a1 = __float_as_uint(qw[(g + 8) * kLd + kk * 8 + t]);
      const uint32_t a2 = __float_as_uint(qw[g * kLd + kk * 8 + t + 4]);
      const uint32_t a3 = __float_as_uint(qw[(g + 8) * kLd + kk * 8 + t + 4]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* kr = ks + (j * 8 + g) * kLd + kk * 8;
        mma_tf32(s[j], a0, a1, a2, a3, __float_as_uint(kr[t]), __float_as_uint(kr[t + 4]));
      }
    }

    // scale, distance bias, mask and the online-softmax update (element e
    // of tile j sits at row row0 + 8·(e / 2), key j·8 + 2t + e % 2)
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kt = j * 8 + 2 * t + (e & 1);
        const int key = k0 + kt;
        const int row = row0 + 8 * (e >> 1);
        const float dx = cqx[e >> 1] - cks[2 * kt];
        const float dy = cqy[e >> 1] - cks[2 * kt + 1];
        const float dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        const bool exempt = p.exempt_first && (row == 0 || key == 0);
        const float bias = exempt ? 0.f : __fmul_rn(-slope, dist);
        s[j][e] = key < p.n ? __fadd_rn(__fmul_rn(s[j][e], p.scale), bias) : kNegInf;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        row_sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + row_sum[i];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      acc_o[n][0] *= alpha[0];
      acc_o[n][1] *= alpha[0];
      acc_o[n][2] *= alpha[1];
      acc_o[n][3] *= alpha[1];
    }

    // O += P·V with the score fragment as the A operand (keys of each
    // 8-step in the order 0,2,4,6,1,3,5,7; V rows j·8 + 2t and j·8 + 2t + 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t a0 = to_tf32(s[j][0]), a1 = to_tf32(s[j][2]);
      const uint32_t a2 = to_tf32(s[j][1]), a3 = to_tf32(s[j][3]);
      const float* v0 = vs + (j * 8 + 2 * t) * kLd;
      const float* v1 = v0 + kLd;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        mma_tf32(acc_o[n], a0, a1, a2, a3, to_tf32(v0[n * 8 + g]), to_tf32(v1[n * 8 + g]));
      }
    }
  }

  // epilogue: full row sums, O = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
    const int row = row0 + 8 * i;
    if (row >= p.n) continue;
    const long base = (seq + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      *reinterpret_cast<float2*>(p.out + base + n * 8) =
          make_float2(acc_o[n][2 * i] / denom, acc_o[n][2 * i + 1] / denom);
    }
  }
}

template <int D>
cudaError_t launch_alibi2d(const Alibi2dParams& p, int bh, cudaStream_t stream) {
  constexpr int smem = Alibi2dSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_alibi2d_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + kBlockQ - 1) / kBlockQ, bh);
  flash_alibi2d_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v [bh, n, d] f32; coords [bh, n, 2] f32; slopes [bh] f32; out
// [bh, n, d] f32.  Scores are scaled by `scale` after the dot; with
// exempt_first != 0 row 0 and column 0 get no bias.  Every array contiguous
// and 16-byte aligned; d in (32, 64, 128).  Returns a cudaError_t.
int stamp_flash_alibi2d_fwd(const void* q, const void* k, const void* v, const void* coords,
                            const void* slopes, void* out, int bh, int n, int head_dim,
                            float scale, int exempt_first, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Alibi2dParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.coords = static_cast<const float*>(coords);
  p.slopes = static_cast<const float*>(slopes);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.scale = scale;
  p.exempt_first = exempt_first != 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_alibi2d<32>(p, bh, s);
    case 64:
      return launch_alibi2d<64>(p, bh, s);
    case 128:
      return launch_alibi2d<128>(p, bh, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
