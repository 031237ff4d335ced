// Masked flash attention, plain and with the post-softmax spatial-ALiBi bias.
//
// Replaces (forward only):
//   * stamp_tpu/ops/flash_attention.py:307 `flash_mha` → `_flash_forward`
//     (:109, pallas_call :115, body `_flash_kernel` :45);
//   * stamp_tpu/ops/flash_attention.py:950 `flash_alibi_mha` →
//     `_flash_alibi_forward` (:810, pallas_call :816, body
//     `_flash_alibi_kernel` :730) and the `out − dist_scale·dacc`
//     combination of `_alibi_core` (:850).
//
// Both compute, per (batch·head) sequence of f32 q, k, v [T, d] and a key
// mask, O = softmax(q·kᵀ·d^-1/2 | masked keys → −1e30)·V with an online
// softmax, and lse = m + log l.  The ALiBi variant adds
// dacc = D·V with D[i, j] = ‖c_i − c_j‖ (0 for masked keys), and
// out = O − dist_scale·dacc.  Neither materialises a [T, T] matrix.
//
// What bounds it on the H100: operations.  At the deploy shapes
// ([8, T, 64], T = 4,097 … 32,769) q·kᵀ and P·V are 4·BH·T²·d flops
// (550 GFLOP at T = 16,385, 1.11 ms at the 495 TFLOP/s TF32 rate) against
// 4·BH·T·d·4 bytes of q, k, v and O (a few tens of MB, about 10 us at
// 3.35 TB/s).  The ALiBi D·V adds 2·BH·T²·d flops that must stay exact f32,
// and a square root per (query, key, head).
//
// What the design does about it:
//   * the TPU grid's sequential key-block axis becomes a loop inside one
//     thread block; the running max, running sum and the O (and dacc)
//     accumulators stay in registers for the whole loop;
//   * a block owns 64 queries of one (batch·head), four warps of 16 rows;
//     at BH = 8, T ≥ 4,097 that is ≥ 520 blocks for 132 SMs.  K and V tiles
//     of 64 keys are staged in shared memory (rows padded to d + 4 floats,
//     so every fragment load below is free of bank conflicts);
//   * arithmetic: q·kᵀ and P·V run on the tensor cores in TF32
//     (mma.sync m16n8k8, f32 accumulate), as the Pallas kernel runs those
//     dots at default precision; scale, mask, max, exp, sum and the final
//     divide run in f32 FFMA/SFU as in the Pallas body.  D·V, which the
//     Pallas kernel runs at Precision.HIGHEST, is a 3×TF32 split
//     (D_hi·V_hi + D_hi·V_lo + D_lo·V_hi), summed per 64-key tile on the
//     tensor cores and across tiles with rounded f32 adds, so it stays
//     within f32 rounding of the plain version at any T.
//     Distances come from per-axis differences (no Gram identity), with
//     no contraction into FMA, so they equal the plain version's;
//   * the score fragment of q·kᵀ is used as the A operand of P·V (and the
//     distance fragment, laid out the same way, as the A operand of D·V)
//     without a shuffle: within each 8-key step the keys are taken in the
//     order (0, 2, 4, 6, 1, 3, 5, 7), and V rows are read in that order;
//   * the key mask is a [BH, T] byte array; keys past T (the ragged last
//     tile) are masked in the kernel instead of padding T on the host.
//     A key counts as masked exactly as in the Pallas body (score −1e30),
//     so a query whose every key is masked behaves the same way there.

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

struct FlashParams {
  const float* q;           // [bh, tq, d]
  const float* k;           // [bh, tk, d]
  const float* v;           // [bh, tk, d]
  const uint8_t* mask;      // [bh, tk], nonzero = valid key
  const float* cq;          // [bh, tq, 2] µm (ALiBi)
  const float* ck;          // [bh, tk, 2] µm (ALiBi)
  const float* dist_scale;  // [bh] (ALiBi)
  float* o;                 // [bh, tq, d] softmax output
  float* dacc;              // [bh, tq, d] D·V (ALiBi)
  float* out;               // [bh, tq, d] o − dist_scale·dacc (ALiBi)
  float* lse;               // [bh, tq]
  int tq;
  int tk;
  float scale;
};

template <int D>
struct Smem {
  static constexpr int kLd = D + 4;  // f32 row stride of the q, k and v tiles
  static constexpr int kBytes = (3 * kBlockQ * kLd + kBlockK + 2 * kBlockK) * 4;
};

template <int D, bool kAlibi>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashParams p) {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int kLd = Smem<D>::kLd;
  constexpr int kN = D / 8;  // 8-wide column tiles of O; 8-deep steps of q·kᵀ
  constexpr int kDaccChunk = kN < 8 ? kN : 8;  // dacc column tiles per pass
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [64][kLd] q, TF32-rounded
  float* ks = qs + kBlockQ * kLd;  // [64][kLd] k, TF32-rounded
  float* vs = ks + kBlockK * kLd;  // [64][kLd] v, f32
  float* valid = vs + kBlockK * kLd;  // [64] 1 = valid key, 0 = masked or past tk
  float* cks = valid + kBlockK;       // [64][2] key coordinates

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float* qw = qs + warp * 16 * kLd;

  load_rows<D, kBlockQ, kThreads>(qs, p.q + (long)bh * p.tq * D, q0, p.tq, true);

  float cqx[2] = {0.f, 0.f}, cqy[2] = {0.f, 0.f};
  if constexpr (kAlibi) {
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < p.tq) {
        cqx[i] = p.cq[((long)bh * p.tq + row) * 2];
        cqy[i] = p.cq[((long)bh * p.tq + row) * 2 + 1];
      }
    }
  }

  float acc_o[kN][4];
  float acc_d[kAlibi ? kN : 1][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[n][e] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < (kAlibi ? kN : 1); ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_d[n][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int k0 = 0; k0 < p.tk; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<D, kBlockK, kThreads>(ks, p.k + (long)bh * p.tk * D, k0, p.tk, true);
    load_rows<D, kBlockK, kThreads>(vs, p.v + (long)bh * p.tk * D, k0, p.tk, false);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      const bool in_range = key < p.tk;
      valid[threadIdx.x] = in_range && p.mask[(long)bh * p.tk + key] != 0 ? 1.f : 0.f;
      if constexpr (kAlibi) {
        cks[2 * threadIdx.x] = in_range ? p.ck[((long)bh * p.tk + key) * 2] : 0.f;
        cks[2 * threadIdx.x + 1] = in_range ? p.ck[((long)bh * p.tk + key) * 2 + 1] : 0.f;
      }
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

    // scale, mask and the online-softmax update (element e of tile j sits
    // at row row0 + 8·(e / 2), key j·8 + 2t + e % 2)
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        s[j][e] = valid[key] > 0.f ? s[j][e] * p.scale : kNegInf;
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

    // O += P·V: step j covers keys j·8 … j·8+7 in the order (0,2,4,6,1,3,5,7),
    // so the A fragment is the score fragment (c0, c2, c1, c3) and the B
    // fragment reads V rows j·8 + 2t and j·8 + 2t + 1
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

    if constexpr (kAlibi) {
      // dacc += D·V in 3×TF32, D laid out like the score fragment.  The
      // tensor cores' f32 accumulation does not round to nearest, so over a
      // whole key loop its error would grow with T: each tile's product is
      // summed over its 64 keys in a fresh register tile and added to dacc
      // with a rounded f32 add.  Column tiles go 8 at a time (registers);
      // at d = 128 the distances are computed once per half.
#pragma unroll
      for (int n0 = 0; n0 < kN; n0 += kDaccChunk) {
        float tile[kDaccChunk][4];
#pragma unroll
        for (int n = 0; n < kDaccChunk; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) tile[n][e] = 0.f;
        }
        dist_dv_tile<kLd, kDaccChunk>(tile, cqx, cqy, cks, valid, vs, n0, g, t);
#pragma unroll
        for (int n = 0; n < kDaccChunk; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc_d[n0 + n][e] = __fadd_rn(acc_d[n0 + n][e], tile[n][e]);
        }
      }
    }
  }

  // epilogue: full row sums, O = acc / max(l, 1e-30), lse = m + log max(l, 1e-30)
  float denom[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    denom[i] = fmaxf(l[i], 1e-30f);
  }
  const float ds = kAlibi ? p.dist_scale[bh] : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.tq) continue;
    const long base = ((long)bh * p.tq + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float o0 = acc_o[n][2 * i] / denom[i];
      const float o1 = acc_o[n][2 * i + 1] / denom[i];
      *reinterpret_cast<float2*>(p.o + base + n * 8) = make_float2(o0, o1);
      if constexpr (kAlibi) {
        const float d0 = acc_d[n][2 * i], d1 = acc_d[n][2 * i + 1];
        *reinterpret_cast<float2*>(p.dacc + base + n * 8) = make_float2(d0, d1);
        *reinterpret_cast<float2*>(p.out + base + n * 8) = make_float2(o0 - ds * d0, o1 - ds * d1);
      }
    }
    if (t == 0) p.lse[(long)bh * p.tq + row] = m[i] + logf(denom[i]);
  }
}

template <int D, bool kAlibi>
cudaError_t launch(const FlashParams& p, int bh, cudaStream_t stream) {
  constexpr int smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kAlibi>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<D, kAlibi><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kAlibi>
cudaError_t dispatch(const FlashParams& p, int bh, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<32, kAlibi>(p, bh, stream);
    case 64:
      return launch<64, kAlibi>(p, bh, stream);
    case 128:
      return launch<128, kAlibi>(p, bh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [bh, tq, d], k and v [bh, tk, d] f32; mask [bh, tk] bytes; o [bh, tq, d]
// and lse [bh, tq] f32.  With alibi != 0 also cq [bh, tq, 2], ck [bh, tk, 2],
// dist_scale [bh] f32 in and dacc, out [bh, tq, d] f32 out; otherwise those
// pointers may be NULL.  Scores are scaled by `scale` after the dot.  Every
// array contiguous and 16-byte aligned.
// Returns a cudaError_t.
int stamp_flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask,
                         const void* cq, const void* ck, const void* dist_scale, void* o,
                         void* dacc, void* out, void* lse, int bh, int tq, int tk, int head_dim,
                         float scale, int alibi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FlashParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.cq = static_cast<const float*>(cq);
  p.ck = static_cast<const float*>(ck);
  p.dist_scale = static_cast<const float*>(dist_scale);
  p.o = static_cast<float*>(o);
  p.dacc = static_cast<float*>(dacc);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  return alibi ? dispatch<true>(p, bh, head_dim, s) : dispatch<false>(p, bh, head_dim, s);
}

}  // extern "C"
