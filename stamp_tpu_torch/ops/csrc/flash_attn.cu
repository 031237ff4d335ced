// Masked flash attention of the MIL ViT, plain and with the post-softmax
// spatial-ALiBi bias (forward).
//
// Replaces:
//   * stamp_tpu/ops/flash_attention.py:307 `flash_mha` → `_flash_forward`
//     (:109, pallas_call :115, body `_flash_kernel` :45), reached through
//     `_flash_core` (:220);
//   * stamp_tpu/ops/flash_attention.py:950 `flash_alibi_mha` →
//     `_flash_alibi_forward` (:810, pallas_call :816, body
//     `_flash_alibi_kernel` :730) and the `out − dist_scale·dacc`
//     combination of `_alibi_core` (:850).
//
// Both compute, per (batch·head) sequence of f32 q [Tq, d], k and v [Tk, d]
// and a key mask, O = softmax(q·kᵀ·scale | masked keys → −1e30)·V with an
// online softmax, and lse = m + log l.  The ALiBi variant adds
// dacc = D·V with D[i, j] = ‖c_i − c_j‖ (0 for masked keys), and
// out = O − dist_scale·dacc.  Neither materialises a [Tq, Tk] matrix.
//
// What bounds it on the H100: operations.  At the deploy and training shapes
// ([8, T, 64], T = 4,097 … 32,769, bucket padding masking up to half the
// keys) q·kᵀ and P·V are 4·BH·Tq·Tk_valid·d flops (330 GFLOP at T = 16,385
// with 60% of the keys valid: 0.67 ms at the 495 TFLOP/s TF32 rate) against
// a few tens of MB of q, k, v, O and copies (about 0.03 ms at 3.35 TB/s).
// The ALiBi D·V adds 2·BH·Tq·Tk_valid·d flops that must stay f32-accurate.
//
// The plain forward is three launches on the caller's stream (the
// machinery of tf32_wgmma.cuh, as TITAN's flash_alibi2d.cu uses it):
//   1. flash_fwd_prepass_kernel, 128 rows a block: TF32-rounded (cvt.rna)
//      copies of q and k; the transposed rounded copy Vᵀ [bh, d, tk_pad] in
//      the depth order (0, 2, 4, 6, 1, 3, 5, 7) within each 8 (so that the
//      probabilities' accumulator registers are P·V's A operand as they
//      stand); the key mask as the score a key takes instead of its own
//      (0: valid, kMasked: masked, −inf: past Tk); and two flags per 32
//      keys: one of them is valid, all of them are;
//   2. flash_fwd_lists_kernel: per sequence, the increasing list of key
//      tiles that hold a valid key (every tile when the sequence has none),
//      each with a bit that says whether all its keys are valid;
//   3. flash_fwd_kernel: a block owns 64·kGroups queries of one
//      (batch·head), loaded once by TMA into shared memory (the A operand of
//      S = q·kᵀ, SS form); one producer thread keeps a ring of stages (a
//      listed key tile of k, its Vᵀ columns and its mask scores) filled by
//      TMA through "full" and "empty" mbarriers; each consumer warpgroup of
//      64 queries runs S = q·kᵀ by TF32 wgmma (m64nNk8), the online softmax
//      in registers, and O += P·V by wgmma with P from registers (RS).  A
//      warpgroup issues tile n's scores and tile n − 1's P·V together and
//      runs tile n's softmax while P·V is on the tensor cores; the two
//      warpgroups take turns at issuing (named barriers), so that one's
//      softmax also runs beside the other's products.  The producer gives
//      its registers to the consumers (setmaxnreg).
// The ALiBi forward is the distance-weighted sum of flash_attn_bwd.cu
// (kernels 5–7: dacc = D·V with the queries as rows a and the keys as b,
// under the key mask; three TF32 products a k-step, f32-accurate), then
// kernels 1–3 with an epilogue that reads dacc and writes O, lse and
// out = O − dist_scale·dacc.  One C entry launches all six.
//
// Tiles left out, their contribution being exactly zero (as the backward
// leaves them out, flash_attn_bwd.cu): a key tile with no valid key, in a
// sequence that has one.  Its keys score −1e30, and the softmax over the
// listed tiles equals the softmax over all of them:
//   * after the first valid key the running max m is a valid score, and a
//     masked key weighs exp(−1e30 − m) = 0;
//   * before it, the running max and sums carry only masked keys, and the
//     first valid key rescales them by α = exp(−1e30 − m) = 0, so a tile
//     met before it adds nothing either;
//   * D is 0 on masked keys, so the D·V weights there are 0.
// A sequence with no valid key keeps every tile: there every key in range
// scores −1e30, P = 1, O is the mean of V and lse = −1e30 + log Tk, as in
// the plain version.  Keys past Tk weigh exactly 0 (score −inf), so that
// mean is over the Tk keys only.
//
// Per element the softmax is cut to what the function needs: the scores
// stay in units of the scale (u = q·k, s = u·scale) and exp(s − m) is one
// FMA and one ex2 (2^(u·c − m_u·c), c = scale·log2 e); the mask is applied
// only in the listed tiles that hold a masked key or a key past Tk (a
// compare and a select a score); P is rounded to TF32 by two integer
// operations (tf32_round) instead of cvt.rna.  A masked key scores
// kMasked = −2^100 in units of the scale: kMasked·c is exact, so in a
// sequence with no valid key u·c − m_u·c is exactly 0 and P exactly 1; lse
// there is taken as −1e30 + log l, the plain version's.
//
// Numerics, as the Pallas bodies: q·kᵀ and P·V in TF32 (both operands
// rounded), f32 accumulation, scores scaled after the dot, the final divide
// by max(l, 1e-30) in f32, lse = m + log max(l, 1e-30) in natural units.
// Head widths d ∈ {32, 64, 128}; any Tq, Tk ≥ 1 (rows and keys past them
// are TMA's zero fill and the pre-pass's padding; those rows are not
// stored).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "tf32_wgmma.cuh"

extern "C" int stamp_dist_weighted_sum_workspace(int bh, int ta, int tb, int head_dim, void* bytes);
extern "C" int stamp_dist_weighted_sum(const void* ca, const void* cb, const void* val, const void* b_mask,
                                       const void* a_mask, void* workspace, void* out, int bh, int ta, int tb,
                                       int head_dim, int device, void* stream);

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMasked = -0x1p100f;  // a masked key's score in units of the scale (see the top)
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2^(x·log2 e)

// Per head width: kGroups consumer warpgroups (64 queries each) per block,
// kTile keys per loop step, and the ring's stages (flash_alibi2d.cu's
// A2Cfg).  A consumer holds the scores (kTile / 2 registers), two tiles'
// TF32 P fragments (kTile / 2 each) and the output accumulator (d / 2).
// Shared memory at d = 64: 32 KB of queries and 4 stages of 33 KB.
template <int D>
struct FwdCfg;
template <>
struct FwdCfg<32> {
  static constexpr int kGroups = 2, kTile = 64, kStages = 4;
};
template <>
struct FwdCfg<64> {
  static constexpr int kGroups = 2, kTile = 64, kStages = 4;
};
template <>
struct FwdCfg<128> {
  static constexpr int kGroups = 2, kTile = 32, kStages = 3;
};

struct FwdParams {
  const float* q;           // [bh, tq, d]
  const float* k;           // [bh, tk, d]
  const float* v;           // [bh, tk, d]
  const uint8_t* mask;      // [bh, tk], nonzero = valid key
  const float* dacc;        // [bh, tq, d] D·V (ALiBi), from the distance-weighted sum
  const float* dist_scale;  // [bh] (ALiBi)
  float* o;                 // [bh, tq, d] softmax output
  float* out;               // [bh, tq, d] o − dist_scale·dacc (ALiBi)
  float* lse;               // [bh, tq]
  // the workspace (written by kernels 1 and 2)
  float* qr;                // [bh, tq, d] q, TF32
  float* kr;                // [bh, tk, d] k, TF32
  float* vt;                // [bh, d, tk_pad] Vᵀ, TF32, depth order within 8s
  float* kscore;            // [bh, tk_pad] 0 valid, kMasked masked, −inf past tk
  int* kflags;              // [bh, tk_pad / 32] bit 0: one of the 32 keys is valid; bit 1: all are
  int* klist;               // [bh, tk_pad / 32] listed key tiles, increasing: tile << 1 | all keys valid
  int* kcount;              // [bh]
  int* any_valid;           // [bh] the sequence has a valid key
  int tq, tk, tq_pad, tk_pad;
  float scale;
};

// The block's queries (boxes [64·kGroups, 32]), then stages of a key tile:
// k (B of S = q·kᵀ, N = kTile), Vᵀ (B of O += P·V, N = d), the keys' mask
// scores.
template <int D>
struct FwdLayout {
  using C = FwdCfg<D>;
  using Own = Boxes<64 * C::kGroups, D>;
  using Rows = Boxes<C::kTile, D>;
  using Cols = Boxes<D, C::kTile>;
  static constexpr int kVt = Rows::kBytes, kMask = Rows::kBytes + Cols::kBytes;
  static constexpr uint32_t kTx = kMask + C::kTile * 4;
  static constexpr int kStage = round_up(kTx, 1024);
  static constexpr int kSmem = ring_smem(Own::kBytes, C::kStages, kStage);
};

// ---- 1. the pre-pass ---------------------------------------------------------------

// One block per 128 rows of a sequence (two halves of 64 through `tile`):
// the query side's TF32 copy; the key side's TF32 copy of k, Vᵀ, the mask
// scores and the flags (one warp a 32-key unit).
template <int D>
__global__ void __launch_bounds__(kPreThreads) flash_fwd_prepass_kernel(const FwdParams p) {
  __shared__ float tile[kHalf][D + 1];
  const int bh = blockIdx.y, r0 = blockIdx.x * kPreRows;
  if (r0 < p.tq_pad) {  // uniform in the block
    const long qb = (long)bh * p.tq;
    for (int h0 = r0; h0 < r0 + kPreRows; h0 += kHalf) round_rows<D, false>(nullptr, p.q + qb * D, p.qr + qb * D, h0, p.tq);
  }
  if (r0 < p.tk_pad) {
    const long kb = (long)bh * p.tk;
    for (int h0 = r0; h0 < r0 + kPreRows; h0 += kHalf) {
      round_rows<D, false>(nullptr, p.k + kb * D, p.kr + kb * D, h0, p.tk);
      round_rows<D, true>(tile, p.v + kb * D, nullptr, h0, p.tk);
      __syncthreads();
      write_transposed<D>(tile, p.vt + (long)bh * D * p.tk_pad, h0, p.tk_pad);
      __syncthreads();
    }
    if (threadIdx.x < kPreRows) {  // warps 0–3: one 32-key unit each
      const int row = r0 + threadIdx.x;
      const bool in_range = row < p.tk;
      const bool valid = in_range && p.mask[kb + row] != 0;
      p.kscore[(long)bh * p.tk_pad + row] = valid ? 0.f : in_range ? kMasked : -INFINITY;
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (threadIdx.x % 32 == 0)
        p.kflags[(long)bh * (p.tk_pad / kUnit) + row / kUnit] = (ballot != 0u) | ((ballot == 0xffffffffu) << 1);
    }
  }
}

// ---- 2. the tile list ------------------------------------------------------------

// One warp per sequence: the increasing list of key tiles of kTile keys that
// hold a valid key (every tile when the sequence has none), each entry
// tile << 1 | (all its keys are valid).
template <int kTile>
__global__ void __launch_bounds__(32) flash_fwd_lists_kernel(const FwdParams p) {
  constexpr int kPer = kTile / kUnit;
  const int bh = blockIdx.x, lane = threadIdx.x;
  const int units = p.tk_pad / kUnit;
  const int* flags = p.kflags + (long)bh * units;
  int* list = p.klist + (long)bh * units;
  int any = 0;
  for (int u = lane; u < units; u += 32) any |= flags[u] & 1;
  any = __any_sync(0xffffffffu, any);
  const int tiles = (p.tk + kTile - 1) / kTile;
  int count = 0;
  for (int base = 0; base < tiles; base += 32) {
    const int i = base + lane;
    bool on = false, full = true;
    if (i < tiles) {
      on = !any;
      for (int u = 0; u < kPer; ++u) {
        on |= (flags[i * kPer + u] & 1) != 0;
        full &= (flags[i * kPer + u] & 2) != 0;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (on) list[count + __popc(ballot & ((1u << lane) - 1))] = i << 1 | full;
    count += __popc(ballot);
  }
  if (lane == 0) {
    p.kcount[bh] = count;
    p.any_valid[bh] = any;
  }
}

// ---- 3. the attention ------------------------------------------------------------

// The mask scores of a tile that holds a masked key or a key past tk: score
// element e of k-step j sits at key 8j + 2t + e % 2 of the tile, whose mask
// score is 0 for a valid key (the score stays) or the score it takes.
template <int kT>
__device__ __forceinline__ void apply_mask(float (&sc)[kT / 2], const float2* ks, int t) {
#pragma unroll
  for (int j = 0; j < kT / 8; ++j) {
    const float2 m = ks[4 * j + t];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mk = (e & 1) ? m.y : m.x;
      sc[4 * j + e] = mk == 0.f ? sc[4 * j + e] : mk;
    }
  }
}

// 64·kGroups queries of one (batch·head) against the listed key tiles.
// Maps: the TF32 q rows (boxes [64·kGroups, 32]), k rows (boxes [kTile,
// 32]), Vᵀ (boxes [d, 32]) and the mask scores ([bh, tk_pad], boxes of
// kTile floats).  With kAlibi the epilogue also writes out = O −
// dist_scale·dacc.
template <int D, bool kAlibi>
__global__ void __launch_bounds__(128 * (FwdCfg<D>::kGroups + 1), 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap vt_map, const __grid_constant__ CUtensorMap m_map,
                 const FwdParams p) {
  using C = FwdCfg<D>;
  using L = FwdLayout<D>;
  static_assert(C::kGroups == 2, "the consumer warpgroups take turns in pairs");
  constexpr int S = C::kStages, kRows = 64 * C::kGroups, kT = C::kTile;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int count = p.kcount[bh];  // ≥ 1: tk ≥ 1
  const int* list = p.klist + (long)bh * (p.tk_pad / kUnit);

  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring<L::Own::kBytes, S, L::kStage, C::kGroups>(smem_raw);

  const int wg = threadIdx.x / 128;
  if (wg == C::kGroups) {
    // producer: one thread keeps the ring full
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == C::kGroups * 128) {
      mbar_expect_tx(ring.own_bar, L::Own::kBytes);
      for (int b = 0; b < D / 32; ++b)
        tma_load_3d(ring.own + b * L::Own::kBoxBytes, &q_map, ring.own_bar, 32 * b, q0, bh);
      for (int n = 0; n < count; ++n) {
        const int s = n % S;
        mbar_wait(&ring.empty[s], ((n / S) & 1) ^ 1);  // round 0 passes: the ring starts empty
        mbar_expect_tx(&ring.full[s], L::kTx);
        const int k0 = (list[n] >> 1) * kT;
        uint8_t* st = ring.stages + s * L::kStage;
        for (int b = 0; b < D / 32; ++b)
          tma_load_3d(st + b * L::Rows::kBoxBytes, &k_map, &ring.full[s], 32 * b, k0, bh);
        for (int b = 0; b < kT / 32; ++b)
          tma_load_3d(st + L::kVt + b * L::Cols::kBoxBytes, &vt_map, &ring.full[s], k0 + 32 * b, 0, bh);
        tma_load_2d(st + L::kMask, &m_map, &ring.full[s], k0, bh);
      }
    }
    return;
  }

  // consumers: 64 queries a warpgroup
  reg_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4);  // this warp's first query
  const int wg_rows = (64 * wg * kBoxRowBytes) >> 4;  // this warpgroup's rows in an own box (16-byte units)
  const bool signals = threadIdx.x % 128 == 0;  // one arrival per warpgroup on "empty"
  const float c_scale = p.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};  // running max (units of the scale), below kMasked
  float l[2] = {0.f, 0.f};              // this thread's share of the running row sums
  float alpha[2];                       // the last tile's rescale of the running sums
  float acc[D / 2], sc[kT / 2];
  uint32_t pa[kT / 8][4], pb[kT / 8][4];  // P of the tile in flight and of the next one
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint8_t* own = ring.own;
  auto stage = [&](int n) { return ring.stages + (n % S) * L::kStage; };
  auto issue_scores = [&](int n) {  // S = q·kᵀ of listed tile n, once its stage is full
    mbar_wait(&ring.full[n % S], (n / S) & 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      wgmma_tf32_ss(sc, kstep_desc<kRows>(own, j) + wg_rows, kstep_desc<kT>(stage(n), j), j);
    wgmma_commit();
  };
  // listed tile n's scores (complete) → its P fragments, the running max and sums
  auto softmax = [&](int n, uint32_t (&frag)[kT / 8][4]) {
    fence_operands(sc);
    if (!(list[n] & 1)) apply_mask<kT>(sc, reinterpret_cast<const float2*>(stage(n) + L::kMask), t);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2_approx((m[h] - mx[h]) * c_scale);  // 0 on the first tile (m = −inf)
      m[h] = mx[h];
    }
    // P = exp(s − m) = 2^(u·c − m·c) as TF32 A fragments of O += P·V
    // (depth order within 8s)
    const float mc[2] = {-m[0] * c_scale, -m[1] * c_scale};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[e] = exp2_approx(fmaf(sc[4 * j + e], c_scale, mc[e >> 1]));
        rs[e >> 1] += pr[e];
      }
      frag[j][0] = tf32_round(pr[0]);
      frag[j][1] = tf32_round(pr[2]);
      frag[j][2] = tf32_round(pr[1]);
      frag[j][3] = tf32_round(pr[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + rs[h];
  };
  auto issue_pv = [&](int n, const uint32_t (&frag)[kT / 8][4]) {  // O += P·V of listed tile n
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) wgmma_tf32_rs(acc, frag[j], kstep_desc<D>(stage(n) + L::kVt, j), 1);
    wgmma_commit();
  };
  // Listed tile n: its scores and the previous tile's P·V are issued
  // together, the two warpgroups taking turns (named barriers 1 and 2:
  // warpgroup w waits on 1 + w, then lets the other go); the softmax of
  // tile n runs while P·V of tile n − 1 is on the tensor cores, then the
  // output is rescaled and tile n − 1's stage released.
  auto step = [&](int n, uint32_t (&prev)[kT / 8][4], uint32_t (&cur)[kT / 8][4]) {
    named_barrier_sync(1 + wg, 256);
    wgmma_fence();
    issue_scores(n);
    issue_pv(n - 1, prev);
    named_barrier_arrive(2 - wg, 256);
    wgmma_wait<1>();  // the scores
    softmax(n, cur);
    wgmma_wait<0>();  // P·V of tile n − 1
    fence_operands(acc);
    fence_frags(prev);
    if (signals) mbar_arrive(&ring.empty[(n - 1) % S]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  };

  if (wg == 1) named_barrier_arrive(1, 256);  // warpgroup 0 takes the first turn
  mbar_wait(ring.own_bar, 0);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  softmax(0, pa);
  int n = 1;
  for (; n + 1 < count; n += 2) {
    step(n, pa, pb);
    step(n + 1, pb, pa);
  }
  if (n < count) step(n++, pa, pb);
  wgmma_fence();
  if ((n - 1) % 2 == 0) {  // tile k's P is in pa for even k
    issue_pv(n - 1, pa);
  } else {
    issue_pv(n - 1, pb);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  fence_frags(pa);
  fence_frags(pb);

  // O = acc / max(l, 1e-30) and lse = m + log max(l, 1e-30), the row sums
  // gathered over the quad; a sequence with no valid key has m = −1e30
  const bool any = p.any_valid[bh] != 0;
  float* lse = p.lse + (long)bh * p.tq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 2 * h] /= denom;
      acc[4 * j + 2 * h + 1] /= denom;
    }
    const int row = row0 + g + 8 * h;
    if (t == 0 && row < p.tq) lse[row] = (any ? m[h] * p.scale : kNegInf) + logf(denom);
  }
  const long base = (long)bh * p.tq * D;
  store_acc<D>(p.o + base, acc, row0, p.tq, g, t);
  if constexpr (kAlibi) {
    const float ds = p.dist_scale[bh];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row >= p.tq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const long at = base + (long)row * D + 8 * j + 2 * t;
        const float2 da = *reinterpret_cast<const float2*>(p.dacc + at);
        *reinterpret_cast<float2*>(p.out + at) =
            make_float2(acc[4 * j + 2 * h] - ds * da.x, acc[4 * j + 2 * h + 1] - ds * da.y);
      }
    }
  }
}

// ---- host side --------------------------------------------------------------------

// The workspace, carved from `base` (or from address 0, to size it) in
// 256-byte-aligned arrays; returns its bytes.
inline size_t carve_workspace(FwdParams* p, uint8_t* base, int bh, int tq, int tk, int d) {
  const size_t tk_pad = round_up(tk, kPad);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    uint8_t* ptr = base == nullptr ? nullptr : base + at;
    at = (at + bytes + 255) / 256 * 256;
    return ptr;
  };
  const size_t f = sizeof(float), i = sizeof(int);
  p->qr = reinterpret_cast<float*>(take(f * bh * tq * d));
  p->kr = reinterpret_cast<float*>(take(f * bh * tk * d));
  p->vt = reinterpret_cast<float*>(take(f * bh * d * tk_pad));
  p->kscore = reinterpret_cast<float*>(take(f * bh * tk_pad));
  p->kflags = reinterpret_cast<int*>(take(i * bh * (tk_pad / kUnit)));
  p->klist = reinterpret_cast<int*>(take(i * bh * (tk_pad / kUnit)));
  p->kcount = reinterpret_cast<int*>(take(i * bh));
  p->any_valid = reinterpret_cast<int*>(take(i * bh));
  return at;
}

// The pre-pass and the list go first; the host encodes the tensor maps
// meanwhile.
template <int D, bool kAlibi>
cudaError_t launch_fwd(const FwdParams& p, int bh, cudaStream_t stream) {
  using C = FwdCfg<D>;
  constexpr int kRows = 64 * C::kGroups, kSmem = FwdLayout<D>::kSmem;
  cudaError_t err;
  flash_fwd_prepass_kernel<D><<<dim3((p.tq_pad > p.tk_pad ? p.tq_pad : p.tk_pad) / kPreRows, bh), kPreThreads, 0,
                                stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_fwd_lists_kernel<C::kTile><<<bh, 32, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  CUtensorMap q_map, k_map, vt_map, m_map;
  if ((err = encode_rows(&q_map, p.qr, bh, p.tq, D, kRows)) != cudaSuccess ||
      (err = encode_rows(&k_map, p.kr, bh, p.tk, D, C::kTile)) != cudaSuccess ||
      (err = encode_cols(&vt_map, p.vt, bh, p.tk_pad, D)) != cudaSuccess ||
      (err = encode_vec(&m_map, p.kscore, bh, p.tk_pad, C::kTile)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_fwd_kernel<D, kAlibi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmem)) != cudaSuccess)
    return err;
  flash_fwd_kernel<D, kAlibi><<<dim3(p.tq_pad / kRows, bh), 128 * (C::kGroups + 1), kSmem, stream>>>(
      q_map, k_map, vt_map, m_map, p);
  return cudaGetLastError();
}

template <bool kAlibi>
cudaError_t dispatch(const FwdParams& p, int bh, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_fwd<32, kAlibi>(p, bh, stream);
    case 64:
      return launch_fwd<64, kAlibi>(p, bh, stream);
    default:
      return launch_fwd<128, kAlibi>(p, bh, stream);
  }
}

bool shape_ok(int bh, int tq, int tk, int head_dim) {
  return (head_dim == 32 || head_dim == 64 || head_dim == 128) && bh > 0 && bh <= 65535 && tq > 0 && tk > 0 &&
         tq <= (1 << 30) - kPad && tk <= (1 << 30) - kPad;
}

// The parameters of kernels 1–3 over a workspace carved from `workspace`.
FwdParams make_params(const void* q, const void* k, const void* v, const void* mask, void* workspace, void* o,
                      void* lse, int bh, int tq, int tk, int head_dim, float scale) {
  FwdParams p = {};
  carve_workspace(&p, static_cast<uint8_t*>(workspace), bh, tq, tk, head_dim);
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.tq = tq;
  p.tk = tk;
  p.tq_pad = round_up(tq, kPad);
  p.tk_pad = round_up(tk, kPad);
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Bytes of the workspace stamp_flash_attn_fwd needs for these shapes,
// written as an int64 to *bytes.  Returns a cudaError_t.
int stamp_flash_attn_fwd_workspace(int bh, int tq, int tk, int head_dim, void* bytes) {
  if (!shape_ok(bh, tq, tk, head_dim)) return cudaErrorInvalidValue;
  FwdParams p;
  *static_cast<long long*>(bytes) = (long long)carve_workspace(&p, nullptr, bh, tq, tk, head_dim);
  return cudaSuccess;
}

// q [bh, tq, d], k and v [bh, tk, d] f32; mask [bh, tk] bytes; workspace of
// stamp_flash_attn_fwd_workspace bytes; o [bh, tq, d] and lse [bh, tq] f32
// out.  Scores are scaled by `scale` after the dot.  Every array contiguous
// and 16-byte aligned; d in (32, 64, 128).  Launches the pre-pass, the tile
// list and the attention kernel on `stream`.  Returns a cudaError_t.
int stamp_flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask, void* workspace, void* o,
                         void* lse, int bh, int tq, int tk, int head_dim, float scale, int device, void* stream) {
  if (!shape_ok(bh, tq, tk, head_dim)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const FwdParams p = make_params(q, k, v, mask, workspace, o, lse, bh, tq, tk, head_dim, scale);
  return dispatch<false>(p, bh, head_dim, static_cast<cudaStream_t>(stream));
}

// Bytes of the workspace stamp_flash_alibi_fwd needs for these shapes (the
// flash forward's, then the distance-weighted sum's), written as an int64
// to *bytes.  Returns a cudaError_t.
int stamp_flash_alibi_fwd_workspace(int bh, int tq, int tk, int head_dim, void* bytes) {
  if (!shape_ok(bh, tq, tk, head_dim)) return cudaErrorInvalidValue;
  long long dws = 0;
  const int err = stamp_dist_weighted_sum_workspace(bh, tq, tk, head_dim, &dws);
  if (err != cudaSuccess) return err;
  FwdParams p;
  *static_cast<long long*>(bytes) = (long long)carve_workspace(&p, nullptr, bh, tq, tk, head_dim) + dws;
  return cudaSuccess;
}

// As stamp_flash_attn_fwd, plus cq [bh, tq, 2], ck [bh, tk, 2] and
// dist_scale [bh] f32 in and dacc = D·V and out = o − dist_scale·dacc
// [bh, tq, d] f32 out; workspace of stamp_flash_alibi_fwd_workspace bytes.
// Launches the distance-weighted sum (dacc, the key mask as its b-mask),
// then the pre-pass, the tile list and the attention kernel, whose
// epilogue writes out, on `stream`.  Returns a cudaError_t.
int stamp_flash_alibi_fwd(const void* q, const void* k, const void* v, const void* mask, const void* cq,
                          const void* ck, const void* dist_scale, void* workspace, void* o, void* dacc, void* out,
                          void* lse, int bh, int tq, int tk, int head_dim, float scale, int device, void* stream) {
  if (!shape_ok(bh, tq, tk, head_dim)) return cudaErrorInvalidValue;
  FwdParams p;
  const size_t fwd_bytes = carve_workspace(&p, nullptr, bh, tq, tk, head_dim);
  int err = stamp_dist_weighted_sum(cq, ck, v, mask, nullptr, static_cast<uint8_t*>(workspace) + fwd_bytes, dacc,
                                    bh, tq, tk, head_dim, device, stream);
  if (err != cudaSuccess) return err;
  p = make_params(q, k, v, mask, workspace, o, lse, bh, tq, tk, head_dim, scale);
  p.dacc = static_cast<const float*>(dacc);
  p.dist_scale = static_cast<const float*>(dist_scale);
  p.out = static_cast<float*>(out);
  return dispatch<true>(p, bh, head_dim, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
