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
// [Tk, d], dO and the forward's output O [Tq, d] and its lse [Tq], with
// s = q·kᵀ·scale (−1e30 on masked keys), P = exp(s − lse) and
// D = rowsum(dO∘O):
//   dP = dO·Vᵀ,  dS = P∘(dP − D)·scale,
//   dQ = dS·K,   dV = Pᵀ·dO,  dK = dSᵀ·Q.
// The distance-weighted sum: out_a = Σ_b ‖c_a − c_b‖·val_b over the b that
// the b-mask keeps, for the rows a that the a-mask keeps (zero elsewhere).
//
// What bounds them on the H100: operations.  At the whole-slide training
// shapes ([8, T, 64], T = 4,097 … 16,385) one product of 2·BH·T²·d is
// 275 GFLOP at T = 16,385; the flash backward needs five per (query, valid
// key) pair and runs seven (s and dP in both of its kernels), at the
// 495 TFLOP/s TF32 rate; the distance-weighted sum one that must stay
// f32-accurate, run as three TF32 products (0.41 of the time the 67 TFLOP/s
// f32 rate would take), against a few hundred MB of inputs, outputs and
// copies (about 0.1 ms at 3.35 TB/s).
//
// The flash backward is four launches on the caller's stream:
//   1. flash_bwd_prepass_kernel, one pass over q, k, v, dO and O, 128 rows
//      a block: TF32-rounded (cvt.rna) copies of q, k, v and dO; the
//      transposed, rounded copies qᵀ, kᵀ, dOᵀ [d, T] (see "K-major" below);
//      D; lse and D padded with +inf and 0; the key mask as f32; and one
//      liveness flag per 32 rows: the rows hold a valid key (key side), or a
//      dO row that is not all zero (query side).  The copies of q and dO are
//      made only for 128 rows with a nonzero dO row: no kernel reads others;
//   2. flash_bwd_lists_kernel: per sequence, the increasing lists of live
//      key tiles and live query tiles;
//   3. flash_bwd_dq_kernel: dQ for 64·kGroups queries a block, looping over
//      the live key tiles;
//   4. flash_bwd_dkv_kernel: dK and dV for 64·kGroups keys a block, looping
//      over the live query tiles, on the transposed scores Sᵀ = k·qᵀ.
// Two reduction kernels and no atomics, as on the TPU: every output
// element is summed by one thread in a fixed order, so the result is
// bitwise repeatable.
//
// Kernels 3 and 4 are warp-specialized (hopper.cuh, tf32_wgmma.cuh): one
// producer thread keeps a ring of shared-memory stages filled by TMA, each
// stage paced by a "full" and an "empty" mbarrier; consumer warpgroups of 64
// rows run TF32 wgmma.mma_async (m64nNk8, f32 accumulate).  A warpgroup reads
// the other side's tile from shared memory once per 64 rows.  The block's own
// rows (q and dO for dQ, k and v for dK/dV), the score products' A operands,
// are loaded once into shared memory by TMA: as register fragments they would
// push a consumer past 168 registers, and ptxas then serializes the wgmmas.  In
// kernel 3 the dQ product of one tile runs on while the next tile's scores are
// issued.
//
// K-major.  TF32 wgmma takes both operands K-major (PTX allows the transpose
// bits for 16-bit types only).  The score products contract over d and are
// K-major as stored.  dQ += dS·k, dV += Pᵀ·dO and dK += dSᵀ·q contract over
// the sequence, so their B operands are the transposed copies kᵀ, dOᵀ, qᵀ
// with the sequence contiguous.  Their A operand is dS or Pᵀ straight from
// the score accumulators: a warp's accumulator rows are mma.sync's C layout
// and the TF32 A registers its A layout (tf32_wgmma.cuh), so a = (c0, c2,
// c1, c3) chains them when the depth runs in the order (0, 2, 4, 6, 1, 3,
// 5, 7) within each 8; the pre-pass bakes that order into every 8
// consecutive positions of the transposed copies.
//
// Tiles whose contribution is exactly zero are skipped (the lists of 2):
//   * a key tile with no valid key: there s = −1e30, and with the finite lse
//     of a sequence that has a valid key P = exp(−1e30 − lse) = 0, so dS = 0.
//     A sequence with no valid key keeps every tile (lse ≈ −1e30, P = 1, as
//     in the plain version);
//   * a query tile whose dO rows are all zero: dP = 0 and D = 0, so dS = 0
//     and Pᵀ·dO = 0.  The MIL model reads only the CLS row, so in its last
//     layer every row but row 0 has a zero dO, and in its first layer every
//     padded row does.
// A dQ block whose queries all have a zero dO, and a dK/dV block whose keys
// are all masked (in a sequence with a valid key) or that meets no live
// query tile, store zeros and exit; a warpgroup of a live block whose 64
// rows are such only passes the ring's stages on.  The result equals the
// full loop's up to the sign of zeros.
//
// Arithmetic: the products in TF32 with both operands rounded by cvt.rna,
// f32 accumulation, as the Pallas bodies run them at default precision;
// scale, mask, exp and the dS formula are f32 in the Pallas bodies' order,
// exp(x) taken as exp2f(x·log2 e).
// A masked key has P = 0 exactly, so exactly zero dK and dV.  Rows past T
// are zero (TMA's fill and the pre-pass's padding), queries past Tq have
// lse = +inf.  Head widths d ∈ {32, 64, 128}.
//
// The distance-weighted sum is three launches, on the same machinery:
//   5. dws_prepass_kernel, 128 b a block: the b coordinates padded, one
//      liveness flag per 32 b (a b the b-mask keeps with a nonzero value
//      row) and, for 128 b with a live one, the kept values split into TF32
//      high and low parts (hi = rna(v), lo = rna(v − hi)), both transposed
//      to [d, tb_pad] in the depth order above;
//   6. dws_lists_kernel: per sequence, the increasing list of live 64-b
//      tiles;
//   7. dist_weighted_sum_kernel: 64·kGroups rows a a block, looping over the
//      live b tiles; the distances ‖c_a − c_b‖ are computed in registers as
//      TF32 high and low A fragments, and each k-step runs three wgmmas
//      (hi·hi, hi·lo, lo·hi: 22 of f32's 24 mantissa bits of each operand),
//      as the Pallas kernel runs it at Precision.HIGHEST.  Each 64-b tile
//      goes into a fresh accumulator that is added to the running sum in
//      rounded f32: the tensor cores' f32 accumulation does not round to
//      nearest, so over a whole loop of 16,385 b its error would pass 1e-4.
// Skipped, their contribution being exactly zero: b tiles whose kept values
// are all zero (in the MIL model's last layer dO is zero on every row but
// the CLS row, so every b tile but the first), and rows a the a-mask drops,
// which are stored as zeros (the ALiBi backward keeps only the valid keys'
// rows); a block with no kept row or no live b tile stores zeros and exits.
// Fixed summation order, no atomics: bitwise repeatable.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "tf32_wgmma.cuh"

namespace {

using namespace sm90;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2^(x·log2 e)

// Per head width: kGroups consumer warpgroups (64 rows each) per dQ or
// dK/dV block, kTile rows of the other side per loop step, and the ring's
// stages.  A consumer's registers stay within 65,536 / 384 = 168 (the
// block's own rows are wgmma A operands in shared memory, not registers):
// past that ptxas serializes the wgmmas.  Shared memory per block at d = 64:
// 217 KB (dQ: 3 stages of k, v, kᵀ) and 200 KB (dK/dV: 2 stages of q, dO,
// qᵀ, dOᵀ).
template <int D>
struct Cfg;
template <>
struct Cfg<32> {
  static constexpr int kGroups = 2, kTile = 64, kDqStages = 4, kDkvStages = 4;
};
template <>
struct Cfg<64> {
  static constexpr int kGroups = 2, kTile = 64, kDqStages = 3, kDkvStages = 2;
};
template <>
struct Cfg<128> {
  static constexpr int kGroups = 1, kTile = 32, kDqStages = 3, kDkvStages = 2;
};

struct BwdParams {
  const float* q;       // [bh, tq, d]
  const float* k;       // [bh, tk, d]
  const float* v;       // [bh, tk, d]
  const uint8_t* mask;  // [bh, tk], nonzero = valid key
  const float* dout;    // [bh, tq, d]
  const float* out;     // [bh, tq, d], the forward's output
  const float* lse;     // [bh, tq]
  float* dq;            // [bh, tq, d]
  float* dk;            // [bh, tk, d]
  float* dv;            // [bh, tk, d]
  // the workspace (written by the pre-pass and the lists kernel)
  float* qr;            // [bh, tq, d] q, TF32
  float* kr;            // [bh, tk, d] k, TF32
  float* vr;            // [bh, tk, d] v, TF32
  float* dor;           // [bh, tq, d] dO, TF32
  float* qt;            // [bh, d, tq_pad] qᵀ, TF32, depth order within 8s
  float* kt;            // [bh, d, tk_pad] kᵀ
  float* dot;           // [bh, d, tq_pad] dOᵀ
  float* lse_pad;       // [bh, tq_pad], +inf past tq
  float* dvec;          // [bh, tq_pad] D = rowsum(dO∘O), 0 past tq
  float* kval;          // [bh, tk_pad] 1 = valid key, 0 masked or past tk
  int* qlive;           // [bh, tq_pad / 32] a dO row of the 32 is not all zero
  int* klive;           // [bh, tk_pad / 32] one of the 32 keys is valid
  int* qlist;           // [bh, tq_pad / 32] live query tiles, increasing
  int* klist;           // [bh, tk_pad / 32] live key tiles
  int* qcount;          // [bh]
  int* kcount;          // [bh]
  int* any_valid;       // [bh] the sequence has a valid key
  int tq, tk, tq_pad, tk_pad;
  float scale;
};

// ---- 1. the pre-pass --------------------------------------------------------------

// One block per 128 rows of a sequence (two halves of 64 through `tile`).
// Query side: D, the padded lse and the liveness flags first; the TF32 and
// transposed copies of q and dO only where one of the 128 dO rows is not
// zero (the dQ and dK/dV kernels read no other rows of them).  Key side:
// the copies of k, v and kᵀ, the key mask as f32 and its flags.
template <int D>
__global__ void __launch_bounds__(kPreThreads) flash_bwd_prepass_kernel(const BwdParams p) {
  __shared__ float tile[kHalf][D + 1];
  const int bh = blockIdx.y, r0 = blockIdx.x * kPreRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r0 < p.tq_pad) {  // uniform in the block
    const long qb = (long)bh * p.tq;
    int units = 0;  // lane 0: bit u set where this warp met a nonzero dO row in rows r0 + 32u …
    for (int r = warp; r < kPreRows; r += kPreThreads / 32) {  // one warp a row
      const int row = r0 + r;
      bool nonzero = false;
      float s = 0.f;  // D = rowsum(dO∘O)
      if (row < p.tq) {
        for (int c = lane; c < D; c += 32) {
          const float x = p.dout[(qb + row) * D + c];
          nonzero |= x != 0.f;
          s += x * p.out[(qb + row) * D + c];
        }
      }
      nonzero = __any_sync(0xffffffffu, nonzero);
      s = warp_sum(s);
      if (lane == 0) {
        p.dvec[(long)bh * p.tq_pad + row] = s;
        p.lse_pad[(long)bh * p.tq_pad + row] = row < p.tq ? p.lse[qb + row] : __int_as_float(0x7f800000);
        units |= nonzero << (r / kUnit);
      }
    }
    int any = 0;
    for (int u = 0; u < kPreRows / kUnit; ++u) {
      const int live = __syncthreads_or((units >> u) & 1);
      if (threadIdx.x == 0) p.qlive[(long)bh * (p.tq_pad / kUnit) + r0 / kUnit + u] = live != 0;
      any |= live;
    }
    if (any) {
      float* qt = p.qt + (long)bh * D * p.tq_pad;
      float* dot = p.dot + (long)bh * D * p.tq_pad;
      for (int h0 = r0; h0 < r0 + kPreRows; h0 += kHalf) {
        round_rows<D, true>(tile, p.q + qb * D, p.qr + qb * D, h0, p.tq);
        __syncthreads();
        write_transposed<D>(tile, qt, h0, p.tq_pad);
        __syncthreads();
        round_rows<D, true>(tile, p.dout + qb * D, p.dor + qb * D, h0, p.tq);
        __syncthreads();
        write_transposed<D>(tile, dot, h0, p.tq_pad);
        __syncthreads();
      }
    }
  }
  if (r0 < p.tk_pad) {
    const long kb = (long)bh * p.tk;
    for (int h0 = r0; h0 < r0 + kPreRows; h0 += kHalf) {
      round_rows<D, true>(tile, p.k + kb * D, p.kr + kb * D, h0, p.tk);
      __syncthreads();
      write_transposed<D>(tile, p.kt + (long)bh * D * p.tk_pad, h0, p.tk_pad);
      round_rows<D, false>(nullptr, p.v + kb * D, p.vr + kb * D, h0, p.tk);
      bool valid = false;
      if (threadIdx.x < kHalf) {
        const int row = h0 + threadIdx.x;
        valid = row < p.tk && p.mask[kb + row] != 0;
        p.kval[(long)bh * p.tk_pad + row] = valid ? 1.f : 0.f;
      }
      const int lo = __syncthreads_or(valid && threadIdx.x < kUnit);
      const int hi = __syncthreads_or(valid && threadIdx.x >= kUnit);
      if (threadIdx.x == 0) {
        int* flags = p.klive + (long)bh * (p.tk_pad / kUnit) + h0 / kUnit;
        flags[0] = lo != 0;
        flags[1] = hi != 0;
      }
    }
  }
}

// ---- 2. the tile lists ------------------------------------------------------------

// One block per sequence: warp 0 lists the key tiles of kTile rows that hold
// a valid key (every tile when the sequence has none), warp 1 the query
// tiles whose dO is not all zero; each list in increasing order.
template <int kTile>
__global__ void __launch_bounds__(64) flash_bwd_lists_kernel(const BwdParams p) {
  constexpr int kPer = kTile / kUnit;
  const int bh = blockIdx.x, lane = threadIdx.x % 32;
  const bool keys = threadIdx.x < 32;
  const int n = keys ? p.tk : p.tq;
  const int units = (keys ? p.tk_pad : p.tq_pad) / kUnit;
  const int* live = (keys ? p.klive : p.qlive) + (long)bh * units;
  int* list = (keys ? p.klist : p.qlist) + (long)bh * units;
  bool every = false;
  if (keys) {
    int any = 0;
    for (int u = lane; u < units; u += 32) any |= live[u];
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) p.any_valid[bh] = any;
    every = !any;
  }
  const int tiles = (n + kTile - 1) / kTile;
  int count = 0;
  for (int base = 0; base < tiles; base += 32) {
    const int i = base + lane;
    bool on = false;
    if (i < tiles) {
      on = every;
      for (int u = 0; u < kPer; ++u) on |= live[i * kPer + u] != 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (on) list[count + __popc(ballot & ((1u << lane) - 1))] = i;
    count += __popc(ballot);
  }
  if (lane == 0) (keys ? p.kcount : p.qcount)[bh] = count;
}

// ---- 3 and 4. dQ and dK/dV --------------------------------------------------------

// Shared memory of kernel 3, in 1024-byte-aligned blocks: the block's own
// rows (q and dO: A of the score products), then the ring's stages (k and
// v: B of the score products, N = kTile; kᵀ: B of dQ += dS·k, N = d; the key
// mask), then the barriers.
template <int D>
struct DqLayout {
  using C = Cfg<D>;
  using Own = Boxes<64 * C::kGroups, D>;
  using Rows = Boxes<C::kTile, D>;
  using Cols = Boxes<D, C::kTile>;
  static constexpr int kV = Rows::kBytes, kKt = 2 * Rows::kBytes, kVal = kKt + Cols::kBytes;
  static constexpr uint32_t kTx = kVal + C::kTile * 4;
  static constexpr int kStage = round_up(kTx, 1024);
  static constexpr int kOwnBytes = 2 * Own::kBytes;
  static constexpr int kSmem = ring_smem(kOwnBytes, C::kDqStages, kStage);
};

// Kernel 4's: k and v (A of the score products), then stages of q and dO
// (B of the score products), qᵀ and dOᵀ (B of dK += dSᵀ·q and dV += Pᵀ·dO),
// lse and D.
template <int D>
struct DkvLayout {
  using C = Cfg<D>;
  using Own = Boxes<64 * C::kGroups, D>;
  using Rows = Boxes<C::kTile, D>;
  using Cols = Boxes<D, C::kTile>;
  static constexpr int kDo = Rows::kBytes, kQt = 2 * Rows::kBytes, kDot = kQt + Cols::kBytes;
  static constexpr int kLse = kDot + Cols::kBytes, kDvec = kLse + C::kTile * 4;
  static constexpr uint32_t kTx = kDvec + C::kTile * 4;
  static constexpr int kStage = round_up(kTx, 1024);
  static constexpr int kOwnBytes = 2 * Own::kBytes;
  static constexpr int kSmem = ring_smem(kOwnBytes, C::kDkvStages, kStage);
};

// The block's own rows [row0, row0 + 64·kGroups) of two [bh, n, d] copies
// into shared memory, on `bar`.
template <int D, class Own>
__device__ __forceinline__ void load_own(uint8_t* own, const CUtensorMap* a_map, const CUtensorMap* b_map,
                                         uint64_t* bar, int row0, int bh) {
  mbar_expect_tx(bar, 2 * Own::kBytes);
  for (int b = 0; b < D / 32; ++b) {
    tma_load_3d(own + b * Own::kBoxBytes, a_map, bar, 32 * b, row0, bh);
    tma_load_3d(own + Own::kBytes + b * Own::kBoxBytes, b_map, bar, 32 * b, row0, bh);
  }
}

// Kernel 3: dQ for 64·kGroups queries of one (batch·head), looping over the
// live key tiles.  Maps: q and dO rows (TF32 copies, boxes [64·kGroups, 32]),
// k and v rows (boxes [kTile, 32]), kᵀ ([bh, d, tk_pad], boxes [d, 32]) and
// the key mask as f32 ([bh, tk_pad], boxes [kTile]).
template <int D>
__global__ void __launch_bounds__(128 * (Cfg<D>::kGroups + 1), 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap kt_map, const __grid_constant__ CUtensorMap kval_map,
                    const BwdParams p) {
  using C = Cfg<D>;
  using L = DqLayout<D>;
  constexpr int S = C::kDqStages, kRows = 64 * C::kGroups, kT = C::kTile;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  float* dq = p.dq + (long)bh * p.tq * D;

  // queries whose dO rows are all zero have dQ = 0
  bool live = false;
  for (int u = q0 / kUnit; u < (q0 + kRows) / kUnit; ++u) live |= p.qlive[(long)bh * (p.tq_pad / kUnit) + u] != 0;
  if (!live) {
    store_zero_rows<D>(dq, q0, kRows, p.tq);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring<L::kOwnBytes, S, L::kStage, C::kGroups>(smem_raw);
  const int count = p.kcount[bh];
  const int* list = p.klist + (long)bh * (p.tk_pad / kUnit);

  const int wg = threadIdx.x / 128;
  if (wg == C::kGroups) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == C::kGroups * 128) {
      load_own<D, typename L::Own>(ring.own, &q_map, &do_map, ring.own_bar, q0, bh);
      for (int n = 0; n < count; ++n) {
        const int s = n % S;
        mbar_wait(&ring.empty[s], ((n / S) & 1) ^ 1);  // round 0 passes: the ring starts empty
        mbar_expect_tx(&ring.full[s], L::kTx);
        const int k0 = list[n] * kT;
        uint8_t* st = ring.stages + s * L::kStage;
        for (int b = 0; b < D / 32; ++b) {
          tma_load_3d(st + b * L::Rows::kBoxBytes, &k_map, &ring.full[s], 32 * b, k0, bh);
          tma_load_3d(st + L::kV + b * L::Rows::kBoxBytes, &v_map, &ring.full[s], 32 * b, k0, bh);
        }
        for (int b = 0; b < kT / 32; ++b)
          tma_load_3d(st + L::kKt + b * L::Cols::kBoxBytes, &kt_map, &ring.full[s], k0 + 32 * b, 0, bh);
        tma_load_2d(st + L::kVal, &kval_map, &ring.full[s], k0, bh);
      }
    }
    return;
  }

  // consumers: 64 queries a warpgroup
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4);  // this warp's first query
  float lse[2], dvec[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse[h] = p.lse_pad[(long)bh * p.tq_pad + row0 + g + 8 * h];
    dvec[h] = p.dvec[(long)bh * p.tq_pad + row0 + g + 8 * h];
  }
  const int wg_rows = (64 * wg * kBoxRowBytes) >> 4;  // this warpgroup's rows in an own box (16-byte units)
  // a warpgroup whose 64 queries all have a zero dO only passes the stages on
  const int* units = p.qlive + (long)bh * (p.tq_pad / kUnit) + q0 / kUnit;
  const bool wg_live = units[2 * wg] || units[2 * wg + 1];
  const uint8_t* q_own = ring.own;
  const uint8_t* do_own = ring.own + L::Own::kBytes;
  const bool signals = threadIdx.x % 128 == 0;  // one arrival per warpgroup on "empty"
  mbar_wait(ring.own_bar, 0);

  // dQ += dS·k of tile n runs on while tile n + 1's scores are issued: its
  // A fragments stay reserved (fence_frags), and its stage is released
  // after the next wait
  float acc[D / 2];
  uint32_t a[kT / 8][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int n = 0; n < count; ++n) {
    const int s = n % S;
    mbar_wait(&ring.full[s], (n / S) & 1);
    if (!wg_live) {
      if (signals) mbar_arrive(&ring.empty[s]);
      continue;
    }
    const uint8_t* st = ring.stages + s * L::kStage;

    float sc[kT / 2], dp[kT / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // s = q·kᵀ
      wgmma_tf32_ss(sc, kstep_desc<kRows>(q_own, j) + wg_rows, kstep_desc<kT>(st, j), j);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // dP = dO·vᵀ
      wgmma_tf32_ss(dp, kstep_desc<kRows>(do_own, j) + wg_rows, kstep_desc<kT>(st + L::kV, j), j);
    wgmma_commit();
    wgmma_wait<0>();  // this tile's scores, and the previous tile's dQ product
    fence_operands(sc);
    fence_operands(dp);
    fence_operands(acc);
    fence_frags(a);
    if (n > 0 && signals) mbar_arrive(&ring.empty[(n - 1) % S]);

    // dS, as TF32 A fragments of dQ += dS·k (depth order within each 8)
    const float* kval = reinterpret_cast<const float*>(st + L::kVal);
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float2 valid = *reinterpret_cast<const float2*>(kval + 8 * j + 2 * t);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = ((e & 1) ? valid.y : valid.x) > 0.f ? sc[4 * j + e] * p.scale : kNegInf;
        const float pr = exp2f((sv - lse[e >> 1]) * kLog2e);
        ds[e] = pr * (dp[4 * j + e] - dvec[e >> 1]) * p.scale;
      }
      a[j][0] = to_tf32(ds[0]);
      a[j][1] = to_tf32(ds[2]);
      a[j][2] = to_tf32(ds[1]);
      a[j][3] = to_tf32(ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) wgmma_tf32_rs(acc, a[j], kstep_desc<D>(st + L::kKt, j), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);
  fence_frags(a);
  if (wg_live && count > 0 && signals) mbar_arrive(&ring.empty[(count - 1) % S]);
  store_acc<D>(dq, acc, row0, p.tq, g, t);
}

// Kernel 4: dK and dV for 64·kGroups keys of one (batch·head), looping over
// the live query tiles, on the transposed scores Sᵀ = k·qᵀ.  Maps: k and v
// rows (boxes [64·kGroups, 32]), q and dO rows (boxes [kTile, 32]), qᵀ and
// dOᵀ (boxes [d, 32]), lse and D padded ([bh, tq_pad], boxes [kTile]).
template <int D>
__global__ void __launch_bounds__(128 * (Cfg<D>::kGroups + 1), 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap qt_map, const __grid_constant__ CUtensorMap dot_map,
                     const __grid_constant__ CUtensorMap lse_map, const __grid_constant__ CUtensorMap dvec_map,
                     const BwdParams p) {
  using C = Cfg<D>;
  using L = DkvLayout<D>;
  constexpr int S = C::kDkvStages, kRows = 64 * C::kGroups, kT = C::kTile;
  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  float* dk = p.dk + (long)bh * p.tk * D;
  float* dv = p.dv + (long)bh * p.tk * D;

  // no live query tile, or (in a sequence with a valid key) no valid key
  // here: dK = dV = 0
  const int count = p.qcount[bh];
  bool live = count > 0;
  if (live && p.any_valid[bh]) {
    bool any = false;
    for (int u = k0 / kUnit; u < (k0 + kRows) / kUnit; ++u) any |= p.klive[(long)bh * (p.tk_pad / kUnit) + u] != 0;
    live = any;
  }
  if (!live) {
    store_zero_rows<D>(dk, k0, kRows, p.tk);
    store_zero_rows<D>(dv, k0, kRows, p.tk);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring<L::kOwnBytes, S, L::kStage, C::kGroups>(smem_raw);
  const int* list = p.qlist + (long)bh * (p.tq_pad / kUnit);

  const int wg = threadIdx.x / 128;
  if (wg == C::kGroups) {
    if (threadIdx.x == C::kGroups * 128) {
      load_own<D, typename L::Own>(ring.own, &k_map, &v_map, ring.own_bar, k0, bh);
      for (int n = 0; n < count; ++n) {
        const int s = n % S;
        mbar_wait(&ring.empty[s], ((n / S) & 1) ^ 1);
        mbar_expect_tx(&ring.full[s], L::kTx);
        const int q0 = list[n] * kT;
        uint8_t* st = ring.stages + s * L::kStage;
        for (int b = 0; b < D / 32; ++b) {
          tma_load_3d(st + b * L::Rows::kBoxBytes, &q_map, &ring.full[s], 32 * b, q0, bh);
          tma_load_3d(st + L::kDo + b * L::Rows::kBoxBytes, &do_map, &ring.full[s], 32 * b, q0, bh);
        }
        for (int b = 0; b < kT / 32; ++b) {
          tma_load_3d(st + L::kQt + b * L::Cols::kBoxBytes, &qt_map, &ring.full[s], q0 + 32 * b, 0, bh);
          tma_load_3d(st + L::kDot + b * L::Cols::kBoxBytes, &dot_map, &ring.full[s], q0 + 32 * b, 0, bh);
        }
        tma_load_2d(st + L::kLse, &lse_map, &ring.full[s], q0, bh);
        tma_load_2d(st + L::kDvec, &dvec_map, &ring.full[s], q0, bh);
      }
    }
    return;
  }

  // consumers: 64 keys a warpgroup
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = k0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4);  // this warp's first key
  bool key_valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key_valid[h] = p.kval[(long)bh * p.tk_pad + row0 + g + 8 * h] > 0.f;
  const int wg_rows = (64 * wg * kBoxRowBytes) >> 4;
  // a warpgroup whose 64 keys are all masked (in a sequence with a valid
  // key) only passes the stages on
  const int* units = p.klive + (long)bh * (p.tk_pad / kUnit) + k0 / kUnit;
  const bool wg_live = !p.any_valid[bh] || units[2 * wg] || units[2 * wg + 1];
  const uint8_t* k_own = ring.own;
  const uint8_t* v_own = ring.own + L::Own::kBytes;
  const bool signals = threadIdx.x % 128 == 0;
  mbar_wait(ring.own_bar, 0);

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  for (int n = 0; n < count; ++n) {
    const int s = n % S;
    mbar_wait(&ring.full[s], (n / S) & 1);
    if (!wg_live) {
      if (signals) mbar_arrive(&ring.empty[s]);
      continue;
    }
    const uint8_t* st = ring.stages + s * L::kStage;

    float sc[kT / 2], dp[kT / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // sᵀ = k·qᵀ
      wgmma_tf32_ss(sc, kstep_desc<kRows>(k_own, j) + wg_rows, kstep_desc<kT>(st, j), j);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // dPᵀ = v·dOᵀ
      wgmma_tf32_ss(dp, kstep_desc<kRows>(v_own, j) + wg_rows, kstep_desc<kT>(st + L::kDo, j), j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);

    // Pᵀ and dSᵀ (element e: key row g + 8·(e / 2), query column 8j + 2t + e % 2)
    const float* lse = reinterpret_cast<const float*>(st + L::kLse);
    const float* dvec = reinterpret_cast<const float*>(st + L::kDvec);
    uint32_t pa[kT / 8][4], da[kT / 8][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dvec + 8 * j + 2 * t);
      float pt[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = key_valid[e >> 1] ? sc[4 * j + e] * p.scale : kNegInf;
        pt[e] = exp2f((sv - ((e & 1) ? l2.y : l2.x)) * kLog2e);
        ds[e] = pt[e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * p.scale;
      }
      pa[j][0] = to_tf32(pt[0]);
      pa[j][1] = to_tf32(pt[2]);
      pa[j][2] = to_tf32(pt[1]);
      pa[j][3] = to_tf32(pt[3]);
      da[j][0] = to_tf32(ds[0]);
      da[j][1] = to_tf32(ds[2]);
      da[j][2] = to_tf32(ds[1]);
      da[j][3] = to_tf32(ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) wgmma_tf32_rs(acc_dv, pa[j], kstep_desc<D>(st + L::kDot, j), 1);  // dV += Pᵀ·dO
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) wgmma_tf32_rs(acc_dk, da[j], kstep_desc<D>(st + L::kQt, j), 1);  // dK += dSᵀ·q
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_dv);
    fence_operands(acc_dk);
    if (signals) mbar_arrive(&ring.empty[s]);
  }
  store_acc<D>(dk, acc_dk, row0, p.tk, g, t);
  store_acc<D>(dv, acc_dv, row0, p.tk, g, t);
}

// ---- 5, 6 and 7. the distance-weighted sum ----------------------------------------

constexpr int kDwsTile = 64;  // b per loop step: one fresh accumulator (see the top of this file)

// Per head width: kGroups consumer warpgroups (64 rows a each) per block and
// the ring's stages (the high and low parts of 64 values, their
// coordinates).  A consumer holds the tile's accumulator, the running sum
// and the distances' high and low fragments: 128 registers at d = 64, 192
// at d = 128, which takes one consumer warpgroup to stay clear of spills.
template <int D>
struct DwsCfg;
template <>
struct DwsCfg<32> {
  static constexpr int kGroups = 2, kStages = 4;
};
template <>
struct DwsCfg<64> {
  static constexpr int kGroups = 2, kStages = 4;
};
template <>
struct DwsCfg<128> {
  static constexpr int kGroups = 1, kStages = 3;
};

struct DwsParams {
  const float* ca;        // [bh, ta, 2] output side
  const float* cb;        // [bh, tb, 2] summation side
  const float* val;       // [bh, tb, d]
  const uint8_t* b_mask;  // [bh, tb] nonzero = include b, or NULL (every b)
  const uint8_t* a_mask;  // [bh, ta] nonzero = compute row a (others are zero), or NULL (every a)
  float* out;             // [bh, ta, d]
  // the workspace (written by kernels 5 and 6)
  float* vhi;             // [bh, d, tb_pad] kept values, TF32 high part, transposed, depth order within 8s
  float* vlo;             // [bh, d, tb_pad] TF32 low part: value − high part
  float* cbp;             // [bh, 2·tb_pad] b coordinates, zero past tb
  int* blive;             // [bh, tb_pad / 32] one of the 32 b is kept and has a nonzero value
  int* blist;             // [bh, tb_pad / 64] live b tiles, increasing
  int* bcount;            // [bh]
  int ta, tb, ta_pad, tb_pad;
};

// Kernel 7's stage: the high and low parts of 64 values as the B operands
// of the products over b (N = d), then the 64 b coordinates.
template <int D>
struct DwsLayout {
  using Cols = Boxes<D, kDwsTile>;
  static constexpr int kLo = Cols::kBytes, kCb = 2 * Cols::kBytes;
  static constexpr uint32_t kTx = kCb + 2 * kDwsTile * 4;
  static constexpr int kStage = round_up(kTx, 1024);
  static constexpr int kSmem = ring_smem(0, DwsCfg<D>::kStages, kStage);
};

// Kernel 5, one block per 128 b of a sequence: the padded coordinates, the
// liveness flags and, where one of the 128 is live, the high and low parts
// of the kept values (zero where the b-mask drops a row and past tb).
template <int D>
__global__ void __launch_bounds__(kPreThreads) dws_prepass_kernel(const DwsParams p) {
  __shared__ float tile[kHalf][D + 1];
  const int bh = blockIdx.y, r0 = blockIdx.x * kPreRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long base = (long)bh * p.tb;
  auto kept = [&](int row) { return row < p.tb && (p.b_mask == nullptr || p.b_mask[base + row] != 0); };
  if (threadIdx.x < kPreRows) {
    const int row = r0 + threadIdx.x;
    const float2 c = row < p.tb ? reinterpret_cast<const float2*>(p.cb)[base + row] : make_float2(0.f, 0.f);
    reinterpret_cast<float2*>(p.cbp)[(long)bh * p.tb_pad + row] = c;
  }
  int units = 0;  // lane 0: bit u set where this warp met a live row in rows r0 + 32u …
  for (int r = warp; r < kPreRows; r += kPreThreads / 32) {
    bool nonzero = false;
    if (kept(r0 + r)) {
      for (int c = lane; c < D; c += 32) nonzero |= p.val[(base + r0 + r) * D + c] != 0.f;
    }
    nonzero = __any_sync(0xffffffffu, nonzero);
    if (lane == 0) units |= nonzero << (r / kUnit);
  }
  int live_rows = 0;
  for (int u = 0; u < kPreRows / kUnit; ++u) {
    const int live = __syncthreads_or((units >> u) & 1);
    if (threadIdx.x == 0) p.blive[(long)bh * (p.tb_pad / kUnit) + r0 / kUnit + u] = live != 0;
    live_rows |= live;
  }
  if (!live_rows) return;  // uniform in the block: kernel 7 reads no row of it
  for (int h0 = r0; h0 < r0 + kPreRows; h0 += kHalf) {
    for (int i = threadIdx.x; i < kHalf * D; i += kPreThreads) {
      const int r = i / D, c = i % D;
      tile[r][c] = kept(h0 + r) ? p.val[(base + h0 + r) * D + c] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < D * kHalf; i += kPreThreads) {
      const int c = i / kHalf, pos = i % kHalf;
      const float x = tile[depth_row(pos)][c];
      const uint32_t hi = to_tf32(x);
      const long at = ((long)bh * D + c) * p.tb_pad + h0 + pos;
      p.vhi[at] = __uint_as_float(hi);
      p.vlo[at] = __uint_as_float(to_tf32(x - __uint_as_float(hi)));
    }
    __syncthreads();
  }
}

// Kernel 6, one warp per sequence: the increasing list of live b tiles.
__global__ void __launch_bounds__(32) dws_lists_kernel(const DwsParams p) {
  constexpr int kPer = kDwsTile / kUnit;
  const int bh = blockIdx.x, lane = threadIdx.x;
  const int* live = p.blive + (long)bh * (p.tb_pad / kUnit);
  int* list = p.blist + (long)bh * (p.tb_pad / kDwsTile);
  const int tiles = (p.tb + kDwsTile - 1) / kDwsTile;
  int count = 0;
  for (int base = 0; base < tiles; base += 32) {
    const int i = base + lane;
    bool on = false;
    if (i < tiles) {
      for (int u = 0; u < kPer; ++u) on |= live[i * kPer + u] != 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (on) list[count + __popc(ballot & ((1u << lane) - 1))] = i;
    count += __popc(ballot);
  }
  if (lane == 0) p.bcount[bh] = count;
}

// Kernel 7: out_a = Σ_b ‖c_a − c_b‖·val_b for 64·kGroups rows a of one
// (batch·head), looping over the live b tiles.  The distances are the A
// operand, computed in registers (thread (g, t) of a warp: rows g and g + 8,
// b 8j + 2t and 8j + 2t + 1, the depth positions t and t + 4 of k-step j),
// split into TF32 high and low parts; the values' parts are the B operands
// (maps of the transposed copies, boxes [d, 32]; the coordinates, boxes of
// 128 floats).  Three products a k-step (hi·hi, hi·lo, lo·hi) into a fresh
// accumulator a tile, added to the running sum in rounded f32.
template <int D>
__global__ void __launch_bounds__(128 * (DwsCfg<D>::kGroups + 1), 1)
dist_weighted_sum_kernel(const __grid_constant__ CUtensorMap hi_map, const __grid_constant__ CUtensorMap lo_map,
                         const __grid_constant__ CUtensorMap cb_map, const DwsParams p) {
  using C = DwsCfg<D>;
  using L = DwsLayout<D>;
  constexpr int S = C::kStages, kRows = 64 * C::kGroups, kT = kDwsTile;
  const int bh = blockIdx.y, a0 = blockIdx.x * kRows;
  float* out = p.out + (long)bh * p.ta * D;
  const uint8_t* a_mask = p.a_mask == nullptr ? nullptr : p.a_mask + (long)bh * p.ta;

  // bit w: warpgroup w has a row the a-mask keeps; a block with none, or
  // with no live b tile, stores zeros
  bool row_kept = false;
  if (threadIdx.x < kRows) {
    const int row = a0 + threadIdx.x;
    row_kept = row < p.ta && (a_mask == nullptr || a_mask[row] != 0);
  }
  int groups = 0;
  for (int w = 0; w < C::kGroups; ++w) groups |= (__syncthreads_or(row_kept && threadIdx.x / 64 == w) != 0) << w;
  const int count = p.bcount[bh];
  if (groups == 0 || count == 0) {
    store_zero_rows<D>(out, a0, kRows, p.ta);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring<0, S, L::kStage, C::kGroups>(smem_raw);
  const int* list = p.blist + (long)bh * (p.tb_pad / kT);

  const int wg = threadIdx.x / 128;
  if (wg == C::kGroups) {
    if (threadIdx.x == C::kGroups * 128) {
      for (int n = 0; n < count; ++n) {
        const int s = n % S;
        mbar_wait(&ring.empty[s], ((n / S) & 1) ^ 1);  // round 0 passes: the ring starts empty
        mbar_expect_tx(&ring.full[s], L::kTx);
        const int b0 = list[n] * kT;
        uint8_t* st = ring.stages + s * L::kStage;
        for (int b = 0; b < kT / 32; ++b) {
          tma_load_3d(st + b * L::Cols::kBoxBytes, &hi_map, &ring.full[s], b0 + 32 * b, 0, bh);
          tma_load_3d(st + L::kLo + b * L::Cols::kBoxBytes, &lo_map, &ring.full[s], b0 + 32 * b, 0, bh);
        }
        tma_load_2d(st + L::kCb, &cb_map, &ring.full[s], 2 * b0, bh);
      }
    }
    return;
  }

  // consumers: 64 rows a a warpgroup; one whose rows the a-mask all drops
  // only passes the stages on
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = a0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4);  // this warp's first row
  const bool wg_live = (groups >> wg) & 1;
  const bool signals = threadIdx.x % 128 == 0;
  float ax[2], ay[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    const float2 c = row < p.ta ? reinterpret_cast<const float2*>(p.ca)[(long)bh * p.ta + row] : make_float2(0.f, 0.f);
    ax[h] = c.x;
    ay[h] = c.y;
  }
  float sum[D / 2], tile[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) sum[i] = 0.f;
  for (int n = 0; n < count; ++n) {
    const int s = n % S;
    mbar_wait(&ring.full[s], (n / S) & 1);
    if (!wg_live) {
      if (signals) mbar_arrive(&ring.empty[s]);
      continue;
    }
    const uint8_t* st = ring.stages + s * L::kStage;
    const float4* cb = reinterpret_cast<const float4*>(st + L::kCb);
    uint32_t hi[kT / 8][4], lo[kT / 8][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float4 c = cb[4 * j + t];  // b 8j + 2t and 8j + 2t + 1
      const float dist[4] = {distance(ax[0], ay[0], c.x, c.y), distance(ax[1], ay[1], c.x, c.y),
                             distance(ax[0], ay[0], c.z, c.w), distance(ax[1], ay[1], c.z, c.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[j][i] = tf32_round(dist[i]);
        lo[j][i] = tf32_round(dist[i] - __uint_as_float(hi[j][i]));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      wgmma_tf32_rs(tile, hi[j], kstep_desc<D>(st, j), j);
      wgmma_tf32_rs(tile, hi[j], kstep_desc<D>(st + L::kLo, j), 1);
      wgmma_tf32_rs(tile, lo[j], kstep_desc<D>(st, j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(tile);
    fence_frags(hi);
    fence_frags(lo);
    if (signals) mbar_arrive(&ring.empty[s]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) sum[i] = __fadd_rn(sum[i], tile[i]);
  }
  // rows the a-mask drops are zero
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row < p.ta && a_mask != nullptr && a_mask[row] == 0) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) sum[4 * j + 2 * h] = sum[4 * j + 2 * h + 1] = 0.f;
    }
  }
  store_acc<D>(out, sum, row0, p.ta, g, t);
}

// ---- host side --------------------------------------------------------------------

// The workspace, carved from `base` (or from address 0, to size it) in
// 256-byte-aligned arrays; returns its bytes.
inline size_t carve_workspace(BwdParams* p, uint8_t* base, int bh, int tq, int tk, int d) {
  const size_t tq_pad = round_up(tq, kPad), tk_pad = round_up(tk, kPad);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    uint8_t* ptr = base == nullptr ? nullptr : base + at;
    at = (at + bytes + 255) / 256 * 256;
    return ptr;
  };
  const size_t f = sizeof(float), i = sizeof(int);
  p->qr = reinterpret_cast<float*>(take(f * bh * tq * d));
  p->dor = reinterpret_cast<float*>(take(f * bh * tq * d));
  p->kr = reinterpret_cast<float*>(take(f * bh * tk * d));
  p->vr = reinterpret_cast<float*>(take(f * bh * tk * d));
  p->qt = reinterpret_cast<float*>(take(f * bh * d * tq_pad));
  p->dot = reinterpret_cast<float*>(take(f * bh * d * tq_pad));
  p->kt = reinterpret_cast<float*>(take(f * bh * d * tk_pad));
  p->lse_pad = reinterpret_cast<float*>(take(f * bh * tq_pad));
  p->dvec = reinterpret_cast<float*>(take(f * bh * tq_pad));
  p->kval = reinterpret_cast<float*>(take(f * bh * tk_pad));
  p->qlive = reinterpret_cast<int*>(take(i * bh * (tq_pad / kUnit)));
  p->klive = reinterpret_cast<int*>(take(i * bh * (tk_pad / kUnit)));
  p->qlist = reinterpret_cast<int*>(take(i * bh * (tq_pad / kUnit)));
  p->klist = reinterpret_cast<int*>(take(i * bh * (tk_pad / kUnit)));
  p->qcount = reinterpret_cast<int*>(take(i * bh));
  p->kcount = reinterpret_cast<int*>(take(i * bh));
  p->any_valid = reinterpret_cast<int*>(take(i * bh));
  return at;
}

// The pre-pass and the lists go first; the host encodes the tensor maps of
// kernels 3 and 4 while the card runs them.
template <int D>
cudaError_t launch_bwd(const BwdParams& p, int bh, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr int kRows = 64 * C::kGroups;
  constexpr int kBlockThreads = 128 * (C::kGroups + 1);
  constexpr int kDqSmem = DqLayout<D>::kSmem, kDkvSmem = DkvLayout<D>::kSmem;
  cudaError_t err;
  flash_bwd_prepass_kernel<D><<<dim3((p.tq_pad > p.tk_pad ? p.tq_pad : p.tk_pad) / kPreRows, bh), kPreThreads, 0,
                                stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_lists_kernel<C::kTile><<<bh, 64, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // rows of the other side (boxes [kTile, 32]), a block's own rows (boxes
  // [64·kGroups, 32]), the transposed copies and the vectors
  CUtensorMap q_map, do_map, k_map, v_map, q_own, do_own, k_own, v_own, qt_map, dot_map, kt_map, lse_map,
      dvec_map, kval_map;
  if ((err = encode_rows(&q_map, p.qr, bh, p.tq, D, C::kTile)) != cudaSuccess ||
      (err = encode_rows(&do_map, p.dor, bh, p.tq, D, C::kTile)) != cudaSuccess ||
      (err = encode_rows(&k_map, p.kr, bh, p.tk, D, C::kTile)) != cudaSuccess ||
      (err = encode_rows(&v_map, p.vr, bh, p.tk, D, C::kTile)) != cudaSuccess ||
      (err = encode_rows(&q_own, p.qr, bh, p.tq, D, kRows)) != cudaSuccess ||
      (err = encode_rows(&do_own, p.dor, bh, p.tq, D, kRows)) != cudaSuccess ||
      (err = encode_rows(&k_own, p.kr, bh, p.tk, D, kRows)) != cudaSuccess ||
      (err = encode_rows(&v_own, p.vr, bh, p.tk, D, kRows)) != cudaSuccess ||
      (err = encode_cols(&qt_map, p.qt, bh, p.tq_pad, D)) != cudaSuccess ||
      (err = encode_cols(&dot_map, p.dot, bh, p.tq_pad, D)) != cudaSuccess ||
      (err = encode_cols(&kt_map, p.kt, bh, p.tk_pad, D)) != cudaSuccess ||
      (err = encode_vec(&lse_map, p.lse_pad, bh, p.tq_pad, C::kTile)) != cudaSuccess ||
      (err = encode_vec(&dvec_map, p.dvec, bh, p.tq_pad, C::kTile)) != cudaSuccess ||
      (err = encode_vec(&kval_map, p.kval, bh, p.tk_pad, C::kTile)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kDqSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kDkvSmem)) != cudaSuccess)
    return err;
  flash_bwd_dq_kernel<D><<<dim3(p.tq_pad / kRows, bh), kBlockThreads, kDqSmem, stream>>>(
      q_own, do_own, k_map, v_map, kt_map, kval_map, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D><<<dim3(p.tk_pad / kRows, bh), kBlockThreads, kDkvSmem, stream>>>(
      k_own, v_own, q_map, do_map, qt_map, dot_map, lse_map, dvec_map, p);
  return cudaGetLastError();
}

// The distance-weighted sum's workspace, carved as carve_workspace does.
inline size_t carve_dws_workspace(DwsParams* p, uint8_t* base, int bh, int tb, int d) {
  const size_t tb_pad = round_up(tb, kPad);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    uint8_t* ptr = base == nullptr ? nullptr : base + at;
    at = (at + bytes + 255) / 256 * 256;
    return ptr;
  };
  const size_t f = sizeof(float), i = sizeof(int);
  p->vhi = reinterpret_cast<float*>(take(f * bh * d * tb_pad));
  p->vlo = reinterpret_cast<float*>(take(f * bh * d * tb_pad));
  p->cbp = reinterpret_cast<float*>(take(f * bh * 2 * tb_pad));
  p->blive = reinterpret_cast<int*>(take(i * bh * (tb_pad / kUnit)));
  p->blist = reinterpret_cast<int*>(take(i * bh * (tb_pad / kDwsTile)));
  p->bcount = reinterpret_cast<int*>(take(i * bh));
  return at;
}

// Kernels 5 and 6 go first; the host encodes kernel 7's maps meanwhile.
template <int D>
cudaError_t launch_dws(const DwsParams& p, int bh, cudaStream_t stream) {
  using C = DwsCfg<D>;
  constexpr int kSmem = DwsLayout<D>::kSmem;
  cudaError_t err;
  dws_prepass_kernel<D><<<dim3(p.tb_pad / kPreRows, bh), kPreThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dws_lists_kernel<<<bh, 32, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  CUtensorMap hi_map, lo_map, cb_map;
  if ((err = encode_cols(&hi_map, p.vhi, bh, p.tb_pad, D)) != cudaSuccess ||
      (err = encode_cols(&lo_map, p.vlo, bh, p.tb_pad, D)) != cudaSuccess ||
      (err = encode_vec(&cb_map, p.cbp, bh, 2 * p.tb_pad, 2 * kDwsTile)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dist_weighted_sum_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmem)) != cudaSuccess)
    return err;
  dist_weighted_sum_kernel<D><<<dim3(p.ta_pad / (64 * C::kGroups), bh), 128 * (C::kGroups + 1), kSmem, stream>>>(
      hi_map, lo_map, cb_map, p);
  return cudaGetLastError();
}

bool bwd_shape_ok(int bh, int tq, int tk, int head_dim) {
  return (head_dim == 32 || head_dim == 64 || head_dim == 128) && bh > 0 && bh <= 65535 && tq > 0 && tk > 0 &&
         tq <= (1 << 30) - kPad && tk <= (1 << 30) - kPad;
}

}  // namespace

extern "C" {

// Bytes of the workspace stamp_flash_attn_bwd needs for these shapes,
// written as an int64 to *bytes.  Returns a cudaError_t.
int stamp_flash_attn_bwd_workspace(int bh, int tq, int tk, int head_dim, void* bytes) {
  if (!bwd_shape_ok(bh, tq, tk, head_dim)) return cudaErrorInvalidValue;
  BwdParams p;
  *static_cast<long long*>(bytes) = (long long)carve_workspace(&p, nullptr, bh, tq, tk, head_dim);
  return cudaSuccess;
}

// q [bh, tq, d], k and v [bh, tk, d], dout and out (the forward's output)
// [bh, tq, d] f32; mask [bh, tk] bytes; lse [bh, tq] f32 in; workspace of
// stamp_flash_attn_bwd_workspace bytes; dq [bh, tq, d], dk and dv
// [bh, tk, d] f32 out.  Scores are scaled by `scale` after the dot.  Every
// array contiguous and 16-byte aligned.  Launches the pre-pass, the tile
// lists, the dQ and the dK/dV kernels on `stream`.  Returns a cudaError_t.
int stamp_flash_attn_bwd(const void* q, const void* k, const void* v, const void* mask, const void* dout,
                         const void* out, const void* lse, void* workspace, void* dq, void* dk, void* dv, int bh,
                         int tq, int tk, int head_dim, float scale, int device, void* stream) {
  if (!bwd_shape_ok(bh, tq, tk, head_dim)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BwdParams p;
  carve_workspace(&p, static_cast<uint8_t*>(workspace), bh, tq, tk, head_dim);
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.dout = static_cast<const float*>(dout);
  p.out = static_cast<const float*>(out);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.tq = tq;
  p.tk = tk;
  p.tq_pad = round_up(tq, kPad);
  p.tk_pad = round_up(tk, kPad);
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_bwd<32>(p, bh, s);
    case 64:
      return launch_bwd<64>(p, bh, s);
    default:
      return launch_bwd<128>(p, bh, s);
  }
}

// Bytes of the workspace stamp_dist_weighted_sum needs for these shapes,
// written as an int64 to *bytes.  Returns a cudaError_t.
int stamp_dist_weighted_sum_workspace(int bh, int ta, int tb, int head_dim, void* bytes) {
  if (!bwd_shape_ok(bh, ta, tb, head_dim)) return cudaErrorInvalidValue;
  DwsParams p;
  *static_cast<long long*>(bytes) = (long long)carve_dws_workspace(&p, nullptr, bh, tb, head_dim);
  return cudaSuccess;
}

// ca [bh, ta, 2], cb [bh, tb, 2], val [bh, tb, d] f32; b_mask [bh, tb]
// bytes or NULL (every b); a_mask [bh, ta] bytes or NULL (every row a; a
// row it drops is zero); workspace of stamp_dist_weighted_sum_workspace
// bytes; out [bh, ta, d] f32.  Every array contiguous and 16-byte aligned.
// Launches kernels 5, 6 and 7 on `stream`.  Returns a cudaError_t.
int stamp_dist_weighted_sum(const void* ca, const void* cb, const void* val, const void* b_mask,
                            const void* a_mask, void* workspace, void* out, int bh, int ta, int tb, int head_dim,
                            int device, void* stream) {
  if (!bwd_shape_ok(bh, ta, tb, head_dim)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  DwsParams p;
  carve_dws_workspace(&p, static_cast<uint8_t*>(workspace), bh, tb, head_dim);
  p.ca = static_cast<const float*>(ca);
  p.cb = static_cast<const float*>(cb);
  p.val = static_cast<const float*>(val);
  p.b_mask = static_cast<const uint8_t*>(b_mask);
  p.a_mask = static_cast<const uint8_t*>(a_mask);
  p.out = static_cast<float*>(out);
  p.ta = ta;
  p.tb = tb;
  p.ta_pad = round_up(ta, kPad);
  p.tb_pad = round_up(tb, kPad);
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dws<32>(p, bh, s);
    case 64:
      return launch_dws<64>(p, bh, s);
    default:
      return launch_dws<128>(p, bh, s);
  }
}

}  // extern "C"
