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
// N = 4,097 … 20,001 tiles + CLS) q·kᵀ and P·V are 4·BH·N²·d flops (825
// GFLOP at N = 16,385: 1.67 ms at the 495 TFLOP/s TF32 rate) against
// 4·BH·N·d·4 bytes of q, k, v and the output (about 0.06 ms at 3.35 TB/s).
// Beside the products, every (query, key, head) triple needs a distance, a
// square root, an exponential and a few f32 operations: 3.2·10⁹ triples at
// N = 16,385, which load the special-function unit (two operations each) and
// the f32 lanes about as much as the products load the tensor cores.
//
// What the design does about it (the Hopper machinery of tf32_wgmma.cuh, as
// the flash backward uses it):
//   1. alibi2d_prepass_kernel, 128 rows a block: TF32-rounded (cvt.rna)
//      copies of q and k, the transposed rounded copy Vᵀ [bh, d, n_pad] in
//      the depth order (0, 2, 4, 6, 1, 3, 5, 7) within each 8 (so that the
//      probabilities' accumulator registers are P·V's A operand as they
//      stand), and the coordinates padded with zeros to n_pad;
//   2. flash_alibi2d_kernel: a block owns 64·kGroups queries of one
//      (batch·head), loaded once by TMA into shared memory (the A operand of
//      S = q·kᵀ, SS form); one producer thread keeps a ring of stages (a
//      key tile of k, its Vᵀ columns and its coordinates) filled by TMA
//      through "full" and "empty" mbarriers; each consumer warpgroup of 64
//      queries runs S = q·kᵀ by TF32 wgmma (m64nNk8), the bias and the
//      online softmax in registers, and O += P·V by wgmma with P from
//      registers (RS).  A warpgroup issues tile n's scores and tile n − 1's
//      P·V together and runs tile n's softmax while P·V is on the tensor
//      cores; the two warpgroups take turns at issuing (named barriers), so
//      that one's softmax also runs beside the other's products.  The
//      producer gives its registers to the consumers (setmaxnreg).
// The per-element arithmetic is cut to what the function needs: the bias
// is one FMA a score in units of the scale (u = q·k − (slope/scale)·dist),
// exp(s − m) one FMA and one ex2 (2^(u·scale·log2 e − m·scale·log2 e)),
// the square root sqrt.approx; the CLS row's exemption is a zero slope for
// that row, the CLS column and the keys past N (−1e30) are tested only in
// the first and the last key tile, and P is rounded to TF32 by two integer
// operations (tf32_round) instead of cvt.rna.
//
// Numerics, as the Pallas body: q·kᵀ and P·V in TF32 (both operands
// rounded), f32 accumulation; the distance from per-axis differences
// (never the Gram identity), the bias added before the running max, the
// final divide by max(l, 1e-30) in f32.  Head widths d ∈ {32, 64, 128};
// any N ≥ 1 (rows and keys past N are TMA's zero fill and the pre-pass's
// padding; those rows are not stored).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "tf32_wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2^(x·log2 e)

// Per head width: kGroups consumer warpgroups (64 queries each) per block,
// kTile keys per loop step, and the ring's stages.  A consumer holds the
// scores (kTile / 2 registers), two tiles' TF32 P fragments (kTile / 2
// each) and the output accumulator (d / 2): at d = 64, 168 registers spill
// a little, the 232 it gets from the producer (setmaxnreg) do not; 128
// keys a step spill either way.
// Shared memory at d = 64: 32 KB of queries and 4 stages of 33 KB.
template <int D>
struct A2Cfg;
template <>
struct A2Cfg<32> {
  static constexpr int kGroups = 2, kTile = 64, kStages = 4;
};
template <>
struct A2Cfg<64> {
  static constexpr int kGroups = 2, kTile = 64, kStages = 4;
};
template <>
struct A2Cfg<128> {
  static constexpr int kGroups = 2, kTile = 32, kStages = 3;
};

struct Alibi2dParams {
  const float* q;       // [bh, n, d]
  const float* k;       // [bh, n, d]
  const float* v;       // [bh, n, d]
  const float* coords;  // [bh, n, 2]
  const float* slopes;  // [bh]
  float* out;           // [bh, n, d]
  // the workspace (written by the pre-pass)
  float* qr;            // [bh, n, d] q, TF32
  float* kr;            // [bh, n, d] k, TF32
  float* vt;            // [bh, d, n_pad] Vᵀ, TF32, depth order within 8s
  float* cpad;          // [bh, 2·n_pad] coordinates, zero past n
  int n, n_pad;
  float scale;
  int exempt_first;
};

// The block's queries (boxes [64·kGroups, 32]), then stages of a key tile:
// k (B of S = q·kᵀ, N = kTile), Vᵀ (B of O += P·V, N = d), the keys'
// coordinates.
template <int D>
struct A2Layout {
  using C = A2Cfg<D>;
  using Own = Boxes<64 * C::kGroups, D>;
  using Rows = Boxes<C::kTile, D>;
  using Cols = Boxes<D, C::kTile>;
  static constexpr int kVt = Rows::kBytes, kC = Rows::kBytes + Cols::kBytes;
  static constexpr uint32_t kTx = kC + 2 * C::kTile * 4;
  static constexpr int kStage = round_up(kTx, 1024);
  static constexpr int kSmem = ring_smem(Own::kBytes, C::kStages, kStage);
};

// ---- 1. the pre-pass ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kPreThreads) alibi2d_prepass_kernel(const Alibi2dParams p) {
  __shared__ float tile[kHalf][D + 1];
  const int bh = blockIdx.y, r0 = blockIdx.x * kPreRows;
  const long base = (long)bh * p.n;
  if (threadIdx.x < kPreRows) {
    const int row = r0 + threadIdx.x;
    const float2 c = row < p.n ? reinterpret_cast<const float2*>(p.coords)[base + row] : make_float2(0.f, 0.f);
    reinterpret_cast<float2*>(p.cpad)[(long)bh * p.n_pad + row] = c;
  }
  for (int h0 = r0; h0 < r0 + kPreRows; h0 += kHalf) {
    round_rows<D, false>(nullptr, p.q + base * D, p.qr + base * D, h0, p.n);
    round_rows<D, false>(nullptr, p.k + base * D, p.kr + base * D, h0, p.n);
    round_rows<D, true>(tile, p.v + base * D, nullptr, h0, p.n);
    __syncthreads();
    write_transposed<D>(tile, p.vt + (long)bh * D * p.n_pad, h0, p.n_pad);
    __syncthreads();
  }
}

// ---- 2. the attention ------------------------------------------------------------

// The tile's scores in units of the scale: u = q·k + bias·dist, bias =
// −slope / scale (0 on the CLS row), so that s = u·scale and exp(s − m) =
// 2^(u·c − m_u·c) with c = scale·log2 e: one FMA a score here and one in
// the exponent.  Score element e of k-step j sits at key k0 + 8j + 2t +
// e % 2; ck holds the keys' coordinates (x, y) in pairs.  kEdge: the tile
// holds key 0 (the CLS column) or keys past n.
template <int kT, bool kEdge>
__device__ __forceinline__ void alibi_scores(float (&sc)[kT / 2], const float4* ck, const float (&qx)[2],
                                             const float (&qy)[2], const float (&bias)[2], int k0, int n,
                                             bool exempt_first, int t) {
#pragma unroll
  for (int j = 0; j < kT / 8; ++j) {
    const float4 c = ck[4 * j + t];  // keys k0 + 8j + 2t and k0 + 8j + 2t + 1
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int key = k0 + 8 * j + 2 * t + (e & 1);
      const float b = kEdge && exempt_first && key == 0 ? 0.f : bias[h];
      const float u = fmaf(distance(qx[h], qy[h], (e & 1) ? c.z : c.x, (e & 1) ? c.w : c.y), b, sc[4 * j + e]);
      sc[4 * j + e] = kEdge && key >= n ? kNegInf : u;
    }
  }
}

// 64·kGroups queries of one (batch·head) against every key tile.  Maps: the
// TF32 q rows (boxes [64·kGroups, 32]), k rows (boxes [kTile, 32]), Vᵀ
// (boxes [d, 32]) and the padded coordinates ([bh, 2·n_pad], boxes of
// 2·kTile floats).
template <int D>
__global__ void __launch_bounds__(128 * (A2Cfg<D>::kGroups + 1), 1)
flash_alibi2d_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap vt_map, const __grid_constant__ CUtensorMap c_map,
                     const Alibi2dParams p) {
  using C = A2Cfg<D>;
  using L = A2Layout<D>;
  static_assert(C::kGroups == 2, "the consumer warpgroups take turns in pairs");
  constexpr int S = C::kStages, kRows = 64 * C::kGroups, kT = C::kTile;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int tiles = (p.n + kT - 1) / kT;

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
      for (int n = 0; n < tiles; ++n) {
        const int s = n % S;
        mbar_wait(&ring.empty[s], ((n / S) & 1) ^ 1);  // round 0 passes: the ring starts empty
        mbar_expect_tx(&ring.full[s], L::kTx);
        const int k0 = n * kT;
        uint8_t* st = ring.stages + s * L::kStage;
        for (int b = 0; b < D / 32; ++b)
          tma_load_3d(st + b * L::Rows::kBoxBytes, &k_map, &ring.full[s], 32 * b, k0, bh);
        for (int b = 0; b < kT / 32; ++b)
          tma_load_3d(st + L::kVt + b * L::Cols::kBoxBytes, &vt_map, &ring.full[s], k0 + 32 * b, 0, bh);
        tma_load_2d(st + L::kC, &c_map, &ring.full[s], 2 * k0, bh);
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
  const bool exempt = p.exempt_first != 0;
  const float c_scale = p.scale * kLog2e;
  const float slope = p.slopes[bh] / p.scale;
  float qx[2], qy[2], bias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;  // < n_pad: the grid covers n_pad rows
    const float2 c = reinterpret_cast<const float2*>(p.cpad)[(long)bh * p.n_pad + row];
    qx[h] = c.x;
    qy[h] = c.y;
    bias[h] = exempt && row == 0 ? 0.f : -slope;
  }
  float m[2] = {kNegInf, kNegInf};  // running max (units of the scale)
  float l[2] = {0.f, 0.f};          // this thread's share of the running row sums
  float alpha[2];                   // the last tile's rescale of the running sums
  float acc[D / 2], sc[kT / 2];
  uint32_t pa[kT / 8][4], pb[kT / 8][4];  // P of the tile in flight and of the next one
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint8_t* own = ring.own;
  auto stage = [&](int n) { return ring.stages + (n % S) * L::kStage; };
  auto issue_scores = [&](int n) {  // S = q·kᵀ of tile n, once its stage is full
    mbar_wait(&ring.full[n % S], (n / S) & 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      wgmma_tf32_ss(sc, kstep_desc<kRows>(own, j) + wg_rows, kstep_desc<kT>(stage(n), j), j);
    wgmma_commit();
  };
  // tile n's scores (complete) → its P fragments, the running max and sums
  auto softmax = [&](int n, uint32_t (&frag)[kT / 8][4]) {
    fence_operands(sc);
    const int k0 = n * kT;
    const float4* ck = reinterpret_cast<const float4*>(stage(n) + L::kC);
    if (n == 0 || k0 + kT > p.n) {
      alibi_scores<kT, true>(sc, ck, qx, qy, bias, k0, p.n, exempt, t);
    } else {
      alibi_scores<kT, false>(sc, ck, qx, qy, bias, k0, p.n, exempt, t);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2_approx((m[h] - mx[h]) * c_scale);
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
  auto issue_pv = [&](int n, const uint32_t (&frag)[kT / 8][4]) {  // O += P·V of tile n
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) wgmma_tf32_rs(acc, frag[j], kstep_desc<D>(stage(n) + L::kVt, j), 1);
    wgmma_commit();
  };
  // Tile n: its scores and the previous tile's P·V are issued together,
  // the two warpgroups taking turns (named barriers 1 and 2: warpgroup w
  // waits on 1 + w, then lets the other go), so that one's softmax runs
  // beside the other's products; the softmax of tile n also runs while P·V
  // of tile n − 1 is on the tensor cores, then the output is rescaled and
  // tile n − 1's stage released.
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
  for (; n + 1 < tiles; n += 2) {
    step(n, pa, pb);
    step(n + 1, pb, pa);
  }
  if (n < tiles) step(n++, pa, pb);
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

  // O = acc / max(l, 1e-30), the row sums gathered over the quad
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
  }
  store_acc<D>(p.out + (long)bh * p.n * D, acc, row0, p.n, g, t);
}

// ---- host side --------------------------------------------------------------------

// The workspace, carved from `base` (or from address 0, to size it) in
// 256-byte-aligned arrays; returns its bytes.
inline size_t carve_workspace(Alibi2dParams* p, uint8_t* base, int bh, int n, int d) {
  const size_t n_pad = round_up(n, kPad);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    uint8_t* ptr = base == nullptr ? nullptr : base + at;
    at = (at + bytes + 255) / 256 * 256;
    return ptr;
  };
  const size_t f = sizeof(float);
  p->qr = reinterpret_cast<float*>(take(f * bh * n * d));
  p->kr = reinterpret_cast<float*>(take(f * bh * n * d));
  p->vt = reinterpret_cast<float*>(take(f * bh * d * n_pad));
  p->cpad = reinterpret_cast<float*>(take(f * bh * 2 * n_pad));
  return at;
}

// The pre-pass goes first; the host encodes the tensor maps meanwhile.
template <int D>
cudaError_t launch_alibi2d(const Alibi2dParams& p, int bh, cudaStream_t stream) {
  using C = A2Cfg<D>;
  constexpr int kRows = 64 * C::kGroups, kSmem = A2Layout<D>::kSmem;
  cudaError_t err;
  alibi2d_prepass_kernel<D><<<dim3(p.n_pad / kPreRows, bh), kPreThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  CUtensorMap q_map, k_map, vt_map, c_map;
  if ((err = encode_rows(&q_map, p.qr, bh, p.n, D, kRows)) != cudaSuccess ||
      (err = encode_rows(&k_map, p.kr, bh, p.n, D, C::kTile)) != cudaSuccess ||
      (err = encode_cols(&vt_map, p.vt, bh, p.n_pad, D)) != cudaSuccess ||
      (err = encode_vec(&c_map, p.cpad, bh, 2 * p.n_pad, 2 * C::kTile)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_alibi2d_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem)) !=
          cudaSuccess)
    return err;
  flash_alibi2d_kernel<D><<<dim3(p.n_pad / kRows, bh), 128 * (C::kGroups + 1), kSmem, stream>>>(q_map, k_map,
                                                                                               vt_map, c_map, p);
  return cudaGetLastError();
}

bool shape_ok(int bh, int n, int head_dim) {
  return (head_dim == 32 || head_dim == 64 || head_dim == 128) && bh > 0 && bh <= 65535 && n > 0 &&
         n <= (1 << 30) - kPad;
}

}  // namespace

extern "C" {

// Bytes of the workspace stamp_flash_alibi2d_fwd needs for these shapes,
// written as an int64 to *bytes.  Returns a cudaError_t.
int stamp_flash_alibi2d_workspace(int bh, int n, int head_dim, void* bytes) {
  if (!shape_ok(bh, n, head_dim)) return cudaErrorInvalidValue;
  Alibi2dParams p;
  *static_cast<long long*>(bytes) = (long long)carve_workspace(&p, nullptr, bh, n, head_dim);
  return cudaSuccess;
}

// q, k, v [bh, n, d] f32; coords [bh, n, 2] f32; slopes [bh] f32;
// workspace of stamp_flash_alibi2d_workspace bytes; out [bh, n, d] f32.
// Scores are scaled by `scale` after the dot; with exempt_first != 0 row 0
// and column 0 get no bias.  Every array contiguous and 16-byte aligned; d
// in (32, 64, 128).  Launches the pre-pass and the attention kernel on
// `stream`.  Returns a cudaError_t.
int stamp_flash_alibi2d_fwd(const void* q, const void* k, const void* v, const void* coords,
                            const void* slopes, void* workspace, void* out, int bh, int n, int head_dim,
                            float scale, int exempt_first, int device, void* stream) {
  if (!shape_ok(bh, n, head_dim)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Alibi2dParams p;
  carve_workspace(&p, static_cast<uint8_t*>(workspace), bh, n, head_dim);
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.coords = static_cast<const float*>(coords);
  p.slopes = static_cast<const float*>(slopes);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.n_pad = round_up(n, kPad);
  p.scale = scale;
  p.exempt_first = exempt_first;
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_alibi2d<32>(p, bh, s);
    case 64:
      return launch_alibi2d<64>(p, bh, s);
    default:
      return launch_alibi2d<128>(p, bh, s);
  }
}

}  // extern "C"
