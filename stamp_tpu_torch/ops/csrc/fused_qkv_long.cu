// Multi-head softmax attention read straight off a packed qkv projection,
// for sequences longer than the one-pass kernel holds (N > 272: CONCH's and
// CONCH1.5's 785 tokens).  fused_qkv_attn.cu's one-pass kernel takes N <= 272.
//
// Replaces: stamp_tpu/ops/flash_attention.py:589 `fused_qkv_mha`, whose
// Pallas bodies are `_fused_qkv_attn_kernel` (:535) and
// `_fused_qkv_attn_kernel_interleaved` (:501; the body its VMEM budget picks
// at N = 785 with 12 or 16 heads).
//
// What it computes, in the Pallas kernel's order of operations: s = q·kᵀ
// summed in f32, scaled by d^-1/2 after the dot; the exact softmax over the
// N keys (the true row max m, l = Σ exp(s − m) in f32, p = exp(s − m) / l in
// f32); p cast to bf16 before P·V; P·V summed in f32 and cast to bf16 once.
// Keys >= N contribute 0.  Not the online form that normalizes at the end:
// that one casts the unnormalized p to bf16.
//
// What bounds it on the H100: operations.  At CONCH1.5's shape (batch 64,
// N = 785, 16 heads of 64) q·kᵀ and P·V are 4·B·H·N²·d = 161.6 GFLOP, 0.163
// ms at 989 TFLOP/s bf16, against 79 MB of qkv and 26 MB of output (0.031 ms
// at 3.35 TB/s).  Keeping the order costs this design q·kᵀ twice (6
// products, not 4) and two ex2 a score, one in each pass: 0.245 ms of
// products, and 1.26 G ex2 at 16 a clock an SM (about 0.3 ms).
//
// The design: two passes over the keys, pass 1 in stages of 128 keys (64 at
// d = 80), pass 2 in tiles of 64.
//   * a persistent grid (one block an SM) walks the work items (a tile of
//     192 queries of one head of one batch item), the query tile fastest, so
//     the blocks in flight share their head's K and V in L2;
//   * warpgroup 3 is the producer: one thread issues TMA loads through a
//     3-D tensor map over the packed qkv [B, N, 3·H·d] (boxes of 64 rows and
//     64 columns, 128-byte swizzled; rows past N zero-filled per batch item,
//     so a tile never reads the next item's rows): the item's queries (q of
//     head h at column h·d), then pass 1's K tiles (column dim + h·d; two
//     tiles a stage at d = 64, the second in the V slot, so the stage holds
//     one K-major operand of 128 keys) and pass 2's K and V tiles (2·dim +
//     h·d), into a ring of stages paced by "full" and "empty" mbarriers
//     (hopper.cuh: waits that trap after 10 s).
//     It gives its registers to the consumers (setmaxnreg) and loads the
//     next item's queries once every consumer holds its own in registers;
//   * warpgroups 0–2 are the consumers, 64 queries each.  Each loads its q
//     rows once into wgmma A registers (ldmatrix off the swizzled box);
//     pass 1 runs S = q·kᵀ by bf16 wgmma (m64n128k16 at d = 64, m64n64k16
//     at d = 80; K K-major from the stage) and keeps each thread's running
//     max and rescaled sum over its own columns (l ← l·2^(m_old − m_new) +
//     Σ 2^(s' − m_new)), gathered over the quad of a row once the keys are
//     done; pass 2 recomputes S, takes
//     p = 2^(s' − m')·(1/l) in f32 (s' = s·d^-1/2·log2 e, one FMA and one ex2
//     a score), packs p to bf16 straight into the A registers of O += P·V (a
//     k16 accumulator is an A fragment as it stands) and runs it by wgmma
//     with V read as an MN-major B operand (the descriptor's transpose for
//     16-bit types).  Pass 2 issues tile n's scores with tile n − 1's P·V and
//     computes tile n's p while that product runs.  A consumer whose 64 rows
//     are all past N (in a sequence's last item) only follows the ring, so
//     N = 785 computes 832 query rows, not 960;
//   * the consumers take turns at issuing (named barriers 1–3, in a ring),
//     so one's exponentials run beside the others' products;
//   * keys >= N are masked in the last tile only (zero-filled keys score 0,
//     not −inf); O is written with 16-byte stores after a quad transpose,
//     rows < N only.
// Three consumer warpgroups rather than two: 12 consumer warps on 4
// schedulers hide the ex2 and the products behind each other better, and a
// key tile is read once for 192 queries (scripts/fused_qkv_attn_probe.py
// times both, and the parts: the ex2 of each pass, the loads, the turns).
// No atomics: a run is bitwise repeatable.  Head widths 64 and 80 (d = 80:
// two 64-column boxes a row, of which the product reads 80 columns).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "ln_gemm_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kConsumers = 3;               // consumer warpgroups, 64 queries each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kQueries = 64 * kConsumers;   // queries a work item
constexpr int kTile = 64;                   // keys a ring stage
constexpr int kBoxBytes = 64 * 128;         // a [64 rows, 64 columns] bf16 box
// registers after setmaxnreg: 3·128·160 + 128·24 ≤ 65,536
constexpr int kConsumerRegs = 160, kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct LongCfg {
  static_assert(D == 64 || D == 80, "head widths 64 and 80");
  static constexpr int kBoxes = (D + 63) / 64;                // 64-column boxes a row of one head
  static constexpr int kStages = D == 64 ? 6 : 4;
  static constexpr int kQBytes = kConsumers * kBoxes * kBoxBytes;
  static constexpr int kKBytes = kBoxes * kBoxBytes;          // a stage's K (pass 1 loads only these)
  static constexpr int kStageBytes = 2 * kKBytes;             // K, then V
  // pass 1 needs no V: at d = 64 a stage holds two K tiles there (the second
  // in the V slot, right after the first: one K-major operand of 128 keys)
  static constexpr int kKeys1 = D == 64 ? 2 * kTile : kTile;
  // the queries, the ring, its 2·kStages barriers and the queries' two, and
  // 1024 bytes to align the start
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + (2 * kStages + 2) * 8 + 1024;
};

// ---- bf16 wgmma, A from registers ------------------------------------------
// Accumulator (per warp w of the warpgroup, g = lane / 4, t = lane % 4):
// d[4j + 2h + e] is row 16w + g + 8h, column 8j + 2t + e.  A: warp w holds
// rows 16w..16w+15 as mma.sync m16n8k16's A fragment.  kTransB = 0: B is
// K-major; 1: MN-major.  With scale_d = 0 the accumulator's old value is
// ignored.

template <int kTransB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

// Descriptor of an MN-major wgmma B operand in 128-byte-swizzled boxes of
// 64 rows (the depth, here keys) by 64 columns (N): 8-row groups 1024 bytes
// apart (stride offset), the next 64 columns one box further (leading
// offset), layout type 1 (128-byte swizzle).  The k-step j (rows 16j …
// 16j + 15) starts 2048·j bytes in.
__device__ __forceinline__ uint64_t smem_desc_sw128_mn(const void* box) {
  const uint64_t addr = smem_addr(box);
  return ((addr & 0x3FFFFull) >> 4) | ((uint64_t)(kBoxBytes >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Work item `item` → (first query, head, batch item), the query tile fastest.
struct Item {
  int q0, h, b;
};
__device__ __forceinline__ Item decode(int item, int q_tiles, int heads) {
  const int rest = item / q_tiles;
  return {(item % q_tiles) * kQueries, rest % heads, rest / heads};
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fused_qkv_long_kernel(const __grid_constant__ CUtensorMap qkv_map, __nv_bfloat16* __restrict__ out, int n,
                      int heads, int items, float scale) {
  using C = LongCfg<D>;
  constexpr int S = C::kStages, kB = C::kBoxes, kSteps = D / 16;
  const int dim = heads * D;
  const int q_tiles = (n + kQueries - 1) / kQueries;
  const int tiles = (n + kTile - 1) / kTile;              // pass 2's key tiles
  const int tiles1 = (n + C::kKeys1 - 1) / C::kKeys1;     // pass 1's

  extern __shared__ uint8_t smem_raw[];
  // aligned by an offset from the shared array, so that the compiler still
  // knows every pointer below is shared memory
  uint8_t* q_smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = q_smem + C::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kStageBytes);
  uint64_t* empty = full + S;
  uint64_t* q_full = empty + S;
  uint64_t* q_empty = q_full + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread keeps the queries and the ring filled
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      uint32_t r = 0;  // ring stages filled so far, across items
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const Item w = decode(item, q_tiles, heads);
        mbar_wait(q_empty, (it & 1) ^ 1);  // both consumers hold the previous item's q; item 0 passes
        mbar_expect_tx(q_full, C::kQBytes);
        for (int c = 0; c < kConsumers; ++c)
          for (int x = 0; x < kB; ++x)
            tma_load_3d(q_smem + (c * kB + x) * kBoxBytes, &qkv_map, q_full, w.h * D + 64 * x, w.q0 + 64 * c, w.b);
        for (int pass = 0; pass < 2; ++pass) {
          for (int kt = 0; kt < (pass ? tiles : tiles1); ++kt, ++r) {
            const int s = r % S;
            mbar_wait(&empty[s], ((r / S) & 1) ^ 1);  // round 0 passes: the ring starts empty
            uint8_t* st = ring + s * C::kStageBytes;
            if (pass == 0) {  // K tiles only, kKeys1 keys
              mbar_expect_tx(&full[s], C::kKeys1 / kTile * C::kKBytes);
              for (int y = 0; y < C::kKeys1 / kTile; ++y)
                for (int x = 0; x < kB; ++x)
                  tma_load_3d(st + y * C::kKBytes + x * kBoxBytes, &qkv_map, &full[s], dim + w.h * D + 64 * x,
                              kt * C::kKeys1 + y * kTile, w.b);
            } else {  // a K tile and its V tile
              mbar_expect_tx(&full[s], 2 * C::kKBytes);
              for (int x = 0; x < kB; ++x) {
                tma_load_3d(st + x * kBoxBytes, &qkv_map, &full[s], dim + w.h * D + 64 * x, kt * kTile, w.b);
                tma_load_3d(st + C::kKBytes + x * kBoxBytes, &qkv_map, &full[s], 2 * dim + w.h * D + 64 * x,
                            kt * kTile, w.b);
              }
            }
          }
        }
      }
    }
    return;
  }

  // consumers: 64 queries a warpgroup
  reg_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wq = (threadIdx.x / 32) % 4;       // this warp's 16 rows of the warpgroup's 64
  const bool signals = threadIdx.x % 128 == 0;  // one arrival per warpgroup on "empty" and "q_empty"
  const float c = scale * kLog2e;
  const int last_keys = n - (tiles - 1) * kTile;  // valid keys of pass 2's last tile (1 … 64)
  const int last_keys1 = n - (tiles1 - 1) * C::kKeys1;  // and of pass 1's (1 … kKeys1)

  uint32_t qa[kSteps][4];                 // this warp's q rows, the A operand of S = q·kᵀ
  float s1[C::kKeys1 / 2];                // pass 1's S of one stage
  float sc[32];                           // pass 2's S of one key tile
  float acc[D / 2];                       // O
  uint32_t pa[kTile / 16][4], pb[kTile / 16][4];  // bf16 p of the tile in flight and of the next one

  auto stage = [&](uint32_t r) { return ring + (r % S) * C::kStageBytes; };
  // S = q·kᵀ of the keys of ring stage r into dst, once the stage is full
  // (the fence: the A registers and dst were last written outside wgmma)
  auto issue_scores = [&](auto& dst, uint32_t r) {
    mbar_wait(&full[r % S], (r / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      wgmma_bf16_rs<0>(dst, qa[j], smem_desc_sw128(stage(r) + (j / 4) * kBoxBytes) + 2 * (j % 4), j);
    wgmma_commit();
  };
  auto issue_pv = [&](uint32_t r, const uint32_t (&frag)[kTile / 16][4]) {  // O += P·V of ring stage r
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j)
      wgmma_bf16_rs<1>(acc, frag[j], smem_desc_sw128_mn(stage(r) + C::kKBytes + 2048 * j), 1);
    wgmma_commit();
  };
  auto release = [&](uint32_t r) {
    if (signals) mbar_arrive(&empty[r % S]);
  };
  // keys past n score −inf; score element i sits at key 8·(i / 4) + 2t + i % 2
  // of the last tile or stage, which holds `valid` keys
  auto mask_last = [&](auto& x, int valid) {
    constexpr int kN = sizeof(x) / sizeof(float);
#pragma unroll
    for (int i = 0; i < kN; ++i)
      if (8 * (i / 4) + 2 * t + (i & 1) >= valid) x[i] = -INFINITY;
  };
  // take a turn at issuing: warpgroup w waits on barrier 1 + w …
  auto turn_begin = [&]() { named_barrier_sync(1 + wg, 256); };
  // … and lets the next go once its products are issued
  auto turn_end = [&]() { named_barrier_arrive(1 + (wg + 1) % kConsumers, 256); };

  if (wg == kConsumers - 1) named_barrier_arrive(1, 256);  // warpgroup 0 takes the first turn
  uint32_t r = 0;
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const Item w = decode(item, q_tiles, heads);

    // the warp's q rows off the swizzled boxes: matrices (rows 0–7, 8–15) ×
    // (columns 0–7, 8–15) of each k-step, lane l addressing row l % 8 of
    // matrix l / 8
    mbar_wait(q_full, it & 1);
    {
      const int row = 16 * wq + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const uint8_t* box = q_smem + (wg * kB + j / 4) * kBoxBytes;
        ln_gemm::ldmatrix_x4(qa[j], box + ln_gemm::swz(row, 2 * (j % 4) + (lane >> 4)));
      }
    }
    fence_frags(qa);
    named_barrier_sync(1 + kConsumers + wg, 128);  // every warp of the warpgroup holds its q
    if (signals) mbar_arrive(q_empty);

    if (w.q0 + 64 * wg >= n) {
      // no valid query in this warpgroup's rows (the last item of a
      // sequence): take its turns and free its stages, computing nothing
      for (int k = 0; k < tiles1 + tiles; ++k, ++r) {
        turn_begin();
        mbar_wait(&full[r % S], (r / S) & 1);
        turn_end();
        release(r);
      }
      turn_begin();  // pass 2's last turn
      turn_end();
      continue;
    }

    // pass 1: each thread's running max mt and sum lt over its own columns,
    // in units of the scores (s = u·scale) and of 2^(u·c − mt·c)
    float mt[2] = {-INFINITY, -INFINITY}, lt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int kt = 0; kt < tiles1; ++kt, ++r) {
      turn_begin();
      issue_scores(s1, r);
      turn_end();
      wgmma_wait<0>();
      fence_operands(s1);
      release(r);
      if (kt == tiles1 - 1) mask_last(s1, last_keys1);
      float mx[2] = {mt[0], mt[1]};
#pragma unroll
      for (int i = 0; i < C::kKeys1 / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s1[i]);
      float mc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // a thread that has met only masked keys keeps m = −inf and l = 0
        const bool none = mx[h] == -INFINITY;
        const float alpha = none ? 1.f : exp2_approx((mt[h] - mx[h]) * c);
        lt[h][0] *= alpha;
        lt[h][1] *= alpha;
        mt[h] = mx[h];
        mc[h] = none ? 0.f : -mx[h] * c;
      }
#pragma unroll
      for (int i = 0; i < C::kKeys1 / 2; ++i)
        lt[(i >> 1) & 1][(i >> 2) & 1] += exp2_approx(fmaf(s1[i], c, mc[(i >> 1) & 1]));
    }
    // the rows' max and sum over the quad
    float mcs[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m = quad_max(mt[h]);  // finite: every row has a valid key
      const float l = (lt[h][0] + lt[h][1]) * exp2_approx((mt[h] - m) * c);  // 0 for a thread of masked keys only
      inv[h] = 1.0f / quad_sum(l);
      mcs[h] = -m * c;
    }

    // pass 2: p = 2^(u·c − m·c) · (1/l) as bf16 A fragments of O += P·V
    auto probs = [&](int kt, uint32_t (&frag)[kTile / 16][4]) {
      fence_operands(sc);
      if (kt == tiles - 1) mask_last(sc, last_keys);
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // elements 8j + 2i, + 1: row half i % 2
          const float* s2 = sc + 8 * j + 2 * i;
          frag[j][i] = ln_gemm::pack_bf16(exp2_approx(fmaf(s2[0], c, mcs[i & 1])) * inv[i & 1],
                                          exp2_approx(fmaf(s2[1], c, mcs[i & 1])) * inv[i & 1]);
        }
      }
    };
    // tile kt (ring stage r2 + kt): its scores and tile kt − 1's P·V are
    // issued together; its p is computed while that product runs, then tile
    // kt − 1's stage is freed
    const uint32_t r2 = r;
    auto step = [&](int kt, uint32_t (&prev)[kTile / 16][4], uint32_t (&cur)[kTile / 16][4]) {
      turn_begin();
      issue_scores(sc, r2 + kt);
      issue_pv(r2 + kt - 1, prev);
      turn_end();
      wgmma_wait<1>();  // the scores
      probs(kt, cur);
      wgmma_wait<0>();  // P·V of tile kt − 1
      fence_operands(acc);
      fence_frags(prev);
      release(r2 + kt - 1);
    };
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    turn_begin();
    issue_scores(sc, r2);
    turn_end();
    wgmma_wait<0>();
    probs(0, pa);
    int kt = 1;
    for (; kt + 1 < tiles; kt += 2) {
      step(kt, pa, pb);
      step(kt + 1, pb, pa);
    }
    if (kt < tiles) step(kt, pa, pb);
    // the last tile's P·V (tile k's p is in pa for even k)
    r = r2 + tiles;
    turn_begin();
    wgmma_fence();  // the p registers
    if ((tiles - 1) % 2 == 0) {
      issue_pv(r - 1, pa);
    } else {
      issue_pv(r - 1, pb);
    }
    turn_end();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_frags(pa);
    fence_frags(pb);
    release(r - 1);

    // rows w.q0 + 64·wg + 16·wq + g (+ 8): 16-byte stores of 8 columns after
    // a quad transpose; d = 80's last 16 columns as pairs
    __nv_bfloat16* out_base = out + (long)w.b * n * dim + w.h * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w.q0 + 64 * wg + 16 * wq + g + 8 * h;
#pragma unroll
      for (int q = 0; q < D / 32; ++q) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = ln_gemm::pack_bf16(acc[4 * (4 * q + i) + 2 * h], acc[4 * (4 * q + i) + 2 * h + 1]);
        ln_gemm::quad_transpose(v, lane);
        if (row < n)
          *reinterpret_cast<uint4*>(out_base + (long)row * dim + 32 * q + 8 * t) = make_uint4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int j = 4 * (D / 32); j < D / 8; ++j) {
        if (row < n)
          *reinterpret_cast<uint32_t*>(out_base + (long)row * dim + 8 * j + 2 * t) =
              ln_gemm::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---- host side ------------------------------------------------------------------

// the packed qkv [batch, n, 3·dim] bf16 in boxes of 64 rows by 64 columns,
// 128-byte swizzled; rows past n (of each batch item) and columns past
// 3·dim zero-filled
cudaError_t encode_qkv(CUtensorMap* map, const void* qkv, int batch, int n, int dim) {
  PFN_cuTensorMapEncodeTiled encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)3 * dim, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)3 * dim * 2, (cuuint64_t)n * 3 * dim * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* qkv, void* out, int batch, int n, int heads, int device, cudaStream_t stream) {
  const long long items = (long long)((n + kQueries - 1) / kQueries) * heads * batch;
  if (batch <= 0 || n <= 0 || heads <= 0 || items > INT_MAX || (long long)n * 3 * heads * D > INT_MAX)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err = encode_qkv(&map, qkv, batch, n, heads * D);
  if (err != cudaSuccess) return err;
  constexpr int kSmem = LongCfg<D>::kSmem;
  err = cudaFuncSetAttribute(fused_qkv_long_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  fused_qkv_long_kernel<D><<<(int)(items < sms ? items : sms), kThreads, kSmem, stream>>>(
      map, static_cast<__nv_bfloat16*>(out), n, heads, (int)items, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv: [batch, n, 3·heads·head_dim] bf16, contiguous, 16-byte aligned;
// out: [batch, n, heads·head_dim] bf16; head_dim 64 or 80; any n >= 1 (the
// wrapper sends n > 272 here, shorter sequences to stamp_fused_qkv_attn).
// Returns a cudaError_t.
int stamp_fused_qkv_long(const void* qkv, void* out, int batch, int n, int heads, int head_dim, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(qkv, out, batch, n, heads, device, s);
    case 80:
      return launch<80>(qkv, out, batch, n, heads, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
