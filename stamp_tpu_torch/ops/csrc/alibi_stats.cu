// The spatial-ALiBi Welford statistic of the MIL ViT: over every ordered
// pair (row i, key j) with both valid, the sum of ‖c_i − c_j‖ and the number
// of such pairs:
//   out[0] += Σ_b Σ_{i valid} Σ_{j valid} ‖coords[b, i] − coords_k[b, j]‖
//   out[1] += Σ_b (#valid rows of b)·(#valid keys of b)
// (float64; the caller zeroes `out`).  Without a row or a key mask every row
// or key is valid.  Rows and keys are separate arrays so that a rank of a
// sequence group sums its share of the rows against the whole sequence.
//
// Replaces no TPU kernel: stamp_tpu/ops/attention.py:77-115
// (`mean_pairwise_distance`) leaves the reduction to XLA.  The port's plain
// version (ops/attention.py, `pairwise_distance_sums_reference`) streams
// 512-row blocks of the padded bag against every key: per pair it writes
// and reads the per-axis differences, the distance and two mask products
// (about 72 bytes a pair, 210 GB a whole-slide training step at 20×).
//
// What bounds it on the H100: the special-function unit.  A pair is two
// subtractions, a product, an FMA, one square root (sqrt.approx: one MUFU
// op, 16 a clock an SM) and the FMA that adds it with the key's weight; the
// bytes are the coordinates and masks, read once (9 bytes a row or key).
// 2.3·10⁹ pairs (a bag of 48,000 tiles) take about 0.55 ms at the MUFU rate.
//
// What the design does about it: a block holds 1,024 rows in registers (4 a
// thread, strided so the loads coalesce) and stages 1,024 keys in shared
// memory as (x, y, weight) with weight 0 for an invalid key; each key is one
// broadcast load for 4 pairs a thread.  A block whose rows or keys are all
// invalid (the bucket padding of a whole-slide bag) returns before any pair.
// Invalid rows are summed with weight 0.  No [Q, K] tensor exists anywhere.
//
// Numerics: each thread sums its 4 × ≤1,024 distances in f32 (relative
// error of order √1024·2⁻²⁴ a thread, of either sign), the block's 256
// thread sums are added in f64, and blocks combine by f64 atomics, whose
// order varies from run to run only in f64's last bits.  The square root is
// sqrt.approx.ftz.f32 (relative error at most 2⁻²³, 0 at 0).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kRows = kThreads * kRowsPerThread;  // rows a block
constexpr int kKeys = 1024;                       // keys a block stages

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ double block_sum(double v, double* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? scratch[lane] : 0.0;
  if (warp == 0)
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grid (row blocks, key blocks, batch); kThreads threads.
__global__ void __launch_bounds__(kThreads) alibi_pair_sums_kernel(const float2* __restrict__ coords,
                                                                   const uint8_t* __restrict__ mask,
                                                                   const float2* __restrict__ coords_k,
                                                                   const uint8_t* __restrict__ key_mask,
                                                                   double* __restrict__ out, int tq, int tk) {
  __shared__ float4 keys[kKeys];
  __shared__ double scratch[kThreads / 32];
  const long b = blockIdx.z;
  const int row0 = blockIdx.x * kRows, key0 = blockIdx.y * kKeys;
  coords += b * tq;
  coords_k += b * tk;
  if (mask != nullptr) mask += b * tq;
  if (key_mask != nullptr) key_mask += b * tk;

  float rx[kRowsPerThread], ry[kRowsPerThread], rw[kRowsPerThread];
  int n_rows = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = row0 + r * kThreads + threadIdx.x;
    const bool valid = i < tq && (mask == nullptr || mask[i]);
    const float2 c = valid ? coords[i] : make_float2(0.f, 0.f);
    rx[r] = c.x;
    ry[r] = c.y;
    rw[r] = valid ? 1.f : 0.f;
    n_rows += __syncthreads_count(valid);
  }
  int n_keys = 0;
  for (int j = threadIdx.x; j < kKeys; j += kThreads) {
    const int k = key0 + j;
    const bool valid = k < tk && (key_mask == nullptr || key_mask[k]);
    const float2 c = valid ? coords_k[k] : make_float2(0.f, 0.f);
    keys[j] = make_float4(c.x, c.y, valid ? 1.f : 0.f, 0.f);
    n_keys += __syncthreads_count(valid);  // also the barrier before the keys are read
  }
  if (n_rows == 0 || n_keys == 0) return;  // the same in every thread

  const int n_stage = min(kKeys, tk - key0);
  float acc[kRowsPerThread] = {};
#pragma unroll 4
  for (int j = 0; j < n_stage; ++j) {
    const float4 kv = keys[j];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float dx = rx[r] - kv.x, dy = ry[r] - kv.y;
      acc[r] = fmaf(kv.z, sqrt_approx(fmaf(dx, dx, dy * dy)), acc[r]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) sum = fmaf(rw[r], acc[r], sum);
  const double total = block_sum(static_cast<double>(sum), scratch);
  if (threadIdx.x == 0) {
    atomicAdd(out, total);
    atomicAdd(out + 1, static_cast<double>(n_rows) * static_cast<double>(n_keys));
  }
}

}  // namespace

extern "C" {

// coords [b, tq, 2] and coords_k [b, tk, 2] f32, mask [b, tq] and key_mask
// [b, tk] bool (1 byte) or NULL (every row or key valid), out [2] f64 that
// the caller zeroed.  Returns a cudaError_t.
int stamp_alibi_pair_sums(const void* coords, const void* mask, const void* coords_k, const void* key_mask, void* out,
                          int b, int tq, int tk, int device, void* stream) {
  if (b <= 0 || b > 65535 || tq <= 0 || tk <= 0 || (tk + kKeys - 1) / kKeys > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kRows - 1) / kRows, (tk + kKeys - 1) / kKeys, b);
  alibi_pair_sums_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(coords), static_cast<const uint8_t*>(mask), static_cast<const float2*>(coords_k),
      static_cast<const uint8_t*>(key_mask), static_cast<double*>(out), tq, tk);
  return cudaGetLastError();
}

}  // extern "C"
