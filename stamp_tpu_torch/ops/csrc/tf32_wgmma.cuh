// The TF32 wgmma machinery shared by the f32 attention kernels fed by TMA
// (flash_attn.cu: the MIL forward; flash_attn_bwd.cu: its backward and the
// distance-weighted sum; flash_alibi2d.cu: TITAN's pre-softmax ALiBi
// attention): the m64nNk8
// products with A in registers or shared memory, the 128-byte-swizzled box
// layout TMA writes and its k-step descriptors, the producer/consumer ring
// of shared-memory stages, the pre-passes' TF32 and transposed copies, the
// accumulator stores, and the host's tensor-map encoders.
//
// K-major.  TF32 wgmma takes both operands K-major (PTX allows the transpose
// bits for 16-bit types only).  A product that contracts over the sequence
// (P·V, dS·k, D·V) therefore reads a transposed copy [d, n_pad] with the
// sequence contiguous.  Its A operand comes from registers: a warp's score
// accumulator rows are mma.sync m16n8k8's C layout and the TF32 A registers
// its A layout (g = lane / 4, t = lane % 4):
//   a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
//   c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
// A C fragment over 8 columns becomes the A fragment of a product whose
// depth runs over those columns when the depth is taken in the order
// (0, 2, 4, 6, 1, 3, 5, 7): a = (c0, c2, c1, c3).  The pre-passes bake that
// order into every 8 consecutive positions of the transposed copies.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace sm90;

// x rounded to TF32 (to nearest, ties away from zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// ---- TF32 wgmma: m64nNk8, D (f32) += A·B --------------------------------------
// Accumulator (per warp w of the warpgroup, g = lane / 4, t = lane % 4):
// d[4j + 2h + e] is row 16w + g + 8h, column 8j + 2t + e.  A in registers
// (rs): warp w holds rows 16w..16w+15 as mma.sync m16n8k8's TF32 A
// fragment, a = (A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]).  A in shared
// memory (ss) and B: descriptors of K-major 128-byte-swizzled boxes.  With
// scale_d = 0 the accumulator's old value is ignored.

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---- tiling -----------------------------------------------------------------

constexpr int kUnit = 32;          // rows per liveness flag
constexpr int kPad = 128;          // padding of the transposed copies and the vectors
constexpr int kPreRows = 128;      // rows per pre-pass block
constexpr int kHalf = 64;          // rows per pass through its tile
constexpr int kPreThreads = 256;
constexpr int kBoxRowBytes = 128;  // a swizzled box row: 32 f32

// A [kRows, kCols] f32 block in shared memory as TMA writes it: kCols / 32
// boxes of [kRows, 32] (128-byte rows, 128-byte swizzle), box b holding
// columns 32b … 32b + 31.
template <int kRows, int kCols>
struct Boxes {
  static constexpr int kBoxBytes = kRows * kBoxRowBytes;
  static constexpr int kBytes = kBoxBytes * (kCols / 32);
  static_assert(kBoxBytes % 1024 == 0, "swizzled boxes need 1024-byte alignment");
};

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Descriptor of k-step j (columns 8j … 8j + 7) of a block of kRows-row boxes.
template <int kRows>
__device__ __forceinline__ uint64_t kstep_desc(const uint8_t* block, int j) {
  return smem_desc_sw128(block + (j / 4) * kRows * kBoxRowBytes) + 2 * (j % 4);
}

// x rounded to TF32 (to nearest, ties away from zero: cvt.rna's result)
// in two integer operations: the tensor cores ignore the low 13 bits of a
// TF32 operand, so adding half of their weight and clearing them rounds
// the magnitude.  Equal to to_tf32 for every finite x and ±inf.
__device__ __forceinline__ uint32_t tf32_round(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// √x by the special-function unit (sqrt.approx.ftz.f32: relative error of
// order 2^-23; √0 = 0, subnormal squares flush to 0)
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// ‖a − b‖ from per-axis differences (the Gram identity cancels for nearby
// points), with no contraction into FMA, and √ as above
__device__ __forceinline__ float distance(float ax, float ay, float bx, float by) {
  const float dx = ax - bx, dy = ay - by;
  return sqrt_approx(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- the ring -----------------------------------------------------------------

// The block's shared memory from a 1024-byte boundary: its own rows, the
// ring's stages, then the barriers (full[S], empty[S], and one for its own
// rows).  One producer thread fills a stage by TMA and arms "full"; each
// consumer warpgroup arrives on "empty" once it is done with the stage.
struct Ring {
  uint8_t* own;
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own_bar;
};

template <int kOwnBytes, int kStages, int kStageBytes, int kGroups>
__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw) {
  Ring r;
  // aligned by an offset from the shared array, so that the compiler still
  // knows every pointer below is shared memory
  r.own = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  r.stages = r.own + kOwnBytes;
  r.full = reinterpret_cast<uint64_t*>(r.stages + kStages * kStageBytes);
  r.empty = r.full + kStages;
  r.own_bar = r.empty + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], kGroups);
    }
    mbar_init(r.own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// Registers of a consumer thread and of a producer thread after setmaxnreg,
// in a block of two consumer warpgroups and one producer warpgroup:
// 2·128·232 + 128·40 ≤ 65,536.
constexpr int kConsumerRegs = 232, kProducerRegs = 40;

// Shared memory a kernel asks for: its own rows, kStages stages and the
// barriers, plus 1024 bytes to align the start.
__host__ __device__ constexpr int ring_smem(int own_bytes, int stages, int stage_bytes) {
  return own_bytes + stages * stage_bytes + (2 * stages + 1) * 8 + 1024;
}

// ---- pre-pass copies ----------------------------------------------------------------

// Rows [r0, r0 + 64) of src [n, D], TF32-rounded, into dst (rows < n; none
// with a null dst) and, with kToTile, into `tile` (zero past n).  Run by a
// whole pre-pass block.
template <int D, bool kToTile>
__device__ __forceinline__ void round_rows(float (*tile)[D + 1], const float* __restrict__ src,
                                           float* __restrict__ dst, int r0, int n) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < kHalf * kVecs; i += kPreThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    const long row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) x = *reinterpret_cast<const float4*>(src + row * D + c);
    x.x = __uint_as_float(to_tf32(x.x));
    x.y = __uint_as_float(to_tf32(x.y));
    x.z = __uint_as_float(to_tf32(x.z));
    x.w = __uint_as_float(to_tf32(x.w));
    if (dst != nullptr && row < n) *reinterpret_cast<float4*>(dst + row * D + c) = x;
    if constexpr (kToTile) {
      tile[r][c] = x.x;
      tile[r][c + 1] = x.y;
      tile[r][c + 2] = x.z;
      tile[r][c + 3] = x.w;
    }
  }
}

// Row r of a 64-row tile that position pos of a transposed copy holds:
// position 8m + i holds row 8m + (0, 2, 4, 6, 1, 3, 5, 7)[i], the depth
// order in which a score accumulator is an A fragment.
__device__ __forceinline__ int depth_row(int pos) {
  const int j = pos & 7;
  return (pos & ~7) | (j < 4 ? 2 * j : 2 * j - 7);
}

// The tile's columns as rows of dst [D, n_pad], positions r0 … r0 + 63, in
// the depth order above.
template <int D>
__device__ __forceinline__ void write_transposed(const float (*tile)[D + 1], float* __restrict__ dst, int r0,
                                                 int n_pad) {
  for (int i = threadIdx.x; i < D * kHalf; i += kPreThreads) {
    const int c = i / kHalf, pos = i % kHalf;
    dst[(long)c * n_pad + r0 + pos] = tile[depth_row(pos)][c];
  }
}

// ---- stores -------------------------------------------------------------------------

// Rows row0 + g and row0 + g + 8 of an [n, D] output from a warp's m64nD
// accumulator.
template <int D>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, const float (&acc)[D / 2], int row0, int n,
                                          int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dst + (long)row * D + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// Zeros into rows [row0, row0 + rows) ∩ [0, n) of an [n, D] output, by the
// whole block.
template <int D>
__device__ __forceinline__ void store_zero_rows(float* __restrict__ dst, int row0, int rows, int n) {
  const int end = min(row0 + rows, n);
  for (long i = (long)row0 * D / 4 + threadIdx.x; i < (long)end * D / 4; i += blockDim.x)
    reinterpret_cast<float4*>(dst)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---- host side: tensor maps -------------------------------------------------------

// A map of rank 2 or 3 over f32 (dims and byte strides innermost first),
// boxes of `box` (128-byte rows with `swizzled`), zero fill past the edges.
inline cudaError_t encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                          const cuuint64_t* strides, const cuuint32_t* box, bool swizzled) {
  PFN_cuTensorMapEncodeTiled fn;
  cudaError_t err = tensor_map_encoder(&fn);
  if (err != cudaSuccess) return err;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// rows of [bh, n, d] in boxes of [rows, 32]
inline cudaError_t encode_rows(CUtensorMap* map, const float* ptr, int bh, int n, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)n * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  return encode(map, ptr, 3, dims, strides, box, true);
}

// a transposed copy [bh, d, n_pad] in boxes of [d, 32]
inline cudaError_t encode_cols(CUtensorMap* map, const float* ptr, int bh, int n_pad, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)n_pad, (cuuint64_t)d, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)n_pad * 4, (cuuint64_t)n_pad * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)d, 1};
  return encode(map, ptr, 3, dims, strides, box, true);
}

// a padded vector [bh, n_pad] in boxes of `len`
inline cudaError_t encode_vec(CUtensorMap* map, const float* ptr, int bh, int n_pad, int len) {
  const cuuint64_t dims[2] = {(cuuint64_t)n_pad, (cuuint64_t)bh};
  const cuuint64_t strides[1] = {(cuuint64_t)n_pad * 4};
  const cuuint32_t box[2] = {(cuuint32_t)len, 1};
  return encode(map, ptr, 2, dims, strides, box, false);
}

}  // namespace
