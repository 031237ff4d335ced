// Hopper's asynchronous machinery, shared by the TMA + wgmma kernels
// (ln_gemm_sm90.cuh for ln_dense and ln_quant_dense; through
// tf32_wgmma.cuh, flash_attn.cu, flash_attn_bwd.cu and flash_alibi2d.cu;
// fused_qkv_long.cu): shared-memory addresses, mbarriers whose waits trap
// after 10 s instead of hanging the card, TMA loads, register reallocation
// and named barriers between warpgroups, the wgmma fences (and the one that
// keeps A fragments in their registers), the descriptor of a
// 128-byte-swizzled K-major operand, the special-function unit's 2^x, and
// cuTensorMapEncodeTiled reached through the runtime.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace sm90 {

constexpr unsigned long long kWatchdogNs = 10000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_timer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of `bar` has completed.  A fault
// in the ring's phases would spin forever; after 10 s the kernel traps, so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint64_t start = 0;
  for (uint32_t polls = 1;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((polls & 1023) == 0) {
      const uint64_t now = global_timer();
      if (start == 0) {
        start = now;
      } else if (now - start > kWatchdogNs) {
        __trap();
      }
    }
  }
}

// ---- TMA ------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- registers and wgmma ----------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep A fragments in their registers until the wgmmas that read them
// completed: the compiler sees them read and written here, after the wait.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
  }
}

// named barriers 1 … 15 among `threads` threads (warpgroups taking turns)
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Descriptor of a K-major wgmma operand as TMA's 128-byte swizzle lays it
// out: 128-byte rows, 8-row groups 1024 bytes apart (stride offset 64 × 16
// bytes), leading offset unused for a swizzled K-major operand (1), layout
// type 1 (128-byte swizzle).  The box must be 1024-byte aligned.  The k-step
// j of a box starts 32·j bytes into each row: add 2·j (16-byte units).
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* box) {
  const uint64_t addr = smem_addr(box);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// ---- the special-function unit -----------------------------------------------------

// 2^x by the special-function unit (ex2.approx.ftz.f32; 2^(−1e30) = +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// ---- host side ------------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no -lcuda
inline cudaError_t tensor_map_encoder(PFN_cuTensorMapEncodeTiled* fn) {
  static PFN_cuTensorMapEncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

}  // namespace sm90
}  // namespace
