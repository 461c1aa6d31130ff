// Hopper PTX of the persistent recurrent kernels (csrc/fused_gru.cu): the
// gpu-scope arrive and acquire of their grid-wide barrier, the coherent
// load of values that other blocks write during the launch, and 16-byte
// (through L2) and 4-byte asynchronous copies into shared memory. Every
// piece of PTX those kernels use is here, so that a host C++ version of
// these few functions
// (tests/test_torch_fused_gru_cuda_source.py writes one, on std::atomic_ref)
// runs the kernels' own tiling, barrier and masking logic on a CPU.
//
// Memory-ordering rule of the barrier built on them: a block's threads
// finish their global writes, meet at __syncthreads, and then ONE thread
// arrives (fence.acq_rel.gpu, then the add), which releases the block's
// writes at gpu scope; the waiting thread acquires (ld.acquire.gpu) and
// meets its block at __syncthreads again. A value another block wrote
// before the barrier is then read with load_cg (ld.global.cg, from L2) or
// copied with cp_async16 (cp.async.cg), never through L1 or the
// non-coherent path (__ldg / const __restrict__, cp.async.ca), which may
// return a line fetched before the barrier.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace grid {

// *p += v at gpu scope after an acquire-release fence; returns the old value.
__device__ __forceinline__ unsigned arrive(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile(
      "fence.acq_rel.gpu;\n\t"
      "atom.relaxed.gpu.global.add.u32 %0, [%1], %2;\n"
      : "=r"(old)
      : "l"(p), "r"(v)
      : "memory");
  return old;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A float written by another block during this launch (before a barrier).
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }

// 16 bytes from global to shared memory, asynchronously, through L2 (.cg:
// not L1), so also for values other blocks wrote before a barrier.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// 4 bytes from global to shared memory, asynchronously, through L1 (.ca:
// read-only inputs only).
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (clamped to 0..3) of this thread's copy groups are
// in flight; the finished ones are then visible to it.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Wait for all of this thread's copies; they are then visible to it.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace grid
