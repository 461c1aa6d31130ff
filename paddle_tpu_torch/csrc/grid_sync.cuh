// Hopper PTX of the persistent recurrent kernels (csrc/fused_gru.cu,
// csrc/fused_lstm.cu), and the grid-wide barrier and cooperative launch
// built on it. The first namespace block holds every piece of PTX those
// kernels use: the gpu-scope arrive and acquire of the barrier, the
// coherent load of values that other blocks write during the launch,
// 16-byte (through L2) and 4-byte asynchronous copies into shared memory,
// and the 3xTF32 multiply on the tensor cores (mma.sync m16n8k8). A host
// C++ version of that block alone (tests/test_torch_cuda_emulation.py
// writes one, on std::atomic_ref and a warp's exchange buffer) runs the
// kernels' own tiling, barrier and masking logic on a CPU, with the rest
// of this file compiled as it is.
//
// Memory-ordering rule of the barrier: a block's threads finish their
// global writes, meet at __syncthreads, and then ONE thread arrives
// (fence.acq_rel.gpu, then the add), which releases the block's writes at
// gpu scope; the waiting thread acquires (ld.acquire.gpu) and meets its
// block at __syncthreads again. A value another block wrote before the
// barrier is then read with load_cg (ld.global.cg, from L2) or copied with
// cp_async16 (cp.async.cg), never through L1 or the non-coherent path
// (__ldg / const __restrict__, cp.async.ca), which may return a line
// fetched before the barrier.
//
// mma.sync m16n8k8 .row.col f32.tf32.tf32.f32 fragments (PTX ISA, "Matrix
// fragments for mma.m16n8k8", .tf32), with g = lane / 4, t = lane % 4:
//   A (16 x 8): a[0] = (row g, k t), a[1] = (g + 8, t), a[2] = (g, t + 4),
//     a[3] = (g + 8, t + 4);
//   B (8 x 8): b[0] = (k t, column g), b[1] = (t + 4, g);
//   D (16 x 8): d[0], d[1] = (row g, columns 2t, 2t + 1), d[2], d[3] =
//     (row g + 8, the same columns).
// The tensor cores' float32 sums do not round to nearest (the error of
// each add grows with the running sum), so a kernel keeps the lo passes
// of 3xTF32 in an accumulator of their own, and adds the hi*hi and lo
// sums into a float32 running sum (promote) at least every 128 k.
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

// The 3xTF32 split of v, as two float32 words that mma_tf32 reads as TF32
// (their top 19 bits): hi is v rounded to TF32 (nearest, ties away, as
// cvt.rna rounds a finite value), lo = v - hi (exact: at most 12
// significant bits), read truncated to TF32. hi + lo is v to 2^-22 of
// |v|, at an integer add, a bitwise and and a subtraction an element:
// the kernels split every operand of every product.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += A B for one warp (mma.sync m16n8k8, TF32 operands, float32
// accumulators; fragments as above). Every lane of the warp issues it.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// sum += hi + lo in float32 (rounding adds), then hi = lo = 0: the lo
// passes' own sum joins the hi*hi passes' sum before both join the
// running sum. The kernels read the accumulators of mma_tf32 only here.
__device__ __forceinline__ void promote(float (&sum)[4], float (&hi)[4],
                                        float (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum[i] += hi[i] + lo[i];
    hi[i] = 0.f;
    lo[i] = 0.f;
  }
}

// The same with the lo passes in two accumulators: sum += hi + (la + lb).
__device__ __forceinline__ void promote(float (&sum)[4], float (&hi)[4],
                                        float (&la)[4], float (&lb)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum[i] += hi[i] + (la[i] + lb[i]);
    hi[i] = 0.f;
    la[i] = 0.f;
    lb[i] = 0.f;
  }
}

}  // namespace grid

// ---- Built on the PTX above (compiled unchanged by the host emulation) ----

namespace grid {

// Words of a barrier counter: each on its own 128-byte line.
constexpr int kSyncWords = 32;

// A grid-wide barrier over the blocks of a persistent launch whose tiles
// are `groups` row groups x strips, strip-major (tile i is row group
// i % groups). A step's data flow never leaves a row group, so with one
// block a tile the blocks of row group g = blockIdx.x % groups meet on
// counter g, led by the block of strip 0; with fewer blocks than tiles all
// of them meet on counter 0, led by block 0. The caller zeroes the
// counters (kSyncWords x groups words) before the launch.
struct Barrier {
  unsigned* counter;
  unsigned add;  // 2^31 - (members - 1) for the leader, else 1
  __device__ Barrier(unsigned* words, int groups, int tiles) {
    const bool per_group = gridDim.x == static_cast<unsigned>(tiles);
    counter = words + (per_group ? blockIdx.x % groups * kSyncWords : 0);
    const unsigned members = per_group ? tiles / groups : gridDim.x;
    const bool leader = per_group ? static_cast<int>(blockIdx.x) < groups
                                  : blockIdx.x == 0;
    add = leader ? 0x80000000u - (members - 1) : 1u;
  }
  // Sense-reversing: the counter's top bit flips when the last member
  // arrives, and its low bits are 0 again for the next barrier. arrive()
  // releases the block's writes and returns the counter as it found it
  // (in thread 0); wait() on that value returns once every member has
  // arrived, and a block may work on data of its own in between.
  __device__ __forceinline__ unsigned arrive() const {
    __syncthreads();
    return threadIdx.x == 0 ? grid::arrive(counter, add) : 0u;
  }
  __device__ __forceinline__ void wait(unsigned old) const {
    if (threadIdx.x == 0) {
      while (((old ^ load_acquire(counter)) & 0x80000000u) == 0) {
      }
    }
    __syncthreads();
  }
  __device__ __forceinline__ void sync() const { wait(arrive()); }
};

// kernel<<<blocks, threads, smem, s>>>(args...) as a cooperative launch,
// which the runtime refuses (cudaErrorCooperativeLaunchTooLarge) unless
// every block can be resident at once.
template <class... P, class... A>
cudaError_t launch_cooperative(void (*kernel)(P...), int blocks, int threads,
                               size_t smem, cudaStream_t s, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace grid
