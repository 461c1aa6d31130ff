// Hopper (sm_90a) primitives of the tensor-core kernels in this directory:
// 16-byte asynchronous copies into shared memory, the proxy fence that
// makes shared-memory writes visible to the tensor cores, warpgroup
// matrix multiplies (wgmma.mma_async) with A from registers or from a
// K-major shared tile and B from a K-major shared tile, both in the
// 128-byte swizzle, the round-to-TF32 of the 3xTF32 split, the bfloat16
// pair conversion, a warp shuffle and the dynamic shared memory. Every
// piece of PTX of those kernels is here, so that a host C++ version of
// these few functions (tests/test_torch_cuda_emulation.py writes one)
// runs the kernels' own tiling, staging, masking and reduction logic on a
// CPU.
//
// Fragment and tile semantics the kernels rely on (PTX ISA, "Asynchronous
// Warpgroup Level Matrix Multiply-Accumulate", register fragments and
// shared-memory matrix layouts):
//   A (64 x 16 bf16, or 64 x 8 tf32) from registers: warp w of the
//     warpgroup holds rows 16w..16w+15; with g = lane / 4, t = lane % 4,
//     a[0] = (row g, word t), a[1] = (g + 8, t), a[2] = (g, t + 4),
//     a[3] = (g + 8, t + 4), where word u is columns 2u, 2u+1 of bf16
//     (low half the lower column) or column u of tf32.
//   D (64 x N float32): d[4j + e] = (row g, column 8j + 2t + e) and
//     d[4j + 2 + e] = (row g + 8, column 8j + 2t + e), e in {0, 1}, rows
//     again offset by 16w.
//   B (N x 32 bytes of K, K-major): row n of the tile at byte n * 128 of a
//     1024-byte-aligned tile (8-row atoms of 8 x 128 bytes, 1024 bytes
//     apart), its 16-byte chunk q stored at chunk q ^ (n % 8): the
//     128-byte swizzle. `b` points at the tile plus 32 bytes per k-step
//     (or is its descriptor, b_desc, moved on by desc_add).
//   A from shared memory (tf32 only here, wgmma_ss): the 64 rows of A laid
//     out as B's N rows, `a` the descriptor of the tile plus 32 bytes a
//     k-step.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0 or 16) are filled with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0..3) of this thread's committed copy groups are
// still in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Orders this thread's earlier writes to shared memory (plain stores and
// completed cp.async copies) before later reads of the async proxy, which
// is how wgmma reads its shared-memory operands.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous multiplies.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// v rounded to the nearest TF32 value (ties away from zero), as the bits
// of a float32 whose low 13 mantissa bits are 0.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// Two float32 values rounded to nearest-even bfloat16 and packed: lo in
// the low half (the lower column or channel).
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float shfl_xor(float v, int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask);
}

__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return smem_raw;
}

// Matrix descriptor of a K-major A or B tile in the 128-byte swizzle: start
// address, leading byte offset 16 (unused in this mode), stride byte
// offset 1024 (between 8-row atoms), swizzle mode 1.
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The descriptor of the tile `bytes` further on (a multiple of 16 that
// keeps it in shared memory): one add where a loop walks a tile's k-steps
// and planes from a descriptor made once.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, int bytes) {
  return desc + static_cast<uint64_t>(bytes >> 4);
}

// d[64 x N] = A[64 x K] * B[K x N] (+ d when accumulate is nonzero) for
// one k-step of one warpgroup (N 16, 32, 64 or 128): K = 16 bf16 (kBf16)
// or 8 tf32, float32
// accumulators, A from registers, B from the shared tile of descriptor
// `b` (or at address `b`, below). Issued asynchronously: wgmma_commit
// and wgmma_wait0 complete it. The tensor cores' float32 accumulation
// does not round to nearest (its error grows with the number of steps
// added), so the kernels add a few steps' sum into their own float32
// registers with an ordinary add.
template <int N, bool kBf16>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int accumulate);

#define D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma<16, true>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<32, true>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<64, true>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<128, true>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<16, false>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<32, false>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : D8(0), D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<64, false>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<128, false>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d[64 x N] = A[64 x 8] * B[8 x N] (+ d when accumulate is nonzero), tf32,
// A from the K-major shared tile at `a` (64 rows, laid out as B's rows),
// B from the shared tile at `b`; asynchronous, as wgmma.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1;\n}\n"
      : D8(0), D8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef D8

// wgmma with B given by its shared tile's address.
template <int N, bool kBf16>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], const void* b,
                                      int accumulate) {
  wgmma<N, kBf16>(d, a, b_desc(b), accumulate);
}

}  // namespace sm90
