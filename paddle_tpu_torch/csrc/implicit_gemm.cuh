// The pieces of a tensor-core implicit GEMM (sm_90a) that the fused conv
// kernels (fused_conv.cu) and the ghost-BN bottleneck block
// (block_megakernel.cu) share: the block shape, the two operand types,
// the validity bits of a 3x3's taps, the weight pack into K-major TF32
// hi/lo (float32) or bfloat16 planes that wgmma's B operand reads, and the
// sizes a launch plans with. The main kernels stay in their own sources:
// their A operands, prologues and epilogues differ (see each header).
//
// Every piece of PTX is in sm90_mma.cuh; this header is plain CUDA C++,
// so the host emulation of tests/test_torch_cuda_emulation.py compiles it
// as it is. Each source includes it once, in its own translation unit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90_mma.cuh"

namespace {

constexpr int kThreads = 256;      // two warpgroups
constexpr int kBM = 128;           // output rows a block, 64 a warpgroup
constexpr int kChunkBytes = 128;   // a B tile row of one reduction step
constexpr int kMaxStages = 4;      // B ring depth
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int cdiv(long long a, int b) {
  return static_cast<int>((a + b - 1) / b);
}

// The two operand types. kBK channels make one 128-byte reduction chunk,
// taken in 4 k-steps of kK; float32 keeps hi and lo planes of w.
struct F32 {
  using T = float;
  static constexpr bool kBf16 = false;
  static constexpr int kBytes = 4, kBK = 32, kK = 8, kPlanes = 2;
};
struct BF16 {
  using T = uint16_t;
  static constexpr bool kBf16 = true;
  static constexpr int kBytes = 2, kBK = 64, kK = 16, kPlanes = 1;
};

__device__ __forceinline__ float word_f32(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

__device__ __forceinline__ uint32_t f32_word(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

// Bits t = (dh+1)*3 + (dw+1) of the taps of output row m that stay in its
// H x W image.
__device__ __forceinline__ uint32_t tap_bits(int m, int H, int W) {
  const int h = (m / W) % H, w = m % W;
  uint32_t bits = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int hh = h + t / 3 - 1, ww = w + t % 3 - 1;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W) bits |= 1u << t;
  }
  return bits;
}

// Bytes between the rows of the output tile staged in shared memory: BN
// elements and 16 (bf16) or 32 (float32) bytes more, so that the 8 rows x
// 4 lanes of a fragment write land in 32 banks.
__host__ __device__ constexpr int out_pitch(int bn, int bytes) {
  return bn * bytes + 8 * bytes;
}

// w [taps*C, N] -> K-major [planes][npad][taps][cpad], zero past C and N;
// float32 as TF32 hi and lo planes. One block transposes a 32 x 32 tile
// through shared memory, so that both its reads and its writes are rows.
template <class E>
__global__ void __launch_bounds__(kThreads)
pack_w_kernel(const typename E::T* __restrict__ w, uint32_t* __restrict__ wp32,
              uint16_t* __restrict__ wp16, int taps, int C, int N, int cpad,
              int npad) {
  __shared__ uint32_t tile[32][33];
  const int64_t krow = static_cast<int64_t>(taps) * cpad;
  const int64_t total = krow * npad;
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += kThreads / 32) {  // w row k0 + r
    const int k = k0 + r, tap = k / cpad, c = k % cpad, n = n0 + tx;
    uint32_t v = 0;
    if (c < C && n < N) {
      const int64_t src = (static_cast<int64_t>(tap) * C + c) * N + n;
      if constexpr (E::kBf16)
        v = w[src];
      else
        v = f32_word(w[src]);
    }
    tile[r][tx] = v;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += kThreads / 32) {  // packed row n0 + r
    const int64_t i = static_cast<int64_t>(n0 + r) * krow + k0 + tx;
    const uint32_t v = tile[tx][r];
    if constexpr (E::kBf16) {
      wp16[i] = static_cast<uint16_t>(v);
    } else {
      const uint32_t hi = sm90::tf32_rna(word_f32(v));
      wp32[i] = hi;
      wp32[total + i] = sm90::tf32_rna(word_f32(v) - word_f32(hi));
    }
  }
}

// The largest dynamic shared memory a block may opt in to on this card.
int max_dynamic_smem() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      bytes = 48 * 1024;
  }
  return bytes;
}

}  // namespace
