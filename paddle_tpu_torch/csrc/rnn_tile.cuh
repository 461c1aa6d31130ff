// The 256-thread block, the sigmoid and the bfloat16 stream values of the
// recurrent kernels (csrc/fused_lstm.cu, csrc/fused_gru.cu), and the
// block-wide tiled product of csrc/fused_gru.cu's dW reduction and gate
// recompute. Plain CUDA C++ (no PyTorch headers), included by both
// sources; the build hashes it with each of them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rnn_tile {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// A bfloat16 value as its 16 bits (torch.bfloat16's layout). The kernels'
// bf16 arm reads and writes its [T, B, .] streams in this type and
// computes in float32, as the Pallas kernels do: every value is widened
// at load (exact) and rounded to nearest even at store.
struct bf16 {
  unsigned short bits;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __uint_as_float(static_cast<unsigned>(v.bits) << 16);
}

// v rounded to the stream type S: float as it is, bf16 to nearest even
// (a NaN stays a quiet NaN).
template <class S>
__device__ __forceinline__ S from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  const unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return bf16{static_cast<unsigned short>((u >> 16) | 0x40u)};
  return bf16{
      static_cast<unsigned short>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}

// A read-only input (never written during the launch) through the
// non-coherent path, widened to float32.
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const bf16* p) {
  return to_float(bf16{__ldg(&p->bits)});
}

// Block-wide product of a TR x K operand A and a K x TC operand B, for one
// output tile: acc[i][j] (4x4 per thread) holds this thread's share. The
// reduction over K runs in stages of SPLIT*KG indices staged in shared
// memory; thread group s (of SPLIT groups of (TR/4)*(TC/4) threads) sums
// indices [s*KG, (s+1)*KG) of each stage. a_at(r, k) / b_at(k, c) return
// the operand (0 outside it). A_ALONG_K / B_ALONG_K say whether the
// operand's memory is contiguous along k, so that neighbouring threads
// load neighbouring addresses.
template <int TR, int TC, int SPLIT, int KG>
struct Tile {
  static constexpr int kGroupX = TC / 4;
  static constexpr int kGroup = (TR / 4) * kGroupX;
  static constexpr int kStage = SPLIT * KG;
  static constexpr int kLdA = TR + 4;  // padded: fewer bank conflicts
  static constexpr int kSmemA = kStage * kLdA;
  static constexpr int kSmemB = kStage * TC;
  static constexpr int kSmemRed = SPLIT * TR * TC;
  static constexpr int kSmem =
      (kSmemA + kSmemB) > kSmemRed ? (kSmemA + kSmemB) : kSmemRed;
  static_assert(SPLIT * kGroup == kThreads, "tile must use 256 threads");

  static constexpr int kLoadsA = kStage * TR / kThreads;
  static constexpr int kLoadsB = kStage * TC / kThreads;
  static_assert(kLoadsA * kThreads == kStage * TR, "A stage must split");
  static_assert(kLoadsB * kThreads == kStage * TC, "B stage must split");

  // Operand index of this thread's i-th load of a stage: (k, r) for A,
  // (k, c) for B; neighbouring threads take neighbouring addresses.
  template <bool ALONG_K, int W>
  __device__ __forceinline__ static void slot(int i, int& k, int& rc) {
    const int idx = threadIdx.x + i * kThreads;
    k = ALONG_K ? idx % kStage : idx / W;
    rc = ALONG_K ? idx / kStage : idx % W;
  }

  template <bool A_ALONG_K, bool B_ALONG_K, class FA, class FB>
  __device__ __forceinline__ static void product(int K, FA a_at, FB b_at,
                                                 float* smem,
                                                 float (&acc)[4][4]) {
    float* As = smem;           // [kStage][kLdA], k-major
    float* Bs = smem + kSmemA;  // [kStage][TC]
    const int tid = threadIdx.x;
    const int s = tid / kGroup;
    const int g = tid % kGroup;
    const int gy = g / kGroupX, gx = g % kGroupX;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // the next stage's operands wait in registers while this one computes
    float ra[kLoadsA], rb[kLoadsB];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < kLoadsA; ++i) {
        int k, r;
        slot<A_ALONG_K, TR>(i, k, r);
        ra[i] = (k0 + k < K) ? a_at(r, k0 + k) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kLoadsB; ++i) {
        int k, c;
        slot<B_ALONG_K, TC>(i, k, c);
        rb[i] = (k0 + k < K) ? b_at(k0 + k, c) : 0.f;
      }
    };
    auto stash = [&]() {
#pragma unroll
      for (int i = 0; i < kLoadsA; ++i) {
        int k, r;
        slot<A_ALONG_K, TR>(i, k, r);
        As[k * kLdA + r] = ra[i];
      }
#pragma unroll
      for (int i = 0; i < kLoadsB; ++i) {
        int k, c;
        slot<B_ALONG_K, TC>(i, k, c);
        Bs[k * TC + c] = rb[i];
      }
    };
    fetch(0);
    stash();
    __syncthreads();
    for (int k0 = 0; k0 < K; k0 += kStage) {
      const bool more = k0 + kStage < K;
      if (more) fetch(k0 + kStage);
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        const int k = s * KG + kk;
        const float4 a =
            *reinterpret_cast<const float4*>(&As[k * kLdA + gy * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k * TC + gx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
      if (more) {
        stash();
        __syncthreads();
      }
    }
  }

  // Sum the SPLIT groups' partial tiles in group order into smem[0, TR*TC)
  // (row-major TR x TC); ends with a barrier.
  __device__ __forceinline__ static void reduce(float* smem,
                                                const float (&acc)[4][4]) {
    const int tid = threadIdx.x;
    const int s = tid / kGroup;
    const int g = tid % kGroup;
    const int gy = g / kGroupX, gx = g % kGroupX;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        smem[(s * TR + gy * 4 + i) * TC + gx * 4 + j] = acc[i][j];
    __syncthreads();
    for (int idx = tid; idx < TR * TC; idx += kThreads) {
      float sum = smem[idx];
      for (int q = 1; q < SPLIT; ++q) sum += smem[q * TR * TC + idx];
      smem[idx] = sum;
    }
    __syncthreads();
  }
};

}  // namespace rnn_tile
