// Fused conv + BatchNorm prologue/epilogue, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/fused_conv.py:
//   fused_conv1x1_f32  <- conv1x1_bn_act / _conv1x1_kernel
//   fused_conv3x3_f32  <- conv3x3_bn_act / _conv3x3_kernel
// and computes what they compute, on NHWC-flat rows (M = N*H*W rows of
// C channels, row-major):
//   1x1: out [M,N] = act(x) [M,K] @ w [K,N]
//   3x3 (stride 1, pad 1): out [M,N] = im2col(act(x)) [M,9C] @ w [9C,N],
//        w tap-major (tap t = (dh+1)*3 + (dw+1) holds rows t*C..t*C+C-1);
//        output row r = (n, h, w) reads tap t from row r + dh*W + dw when
//        0 <= h+dh < H and 0 <= w+dw < W, and 0 otherwise.
//   act(x) = x*a + b per input channel when a, b are given (the producer
//   BatchNorm's affine), then max(., 0) when relu is set; with relu and no
//   affine, max(x, 0). In the 3x3 conv the prologue is applied to the
//   loaded value BEFORE the edge mask: an out-of-image tap is 0, not
//   act(0) = relu(b), as zero padding of the activated map requires.
//   stats [2,N] (optional) = per output channel sum and sum of squares of
//   the f32 accumulator over all M rows (the consumer BatchNorm's
//   statistics); rows past M add nothing.
//
// What is not carried over from the TPU kernels: the M-divisibility of the
// row block (_pick_block_m), the 8-row-aligned halo DMA and the
// pltpu.roll shifts, the C-multiple-of-128 rule, the 64-channel
// pixel-pair geometry and the _conv3x3_small fallback. These are answers
// to the TPU's layout rules. Here every M, C and N is taken: rows and
// columns past the edge are masked, and the 3x3 taps are gathered
// straight from x as the operand tile is staged (an implicit GEMM: no
// im2col buffer in device memory).
//
// What bounds it on this card: at the ResNet-50 chain shapes (batch 128)
// the work is 2*M*K'*N FLOP (K' = K, or 9C) in float32 on the FMA units
// (67 TFLOP/s; no tensor cores: TF32 would break parity with the plain
// twin, as in every earlier slice), against (M*K + M*N + K'*N + 2N)*4
// bytes at 3.35 TB/s: the 3x3 convs and the wide 1x1s are bound by
// operations, the narrow 1x1s of the late stages nearly balanced.
//
// Design. One templated kernel for both convs: the classic register-tiled
// SIMT GEMM. A block of 256 threads owns a 128-row x BN-column output tile
// (BN = 128 with 8x8 outputs a thread for N >= 128, else BN = 64 with 8x4,
// so the N = 64 convs of stage 1 waste no half tile). The reduction runs
// in stages of 8: each thread stages 4 elements of the A tile (prologue
// and tap mask applied as they are loaded) and BN/64 of the B tile into a
// double-buffered shared tile, and loads the next stage into registers
// while it computes the current one: one __syncthreads a stage. Static
// shared memory is 8 KB (A) + 8 KB (B) + 16 KB (statistics), and about
// 110-128 registers a thread leave room for 2 blocks an SM (launch bounds
// 256, 2). Chosen over wgmma/TMA because a simple kernel that is right
// comes first; the tensor-core version is a later PR.
// Statistics: each block sums its 128 rows of each column in a fixed
// order (its 8 rows a thread, then the 16 row groups through shared
// memory) and writes one partial [2, BN] per row tile; a second launch
// reduces the partials over the row tiles in tile order. Deterministic,
// no atomics. With stats off neither is written nor launched.
// Offsets of row x channel products are 64-bit.
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the current CUDA stream through ctypes and checks the
// returned cudaError_t (cudaGetLastError after every launch).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;        // output rows a block
constexpr int kBK = 8;          // reduction depth a stage
constexpr int kTM = 8;          // output rows a thread
constexpr int kThreadCols = 16;  // thread grid: 16 row groups x 16 columns
constexpr int kStatGroups = 8;  // partial-reduction row groups a block

inline int cdiv(long long a, int b) { return static_cast<int>((a + b - 1) / b); }

// The activated, masked A operand (row m, reduction index kk) of the conv.
// Rows at or past M and kk at or past Kp read 0.
template <bool kConv3x3>
__device__ __forceinline__ float a_elem(const float* __restrict__ x,
                                        const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        bool relu, int M, int Kp, int C,
                                        int H, int W, int m, int hrow,
                                        int wrow, int kk) {
  if (m >= M || kk >= Kp) return 0.f;
  int c = kk;
  int64_t src = m;
  if (kConv3x3) {
    const int t = kk / C;
    c = kk - t * C;
    const int dh = t / 3 - 1, dw = t % 3 - 1;
    const int hh = hrow + dh, ww = wrow + dw;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) return 0.f;
    src = static_cast<int64_t>(m) + dh * W + dw;
  }
  float v = x[src * C + c];
  if (a != nullptr) v = v * a[c] + b[c];
  if (relu) v = fmaxf(v, 0.f);
  return v;
}

// out tile [128 x 16*TN] of act(x) @ w, and its column partial sums.
template <int TN, bool kConv3x3>
__global__ void __launch_bounds__(kThreads, 2)
fused_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, float* __restrict__ partial,
                  int M, int Kp, int N, int C, int H, int W, int relu_i) {
  constexpr int kBN = kThreadCols * TN;
  constexpr int kLoadsB = kBK * kBN / kThreads;  // 4 or 2
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  __shared__ __align__(16) float red[2][kThreads / kThreadCols][kBN];

  const bool relu = relu_i != 0;
  const int tid = threadIdx.x;
  const int ty = tid / kThreadCols, tx = tid % kThreadCols;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;

  // this thread's A loads: row a_r of the tile, reduction offsets a_k..+3
  const int a_r = tid / 2, a_k = (tid % 2) * 4;
  const int a_m = row0 + a_r;
  int hrow = 0, wrow = 0;
  if (kConv3x3) {
    hrow = (a_m / W) % H;
    wrow = a_m % W;
  }
  const int nk = (Kp + kBK - 1) / kBK;

  float ra[4], rb[kLoadsB];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ra[i] = a_elem<kConv3x3>(x, a, b, relu, M, Kp, C, H, W, a_m, hrow,
                               wrow, kt * kBK + a_k + i);
#pragma unroll
    for (int i = 0; i < kLoadsB; ++i) {
      const int idx = tid + i * kThreads;
      const int k = kt * kBK + idx / kBN, n = col0 + idx % kBN;
      rb[i] = (k < Kp && n < N) ? w[static_cast<int64_t>(k) * N + n] : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][a_k + i][a_r] = ra[i];
#pragma unroll
    for (int i = 0; i < kLoadsB; ++i) {
      const int idx = tid + i * kThreads;
      Bs[buf][idx / kBN][idx % kBN] = rb[i];
    }
  };

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch(kt + 1);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float af[kTM], bf[TN];
#pragma unroll
      for (int i = 0; i < kTM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[cur][k][ty * kTM + i]);
        af[i] = v.x; af[i + 1] = v.y; af[i + 2] = v.z; af[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[cur][k][tx * TN + j]);
        bf[j] = v.x; bf[j + 1] = v.y; bf[j + 2] = v.z; bf[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += af[i] * bf[j];
    }
    if (kt + 1 < nk) stage(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = row0 + ty * kTM + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = col0 + tx * TN + j;
      if (n < N) out[static_cast<int64_t>(m) * N + n] = acc[i][j];
    }
  }
  if (partial == nullptr) return;
  // column sums of this thread's rows (rows past M add nothing), then the
  // 16 row groups in order
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (row0 + ty * kTM + i < M) {
        s1 += acc[i][j];
        s2 += acc[i][j] * acc[i][j];
      }
    }
    red[0][ty][tx * TN + j] = s1;
    red[1][ty][tx * TN + j] = s2;
  }
  __syncthreads();
  for (int e = tid; e < 2 * kBN; e += kThreads) {
    const int s = e / kBN, c = e % kBN;
    if (col0 + c >= N) continue;
    float sum = 0.f;
    for (int g = 0; g < kThreads / kThreadCols; ++g) sum += red[s][g][c];
    partial[(static_cast<int64_t>(blockIdx.x) * 2 + s) * N + col0 + c] = sum;
  }
}

// stats[e] (e < 2N, [2, N] flattened) = sum over the row tiles, in tile
// order within each of 8 strided groups, then the 8 groups in order.
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ partial,
                    float* __restrict__ stats, int tiles, int two_n) {
  __shared__ float red[kStatGroups][32];
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (e < two_n)
    for (int t = g; t < tiles; t += kStatGroups)
      sum += partial[static_cast<int64_t>(t) * two_n + e];
  red[g][lane] = sum;
  __syncthreads();
  if (g == 0 && e < two_n) {
    float total = 0.f;
    for (int k = 0; k < kStatGroups; ++k) total += red[k][lane];
    stats[e] = total;
  }
}

template <bool kConv3x3>
int launch(const float* x, const float* w, const float* a, const float* b,
           float* out, float* partial, float* stats, int M, int Kp, int N,
           int C, int H, int W, int relu, cudaStream_t s) {
  const int tiles = cdiv(M, kBM);
  if (N >= 128) {
    const dim3 grid(tiles, cdiv(N, 128));
    fused_conv_kernel<8, kConv3x3><<<grid, kThreads, 0, s>>>(
        x, w, a, b, out, stats ? partial : nullptr, M, Kp, N, C, H, W, relu);
  } else {
    const dim3 grid(tiles, cdiv(N, 64));
    fused_conv_kernel<4, kConv3x3><<<grid, kThreads, 0, s>>>(
        x, w, a, b, out, stats ? partial : nullptr, M, Kp, N, C, H, W, relu);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return err;
  const int blocks = cdiv(2LL * N, 32);
  stats_reduce_kernel<<<blocks, kThreads, 0, s>>>(partial, stats, tiles,
                                                  2 * N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Row tiles of the kernels (the wrapper sizes the partial-sum scratch,
// [tiles, 2, N], from it).
int fused_conv_row_tile() { return kBM; }

// 1x1 conv: x [M,K], w [K,N], a/b [K] or NULL, out [M,N]; stats [2,N] and
// partial [ceil(M/128), 2, N] scratch, or both NULL for no statistics.
// Returns a cudaError_t.
int fused_conv1x1_f32(const float* x, const float* w, const float* a,
                      const float* b, float* out, float* partial,
                      float* stats, int M, int K, int N, int relu,
                      void* stream) {
  return launch<false>(x, w, a, b, out, partial, stats, M, K, N, K, 1, 1,
                       relu, static_cast<cudaStream_t>(stream));
}

// 3x3 stride-1 pad-1 conv on NHWC-flat rows of img_h x img_w images:
// x [M,C], w [9C,N] tap-major, a/b [C] or NULL, the rest as the 1x1.
int fused_conv3x3_f32(const float* x, const float* w, const float* a,
                      const float* b, float* out, float* partial,
                      float* stats, int M, int C, int N, int img_h,
                      int img_w, int relu, void* stream) {
  return launch<true>(x, w, a, b, out, partial, stats, M, 9 * C, N, C,
                      img_h, img_w, relu, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
