// The ghost-BN identity bottleneck block, forward, float32 and bfloat16,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   paddle_tpu/ops/pallas/block_megakernel.py  bottleneck_block /
//       _bottleneck_kernel (variant full)
//   benchmarks/megakernel_roll_micro.py  block / _kernel (variants full,
//       strided, nobn, noroll)
// and computes what they compute, on NHWC-flat rows (M = N*H*W rows):
//   acc1 = x [M,Cin] @ w1 [Cin,Cm]
//   h1   = relu(acc1 * a1 + b1)
//   acc2 = sum over taps t = (dy+1)*3 + (dx+1) of tap_t(h1) @ w3[t]
//          [Cm,Cm]; tap_t at row (n, h, w) is h1 at (n, h+dy, w+dx) when
//          that pixel lies in the image, else 0 (the affine and ReLU come
//          BEFORE the edge mask: a padded tap is 0, not relu(b))
//   h2   = relu(acc2 * a2 + b2)
//   acc3 = h2 @ w2 [Cm,Cin]
//   y    = relu(acc3 * a3 + b3 + x)
// Ghost BN: (a, b) of each BN are taken per group of `tile` consecutive
// images (G = tile*H*W rows) from the float32 accumulator, single pass:
// mean = sum/G, var = sum(h^2)/G - mean^2, a = gamma / sqrt(var + eps),
// b = beta - mean * a. Sums are float32; with bfloat16 data the taps, h2
// and y are rounded to bfloat16 (nearest even) as the reference rounds
// them, and nowhere else. Variants: strided computes full's function
// (below); nobn uses a = p[0], b = p[1] with no statistics; noroll is
// wrong on purpose, as its reference is: every tap of a row is
// relu(acc1 * a1 + b1) of that row itself, unshifted and unmasked.
//
// What bounds it on this card: one block is 2*M*Cm*(2*Cin + 9*Cm) FLOP,
// 55.9 GFLOP at each ResNet-50 stage at batch 128 (stage 2: Cin 512, Cm
// 128 at 28x28; 3: 1024/256 at 14x14; 4: 2048/512 at 7x7). The hand-ideal
// traffic is x in and y out (with the weights): in bfloat16 2*M*Cin*2
// bytes, 205.5 MB at stage 2 (0.061 ms at 3.35 TB/s) against 0.057 ms of
// tensor-core operations at 989 TFLOP/s; in float32 the 67 TFLOP/s of the
// FMA units bound it (0.83 ms). This design runs every product on the
// FMA units in float32 (the bfloat16 values are widened as they are
// staged) and moves more than the ideal: it writes and reads back the
// three float32 accumulators. At stage 2 in bfloat16 that is x read twice
// (205.5 MB), acc1 and acc2 written once and read at least once (4 x 51.4
// MB), acc3 written and read (2 x 205.5 MB) and y written (102.8 MB):
// about 925 MB, 4.5x the ideal 205.5 MB. So it is bound by its FMA
// operations, far above either bound; it is the simple version that is
// right first.
//
// Design. The TPU kernel holds a whole ghost group in VMEM (acc1 of a
// stage-2 group at tile 2 is 1568 x 128 float32, 802 KB); a Hopper block
// has 227 KB of shared memory. So one C call enqueues a fixed sequence of
// seven kernels on the caller's stream:
//   1. gemm_kernel<kX>: acc1 = x @ w1 and per-row-tile partial sums;
//   2. coef_kernel: (a1, b1) of each group from its tiles' partials;
//   3. gemm_kernel<kTaps> (implicit GEMM, each tap gathered from acc1 as
//      the operand tile is staged, BN1's affine and ReLU applied before
//      the edge mask), or window_kernel for strided: acc2 and partials;
//   4. coef_kernel: (a2, b2);
//   5. gemm_kernel<kAct>: acc3 = relu(acc2 * a2 + b2) @ w2, partials;
//   6. coef_kernel: (a3, b3);
//   7. residual_kernel: y = relu(acc3 * a3 + b3 + x), cast.
// (nobn launches 1, 3, 5 and 7 only, with p as the coefficients.) The
// GEMMs are the register-tiled SIMT GEMM of csrc/fused_conv.cu: 256
// threads own a 128-row x 128-column tile (8x8 outputs a thread), the
// reduction runs in double-buffered shared stages of 8. Their row tiles
// are aligned to the ghost groups: the grid runs over group x row tile
// in the group x column tile, and rows past the group's end are masked,
// so every tile's partial sums belong to one group (G is 49 rows at
// stage 4 with tile 1; a tile of 128 rows then computes 49). Partials
// are summed in a fixed order, with no atomics: a rerun is bitwise
// equal. Offsets of row x channel products are 64-bit. The workspace
// (the accumulators, partials and coefficients) is allocated by the
// caller; the kernels allocate nothing.
//
// strided: the reference builds each dy-trio of taps with one strided
// roll in place of three shifts. Hopper has no such roll; its form of
// "one shifted window in place of three shifts" is window_kernel: for
// each dy and each stage of 8 channels it stages the activated rows
// r-1 .. r+128 of the shifted base row r + dy*W once in shared memory
// and reads the three dx taps from that window at offsets 0, 1, 2,
// masked per row as it reads them; full gathers each tap on its own.
//
// The faster design is a later PR's: a thread-block cluster per ghost
// group, acc1 spread over the cluster's shared memory with the +-W halo
// read through distributed shared memory, wgmma on bfloat16 operands,
// and the statistics reduced across the cluster, so that only x and y
// touch device memory.
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the current CUDA stream through ctypes and checks the
// returned cudaError_t (cudaGetLastError after every launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;         // output rows a block
constexpr int kBN = 128;         // output columns a block
constexpr int kBK = 8;           // reduction depth a stage
constexpr int kTM = 8;           // output rows a thread
constexpr int kTN = 8;           // output columns a thread
constexpr int kThreadCols = 16;  // thread grid: 16 row groups x 16 columns
constexpr int kRowGroups = kThreads / kThreadCols;
constexpr int kWin = kBM + 4;    // window rows (kBM + 2, padded)

// what the A operand of a GEMM is
constexpr int kX = 0;     // x itself
constexpr int kTaps = 1;  // the 3x3's taps of relu(acc1 * a + b)
constexpr int kAct = 2;   // relu(acc2 * a + b)

// the variants, in the wrapper's order
constexpr int kFull = 0, kStrided = 1, kNoBn = 2, kNoRoll = 3;

inline int cdiv(long long a, int b) { return static_cast<int>((a + b - 1) / b); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T and widened back
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// The rows of one ghost-group-aligned row tile.
struct Rows {
  int M;    // rows in all
  int G;    // rows a ghost group
  int tpg;  // row tiles a group
  int H, W;
};

// The A operand (row m, reduction index kk) of a GEMM. ab points at the
// row's group's coefficients [2, C] (a, then b). Rows that are not valid
// and kk at or past Kp read 0.
template <class T, int kA, bool kShift>
__device__ __forceinline__ float a_elem(const T* __restrict__ x,
                                        const float* __restrict__ act,
                                        const float* __restrict__ ab, int C,
                                        int Kp, int H, int W, bool row_ok,
                                        int m, int hrow, int wrow, int kk) {
  if (!row_ok || kk >= Kp) return 0.f;
  if (kA == kX) return to_f(x[static_cast<int64_t>(m) * C + kk]);
  int c = kk;
  int64_t src = m;
  if (kA == kTaps) {
    const int t = kk / C;
    c = kk - t * C;
    if (kShift) {
      const int dy = t / 3 - 1, dx = t % 3 - 1;
      const int hh = hrow + dy, ww = wrow + dx;
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) return 0.f;
      src += dy * W + dx;
    }
  }
  return round_to<T>(fmaxf(act[src * C + c] * ab[c] + ab[C + c], 0.f));
}

// Write this thread's outputs of the tile (valid rows only) and, when
// partial is set, the tile's column sums and sums of squares: each
// thread's 8 rows in order, then the 16 row groups in order.
__device__ __forceinline__ void store_tile(const float (&acc)[kTM][kTN],
                                           float* __restrict__ out,
                                           float* __restrict__ partial,
                                           float* red, int row0,
                                           int rows_valid, int col0, int N) {
  const int tid = threadIdx.x;
  const int ty = tid / kThreadCols, tx = tid % kThreadCols;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty * kTM + i;
    if (r >= rows_valid) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = col0 + tx * kTN + j;
      if (n < N) out[static_cast<int64_t>(row0 + r) * N + n] = acc[i][j];
    }
  }
  if (partial == nullptr) return;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (ty * kTM + i < rows_valid) {
        s1 += acc[i][j];
        s2 += acc[i][j] * acc[i][j];
      }
    }
    red[(0 * kRowGroups + ty) * kBN + tx * kTN + j] = s1;
    red[(1 * kRowGroups + ty) * kBN + tx * kTN + j] = s2;
  }
  __syncthreads();
  for (int e = tid; e < 2 * kBN; e += kThreads) {
    const int s = e / kBN, c = e % kBN;
    if (col0 + c >= N) continue;
    float sum = 0.f;
    for (int g = 0; g < kRowGroups; ++g) sum += red[(s * kRowGroups + g) * kBN + c];
    partial[(static_cast<int64_t>(blockIdx.x) * 2 + s) * N + col0 + c] = sum;
  }
}

// out [M, N] = A @ w [Kp, N] for one 128 x 128 tile; blockIdx.x = group *
// tpg + row tile in the group, blockIdx.y = column tile.
template <class T, int kA, bool kShift>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const T* __restrict__ x, const float* __restrict__ act,
            const float* __restrict__ coef, int coef_stride,
            const T* __restrict__ w, float* __restrict__ out,
            float* __restrict__ partial, Rows rows, int Kp, int N, int C) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  __shared__ __align__(16) float red[2 * kRowGroups * kBN];

  const int tid = threadIdx.x;
  const int ty = tid / kThreadCols, tx = tid % kThreadCols;
  const int group = blockIdx.x / rows.tpg;
  const int first = (blockIdx.x % rows.tpg) * kBM;  // in the group
  const int row0 = group * rows.G + first;
  const int rows_valid = min(kBM, rows.G - first);
  const int col0 = blockIdx.y * kBN;
  const float* ab = coef + static_cast<int64_t>(group) * coef_stride;

  // this thread's A loads: row a_r of the tile, reduction offsets a_k..+3
  const int a_r = tid / 2, a_k = (tid % 2) * 4;
  const bool a_ok = a_r < rows_valid;
  const int a_m = row0 + a_r;
  const int hw = rows.H * rows.W;
  const int hrow = (a_m % hw) / rows.W, wrow = a_m % rows.W;
  const int nk = (Kp + kBK - 1) / kBK;
  constexpr int kLoadsB = kBK * kBN / kThreads;

  float ra[4], rb[kLoadsB];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ra[i] = a_elem<T, kA, kShift>(x, act, ab, C, Kp, rows.H, rows.W, a_ok,
                                    a_m, hrow, wrow, kt * kBK + a_k + i);
#pragma unroll
    for (int i = 0; i < kLoadsB; ++i) {
      const int idx = tid + i * kThreads;
      const int k = kt * kBK + idx / kBN, n = col0 + idx % kBN;
      rb[i] = (k < Kp && n < N) ? to_f(w[static_cast<int64_t>(k) * N + n])
                                : 0.f;
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

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch(kt + 1);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float af[kTM], bf[kTN];
#pragma unroll
      for (int i = 0; i < kTM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[cur][k][ty * kTM + i]);
        af[i] = v.x; af[i + 1] = v.y; af[i + 2] = v.z; af[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kTN; j += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[cur][k][tx * kTN + j]);
        bf[j] = v.x; bf[j + 1] = v.y; bf[j + 2] = v.z; bf[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += af[i] * bf[j];
    }
    if (kt + 1 < nk) stage(cur ^ 1);
    __syncthreads();
  }
  store_tile(acc, out, partial, red, row0, rows_valid, col0, N);
}

// The strided variant's 3x3: acc2 [M, N] = taps(relu(act * a + b)) @ w3
// [9C, N], one 128 x 128 tile. The reduction runs over (dy, stage of 8
// channels); each stage holds the activated window of rows r0-1+dy*W ..
// r0+128+dy*W (r0 the tile's first row) and the three dx slices of w3.
template <class T>
__global__ void __launch_bounds__(kThreads, 2)
window_kernel(const float* __restrict__ act, const float* __restrict__ coef,
              int coef_stride, const T* __restrict__ w,
              float* __restrict__ out, float* __restrict__ partial,
              Rows rows, int N, int C) {
  constexpr int kWinLoads = (kBK * (kBM + 2) + kThreads - 1) / kThreads;
  constexpr int kLoadsB = 3 * kBK * kBN / kThreads;
  constexpr int kWinSize = kBK * kWin;          // a buffer's window
  constexpr int kBSize = 3 * kBK * kBN;         // a buffer's w3 slices
  // two buffers of (window, w3 slices); the statistics reuse it
  __shared__ __align__(16) float smem[2 * (kWinSize + kBSize)];

  const int tid = threadIdx.x;
  const int ty = tid / kThreadCols, tx = tid % kThreadCols;
  const int group = blockIdx.x / rows.tpg;
  const int first = (blockIdx.x % rows.tpg) * kBM;
  const int row0 = group * rows.G + first;
  const int rows_valid = min(kBM, rows.G - first);
  const int col0 = blockIdx.y * kBN;
  const float* ab = coef + static_cast<int64_t>(group) * coef_stride;
  const int hw = rows.H * rows.W;
  const int chunks = (C + kBK - 1) / kBK;
  const int ns = 3 * chunks;  // stages: dy-major, then channel chunk

  float rw[kWinLoads], rb[kLoadsB];
  auto fetch = [&](int s) {
    const int dy = s / chunks - 1, c0 = (s % chunks) * kBK;
#pragma unroll
    for (int i = 0; i < kWinLoads; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / kBK, c = c0 + e % kBK;
      const int64_t src = static_cast<int64_t>(row0) + j - 1 + dy * rows.W;
      float v = 0.f;
      if (j < kBM + 2 && c < C && src >= 0 && src < rows.M)
        v = round_to<T>(fmaxf(act[src * C + c] * ab[c] + ab[C + c], 0.f));
      rw[i] = v;
    }
#pragma unroll
    for (int i = 0; i < kLoadsB; ++i) {
      const int idx = tid + i * kThreads;
      const int dx = idx / (kBK * kBN), k = (idx / kBN) % kBK;
      const int c = c0 + k, n = col0 + idx % kBN;
      rb[i] = (c < C && n < N)
                  ? to_f(w[(static_cast<int64_t>((dy + 1) * 3 + dx) * C + c) * N + n])
                  : 0.f;
    }
  };
  auto stage = [&](int buf) {
    float* win = smem + buf * (kWinSize + kBSize);
#pragma unroll
    for (int i = 0; i < kWinLoads; ++i) {
      const int e = tid + i * kThreads;
      if (e < kBK * (kBM + 2)) win[(e % kBK) * kWin + e / kBK] = rw[i];
    }
#pragma unroll
    for (int i = 0; i < kLoadsB; ++i) win[kWinSize + tid + i * kThreads] = rb[i];
  };
  // bit i*3 + dx: row i of this thread reads its (dy, dx-1) tap
  auto taps_ok = [&](int s) {
    const int dy = s / chunks - 1;
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty * kTM + i;
      const int p = (row0 + r) % hw;
      const int hh = p / rows.W + dy, ww = p % rows.W;
      if (r >= rows_valid || hh < 0 || hh >= rows.H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        if (ww + dx - 1 >= 0 && ww + dx - 1 < rows.W) bits |= 1u << (i * 3 + dx);
    }
    return bits;
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage(0);
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    const int cur = s & 1;
    const unsigned ok = taps_ok(s);
    if (s + 1 < ns) fetch(s + 1);
    const float* win = smem + cur * (kWinSize + kBSize);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float af[kTM], bf[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          af[i] = (ok >> (i * 3 + dx)) & 1u
                      ? win[k * kWin + ty * kTM + i + dx] : 0.f;
#pragma unroll
        for (int j = 0; j < kTN; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              &win[kWinSize + (dx * kBK + k) * kBN + tx * kTN + j]);
          bf[j] = v.x; bf[j + 1] = v.y; bf[j + 2] = v.z; bf[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] += af[i] * bf[j];
      }
    }
    if (s + 1 < ns) stage(cur ^ 1);
    __syncthreads();
  }
  store_tile(acc, out, partial, smem, row0, rows_valid, col0, N);
}

// coef [groups, 2, N] (a, b) of each group from the partial sums of its
// row tiles, summed in tile order; p [2, N] is (gamma, beta).
__global__ void __launch_bounds__(kBN)
coef_kernel(const float* __restrict__ partial, const float* __restrict__ p,
            float* __restrict__ coef, int N, int tpg, int rows, float eps) {
  const int g = blockIdx.y;
  const int c = blockIdx.x * kBN + threadIdx.x;
  if (c >= N) return;
  // this group's row tiles and rows
  const int first = g * tpg, count = tpg, n_rows = rows;
  float s1 = 0.f, s2 = 0.f;
  for (int t = first; t < first + count; ++t) {
    s1 += partial[(static_cast<int64_t>(t) * 2) * N + c];
    s2 += partial[(static_cast<int64_t>(t) * 2 + 1) * N + c];
  }
  const float mean = s1 / n_rows;
  const float var = s2 / n_rows - mean * mean;
  const float a = p[c] * (1.f / sqrtf(var + eps));
  coef[(static_cast<int64_t>(g) * 2) * N + c] = a;
  coef[(static_cast<int64_t>(g) * 2 + 1) * N + c] = p[N + c] - mean * a;
}

// y = relu(acc3 * a + b + x) in T, over all M x N elements.
template <class T>
__global__ void __launch_bounds__(kThreads)
residual_kernel(const float* __restrict__ acc3, const float* __restrict__ coef,
                int coef_stride, const T* __restrict__ x, T* __restrict__ y,
                int64_t total, int N, int G) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t m = e / N;
    const int c = static_cast<int>(e - m * N);
    const float* ab = coef + (m / G) * coef_stride;
    const float v = acc3[e] * ab[c] + ab[N + c] + to_f(x[e]);
    y[e] = from_f<T>(fmaxf(v, 0.f));
  }
}

// The workspace, in floats: acc1, acc2 [M, Cm], acc3 [M, Cin], the
// partials [groups * tpg, 2, max(Cm, Cin)], the coefficients of the three
// BNs [groups, 2, Cm | Cm | Cin].
struct Workspace {
  float *acc1, *acc2, *acc3, *partial, *coef1, *coef2, *coef3;
  long long floats;
  Workspace(float* base, int n, int hw, int cin, int cm, int tile) {
    const long long m = static_cast<long long>(n) * hw;
    const long long groups = n / tile;
    const long long tiles = groups * cdiv(static_cast<long long>(tile) * hw, kBM);
    const long long sizes[7] = {m * cm, m * cm, m * cin,
                                tiles * 2 * (cm > cin ? cm : cin),
                                groups * 2 * cm, groups * 2 * cm,
                                groups * 2 * cin};
    float** parts[7] = {&acc1, &acc2, &acc3, &partial, &coef1, &coef2, &coef3};
    floats = 0;
    for (int i = 0; i < 7; ++i) {
      *parts[i] = base == nullptr ? nullptr : base + floats;
      floats += sizes[i];
    }
  }
};

template <class T>
int run(const T* x, const T* w1, const T* w3, const T* w2, const float* p1,
        const float* p2, const float* p3, T* y, float* base, int n, int h_img,
        int w_img, int cin, int cm, int tile, float eps, int variant,
        cudaStream_t s) {
  if (variant < kFull || variant > kNoRoll) return cudaErrorInvalidValue;
  const int hw = h_img * w_img;
  Workspace ws(base, n, hw, cin, cm, tile);
  const int groups = n / tile;
  Rows rows{n * hw, tile * hw, cdiv(static_cast<long long>(tile) * hw, kBM),
            h_img, w_img};
  const bool stats = variant != kNoBn;
  float* partial = stats ? ws.partial : nullptr;
  cudaError_t err;
  // (a, b) of one BN: from the partials, or p itself with no statistics
  auto coefs = [&](const float* p, float* coef, int c, const float** out,
                   int* stride) {
    if (!stats) {
      *out = p;
      *stride = 0;
      return cudaSuccess;
    }
    const dim3 grid(cdiv(c, kBN), groups);
    coef_kernel<<<grid, kBN, 0, s>>>(ws.partial, p, coef, c, rows.tpg,
                                     rows.G, eps);
    *out = coef;
    *stride = 2 * c;
    return cudaGetLastError();
  };
  const float *c1, *c2, *c3;
  int s1, s2, s3;
  const int tiles = groups * rows.tpg;

  const dim3 grid_cm(tiles, cdiv(cm, kBN)), grid_cin(tiles, cdiv(cin, kBN));
  gemm_kernel<T, kX, true><<<grid_cm, kThreads, 0, s>>>(
      x, nullptr, nullptr, 0, w1, ws.acc1, partial, rows, cin, cm, cin);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = coefs(p1, ws.coef1, cm, &c1, &s1)) != cudaSuccess) return err;

  if (variant == kStrided)
    window_kernel<T><<<grid_cm, kThreads, 0, s>>>(ws.acc1, c1, s1, w3,
                                                  ws.acc2, partial, rows, cm,
                                                  cm);
  else if (variant == kNoRoll)
    gemm_kernel<T, kTaps, false><<<grid_cm, kThreads, 0, s>>>(
        nullptr, ws.acc1, c1, s1, w3, ws.acc2, partial, rows, 9 * cm, cm, cm);
  else
    gemm_kernel<T, kTaps, true><<<grid_cm, kThreads, 0, s>>>(
        nullptr, ws.acc1, c1, s1, w3, ws.acc2, partial, rows, 9 * cm, cm, cm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = coefs(p2, ws.coef2, cm, &c2, &s2)) != cudaSuccess) return err;

  gemm_kernel<T, kAct, true><<<grid_cin, kThreads, 0, s>>>(
      nullptr, ws.acc2, c2, s2, w2, ws.acc3, partial, rows, cm, cin, cm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = coefs(p3, ws.coef3, cin, &c3, &s3)) != cudaSuccess) return err;

  const long long total = static_cast<long long>(n) * hw * cin;
  const int blocks = static_cast<int>(
      total / kThreads + 1 < 132 * 16 ? total / kThreads + 1 : 132 * 16);
  residual_kernel<T><<<blocks, kThreads, 0, s>>>(ws.acc3, c3, s3, x, y, total,
                                                 cin, rows.G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* block_megakernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of the workspace one call needs (the wrapper allocates it).
long long block_megakernel_workspace(int n, int hw, int cin, int cm,
                                     int tile) {
  return Workspace(nullptr, n, hw, cin, cm, tile).floats;
}

// One block: x, y [n, h_img*w_img, cin]; w1 [cin, cm]; w3 [9, cm, cm]
// tap-major; w2 [cm, cin]; p1, p2 [2, cm] and p3 [2, cin] float32 (gamma,
// beta); workspace of block_megakernel_workspace floats; n a multiple of
// tile; variant 0 full, 1 strided, 2 nobn, 3 noroll. Returns a
// cudaError_t.
int block_megakernel_f32(const float* x, const float* w1, const float* w3,
                         const float* w2, const float* p1, const float* p2,
                         const float* p3, float* y, float* workspace, int n,
                         int h_img, int w_img, int cin, int cm, int tile,
                         float eps, int variant, void* stream) {
  return run<float>(x, w1, w3, w2, p1, p2, p3, y, workspace, n, h_img, w_img,
                    cin, cm, tile, eps, variant,
                    static_cast<cudaStream_t>(stream));
}

// The same with x, the weights and y in bfloat16.
int block_megakernel_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                          const __nv_bfloat16* w3, const __nv_bfloat16* w2,
                          const float* p1, const float* p2, const float* p3,
                          __nv_bfloat16* y, float* workspace, int n,
                          int h_img, int w_img, int cin, int cm, int tile,
                          float eps, int variant, void* stream) {
  return run<__nv_bfloat16>(x, w1, w3, w2, p1, p2, p3, y, workspace, n, h_img,
                            w_img, cin, cm, tile, eps, variant,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
