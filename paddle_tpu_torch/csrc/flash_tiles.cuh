// Tiles of the flash-attention kernels on the tensor cores (3xTF32 in
// float32, one pass in bfloat16): the packed operand planes in device
// memory, the kernels that pack them, and the copies and stores that put
// them into the 128-byte-swizzled shared tiles wgmma reads
// (csrc/sm90_mma.cuh states that layout). The bf16 part is at the end.
//
// wgmma takes a TF32 B operand only K-major (the reduction index
// contiguous), and 3xTF32 needs each operand as hi = tf32(v) and lo =
// tf32(v - hi). A pack kernel writes both planes, padded with zeros to
// whole tiles, in one of two layouts of a [BH][S][D] float32 tensor:
//   rows: [plane][BH][D' / 32][Sp][32]: the d chunks of 32 of each row s
//     (D' = D, or 32 for D = 16): B of a product reducing over d (Q.K^T:
//     K; K.Q^T: Q; V.dO^T: dO).
//   cols: [plane][BH][Sp / 32][D][32]: 32 rows s for each d: B of a
//     product reducing over s (P.V: V^T; P^T.dO: dO^T; dS^T.Q: Q^T).
//     Within each group of 8 rows, position u holds row perm8(u), so that
//     the accumulator of the product before, read in place as the A
//     fragment, lines up (see perm8).
// Sp is S rounded up to kPadRows; rows past S and d past D are zeros.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90_mma.cuh"

namespace flash {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kPadRows = 64;       // planes pad S to whole 64-row tiles
constexpr int kPackThreads = 256;
// Multiplies (3 a k-step) a float32 accumulator of the tensor cores may
// take before its sum is added into registers with a rounding add (their
// float32 sums truncate); the source test's model of the truncation pins
// it. Every product of the flash kernels stays under it.
constexpr int kPromoteAfter = 96;

__host__ __device__ constexpr int dpad(int d) { return d < 32 ? 32 : d; }
__host__ __device__ inline long long pad_rows(int s) {
  return (s + kPadRows - 1) / kPadRows * static_cast<long long>(kPadRows);
}
__host__ __device__ inline int cdiv(long long a, int b) {
  return static_cast<int>((a + b - 1) / b);
}

// Dynamic shared memory a block of this device may opt in to.
inline int max_dynamic_smem() {
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

// Elements of one plane of each layout.
inline long long rows_plane(int bh, int s, int d) {
  return static_cast<long long>(bh) * (dpad(d) / 32) * pad_rows(s) * 32;
}
inline long long cols_plane(int bh, int s, int d) {
  return static_cast<long long>(bh) * pad_rows(s) * d;
}

// The row of a group of 8 that K position u of a TF32 A fragment reads
// when that fragment is taken from the accumulator of the product before:
// a thread's accumulator holds columns 2t and 2t + 1 of each group of 8,
// and its A fragment words t and t + 4 (sm90_mma.cuh), so A column u < 4
// is row 2u and u >= 4 is row 2(u - 4) + 1. A sum over the group is the
// same in any order.
__host__ __device__ constexpr int perm8(int u) {
  return u < 4 ? 2 * u : 2 * (u - 4) + 1;
}

__device__ __forceinline__ float word_f32(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// v as TF32 hi and lo: hi = tf32(v), lo = tf32(v - hi)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = sm90::tf32_rna(v);
  lo = sm90::tf32_rna(v - word_f32(hi));
}

// Byte offset of 16-byte chunk q of row n in a 128-byte-swizzled tile.
__device__ __forceinline__ int swz(int n, int q) {
  return n * 128 + ((q ^ (n & 7)) << 4);
}

// src [bh][s][d] -> the rows layout (both planes).
__global__ void __launch_bounds__(kPackThreads)
pack_rows_kernel(const float* __restrict__ src, uint32_t* __restrict__ dst,
                 int bh, int s, int d) {
  const int dc = dpad(d) / 32;
  const long long sp = pad_rows(s);
  const long long plane = static_cast<long long>(bh) * dc * sp * 32;
  for (long long i = blockIdx.x * static_cast<long long>(kPackThreads) +
                     threadIdx.x;
       i < plane; i += static_cast<long long>(gridDim.x) * kPackThreads) {
    const int col = static_cast<int>(i % 32);
    const long long r = (i / 32) % sp;
    const long long c = (i / (32 * sp)) % dc;
    const long long b = i / (32 * sp * dc);
    const int e = static_cast<int>(c) * 32 + col;
    const float v = r < s && e < d ? src[(b * s + r) * d + e] : 0.f;
    uint32_t hi, lo;
    split(v, hi, lo);
    dst[i] = hi;
    dst[plane + i] = lo;
  }
}

// src [bh][s][d] -> the cols layout (both planes), rows permuted within
// each group of 8 by perm8. A block transposes a 32-row x 32-column tile
// through shared memory: reads and writes both run along rows.
__global__ void __launch_bounds__(kPackThreads)
pack_cols_kernel(const float* __restrict__ src, uint32_t* __restrict__ dst,
                 int s, int d, long long plane) {
  __shared__ float tile[32][33];
  const long long sp = pad_rows(s);
  const int r0 = blockIdx.x * 32, d0 = blockIdx.y * 32, b = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += kPackThreads / 32) {
    const int row = r0 + r, e = d0 + tx;
    tile[r][tx] = row < s && e < d ? src[(static_cast<long long>(b) * s +
                                          row) * d + e]
                                   : 0.f;
  }
  __syncthreads();
  for (int c = ty; c < 32; c += kPackThreads / 32) {  // packed row d0 + c
    if (d0 + c >= d) continue;
    const int u = tx;
    const float v = tile[(u & ~7) + perm8(u & 7)][c];
    const long long i =
        ((static_cast<long long>(b) * (sp / 32) + r0 / 32) * d + d0 + c) * 32 +
        u;
    uint32_t hi, lo;
    split(v, hi, lo);
    dst[i] = hi;
    dst[plane + i] = lo;
  }
}

inline cudaError_t pack_rows(const float* src, uint32_t* dst, int bh, int s,
                             int d, cudaStream_t stream) {
  const long long n = rows_plane(bh, s, d);
  const long long want = (n + kPackThreads - 1) / kPackThreads;
  const dim3 grid(static_cast<unsigned>(want < 4096 ? want : 4096));
  pack_rows_kernel<<<grid, kPackThreads, 0, stream>>>(src, dst, bh, s, d);
  return cudaGetLastError();
}

inline cudaError_t pack_cols(const float* src, uint32_t* dst, int bh, int s,
                             int d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(pad_rows(s) / 32), cdiv(d, 32), bh);
  pack_cols_kernel<<<grid, kPackThreads, 0, stream>>>(src, dst, s, d,
                                                      cols_plane(bh, s, d));
  return cudaGetLastError();
}

// Copies, by the calling block's `threads` threads, `rows` rows of 128
// bytes from src (rows 32 uint32 apart) into the swizzled tile at dst,
// for both planes (the lo plane `plane` elements on in device memory,
// `tile_bytes` on in shared memory).
__device__ __forceinline__ void copy_tile(unsigned char* dst,
                                          const uint32_t* src, int rows,
                                          long long plane, int tile_bytes,
                                          int threads) {
  for (int i = threadIdx.x; i < rows * 8; i += threads) {
    const int n = i / 8, q = i % 8;
    const uint32_t* s = src + n * 32 + q * 4;
    const int off = swz(n, q);
    sm90::cp_async16(dst + off, s, 16);
    sm90::cp_async16(dst + tile_bytes + off, s + plane, 16);
  }
}

// Stores value v of row r, column e of a [rows][d'] operand into the
// swizzled hi and lo planes at dst (chunks of 32 columns, each `rows`
// rows of 128 bytes; the lo plane `plane_bytes` on).
__device__ __forceinline__ void store_split(unsigned char* dst, int rows,
                                            int plane_bytes, int r, int e,
                                            float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  const int off = (e / 32) * rows * 128 + swz(r, (e % 32) / 4) + (e % 4) * 4;
  *reinterpret_cast<uint32_t*>(dst + off) = hi;
  *reinterpret_cast<uint32_t*>(dst + plane_bytes + off) = lo;
}

// -- bfloat16 ----------------------------------------------------------------
// The bf16 kernels split nothing: a B tile is one plane of bf16, 64 values
// (128 bytes) a swizzled row and 16 values (32 bytes) a k-step. The B of a
// product that reduces over d (Q.K^T: K; dO.V^T: V; K.Q^T: Q; V.dO^T: dO)
// is read straight from the [BH][S][D] input by cp.async (copy_rows_bf16:
// the pieces past S or D zero-filled); the B of one that reduces over s
// (P.V: V^T; dS.K: K^T; P^T.dO: dO^T; dS^T.Q: Q^T) from a cols plane
// [BH][Sp / 64][D][64] that pack_cols_bf16 writes ahead (rows past S
// zeros). A bf16 product's accumulator is the next product's A fragment
// as it lies: its columns 16j + 2t, 16j + 2t + 1 and 16j + 8 + 2t,
// 16j + 9 + 2t are words t and t + 4 of k-step j, so no pack permutes.

// src [bh][s][d] bf16 -> the bf16 cols plane. A block transposes a
// 64-row x 32-column tile through shared memory.
__global__ void __launch_bounds__(kPackThreads)
pack_cols_bf16_kernel(const uint16_t* __restrict__ src,
                      uint16_t* __restrict__ dst, int s, int d) {
  __shared__ uint16_t tile[64][34];
  const long long sp = pad_rows(s);
  const int r0 = blockIdx.x * 64, d0 = blockIdx.y * 32, b = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 64; r += kPackThreads / 32) {
    const int row = r0 + r, e = d0 + tx;
    tile[r][tx] = row < s && e < d
                      ? src[(static_cast<long long>(b) * s + row) * d + e]
                      : static_cast<uint16_t>(0);
  }
  __syncthreads();
  for (int c = ty; c < 32; c += kPackThreads / 32) {  // packed row d0 + c
    if (d0 + c >= d) continue;
    const long long at =
        ((static_cast<long long>(b) * (sp / 64) + r0 / 64) * d + d0 + c) *
            64 + 2 * tx;
    *reinterpret_cast<uint32_t*>(dst + at) =
        static_cast<uint32_t>(tile[2 * tx][c]) |
        (static_cast<uint32_t>(tile[2 * tx + 1][c]) << 16);
  }
}

inline cudaError_t pack_cols_bf16(const uint16_t* src, uint16_t* dst, int bh,
                                  int s, int d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(pad_rows(s) / 64), cdiv(d, 32), bh);
  pack_cols_bf16_kernel<<<grid, kPackThreads, 0, stream>>>(src, dst, s, d);
  return cudaGetLastError();
}

// d chunks of 64 values a bf16 rows tile holds (D 16 and 32 are padded to
// one chunk with zeros)
__host__ __device__ constexpr int dchunks_bf16(int d) {
  return d <= 64 ? 1 : d / 64;
}

// Copies, by the calling block's `threads` threads, rows n0 .. n0 + rows - 1
// of the bf16 [s][d] matrix at src into the swizzled tiles at dst, chunk c
// (values 64c .. 64c + 63 of each row) rows * 128 bytes on; rows past s and
// values past d are zero-filled.
__device__ __forceinline__ void copy_rows_bf16(unsigned char* dst,
                                               const uint16_t* src, int n0,
                                               int rows, int s, int d,
                                               int threads) {
  const int per_row = dchunks_bf16(d) * 8;
  for (int i = threadIdx.x; i < rows * per_row; i += threads) {
    const int n = i / per_row, c = (i % per_row) / 8, q = i % 8;
    const int e = c * 64 + q * 8;
    const bool in = n0 + n < s && e < d;
    sm90::cp_async16(dst + c * rows * 128 + swz(n, q),
                     in ? src + static_cast<long long>(n0 + n) * d + e : src,
                     in ? 16 : 0);
  }
}

// Copies `rows` rows of 128 bytes from src (rows 64 bf16 apart) into the
// swizzled tile at dst.
__device__ __forceinline__ void copy_plane_bf16(unsigned char* dst,
                                                const uint16_t* src,
                                                int rows, int threads) {
  for (int i = threadIdx.x; i < rows * 8; i += threads) {
    const int n = i / 8, q = i % 8;
    sm90::cp_async16(dst + swz(n, q), src + n * 64 + q * 8, 16);
  }
}

// The A fragment of one bf16 k-step (16 columns) from a 64 x N float32
// accumulator, columns 16j .. 16j + 15, rounded to nearest-even bf16.
__device__ __forceinline__ void acc_fragment_bf16(const float* acc, int j,
                                                  uint32_t (&a)[4]) {
  a[0] = sm90::bf16x2_rn(acc[8 * j], acc[8 * j + 1]);
  a[1] = sm90::bf16x2_rn(acc[8 * j + 2], acc[8 * j + 3]);
  a[2] = sm90::bf16x2_rn(acc[8 * j + 4], acc[8 * j + 5]);
  a[3] = sm90::bf16x2_rn(acc[8 * j + 6], acc[8 * j + 7]);
}

// The A fragment of bf16 k-step `s` of rows r0 and r0 + 8 of a row-major
// bf16 matrix m whose rows are `pitch` 32-bit words apart.
__device__ __forceinline__ void row_fragment_bf16(const uint32_t* m, int pitch,
                                                  int r0, int s, int t,
                                                  uint32_t (&a)[4]) {
  a[0] = m[r0 * pitch + 8 * s + t];
  a[1] = m[(r0 + 8) * pitch + 8 * s + t];
  a[2] = m[r0 * pitch + 8 * s + t + 4];
  a[3] = m[(r0 + 8) * pitch + 8 * s + t + 4];
}

}  // namespace flash
