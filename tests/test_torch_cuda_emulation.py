"""A host emulation of the CUDA subset the port's tensor-core kernels use.

The CUDA sources under paddle_tpu_torch/csrc/ compile only for a card,
but their logic is plain C++ over a small CUDA subset plus the PTX
helpers of csrc/sm90_mma.cuh. ``compile_cuda`` compiles a source with
the host C++ compiler against:

  * ``cuda_runtime.h`` (EMULATION): one block at a time, one std::thread
    per CUDA thread (one team for all the blocks of a launch),
    std::barrier for __syncthreads, __shared__ as a
    static shared by the block's threads, and the launch syntax
    ``k<<<grid, threads, smem, stream>>>(...)`` rewritten to
    ``emu_launch(k, grid, threads, ...)`` (keep grids as named dim3
    variables: the rewrite splits on commas);
  * ``sm90_mma.cuh`` (SM90_EMULATION): the same functions with the same
    fragment and shared-memory semantics that header's comment states.
    Copies are synchronous; a warpgroup multiply runs when its thread
    waits on it (wgmma_wait0), with the A fragment held at issue: the 128
    threads' fragments of every multiply waited on together meet in a
    shared scratch behind one block barrier (every thread of the kernels
    issues every multiply), or A is read, like B, from the
    128-byte-swizzled tile by the swizzle's address rule; a shuffle
    exchanges through shared memory. The multiply adds each k-step's
    products (exact in double: TF32 and bf16 products fit) into its
    float32 accumulator rounding toward zero, as the tensor cores'
    float32 sums truncate, so a kernel that does not promote a long
    reduction shows the error it has on the card.

The test files of the fused convs and of flash attention import it;
``truncating_3xtf32`` is the same truncation as a numpy model, which pins
each kernel's promotion threshold. ``compile_grid_cuda`` does the same
for the persistent recurrent kernels (the fused GRU and LSTM source
tests) against GRID_EMULATION, where a cooperative launch runs every
block of its grid at once, and a host version of csrc/grid_sync.cuh's
PTX (GRID_SYNC_PTX, mma.sync m16n8k8 included). It says nothing about
speed or about the device compiler: chip_smoke.py runs the real kernels
on the card.
"""
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

EMULATION = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorInvalidConfiguration = 9;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
constexpr int kEmuSmemBytes = 232448;  // an H100's opt-in maximum
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = kEmuSmemBytes;
  return 0;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes <= kEmuSmemBytes ? 0 : 1;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __expf(float x) { return expf(x); }
// the block's dynamic shared memory (`extern __shared__ T name[];` is
// rewritten to a pointer into it)
alignas(1024) inline unsigned char emu_dyn_smem[kEmuSmemBytes + 1024];
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// one team of `threads` threads runs the blocks in turn; a barrier after
// each block frees its shared state for the next
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, int threads, A... args) {
  std::barrier<> bar(threads);
  emu_barrier = &bar;
  std::vector<std::thread> team;
  for (int t = 0; t < threads; ++t)
    team.emplace_back([&, t] {
      threadIdx = dim3(t);
      blockDim = dim3(threads);
      gridDim = grid;
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            blockIdx = dim3(bx, by, bz);
            kernel(args...);
            bar.arrive_and_wait();
          }
    });
  for (auto& th : team) th.join();
}
"""

SM90_EMULATION = r"""
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>
namespace sm90 {
inline void cp_async16(void* smem, const void* gmem, int src_bytes) {
  std::memcpy(smem, gmem, src_bytes);
  std::memset(static_cast<char*>(smem) + src_bytes, 0, 16 - src_bytes);
}
inline void cp_async_commit() {}
inline void cp_async_wait(int) {}
inline void fence_proxy_async() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> inline void fence_acc(float (&)[N]) {}
inline uint32_t tf32_rna(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x1000u;  // ties away
  return u & 0xffffe000u;
}
inline uint32_t emu_bf16_rn(float f) {  // nearest even, NaN kept
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
inline uint32_t bf16x2_rn(float lo, float hi) {
  return emu_bf16_rn(lo) | (emu_bf16_rn(hi) << 16);
}
inline float emu_shfl[1024];
inline float shfl_xor(float v, int mask) {
  const int me = threadIdx.x;
  emu_shfl[me] = v;
  __syncthreads();
  const float r = emu_shfl[(me & ~31) | ((me & 31) ^ mask)];
  __syncthreads();
  return r;
}
inline unsigned char* dyn_smem() { return emu_dyn_smem; }
inline float emu_word(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// element k (of `size` bytes) of row n of a 128-byte-swizzled K-major tile
inline const void* emu_swizzled(const void* tile, int n, int k, int size) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(tile) + (n / 8) * 1024 +
                         (n % 8) * 128 + k * size;
  return reinterpret_cast<const void*>(addr ^ (((addr >> 7) & 7) << 4));
}
inline float emu_tf32_at(const void* tile, int n, int k) {
  uint32_t w;
  std::memcpy(&w, emu_swizzled(tile, n, k, 4), 4);
  return emu_word(w & 0xffffe000u);  // TF32 reads 19 bits
}
// acc + sum in float32, rounded toward zero: the tensor cores' float32
// accumulation truncates
inline float emu_truncating_add(float acc, double sum) {
  const double exact = static_cast<double>(acc) + sum;
  float f = static_cast<float>(exact);
  if (std::fabs(static_cast<double>(f)) > std::fabs(exact))
    f = std::nextafter(f, 0.f);
  return f;
}
// A multiply as issued: it runs when the thread waits on it (wgmma_wait0),
// with the A fragment the thread held at issue and the accumulators as
// they are then (a kernel leaves both alone in between, as on the card).
// The warpgroup's A fragments of all the multiplies waited on together
// meet in emu_a behind one barrier.
struct EmuOp {
  int n;
  bool bf16, ss;
  uint32_t a[4];
  const void* a_tile;
  const void* b;
  float* d;
  int accumulate;
};
constexpr int kEmuMaxOps = 64;
inline thread_local std::vector<EmuOp> emu_ops;
inline uint32_t emu_a[kEmuMaxOps][2][64][8];
// a descriptor is the tile's host address / 16 (tiles are 16-aligned)
inline uint64_t b_desc(const void* tile) {
  return reinterpret_cast<uintptr_t>(tile) >> 4;
}
inline uint64_t desc_add(uint64_t desc, int bytes) {
  return desc + static_cast<uint64_t>(bytes >> 4);
}
inline const void* emu_tile(uint64_t desc) {
  return reinterpret_cast<const void*>(static_cast<uintptr_t>(desc << 4));
}
template <int N, bool kBf16>
void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], const void* b,
           int accumulate) {
  emu_ops.push_back({N, kBf16, false, {a[0], a[1], a[2], a[3]}, nullptr, b,
                     d, accumulate});
}
template <int N, bool kBf16>
void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
           int accumulate) {
  wgmma<N, kBf16>(d, a, emu_tile(b), accumulate);
}
template <int N>
void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  emu_ops.push_back({N, false, true, {}, emu_tile(a), emu_tile(b), d,
                     accumulate});
}
inline void wgmma_wait0() {
  if (emu_ops.empty()) return;
  if (emu_ops.size() > static_cast<size_t>(kEmuMaxOps)) std::abort();
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  for (size_t i = 0; i < emu_ops.size(); ++i) {
    uint32_t (&A)[64][8] = emu_a[i][wg];
    const uint32_t* a = emu_ops[i].a;
    A[r0][t] = a[0];
    A[r1][t] = a[1];
    A[r0][t + 4] = a[2];
    A[r1][t + 4] = a[3];
  }
  __syncthreads();
  for (size_t i = 0; i < emu_ops.size(); ++i) {
    const EmuOp& op = emu_ops[i];
    const uint32_t (&A)[64][8] = emu_a[i][wg];
    const int K = op.bf16 ? 16 : 8;
    for (int jn = 0; jn < op.n / 8; ++jn)
      for (int q = 0; q < 4; ++q) {
        const int r = q < 2 ? r0 : r1, n = jn * 8 + 2 * t + (q & 1);
        double sum = 0.0;
        for (int k = 0; k < K; ++k) {
          float av, bv;
          if (op.ss) {
            av = emu_tf32_at(op.a_tile, r, k);
          } else if (op.bf16) {
            const uint32_t w = A[r][k / 2];
            av = emu_word(k % 2 ? w & 0xffff0000u : w << 16);
          } else {
            av = emu_word(A[r][k] & 0xffffe000u);  // TF32 reads 19 bits
          }
          if (op.bf16) {
            uint16_t h;
            std::memcpy(&h, emu_swizzled(op.b, n, k, 2), 2);
            bv = emu_word(static_cast<uint32_t>(h) << 16);
          } else {
            bv = emu_tf32_at(op.b, n, k);
          }
          sum += static_cast<double>(av) * bv;
        }
        float& dd = op.d[jn * 4 + q];
        dd = emu_truncating_add(op.accumulate ? dd : 0.f, sum);
      }
  }
  __syncthreads();
  emu_ops.clear();
}
}  // namespace sm90
"""

CSRC = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
# headers of csrc/ that hold no PTX: compiled for the host as they are,
# beside the source (a quoted include looks there first)
PLAIN_HEADERS = ("implicit_gemm.cuh",)

# kernel<<<grid, threads, smem, stream>>>(args), the kernel name possibly
# with template arguments -> emu_launch(kernel, grid, threads, args)
LAUNCH = re.compile(
    r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>\(")
# extern __shared__ T name[]; -> a pointer into the emulated dynamic
# shared memory
DYN_SMEM = re.compile(r"extern\s+__shared__\s+(\w+)\s+(\w+)\[\];")


def _host_text(text):
    text = LAUNCH.sub(r"emu_launch(\1, \2, \3, ", text)
    text = DYN_SMEM.sub(r"\1* const \2 = reinterpret_cast<\1*>(emu_dyn_smem);",
                        text)
    assert "<<<" not in text
    return text


def compile_cuda(out: Path, text: str, stem: str, headers=None) -> Path:
    """The CUDA source `text` compiled for the host against the emulation,
    as out/lib<stem>.so (skips the test where no host compiler exists).
    headers: {file name: text} of the source's own headers, written beside
    it (after the emulation's, so a mutated header wins over nothing);
    the headers of csrc/ without PTX (PLAIN_HEADERS) are written there as
    they are, unless given."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the CUDA source with")
    (out / "cuda_runtime.h").write_text(EMULATION)
    (out / "sm90_mma.cuh").write_text(SM90_EMULATION)
    headers = dict(headers or {})
    for name in PLAIN_HEADERS:
        headers.setdefault(name, (CSRC / name).read_text())
    for name, body in headers.items():
        (out / name).write_text(_host_text(body))
    (out / f"{stem}.cpp").write_text(_host_text(text))
    so = out / f"lib{stem}.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(out), "-o", str(so), str(out / f"{stem}.cpp")],
                   check=True, capture_output=True, timeout=300)
    return so


def mutate(text, edits):
    """text with each (old, new) edit made; each old occurs exactly once."""
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def tf32(v):
    """v (float64 numpy) rounded to TF32, nearest with ties away, as
    cvt.rna.tf32.f32 rounds."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xffffe000).astype(np.uint32).view(
        np.float32).astype(np.float64)


def truncating_3xtf32(x, w, promote_every):
    """x @ w as the kernels compute it on the tensor cores, in float64
    numpy: 3xTF32 k-steps of 8 (lo*hi, hi*lo, hi*hi), each added into a
    float32 accumulator truncated toward zero, as the tensor cores'
    float32 sums are; every promote_every k-steps (0: never) that
    accumulator is added into the result with a rounding float32 add."""
    def trunc32(v):
        f = v.astype(np.float32)
        over = np.abs(f.astype(np.float64)) > np.abs(v)
        f[over] = np.nextafter(f[over], np.float32(0))
        return f.astype(np.float64)

    xh, wh = tf32(x), tf32(w)
    xl, wl = tf32(x - xh), tf32(w - wh)
    acc = np.zeros((x.shape[0], w.shape[1]))
    part = np.zeros_like(acc)
    for s, k0 in enumerate(range(0, x.shape[1], 8)):
        for a, b in ((xl, wh), (xh, wl), (xh, wh)):
            part = trunc32(part + a[:, k0:k0 + 8] @ b[k0:k0 + 8])
        if promote_every and (s + 1) % promote_every == 0:
            acc = (acc + part).astype(np.float32).astype(np.float64)
            part[:] = 0
    return acc + part if not promote_every else acc


_PROBE = r"""
#include <cuda_runtime.h>
#include "sm90_mma.cuh"
// out[64 x 16] = A[64 x 8] B[8 x 16], A from registers (rs) or from its
// swizzled tile (ss); a row-major [64][8], b row-major [16][8] (K-major)
__global__ void probe_kernel(const float* a, const float* b, float* out,
                             int ss) {
  unsigned char* tile = sm90::dyn_smem();
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4,
            t = tid % 4;
  for (int i = tid; i < 64 * 8; i += 128) {  // A tile, then B tile
    const int r = i / 8, k = i % 8;
    std::memcpy(const_cast<void*>(sm90::emu_swizzled(tile, r, k, 4)),
                &a[i], 4);
    if (r < 16)
      std::memcpy(const_cast<void*>(sm90::emu_swizzled(tile + 8192, r, k, 4)),
                  &b[i], 4);
  }
  __syncthreads();
  float d[8];
  const int r0 = warp * 16 + g;
  if (ss) {
    sm90::wgmma_ss<16>(d, sm90::b_desc(tile), sm90::b_desc(tile + 8192), 0);
  } else {
    uint32_t f[4];
    std::memcpy(&f[0], &a[r0 * 8 + t], 4);
    std::memcpy(&f[1], &a[(r0 + 8) * 8 + t], 4);
    std::memcpy(&f[2], &a[r0 * 8 + t + 4], 4);
    std::memcpy(&f[3], &a[(r0 + 8) * 8 + t + 4], 4);
    sm90::wgmma<16, false>(d, f, tile + 8192, 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait0();
  for (int j = 0; j < 2; ++j)
    for (int e = 0; e < 2; ++e) {
      out[r0 * 16 + 8 * j + 2 * t + e] = d[4 * j + e];
      out[(r0 + 8) * 16 + 8 * j + 2 * t + e] = d[4 * j + 2 + e];
    }
}
extern "C" int probe(const float* a, const float* b, float* out, int ss) {
  const dim3 grid(1);
  probe_kernel<<<grid, 128, 0, nullptr>>>(a, b, out, ss);
  return 0;
}
"""


@pytest.mark.parametrize("ss", [False, True])
def test_emulated_wgmma_is_a_tf32_product_with_truncating_sums(tmp_path, ss):
    """The emulated m64n16k8 TF32 multiply, with A from registers or from
    its swizzled tile, gives the TF32 product of the two tiles at the
    fragment positions sm90_mma.cuh states, its sum rounded toward zero."""
    import ctypes
    lib = ctypes.CDLL(str(compile_cuda(tmp_path, _PROBE, "probe")))
    lib.probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    rng = np.random.default_rng(7)
    a = rng.standard_normal((64, 8)).astype(np.float32)
    b = rng.standard_normal((16, 8)).astype(np.float32)
    out = np.zeros((64, 16), np.float32)
    lib.probe(a.ctypes.data, b.ctypes.data, out.ctypes.data, int(ss))
    trunc_a = (a.view(np.uint32) & 0xffffe000).view(np.float32)
    trunc_b = (b.view(np.uint32) & 0xffffe000).view(np.float32)
    exact = trunc_a.astype(np.float64) @ trunc_b.astype(np.float64).T
    want = exact.astype(np.float32)
    over = np.abs(want.astype(np.float64)) > np.abs(exact)
    want[over] = np.nextafter(want[over], np.float32(0))
    np.testing.assert_array_equal(out, want)


# -- the persistent recurrent kernels (csrc/fused_gru.cu, fused_lstm.cu) ---

# cuda_runtime.h for sources built on csrc/grid_sync.cuh. A cooperative
# launch (cudaLaunchKernelEx with the cooperative attribute) runs EVERY
# block of the grid at once, one std::thread per CUDA thread, so the
# kernels' own grid barrier runs as written; a `<<<...>>>` launch runs one
# block at a time. Each block has its own std::barrier (__syncthreads),
# one std::barrier a warp (__syncwarp, shuffles, the multiplies' exchange)
# and its own dynamic shared memory (`extern __shared__`), filled with NaN
# bytes so that a read of an unwritten word shows. emu_configure(sms,
# smem) sets the emulated card's SM count and shared-memory limit a block.
GRID_EMULATION = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct uint2 { unsigned x, y; };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorCooperativeLaunchTooLarge = 720;
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int emu_sms = 132, emu_smem_max = 232448;
extern "C" void emu_configure(int sms, int smem_max) {
  emu_sms = sms;
  emu_smem_max = smem_max;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? emu_sms : emu_smem_max;
  return 0;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes <= emu_smem_max ? 0 : 1;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t smem) {
  *n = smem <= (size_t)emu_smem_max ? 1 : 0;
  return 0;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
template <class T>
inline T __ldg(const T* p) { return *p; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
// gru_step_split.py's phase marks: a clock that only grows, and a
// symbol set from the host
inline std::atomic<long long> emu_clock{0};
inline long long clock64() { return ++emu_clock; }
template <class T>
cudaError_t cudaMemcpyToSymbol(T& symbol, const void* src, size_t n) {
  std::memcpy(&symbol, src, n);
  return 0;
}
inline thread_local std::barrier<>* emu_block_barrier = nullptr;
inline thread_local std::barrier<>* emu_warp_barrier = nullptr;
inline thread_local unsigned char* emu_smem = nullptr;
inline thread_local float* emu_shfl = nullptr;
// each thread's exchange slot of its block (the multiplies' fragments)
inline thread_local void** emu_lanes = nullptr;
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barrier->arrive_and_wait();
}
// a warp shuffle through the block's exchange buffer, behind a barrier of
// the thread's warp (every lane of these kernels' warps shuffles)
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int me = threadIdx.x;
  emu_shfl[me] = v;
  emu_warp_barrier->arrive_and_wait();
  const float r = emu_shfl[(me & ~31) | ((me & 31) ^ mask)];
  emu_warp_barrier->arrive_and_wait();
  return r;
}
// what the threads of one block share
struct EmuBlock {
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<float> smem, shfl;
  std::vector<void*> lanes;
  EmuBlock(unsigned threads, size_t smem_bytes)
      : bar(threads), smem(smem_bytes / sizeof(float) + 4, std::nanf("")),
        shfl(threads), lanes(threads) {
    for (unsigned w = 0; w < (threads + 31) / 32; ++w)
      warps.push_back(std::make_unique<std::barrier<>>(32));
  }
};
// the blocks of `grid`, all at once (together) or one at a time
template <class F, class... A>
void emu_run(F kernel, dim3 grid, unsigned threads, size_t smem,
             bool together, A... args) {
  const unsigned blocks = grid.x * grid.y * grid.z;
  auto team = [&](std::vector<std::unique_ptr<EmuBlock>>& mine,
                  unsigned first) {
    std::vector<std::thread> ts;
    for (unsigned i = 0; i < mine.size(); ++i)
      for (unsigned t = 0; t < threads; ++t)
        ts.emplace_back([&, i, t] {
          const unsigned b = first + i;
          EmuBlock& blk = *mine[i];
          threadIdx = dim3(t);
          blockIdx = dim3(b % grid.x, b / grid.x % grid.y,
                          b / (grid.x * grid.y));
          blockDim = dim3(threads);
          gridDim = grid;
          emu_block_barrier = &blk.bar;
          emu_warp_barrier = blk.warps[t / 32].get();
          emu_smem = reinterpret_cast<unsigned char*>(blk.smem.data());
          emu_shfl = blk.shfl.data();
          emu_lanes = blk.lanes.data();
          kernel(args...);
        });
    for (auto& th : ts) th.join();
  };
  for (unsigned b = 0; b < blocks; b += together ? blocks : 1) {
    std::vector<std::unique_ptr<EmuBlock>> mine;
    for (unsigned i = b; i < (together ? blocks : b + 1); ++i)
      mine.push_back(std::make_unique<EmuBlock>(threads, smem));
    team(mine, b);
  }
}
// kernel<<<grid, threads, smem, stream>>>(...): one block at a time, with
// the card's largest dynamic shared memory
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, int threads, A... args) {
  emu_run(kernel, grid, threads, emu_smem_max, false, args...);
}
enum cudaLaunchAttributeID { cudaLaunchAttributeCooperative = 2 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union { int cooperative; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
// a cooperative launch: every block of the grid at once, refused when the
// emulated card cannot hold them all
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(P...), A... args) {
  bool cooperative = false;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    cooperative |= cfg->attrs[i].id == cudaLaunchAttributeCooperative &&
                   cfg->attrs[i].val.cooperative;
  if (!cooperative) std::abort();
  const dim3 grid = cfg->gridDim;
  if (grid.x * grid.y * grid.z > (unsigned)emu_sms ||
      cfg->dynamicSmemBytes > (size_t)emu_smem_max)
    return cudaErrorCooperativeLaunchTooLarge;
  emu_run(kernel, grid, cfg->blockDim.x, cfg->dynamicSmemBytes, true,
          args...);
  return 0;
}
"""

# The PTX block of csrc/grid_sync.cuh on the host (the rest of that file
# is compiled as it is): the barrier's gpu-scope add and load as
# std::atomic_ref operations (the waiting thread yields), ld.global.cg a
# plain load, the asynchronous copies synchronous copies (so a wrong
# cp.async wait shows only on the card), the TF32 split as written there,
# and mma.sync m16n8k8 from the PTX ISA's fragment layout: a
# multiply is queued with the fragments its lane holds at issue and runs
# when the warp next reads its accumulators (promote), where the 32 lanes'
# queues meet behind the warp's barrier (every lane issues every
# multiply). It adds its exact product (TF32 reads the top 19 bits of each
# word; products of TF32 values and their sum are exact in double) into
# the float32 accumulator rounding toward zero, as the tensor cores'
# float32 sums truncate.
GRID_SYNC_PTX = r"""
#pragma once
#include <cuda_runtime.h>
#include <atomic>
#include <cstring>
#include <thread>
#include <vector>
namespace grid {
inline unsigned arrive(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v,
                                                 std::memory_order_acq_rel);
}
inline unsigned load_acquire(const unsigned* p) {
  std::this_thread::yield();
  return std::atomic_ref<unsigned>(*const_cast<unsigned*>(p)).load(
      std::memory_order_acquire);
}
inline float load_cg(const float* p) { return *p; }
inline void cp_async16(float* smem, const float* gmem) {
  std::memcpy(smem, gmem, 16);
}
inline void cp_async4(float* smem, const float* gmem) { *smem = *gmem; }
inline void cp_async_commit() {}
inline void cp_async_wait(int) {}
inline void cp_async_wait_all() {}
inline uint32_t emu_bits(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  return u;
}
inline void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (emu_bits(v) + 0x1000u) & 0xffffe000u;
  lo = emu_bits(v - __uint_as_float(hi));
}
struct EmuMma {
  uint32_t a[4], b[2];
  float* d;
};
inline thread_local std::vector<EmuMma> emu_mma;
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                     const uint32_t (&b)[2]) {
  emu_mma.push_back({{a[0], a[1], a[2], a[3]}, {b[0], b[1]}, d});
}
inline float emu_truncating_add(float acc, double sum) {
  const double exact = static_cast<double>(acc) + sum;
  float f = static_cast<float>(exact);
  if (std::fabs(static_cast<double>(f)) > std::fabs(exact))
    f = std::nextafter(f, 0.f);
  return f;
}
// the warp's queued multiplies, in issue order
inline void emu_mma_run() {
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  emu_lanes[tid] = &emu_mma;
  __syncwarp();
  auto at = [&](int l, size_t i) -> const EmuMma& {
    const auto& q =
        *static_cast<std::vector<EmuMma>*>(emu_lanes[tid - lane + l]);
    if (q.size() != emu_mma.size()) std::abort();  // not warp-uniform
    return q[i];
  };
  for (size_t i = 0; i < emu_mma.size(); ++i)
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e / 2), col = 2 * t + e % 2;
      double sum = 0.0;
      for (int k = 0; k < 8; ++k) {
        const uint32_t av = at((row % 8) * 4 + k % 4, i).a[row / 8 + 2 * (k / 4)];
        const uint32_t bv = at(col * 4 + k % 4, i).b[k / 4];
        sum += static_cast<double>(__uint_as_float(av & 0xffffe000u)) *
               __uint_as_float(bv & 0xffffe000u);
      }
      emu_mma[i].d[e] = emu_truncating_add(emu_mma[i].d[e], sum);
    }
  __syncwarp();
  emu_mma.clear();
}
inline void promote(float (&sum)[4], float (&hi)[4], float (&lo)[4]) {
  if (!emu_mma.empty()) emu_mma_run();
  for (int i = 0; i < 4; ++i) {
    sum[i] += hi[i] + lo[i];
    hi[i] = 0.f;
    lo[i] = 0.f;
  }
}
inline void promote(float (&sum)[4], float (&hi)[4], float (&la)[4],
                    float (&lb)[4]) {
  if (!emu_mma.empty()) emu_mma_run();
  for (int i = 0; i < 4; ++i) {
    sum[i] += hi[i] + (la[i] + lb[i]);
    hi[i] = 0.f;
    la[i] = 0.f;
    lb[i] = 0.f;
  }
}
}  // namespace grid
"""

GRID_SYNC = CSRC / "grid_sync.cuh"
# the line of csrc/grid_sync.cuh past which it is compiled as it is
GRID_SYNC_MARK = "// ---- Built on the PTX above"


def grid_sync_host(text=None):
    """csrc/grid_sync.cuh (or `text`, a version of it) for the host: its
    PTX block replaced by GRID_SYNC_PTX, the rest as written."""
    text = GRID_SYNC.read_text() if text is None else text
    assert text.count(GRID_SYNC_MARK) == 1
    return GRID_SYNC_PTX + text[text.index(GRID_SYNC_MARK):]


def grid_host_text(text):
    """A source built on grid_sync.cuh as host C++: launches rewritten to
    emu_launch, `extern __shared__` to the block's dynamic shared memory."""
    text = LAUNCH.sub(r"emu_launch(\1, \2, \3, ", text)
    text = DYN_SMEM.sub(r"\1* const \2 = reinterpret_cast<\1*>(emu_smem);",
                        text)
    assert "<<<" not in text and "extern __shared__" not in text
    return text


def compile_grid_cuda(out: Path, text: str, stem: str,
                      grid_sync=None) -> Path:
    """The CUDA source `text` (built on csrc/grid_sync.cuh, or on the
    version `grid_sync` of it) compiled for the host against
    GRID_EMULATION, as out/lib<stem>.so; the other headers of csrc/ are
    included as they are. Skips the test where no host compiler exists."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the CUDA source with")
    (out / "cuda_runtime.h").write_text(GRID_EMULATION)
    (out / "grid_sync.cuh").write_text(grid_sync_host(grid_sync))
    (out / f"{stem}.cpp").write_text(grid_host_text(text))
    so = out / f"lib{stem}.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(out), "-I", str(GRID_SYNC.parent), "-o",
                    str(so), str(out / f"{stem}.cpp")],
                   check=True, capture_output=True, timeout=300)
    return so


_MMA_PROBE = r"""
#include <cuda_runtime.h>
#include "grid_sync.cuh"
// d[16 x 8] (row-major, in and out) += A[16 x 8] B[8 x 8]: a row-major,
// b [n][k]; every lane loads its fragments by the PTX ISA's layout
__global__ void probe_kernel(const float* a, const float* b, float* d) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  uint32_t fa[4], fb[2];
  std::memcpy(&fa[0], &a[g * 8 + t], 4);
  std::memcpy(&fa[1], &a[(g + 8) * 8 + t], 4);
  std::memcpy(&fa[2], &a[g * 8 + t + 4], 4);
  std::memcpy(&fa[3], &a[(g + 8) * 8 + t + 4], 4);
  std::memcpy(&fb[0], &b[g * 8 + t], 4);
  std::memcpy(&fb[1], &b[g * 8 + t + 4], 4);
  float acc[4] = {d[g * 8 + 2 * t], d[g * 8 + 2 * t + 1],
                  d[(g + 8) * 8 + 2 * t], d[(g + 8) * 8 + 2 * t + 1]};
  float sum[4] = {}, lo[4] = {};
  grid::mma_tf32(acc, fa, fb);
  grid::promote(sum, acc, lo);
  d[g * 8 + 2 * t] = sum[0];
  d[g * 8 + 2 * t + 1] = sum[1];
  d[(g + 8) * 8 + 2 * t] = sum[2];
  d[(g + 8) * 8 + 2 * t + 1] = sum[3];
}
extern "C" int probe(const float* a, const float* b, float* d) {
  const dim3 grid(1);
  probe_kernel<<<grid, 32, 0, nullptr>>>(a, b, d);
  return 0;
}
"""


def test_emulated_mma_sync_is_a_tf32_product_with_truncating_sums(tmp_path):
    """The emulated mma.sync m16n8k8 TF32 multiply adds the product of the
    TF32 parts of its fragments, placed as the PTX ISA lays them out, into
    the accumulators, the float32 sum rounded toward zero."""
    import ctypes
    lib = ctypes.CDLL(str(compile_grid_cuda(tmp_path, _MMA_PROBE, "probe")))
    lib.probe.argtypes = [ctypes.c_void_p] * 3
    rng = np.random.default_rng(11)
    a = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal((8, 8)).astype(np.float32)  # [n][k]
    d = (rng.standard_normal((16, 8)) * 3).astype(np.float32)
    out = d.copy()
    lib.probe(a.ctypes.data, b.ctypes.data, out.ctypes.data)
    trunc_a = (a.view(np.uint32) & 0xffffe000).view(np.float32)
    trunc_b = (b.view(np.uint32) & 0xffffe000).view(np.float32)
    exact = d.astype(np.float64) + \
        trunc_a.astype(np.float64) @ trunc_b.astype(np.float64).T
    want = exact.astype(np.float32)
    over = np.abs(want.astype(np.float64)) > np.abs(exact)
    want[over] = np.nextafter(want[over], np.float32(0))
    assert over.any()  # the truncation is exercised
    np.testing.assert_array_equal(out, want)
