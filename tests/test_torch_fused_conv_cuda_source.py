"""The CUDA source of the fused conv + BN kernels, run on the CPU.

paddle_tpu_torch/csrc/fused_conv.cu compiles only for a card, but its
logic — the 128-row tiles and both column tiles, the weight pack into
K-major TF32 hi/lo (or bf16) planes, the ring of copy stages and the
steps issued ahead, the 3x3 halo slab and its nine shifted windows, the
prologue applied once per staged element before the edge mask, the tap
masks, the A fragments and the 128-byte-swizzled B tile, the 3xTF32
split, the per-step promotion of long sums, the staged and the direct
output stores, the per-tile partial statistics and their reduction in
tile order — is plain C++ over a small CUDA subset plus the PTX helpers
of csrc/sm90_mma.cuh. This test compiles the source with the host C++
compiler against a small emulation of that subset (one block at a time,
one std::thread per CUDA thread, std::barrier for __syncthreads,
__shared__ as a static shared by the block's threads) and a host version
of sm90_mma.cuh with the same fragment and shared-memory semantics, and
holds the float32 and bfloat16 C entry points against the plain twins
of ops/kernels/fused_conv.py: M not a multiple of the 128-row tile and
more than one row tile, images smaller than a tile and tiles that cross
image boundaries, a 1x1 image (every off-centre tap masked), odd C (the
plain-load slab), N on both sides of the 128-column switch and rows that
are not whole 16-byte chunks, ReLU without the affine, and stats off.
Two mutants must be caught: the affine applied after the edge mask (a
padded tap becomes relu(b)), and 3xTF32 with its lo products dropped. A
simulation of the tensor cores' truncating float32 sums pins the
promotion threshold. It says nothing about speed or about the device
compiler; chip_smoke.py runs the real kernels on the card.

Tolerance: float32, the same products summed in another order: outputs
atol 1e-5 * max(|plain|, 1), statistics 1e-5 of the sum of |terms|.
bfloat16: each output within one bf16 ulp (at the larger of the two)
plus 1e-5 of its sum of |terms|, statistics as in float32.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_conv as fc

SOURCE = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc" \
    / "fused_conv.cu"
RTOL = 1e-5
ROW_TILE = 128

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
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
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
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, int threads, A... args) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(threads);
        emu_barrier = &bar;
        std::vector<std::thread> team;
        for (int t = 0; t < threads; ++t)
          team.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            blockDim = dim3(threads);
            gridDim = grid;
            kernel(args...);
          });
        for (auto& th : team) th.join();
      }
}
"""

# The PTX helpers of csrc/sm90_mma.cuh as host C++ with the same fragment
# and shared-memory semantics (that header's comment states them): the
# copies are synchronous, the warpgroup multiply gathers the 128 threads'
# A fragments through a shared scratch (the block's barrier: both
# warpgroups of the kernels issue every multiply together) and reads B
# from the 128-byte-swizzled tile by the swizzle's address rule, and the
# shuffle exchanges through shared memory.
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
inline void wgmma_fence() {}
inline void wgmma_commit() {}
inline void wgmma_wait0() {}
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
alignas(1024) inline unsigned char emu_smem[kEmuSmemBytes + 1024];
inline unsigned char* dyn_smem() { return emu_smem; }
inline uint32_t emu_a[2][64][8];
inline float emu_word(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <int N, bool kBf16>
void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], const void* b,
           int accumulate) {
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  uint32_t (&A)[64][8] = emu_a[wg];
  A[r0][t] = a[0];
  A[r1][t] = a[1];
  A[r0][t + 4] = a[2];
  A[r1][t + 4] = a[3];
  __syncthreads();
  const int K = kBf16 ? 16 : 8, size = kBf16 ? 2 : 4;
  for (int jn = 0; jn < N / 8; ++jn)
    for (int q = 0; q < 4; ++q) {
      const int r = q < 2 ? r0 : r1, n = jn * 8 + 2 * t + (q & 1);
      float sum = 0.f;
      for (int k = 0; k < K; ++k) {
        float av, bv;
        const uintptr_t addr = reinterpret_cast<uintptr_t>(b) +
                               (n / 8) * 1024 + (n % 8) * 128 + k * size;
        const uintptr_t phys = addr ^ (((addr >> 7) & 7) << 4);
        if (kBf16) {
          const uint32_t w = A[r][k / 2];
          av = emu_word(k % 2 ? w & 0xffff0000u : w << 16);
          uint16_t h;
          std::memcpy(&h, reinterpret_cast<const void*>(phys), 2);
          bv = emu_word(static_cast<uint32_t>(h) << 16);
        } else {
          av = emu_word(A[r][k] & 0xffffe000u);  // TF32 reads 19 bits
          uint32_t w;
          std::memcpy(&w, reinterpret_cast<const void*>(phys), 4);
          bv = emu_word(w & 0xffffe000u);
        }
        sum += av * bv;
      }
      d[jn * 4 + q] = (accumulate ? d[jn * 4 + q] : 0.f) + sum;
    }
  __syncthreads();
}
}  // namespace sm90
"""

# kernel<<<grid, threads, smem, stream>>>(args), the kernel name possibly
# with template arguments -> emu_launch(kernel, grid, threads, args)
_LAUNCH = re.compile(
    r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>\(")

# the prologue applied after the edge mask (a padded tap reads relu(b)):
# the in-place activation of the slab switched off, and each float32 A
# fragment element activated after its mask
_MASK_THEN_AFFINE = [
    ("    if (tap == 0 && prologue) {", "    if (false) {"),
    ("""          const float e[4] = {v0 ? word_f32(w0[u]) : 0.f,
                              v1 ? word_f32(w1[u]) : 0.f,
                              v0 ? word_f32(w0[u + 4]) : 0.f,
                              v1 ? word_f32(w1[u + 4]) : 0.f};
""", """          float e[4] = {v0 ? word_f32(w0[u]) : 0.f,
                        v1 ? word_f32(w1[u]) : 0.f,
                        v0 ? word_f32(w0[u + 4]) : 0.f,
                        v1 ? word_f32(w1[u + 4]) : 0.f};
          for (int r = 0; r < 4; ++r) {
            const int c = j * E::kBK + u + (r / 2) * 4;
            if (affine && c < p.C) e[r] = e[r] * p.a[c] + p.b[c];
            if (p.relu) e[r] = fmaxf(e[r], 0.f);
          }
"""),
]

# 3xTF32 with the two lo products dropped: a one-pass TF32 product
_DROP_LO = [
    ("""            sm90::wgmma<BN, false>(d, lo[ks], bk, ks | keep);
            sm90::wgmma<BN, false>(d, hi[ks], bk + kBPlane, 1);
            sm90::wgmma<BN, false>(d, hi[ks], bk, 1);
""", """            sm90::wgmma<BN, false>(d, hi[ks], bk, ks | keep);
"""),
]


def _compile(out: Path, text: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the CUDA source with")
    (out / "cuda_runtime.h").write_text(EMULATION)
    (out / "sm90_mma.cuh").write_text(SM90_EMULATION)
    src = _LAUNCH.sub(r"emu_launch(\1, \2, \3, ", text)
    assert "<<<" not in src
    (out / "fused_conv.cpp").write_text(src)
    so = out / "libfused_conv.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(out), "-o", str(so), str(out / "fused_conv.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = fc.bind(ctypes.CDLL(str(so)))
    assert lib.fused_conv_row_tile() == ROW_TILE
    return lib


def _mutate(text, edits):
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("fused_conv_emulated"),
                    SOURCE.read_text())


def _inputs(m, c, n, k_rows, affine, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, c, generator=g).to(dtype)
    w = (torch.randn(k_rows, n, generator=g) * 0.2).to(dtype)
    if not affine:
        return x, w, None, None
    return (x, w, torch.rand(c, generator=g) + 0.5,
            torch.randn(c, generator=g) * 0.5 + 0.3)


def _call(lib, three, x, w, a, b, n, relu, stats, img=(1, 1)):
    """Run one C entry point of x's dtype on CPU buffers: (out, stats or
    None)."""
    m, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty(m, n, dtype=x.dtype)
    st = torch.empty(2, n) if stats else None
    part = torch.empty(-(-m // ROW_TILE), 2, n) if stats else None
    wpack = torch.empty(lib.fused_conv_wpack_bytes(9 if three else 1, c, n,
                                                   int(bf16)),
                        dtype=torch.uint8)

    def ptr(t):
        return None if t is None else t.data_ptr()

    common = [ptr(x), ptr(w), ptr(a), ptr(b), ptr(out), ptr(part), ptr(st),
              ptr(wpack)]
    suffix = "bf16" if bf16 else "f32"
    if three:
        err = getattr(lib, f"fused_conv3x3_{suffix}")(
            *common, m, c, n, img[0], img[1], int(relu), None)
    else:
        err = getattr(lib, f"fused_conv1x1_{suffix}")(
            *common, m, c, n, int(relu), None)
    assert err == 0
    return out, st


def _hold(got, want, xin, w, what):
    (out, st), (ref, ref_st) = got, want
    np.testing.assert_allclose(
        out.numpy(), ref.numpy(), rtol=0,
        atol=RTOL * max(float(ref.abs().max()), 1.0), err_msg=what)
    if ref_st is None:
        assert st is None
        return
    terms = torch.stack([ref.abs().sum(0), (ref * ref).sum(0)])
    np.testing.assert_allclose(st.numpy(), ref_st.numpy(), rtol=0,
                               atol=RTOL * float(terms.max()) + 1e-6,
                               err_msg=f"{what} stats")


def _bf16_ulp(v):
    """The spacing of bfloat16 values at |v| (0 at 0)."""
    mant, exp = torch.frexp(v.float())
    return torch.where(mant == 0, torch.zeros_like(v.float()),
                       torch.ldexp(torch.ones_like(v.float()), exp - 8))


def _hold_bf16(got, three, x, w, a, b, relu, img, what):
    """bfloat16 kernel vs bfloat16 twin: both round the same float32 sums,
    taken in another order, so each output element is within one bf16 ulp
    (at the larger of the two) plus RTOL of its sum of |terms|; the
    statistics of the float32 sums within RTOL of their sum of |terms|."""
    out, st = got
    act = fc._prologue(x, a, b, relu)   # rounded to bf16, as float32
    if three:
        ref32, _ = fc.conv3x3_bn_act_plain(act, w.float(), *img)
        terms_el, _ = fc.conv3x3_bn_act_plain(act.abs(), w.float().abs(),
                                              *img)
        want = fc.conv3x3_bn_act_plain(x, w, *img, a, b, relu, st is not None)
    else:
        ref32, _ = fc.conv1x1_bn_act_plain(act, w.float())
        terms_el, _ = fc.conv1x1_bn_act_plain(act.abs(), w.float().abs())
        want = fc.conv1x1_bn_act_plain(x, w, a, b, relu, st is not None)
    assert out.dtype == torch.bfloat16
    diff = (out.float() - want[0].float()).abs()
    tol = _bf16_ulp(torch.maximum(out.float().abs(), want[0].float().abs())) \
        + RTOL * terms_el
    worst = float((diff - tol).max())
    assert worst <= 0, f"{what}: an output is {worst:.3e} past its limit"
    if want[1] is None:
        assert st is None
        return
    terms = torch.stack([ref32.abs().sum(0), (ref32 * ref32).sum(0)])
    np.testing.assert_allclose(st.numpy(), want[1].numpy(), rtol=0,
                               atol=RTOL * float(terms.max()) + 1e-6,
                               err_msg=f"{what} stats")


# (M, K, N, affine, relu, stats): M below, at and across the 128-row tile,
# N on both sides of the 128-column switch and off both tiles, odd K
CASES_1X1 = [
    (98, 5, 48, True, True, True),
    (200, 16, 130, True, False, True),
    (128, 3, 64, False, True, True),
    (257, 9, 17, False, False, False),
]


@pytest.mark.parametrize("m,k,n,affine,relu,stats", CASES_1X1)
def test_conv1x1_source_matches_plain_twin(lib, m, k, n, affine, relu,
                                           stats):
    x, w, a, b = _inputs(m, k, n, k, affine, seed=m + k + n)
    got = _call(lib, False, x, w, a, b, n, relu, stats)
    want = fc.conv1x1_bn_act_plain(x, w, a, b, relu, stats)
    _hold(got, want, x, w, f"1x1 M{m} K{k} N{n}")


# (images, H, W, C, N, affine, relu, stats): 2x7x7 (M 98, below one row
# tile), 3x9x10 (M 270: tiles cross image boundaries), 1x1 images (every
# off-centre tap masked), odd C, N above 128
CASES_3X3 = [
    (2, 7, 7, 5, 48, True, True, True),
    (3, 9, 10, 4, 130, True, True, True),
    (5, 1, 1, 3, 16, True, True, True),
    (2, 6, 5, 3, 20, False, True, True),
    (1, 12, 11, 2, 8, True, False, False),
]


@pytest.mark.parametrize("nb,h,w_,c,n,affine,relu,stats", CASES_3X3)
def test_conv3x3_source_matches_plain_twin(lib, nb, h, w_, c, n, affine,
                                           relu, stats):
    m = nb * h * w_
    x, w, a, b = _inputs(m, c, n, 9 * c, affine, seed=m + c + n)
    got = _call(lib, True, x, w, a, b, n, relu, stats, img=(h, w_))
    want = fc.conv3x3_bn_act_plain(x, w, h, w_, a, b, relu, stats)
    _hold(got, want, x, w, f"3x3 {nb}x{h}x{w_} C{c} N{n}")


# bfloat16 (M, K, N, affine, relu, stats): the 16-byte copy path (K 8, 72:
# two chunks, the second partial), the plain-load path (odd K), N across
# the column tiles
CASES_1X1_BF16 = [
    (200, 72, 130, True, True, True),
    (98, 8, 48, True, False, True),
    (130, 5, 64, False, True, True),
    (64, 9, 17, False, False, False),
]


@pytest.mark.parametrize("m,k,n,affine,relu,stats", CASES_1X1_BF16)
def test_conv1x1_source_bf16_matches_plain_twin(lib, m, k, n, affine, relu,
                                                stats):
    x, w, a, b = _inputs(m, k, n, k, affine, m + k + n, torch.bfloat16)
    got = _call(lib, False, x, w, a, b, n, relu, stats)
    _hold_bf16(got, False, x, w, a, b, relu, None, f"bf16 1x1 M{m} K{k} N{n}")


# bfloat16 (images, H, W, C, N, affine, relu, stats): tiles across image
# boundaries with C 16 (copy path), 1x1 images, odd C (plain loads)
CASES_3X3_BF16 = [
    (3, 9, 10, 16, 130, True, True, True),
    (5, 1, 1, 8, 16, True, True, True),
    (2, 7, 7, 5, 48, True, False, True),
]


@pytest.mark.parametrize("nb,h,w_,c,n,affine,relu,stats", CASES_3X3_BF16)
def test_conv3x3_source_bf16_matches_plain_twin(lib, nb, h, w_, c, n, affine,
                                                relu, stats):
    m = nb * h * w_
    x, w, a, b = _inputs(m, c, n, 9 * c, affine, m + c + n, torch.bfloat16)
    got = _call(lib, True, x, w, a, b, n, relu, stats, img=(h, w_))
    _hold_bf16(got, True, x, w, a, b, relu, (h, w_),
               f"bf16 3x3 {nb}x{h}x{w_} C{c} N{n}")


def test_conv1x1_source_3xtf32_holds_float32(lib):
    """3xTF32 over several chunks (K 100: 32-channel chunks, the last
    partial) on inputs spread over six binades holds the float32 limit."""
    m, k, n = 160, 100, 72
    x, w, a, b = _inputs(m, k, n, k, True, seed=11)
    x = x * torch.exp2(torch.randint(-3, 3, (m, k),
                                     generator=torch.Generator()
                                     .manual_seed(12)).float())
    got = _call(lib, False, x, w, a, b, n, True, True)
    want = fc.conv1x1_bn_act_plain(x, w, a, b, True, True)
    _hold(got, want, x, w, "3xTF32 1x1")


def test_affine_after_mask_mutant_is_caught(tmp_path):
    """The same source with the prologue applied after the edge mask (a
    padded tap reads relu(b) in place of 0) disagrees with the plain twin
    on the edge pixels, and only there."""
    mutant = _compile(tmp_path, _mutate(SOURCE.read_text(),
                                        _MASK_THEN_AFFINE))
    nb, h, w_, c, n = 2, 7, 7, 5, 48
    x, w, a, b = _inputs(nb * h * w_, c, n, 9 * c, True, seed=1)
    got, _ = _call(mutant, True, x, w, a, b, n, True, False, img=(h, w_))
    want, _ = fc.conv3x3_bn_act_plain(x, w, h, w_, a, b, True, False)
    diff = (got - want).abs().reshape(nb, h, w_, n).amax(dim=(0, 3))
    interior = diff[1:-1, 1:-1]
    assert float(interior.max()) <= RTOL * float(want.abs().max())
    edge = torch.cat([diff[0], diff[-1], diff[:, 0], diff[:, -1]])
    assert float(edge.min()) > 1e-2


def test_dropping_tf32_lo_terms_is_caught(tmp_path):
    """The float32 path with the two lo products dropped (one TF32 pass)
    misses the float32 limit."""
    mutant = _compile(tmp_path, _mutate(SOURCE.read_text(), _DROP_LO))
    m, k, n = 130, 64, 64
    x, w, a, b = _inputs(m, k, n, k, True, seed=3)
    got, _ = _call(mutant, False, x, w, a, b, n, True, False)
    want, _ = fc.conv1x1_bn_act_plain(x, w, a, b, True, False)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err > 10 * RTOL, err


def _truncating_3xtf32(x, w, promote_every):
    """x @ w as the float32 path computes it on the tensor cores, in
    float64 numpy: 3xTF32 k-steps of 8 (lo*hi, hi*lo, hi*hi), each added
    into a float32 accumulator truncated toward zero, as the tensor cores'
    float32 sums are; every promote_every k-steps (0: never) that
    accumulator is added into the result with a rounding float32 add."""
    def tf32(v):
        u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
        return ((u + 0x1000) & 0xffffe000).astype(np.uint32).view(
            np.float32).astype(np.float64)

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


def test_promotion_threshold_holds_the_float32_limit():
    """kPromoteAfter (the source's constant): a float32 conv whose
    k-steps all go into one truncating accumulator stays within half the
    float32 limit up to that many multiplies (K 256 with 3 passes: 96),
    misses the limit at K' 1152 (432), and the per-step promotion (a
    fresh accumulator every 4 k-steps, added with a rounding add) holds
    K' 1152 well inside it."""
    after = int(re.search(r"constexpr int kPromoteAfter = (\d+);",
                          SOURCE.read_text()).group(1))
    rng = np.random.default_rng(0)

    def err(k, promote_every):
        x = np.maximum(rng.standard_normal((64, k)), 0).astype(
            np.float32).astype(np.float64)
        w = (rng.standard_normal((k, 48)) / np.sqrt(k)).astype(
            np.float32).astype(np.float64)
        exact = x @ w
        got = _truncating_3xtf32(x, w, promote_every)
        return np.abs(got - exact).max() / np.abs(exact).max()

    assert err(after // 3 * 8, 0) <= RTOL / 2
    assert err(1152, 0) > RTOL
    assert err(1152, 4) <= RTOL / 10
