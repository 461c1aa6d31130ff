"""The CUDA source of the fused-GRU kernels, run on the CPU.

paddle_tpu_torch/csrc/fused_gru.cu compiles only for a card, but its
logic — tiles, ragged edges, the two stages of a forward step, the
backward's prep/dr/dh stages and carries, the two-part dW reduction — is
plain C++ over a small CUDA subset. This test compiles the unchanged
source with the host C++ compiler against a small emulation of that
subset (one block at a time, one std::thread per CUDA thread,
std::barrier for __syncthreads, __shared__ as a static shared by the
block's threads, 3-D grids) and holds both C entry points against the
plain twins of ops/kernels/fused_gru.py, over shapes off every tile
edge, zero-length and full-length rows, T = 1, B above one row tile, a
nonzero h0 and an h_last cotangent. It says nothing about speed or about
the device compiler; chip_smoke.py runs the real kernels on the card.

Tolerance: float32, the same sums in another order: 1e-5 absolute
forward, 1e-5 * max(|plain|, 1) backward.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_gru as fg

SOURCE = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc" \
    / "fused_gru.cu"
ATOL = 1e-5

EMULATION = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
inline thread_local dim3 threadIdx, blockIdx;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
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
            kernel(args...);
          });
        for (auto& th : team) th.join();
      }
}
"""

# kernel<<<grid, threads, smem, stream>>>(args) -> emu_launch(kernel, grid,
# threads, args)
_LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>\(")

# (T, B, H, lengths): zero-length and full rows; H off the 8- and 16-unit
# tiles and across two dW tiles (H 70: 2H = 140 > 128); B across two row
# tiles; T = 1
CASES = [
    (3, 2, 16, [3, 0]),
    (4, 3, 9, [4, 2, 1]),
    (2, 18, 5, [i % 3 for i in range(18)]),
    (1, 5, 16, [1, 0, 1, 1, 0]),
    (3, 17, 70, [i % 4 for i in range(17)]),
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the CUDA source with")
    out = tmp_path_factory.mktemp("fused_gru_emulated")
    (out / "cuda_runtime.h").write_text(EMULATION)
    src = _LAUNCH.sub(r"emu_launch(\1, \2, \3, ", SOURCE.read_text())
    assert "<<<" not in src
    (out / "fused_gru.cpp").write_text(src)
    so = out / "libfused_gru.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(out), "-I", str(SOURCE.parent), "-o",
                    str(so), str(out / "fused_gru.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.fused_gru_fwd_f32.argtypes = ([ctypes.c_void_p] * 8
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p])
    lib.fused_gru_bwd_f32.argtypes = ([ctypes.c_void_p] * 11
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p])
    return lib


def _inputs(t, b, h, lens, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, b, 3 * h, generator=g) * 0.5
    w = torch.randn(h, 3 * h, generator=g) * 0.3
    h0 = torch.randn(b, h, generator=g) * 0.5
    cts = [torch.randn(t, b, h, generator=g), torch.randn(b, h, generator=g)]
    return (x, w, h0, torch.tensor(lens, dtype=torch.int32)), cts


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


@pytest.mark.parametrize("t,b,h,lens", CASES)
def test_cuda_source_matches_plain_twins(lib, t, b, h, lens):
    inputs, cts = _inputs(t, b, h, lens, seed=len(lens) + h)
    x, w, h0, lengths = inputs
    outs = [torch.empty(t, b, h), torch.empty(b, h), torch.empty(t, b, 3 * h)]
    rh = torch.empty(b, h)
    assert lib.fused_gru_fwd_f32(*_ptrs(*inputs, *outs, rh), t, b, h,
                                 None) == 0
    want = fg.fused_gru_fwd_plain(*inputs)
    for name, got, ref in zip(("h_all", "h_last", "gates"), outs, want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)
    zero = [i for i, n in enumerate(lens) if n == 0]
    np.testing.assert_array_equal(outs[1][zero].numpy(), h0[zero].numpy())
    # the wrapper's part: fold the last-state cotangent, transpose W, and
    # add the zero-length rows' dh_last to dh0
    dh_all, dh0_direct = fg.fold_last(cts[0], cts[1], lengths)
    wt = w.t().contiguous()
    grads = [torch.empty_like(a) for a in (x, w, h0)]
    scratch = [torch.empty(b, h), torch.empty(b, h)]
    assert lib.fused_gru_bwd_f32(
        *_ptrs(wt, h0, lengths, want[0], want[2], dh_all, *grads, *scratch),
        t, b, h, None) == 0
    grads[2] = grads[2] + dh0_direct
    ref_grads = fg.fused_gru_bwd_plain(*inputs[1:], want[0], want[2], *cts)
    for name, got, ref in zip(("dx", "dw", "dh0"), grads, ref_grads):
        np.testing.assert_allclose(
            got.numpy(), ref.numpy(), rtol=0,
            atol=ATOL * max(float(ref.abs().max()), 1.0), err_msg=name)
    # a zero-length row's dh_last reaches dh0 unchanged
    np.testing.assert_array_equal(grads[2][zero].numpy(),
                                  cts[1][zero].numpy())
