"""The CUDA source of the fused-LSTM kernels, run on the CPU.

paddle_tpu_torch/csrc/fused_lstm.cu compiles only for a card, but its
logic — tiles, ragged edges, the staged and prefetched products, the
per-step masks and carries, the dW/db reduction — is plain C++ over a
small CUDA subset. This test compiles the unchanged source with the host
C++ compiler against a small emulation of that subset (one block at a
time, one std::thread per CUDA thread, std::barrier for __syncthreads,
__shared__ as a static shared by the block's threads) and holds both C
entry points against the plain twins of ops/kernels/fused_lstm.py, over
shapes off every tile edge, zero-length rows, T = 1, B > one row tile
and nonzero initial states and last-state cotangents. It says nothing
about speed or about the device compiler; chip_smoke.py runs the real
kernels on the card.

Tolerance: float32, the same sums in another order: 1e-5 absolute
forward, 1e-5 * max(|plain|, 1) backward (measured: <= 8.4e-7).
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_lstm as fl

SOURCE = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc" \
    / "fused_lstm.cu"
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
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(threads);
      emu_barrier = &bar;
      std::vector<std::thread> team;
      for (int t = 0; t < threads; ++t)
        team.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          kernel(args...);
        });
      for (auto& th : team) th.join();
    }
}
"""

# kernel<<<grid, threads, smem, stream>>>(args) -> emu_launch(kernel, grid,
# threads, args)
_LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>\(")

# (T, B, H, lengths)
CASES = [
    (3, 2, 16, [3, 0]),
    (5, 3, 40, [5, 2, 4]),
    (2, 35, 9, [i % 3 for i in range(35)]),
    (1, 5, 16, [1, 0, 1, 1, 0]),
    (3, 33, 130, [i % 4 for i in range(33)]),
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the CUDA source with")
    out = tmp_path_factory.mktemp("fused_lstm_emulated")
    (out / "cuda_runtime.h").write_text(EMULATION)
    src = _LAUNCH.sub(r"emu_launch(\1, \2, \3, ", SOURCE.read_text())
    assert "<<<" not in src
    (out / "fused_lstm.cpp").write_text(src)
    so = out / "libfused_lstm.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(out), "-I", str(SOURCE.parent), "-o",
                    str(so), str(out / "fused_lstm.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.fused_lstm_fwd_f32.argtypes = ([ctypes.c_void_p] * 11
                                       + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p])
    lib.fused_lstm_bwd_f32.argtypes = ([ctypes.c_void_p] * 16
                                       + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p])
    return lib


def _inputs(t, b, h, lens, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, b, 4 * h, generator=g) * 0.5
    w = torch.randn(h, 4 * h, generator=g) * 0.3
    bias = torch.randn(4 * h, generator=g) * 0.1
    h0 = torch.randn(b, h, generator=g) * 0.5
    c0 = torch.randn(b, h, generator=g) * 0.5
    cts = [torch.randn(t, b, h, generator=g), torch.randn(t, b, h, generator=g),
           torch.randn(b, h, generator=g), torch.randn(b, h, generator=g)]
    return (x, w, bias, h0, c0, torch.tensor(lens, dtype=torch.int32)), cts


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


@pytest.mark.parametrize("t,b,h,lens", CASES)
def test_cuda_source_matches_plain_twins(lib, t, b, h, lens):
    inputs, cts = _inputs(t, b, h, lens, seed=len(lens) + h)
    x, w, bias, h0, c0, lengths = inputs
    outs = [torch.empty(t, b, h), torch.empty(t, b, h), torch.empty(b, h),
            torch.empty(b, h)]
    scratch = torch.empty(b, h)
    assert lib.fused_lstm_fwd_f32(*_ptrs(*inputs, *outs, scratch), t, b, h,
                                  None) == 0
    want = fl.fused_lstm_fwd_plain(*inputs)
    for name, got, ref in zip(("h_all", "c_all", "h_last", "c_last"), outs,
                              want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)
    # the wrapper's part: fold the last-state cotangents, transpose W
    dh_all, dc_all = fl.fold_last(*cts, lengths)
    wt = w.t().contiguous()
    grads = [torch.empty_like(a) for a in (x, w, bias, h0, c0)]
    assert lib.fused_lstm_bwd_f32(
        *_ptrs(x, w, wt, bias, h0, c0, lengths, want[0], want[1], dh_all,
               dc_all, *grads), t, b, h, None) == 0
    ref_grads = fl.fused_lstm_bwd_plain(*inputs, want[0], want[1], *cts)
    for name, got, ref in zip(("dx", "dw", "db", "dh0", "dc0"), grads,
                              ref_grads):
        np.testing.assert_allclose(
            got.numpy(), ref.numpy(), rtol=0,
            atol=ATOL * max(float(ref.abs().max()), 1.0), err_msg=name)
