"""The CUDA source of the fused conv + BN kernels, run on the CPU.

paddle_tpu_torch/csrc/fused_conv.cu compiles only for a card, but its
logic — the 128-row tiles and both column tiles, the implicit-GEMM tap
gather with its edge masks, the prologue before the mask, the masked
rows and columns past M and N, the per-tile partial statistics and their
reduction in tile order — is plain C++ over a small CUDA subset. This
test compiles the source with the host C++ compiler against a small
emulation of that subset (one block at a time, one std::thread per CUDA
thread, std::barrier for __syncthreads, __shared__ as a static shared by
the block's threads) and holds both C entry points against the plain
twins of ops/kernels/fused_conv.py: M not a multiple of the 128-row tile
and more than one row tile, images smaller than a tile and tiles that
cross image boundaries, a 1x1 image (every off-centre tap masked), odd C,
N on both sides of the 128-column switch, ReLU without the affine, and
stats off. A mutation check applies the affine after the edge mask (a
padded tap becomes relu(b)) and must be caught. It says nothing about
speed or about the device compiler; chip_smoke.py runs the real kernels
on the card.

Tolerance: float32, the same products summed in another order: outputs
atol 1e-5 * max(|plain|, 1), statistics 1e-5 of the sum of |terms|.
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
#include <barrier>
#include <cmath>
#include <cstring>
#include <math.h>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
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

# kernel<<<grid, threads, smem, stream>>>(args), the kernel name possibly
# with template arguments -> emu_launch(kernel, grid, threads, args)
_LAUNCH = re.compile(
    r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>\(")

# the prologue applied after the edge mask: the mutant to catch
_MASK_THEN_AFFINE = (
    "    if (hh < 0 || hh >= H || ww < 0 || ww >= W) return 0.f;",
    "    if (hh < 0 || hh >= H || ww < 0 || ww >= W) {\n"
    "      float z = a != nullptr ? b[c] : 0.f;\n"
    "      return relu ? fmaxf(z, 0.f) : z;\n"
    "    }")


def _compile(out: Path, text: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the CUDA source with")
    (out / "cuda_runtime.h").write_text(EMULATION)
    src = _LAUNCH.sub(r"emu_launch(\1, \2, \3, ", text)
    assert "<<<" not in src
    (out / "fused_conv.cpp").write_text(src)
    so = out / "libfused_conv.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(out), "-o", str(so), str(out / "fused_conv.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.fused_conv1x1_f32.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p])
    lib.fused_conv3x3_f32.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
    assert lib.fused_conv_row_tile() == ROW_TILE
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("fused_conv_emulated"),
                    SOURCE.read_text())


def _inputs(m, c, n, k_rows, affine, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, c, generator=g)
    w = torch.randn(k_rows, n, generator=g) * 0.2
    if not affine:
        return x, w, None, None
    return (x, w, torch.rand(c, generator=g) + 0.5,
            torch.randn(c, generator=g) * 0.5 + 0.3)


def _call(lib, three, x, w, a, b, n, relu, stats, img=(1, 1)):
    """Run one C entry point on CPU buffers: (out, stats or None)."""
    m, c = x.shape
    out = torch.empty(m, n)
    st = torch.empty(2, n) if stats else None
    part = torch.empty(-(-m // ROW_TILE), 2, n) if stats else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    common = [ptr(x), ptr(w), ptr(a), ptr(b), ptr(out), ptr(part), ptr(st)]
    if three:
        err = lib.fused_conv3x3_f32(*common, m, c, n, img[0], img[1],
                                    int(relu), None)
    else:
        err = lib.fused_conv1x1_f32(*common, m, c, n, int(relu), None)
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


def test_affine_after_mask_mutant_is_caught(tmp_path):
    """The same source with the prologue applied after the edge mask (a
    padded tap reads relu(b) in place of 0) disagrees with the plain twin
    on the edge pixels, and only there."""
    text = SOURCE.read_text()
    assert text.count(_MASK_THEN_AFFINE[0]) == 1
    mutant = _compile(tmp_path, text.replace(*_MASK_THEN_AFFINE))
    nb, h, w_, c, n = 2, 7, 7, 5, 48
    x, w, a, b = _inputs(nb * h * w_, c, n, 9 * c, True, seed=1)
    got, _ = _call(mutant, True, x, w, a, b, n, True, False, img=(h, w_))
    want, _ = fc.conv3x3_bn_act_plain(x, w, h, w_, a, b, True, False)
    diff = (got - want).abs().reshape(nb, h, w_, n).amax(dim=(0, 3))
    interior = diff[1:-1, 1:-1]
    assert float(interior.max()) <= RTOL * float(want.abs().max())
    edge = torch.cat([diff[0], diff[-1], diff[:, 0], diff[:, -1]])
    assert float(edge.min()) > 1e-2
