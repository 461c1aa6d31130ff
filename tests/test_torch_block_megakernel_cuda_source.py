"""The CUDA source of the ghost-BN bottleneck block, run on the CPU.

paddle_tpu_torch/csrc/block_megakernel.cu compiles only for a card, but
its logic — the ghost-group-aligned row tiles with their masked tails,
the implicit-GEMM tap gather and its edge masks, the strided variant's
shared-memory window, the per-tile partial statistics and their
reduction per group, the four variants, the bfloat16 rounding points —
is plain C++ over a small CUDA subset. This test compiles the unchanged
source with the host C++ compiler against a small emulation of that
subset (one block at a time, one std::thread per CUDA thread,
std::barrier for __syncthreads, __shared__ as a static shared by the
block's threads, bfloat16 as a 16-bit struct rounding to nearest even)
and holds both C entry points against the plain twins of
ops/kernels/block_megakernel.py: tile 1, 2 and the whole batch, groups
of 9 to 140 rows (row tiles that would straddle groups if they were not
aligned to them, and a group longer than one 128-row tile), a 1x1 image
(every off-centre tap masked), an odd Cm, Cin over one 128-column tile,
every variant, and bfloat16. Two mutants must be caught: the BN affine
applied after the edge mask (a padded tap reads relu(b)), and statistics
taken over the whole batch in place of each group. It says nothing about
speed or about the device compiler; chip_smoke.py runs the real kernel on
the card.

Tolerance: float32, the same products summed in another order and
renormalized by three ghost BNs: max |kernel - twin| <= 1e-4 * max|twin|
(chip_smoke.py's limit on the card). bfloat16:
2 ulps of max|twin| (2 * 2^-7 * max|twin|): where the two orders of
summation straddle a rounding boundary of a tap or of h2, one value
moves by one ulp, and the output's own rounding adds another.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import block_megakernel as bm

SOURCE = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc" \
    / "block_megakernel.cu"
F32_RTOL = 1e-4
BF16_RTOL = 2 * 2.0 ** -7

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
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
inline thread_local dim3 threadIdx, blockIdx, gridDim, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
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
            gridDim = grid;
            blockDim = dim3(threads);
            kernel(args...);
          });
        for (auto& th : team) th.join();
      }
}
"""

BF16 = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = uint32_t(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
"""

# kernel<<<grid, threads, smem, stream>>>(args), the kernel name possibly
# with template arguments -> emu_launch(kernel, grid, threads, args)
_LAUNCH = re.compile(
    r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>\(")

# the BN affine applied after the edge mask (a padded tap reads relu(b))
_MASK_THEN_AFFINE = (
    "      if (hh < 0 || hh >= H || ww < 0 || ww >= W) return 0.f;",
    "      if (hh < 0 || hh >= H || ww < 0 || ww >= W)\n"
    "        return round_to<T>(fmaxf(ab[C + c], 0.f));")
# statistics over every group's row tiles and rows: full-batch BN
_WHOLE_BATCH_STATS = (
    "  const int first = g * tpg, count = tpg, n_rows = rows;",
    "  const int first = 0, count = tpg * gridDim.y, "
    "n_rows = rows * gridDim.y;")


def _compile(out: Path, text: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the CUDA source with")
    (out / "cuda_runtime.h").write_text(EMULATION)
    (out / "cuda_bf16.h").write_text(BF16)
    src = _LAUNCH.sub(r"emu_launch(\1, \2, \3, ", text)
    assert "<<<" not in src
    (out / "block_megakernel.cpp").write_text(src)
    so = out / "libblock_megakernel.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(out), "-o", str(so),
                    str(out / "block_megakernel.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for dt in ("f32", "bf16"):
        getattr(lib, f"block_megakernel_{dt}").argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.block_megakernel_workspace.argtypes = [ctypes.c_int] * 5
    lib.block_megakernel_workspace.restype = ctypes.c_longlong
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("block_megakernel_emulated"),
                    SOURCE.read_text())


def _inputs(n, h, w, cin, cm, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    x = t(rng.randn(n, h * w, cin) * 0.5)
    w1 = t(rng.randn(cin, cm) / np.sqrt(cin))
    w3 = t(rng.randn(9, cm, cm) / np.sqrt(9 * cm))
    w2 = t(rng.randn(cm, cin) / np.sqrt(cm))
    bns = [torch.from_numpy(np.stack([rng.rand(c) + 0.5,
                                      rng.randn(c) * 0.1 + 0.2]
                                     ).astype(np.float32))
           for c in (cm, cm, cin)]
    return x, w1, w3, w2, bns


def _call(lib, x, w1, w3, w2, bns, h, w, tile, variant):
    """Run the C entry point of x's dtype on CPU buffers."""
    n, hw, cin = x.shape
    cm = w1.shape[1]
    y = torch.empty_like(x)
    ws = torch.empty(lib.block_megakernel_workspace(n, hw, cin, cm, tile))
    dt = "f32" if x.dtype == torch.float32 else "bf16"
    err = getattr(lib, f"block_megakernel_{dt}")(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        *(p.data_ptr() for p in bns), y.data_ptr(), ws.data_ptr(), n, h, w,
        cin, cm, tile, bm.EPS, bm.VARIANTS.index(variant), None)
    assert err == 0
    return y


def _gap(got, want):
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


# (n, H, W, Cin, Cm, tile): groups of 9 and 18 rows (tile 1, 2), 6x6 at
# the whole batch (36 rows a group, 144 in all), a 10x14 group of 140
# rows (two row tiles, the second 12 rows long), a 1x1 image (every
# off-centre tap masked), an odd Cm with Cin over one 128-column tile
CASES = [
    (4, 3, 3, 16, 8, 1),
    (4, 3, 3, 16, 8, 2),
    (4, 6, 6, 12, 8, 4),
    (2, 10, 14, 8, 8, 1),
    (6, 1, 1, 12, 8, 2),
    (2, 4, 5, 136, 5, 1),
]


@pytest.mark.parametrize("n,h,w,cin,cm,tile", CASES)
def test_block_source_matches_plain_twin(lib, n, h, w, cin, cm, tile):
    x, w1, w3, w2, bns = _inputs(n, h, w, cin, cm, seed=n * h + w + cm)
    got = _call(lib, x, w1, w3, w2, bns, h, w, tile, "full")
    want = bm.bottleneck_block_plain(x, w1, w3, w2, *bns, h, w, tile=tile)
    assert _gap(got, want) <= F32_RTOL


@pytest.mark.parametrize("variant", bm.VARIANTS)
# (n, side, Cin, Cm, tile): 5x5 images in groups of 50 rows, and 12x12
# images in groups of 144 (a second row tile of 16 rows; the strided
# window's rows cross the tile edge)
@pytest.mark.parametrize("n,side,cin,cm,tile", [(4, 5, 16, 12, 2),
                                                (2, 12, 8, 8, 1)])
def test_micro_variants_match_their_twins(lib, variant, n, side, cin, cm,
                                          tile):
    x, w1, w3, w2, bns = _inputs(n, side, side, cin, cm, seed=7)
    got = _call(lib, x, w1, w3, w2, bns, side, side, tile, variant)
    want = bm.roll_micro_block_plain(x.reshape(-1, cin), w1, w3, w2, *bns,
                                     variant, side, tile)
    assert _gap(got, want.reshape(got.shape)) <= F32_RTOL


@pytest.mark.parametrize("variant", ["full", "strided"])
def test_bf16_source_matches_plain_twin(lib, variant):
    x, w1, w3, w2, bns = _inputs(4, 5, 5, 24, 16, seed=3,
                                 dtype=torch.bfloat16)
    got = _call(lib, x, w1, w3, w2, bns, 5, 5, 2, variant)
    want = bm.bottleneck_block_plain(x, w1, w3, w2, *bns, 5, 5, tile=2)
    assert got.dtype == torch.bfloat16
    assert _gap(got, want) <= BF16_RTOL


def test_affine_after_mask_mutant_is_caught(tmp_path):
    """The same source with the BN affine applied after the edge mask (a
    padded tap reads relu(b) in place of 0) disagrees with the twin on
    the edge pixels."""
    text = SOURCE.read_text()
    assert text.count(_MASK_THEN_AFFINE[0]) == 1
    mutant = _compile(tmp_path, text.replace(*_MASK_THEN_AFFINE))
    x, w1, w3, w2, bns = _inputs(2, 6, 6, 16, 8, seed=1)
    got = _call(mutant, x, w1, w3, w2, bns, 6, 6, 1, "full")
    want = bm.bottleneck_block_plain(x, w1, w3, w2, *bns, 6, 6, tile=1)
    assert _gap(got, want) > 1e-2


def test_whole_batch_statistics_mutant_is_caught(tmp_path):
    """The same source with the statistics taken over the whole batch
    disagrees with the twin at tile 1, and agrees with it where the tile
    is the whole batch (ghost BN is then batch BN)."""
    text = SOURCE.read_text()
    assert text.count(_WHOLE_BATCH_STATS[0]) == 1
    mutant = _compile(tmp_path, text.replace(*_WHOLE_BATCH_STATS))
    x, w1, w3, w2, bns = _inputs(4, 3, 3, 16, 8, seed=2)
    got = _call(mutant, x, w1, w3, w2, bns, 3, 3, 1, "full")
    want = bm.bottleneck_block_plain(x, w1, w3, w2, *bns, 3, 3, tile=1)
    assert _gap(got, want) > 1e-2
    got = _call(mutant, x, w1, w3, w2, bns, 3, 3, 4, "full")
    want = bm.bottleneck_block_plain(x, w1, w3, w2, *bns, 3, 3, tile=4)
    assert _gap(got, want) <= F32_RTOL
