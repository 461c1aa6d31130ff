"""The CUDA source of the fused-GRU kernels, run on the CPU.

paddle_tpu_torch/csrc/fused_gru.cu compiles only for a card, but its
logic — the persistent forward and backward kernels' tiles, ragged edges,
resident and streamed W strips, x prefetch slots, ping-pong state,
grid-wide barriers, carries and masks, and the two-part dW reduction — is
plain C++ over a small CUDA subset plus the PTX helpers of
csrc/grid_sync.cuh. This test compiles the unchanged source with the host
C++ compiler against a small emulation of that subset and holds both C
entry points against the plain twins of ops/kernels/fused_gru.py, over
shapes off every tile edge, zero-length and full-length rows, T = 1, B
above one row tile, a nonzero h0 and an h_last cotangent; a grid of fewer
blocks than tiles (each block walks several tiles, some of another W
strip, some past its x slots, and dW sums two row splits); a W strip
that does not fit in shared memory (streamed rows, A in two chunks); and
a rerun, which must be bitwise equal. It also holds gru_step_split.py's
edits of the source (phase marks, variants) against the current file and
runs the marked source.

The emulation: a cooperative launch runs EVERY block of the grid at once,
one std::thread per CUDA thread, so the kernels' own grid barrier (a
sense-reversing counter) runs as written over std::atomic_ref (the host
grid_sync.cuh: acquire-release add, acquire load); __syncthreads is a
std::barrier per block; `extern __shared__` is each block's own buffer,
filled with NaN bytes so that a read of an unwritten word shows. The
emulated card's SM count and shared-memory limit are set per test
(emu_configure), which is how the fewer-blocks and streamed-W cases are
reached at small shapes. A `<<<...>>>` launch (the dW kernel) runs one
block at a time. It says nothing about speed, about races that only a
card's timing shows, or about the device compiler; chip_smoke.py runs
the real kernels on the card.

Tolerance: float32, the same sums in another order: 1e-5 absolute
forward, 1e-5 * max(|plain|, 1) backward.
"""
import ctypes
import importlib.util
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
# the emulated card: an H100's SM count and opt-in shared memory per block
SMS, SMEM = 132, 232448

EMULATION = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstring>
#include <memory>
#include <thread>
#include <cstdlib>
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
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
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
inline thread_local unsigned char* emu_smem = nullptr;
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
// a warp shuffle through the block's exchange buffer, behind a barrier of
// the thread's warp (every lane of these kernels' warps shuffles)
inline thread_local float* emu_shfl = nullptr;
inline thread_local std::barrier<>* emu_warp_barrier = nullptr;
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int me = threadIdx.x;
  emu_shfl[me] = v;
  emu_warp_barrier->arrive_and_wait();
  const float r = emu_shfl[(me & ~31) | ((me & 31) ^ mask)];
  emu_warp_barrier->arrive_and_wait();
  return r;
}
// kernel<<<grid, threads, 0, stream>>>(...): one block at a time
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, int threads, A... args) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(threads);
        std::vector<std::thread> team;
        for (int t = 0; t < threads; ++t)
          team.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            blockDim = dim3(threads);
            gridDim = grid;
            emu_block_barrier = &bar;
            kernel(args...);
          });
        for (auto& th : team) th.join();
      }
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
// a cooperative launch runs every block of the grid at once, each with its
// own block barrier and dynamic shared memory (NaN bytes until written)
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(P...), A... args) {
  const dim3 grid = cfg->gridDim, block = cfg->blockDim;
  const size_t smem = cfg->dynamicSmemBytes;
  const unsigned blocks = grid.x * grid.y * grid.z, threads = block.x;
  bool cooperative = false;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    cooperative |= cfg->attrs[i].id == cudaLaunchAttributeCooperative &&
                   cfg->attrs[i].val.cooperative;
  if (!cooperative) std::abort();
  if (blocks > (unsigned)emu_sms || smem > (size_t)emu_smem_max)
    return cudaErrorCooperativeLaunchTooLarge;
  std::vector<std::unique_ptr<std::barrier<>>> bars, warps;
  std::vector<std::vector<float>> mem, shfl;
  for (unsigned b = 0; b < blocks; ++b) {
    bars.push_back(std::make_unique<std::barrier<>>(threads));
    for (unsigned w = 0; w < threads / 32; ++w)
      warps.push_back(std::make_unique<std::barrier<>>(32));
    mem.emplace_back(smem / sizeof(float) + 4, std::nanf(""));
    shfl.emplace_back(threads);
  }
  std::vector<std::thread> team;
  for (unsigned b = 0; b < blocks; ++b)
    for (unsigned t = 0; t < threads; ++t)
      team.emplace_back([&, b, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b % grid.x, b / grid.x % grid.y,
                        b / (grid.x * grid.y));
        blockDim = block;
        gridDim = grid;
        emu_block_barrier = bars[b].get();
        emu_smem = reinterpret_cast<unsigned char*>(mem[b].data());
        emu_shfl = shfl[b].data();
        emu_warp_barrier = warps[b * (threads / 32) + t / 32].get();
        kernel(args...);
      });
  for (auto& th : team) th.join();
  return 0;
}
"""

# csrc/grid_sync.cuh on the host: the barrier's gpu-scope add and load as
# std::atomic_ref operations (the waiting thread yields), ld.global.cg as
# a plain load, and the asynchronous copies as copies
GRID_SYNC = r"""
#pragma once
#include <cuda_runtime.h>
#include <atomic>
#include <cstring>
#include <thread>
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
}  // namespace grid
"""

# kernel<<<grid, threads, smem, stream>>>(args) -> emu_launch(kernel, grid,
# threads, args)
_LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>\(")
# extern __shared__ T name[]; -> the block's emulated dynamic shared memory
_DYN_SMEM = re.compile(r"extern\s+__shared__\s+(\w+)\s+(\w+)\[\];")

# (T, B, H, lengths): zero-length and full rows; H off the 16-unit tiles
# and across two dW tiles (H 70: 2H = 140 > 128); B across two row tiles;
# T = 1
CASES = [
    (3, 2, 16, [3, 0]),
    (4, 3, 9, [4, 2, 1]),
    (2, 18, 5, [i % 3 for i in range(18)]),
    (1, 5, 16, [1, 0, 1, 1, 0]),
    (3, 17, 70, [i % 4 for i in range(17)]),
]


def host_source(text):
    """fused_gru.cu as host C++: launches and dynamic shared memory
    rewritten for the emulation."""
    text = _LAUNCH.sub(r"emu_launch(\1, \2, \3, ", text)
    text = _DYN_SMEM.sub(
        r"\1* const \2 = reinterpret_cast<\1*>(emu_smem);", text)
    assert "<<<" not in text and "extern __shared__" not in text
    return text


def compile_source(out: Path, text: str) -> ctypes.CDLL:
    """`text` (a version of fused_gru.cu) compiled against the emulation
    into out/, loaded, with its C entry points' argument types set."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the CUDA source with")
    (out / "cuda_runtime.h").write_text(EMULATION)
    (out / "grid_sync.cuh").write_text(GRID_SYNC)
    (out / "fused_gru.cpp").write_text(host_source(text))
    so = out / "libfused_gru.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(out), "-I", str(SOURCE.parent), "-o",
                    str(so), str(out / "fused_gru.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.fused_gru_fwd_f32.argtypes = ([ctypes.c_void_p] * 10
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p] * 2)
    lib.fused_gru_bwd_f32.argtypes = ([ctypes.c_void_p] * 13
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p] * 2)
    lib.fused_gru_dw_splits.argtypes = [ctypes.c_int] * 3
    lib.fused_gru_sync_words.argtypes = [ctypes.c_int]
    lib.fused_gru_barrier_floor.argtypes = ([ctypes.c_void_p]
                                            + [ctypes.c_int] * 4
                                            + [ctypes.c_void_p] * 2)
    lib.emu_configure.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return compile_source(tmp_path_factory.mktemp("fused_gru_emulated"),
                          SOURCE.read_text())


def _inputs(t, b, h, lens, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, b, 3 * h, generator=g) * 0.5
    w = torch.randn(h, 3 * h, generator=g) * 0.3
    h0 = torch.randn(b, h, generator=g) * 0.5
    cts = [torch.randn(t, b, h, generator=g), torch.randn(b, h, generator=g)]
    return (x, w, h0, torch.tensor(lens, dtype=torch.int32)), cts


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _nan(*shape):
    return torch.full(shape, float("nan"))


def run_kernels(lib, inputs, cts, sms=SMS, smem=SMEM):
    """Both C entry points on the emulated card with `sms` SMs and `smem`
    bytes of shared memory a block: ((h_all, h_last, gates), (dx, dw,
    dh0), forward plan, backward plan + [the dW reduction's row
    splits]). The backward reads the plain
    forward's h_all and gates; the wrapper's part (fold the last-state
    cotangent, add the zero-length rows' dh_last to dh0) is done here.
    Scratch starts as NaN."""
    x, w, h0, lengths = inputs
    t, b, g3 = x.shape
    h = g3 // 3
    lib.emu_configure(sms, smem)
    outs = [_nan(t, b, h), _nan(b, h), _nan(t, b, 3 * h)]
    # scratch: rh and h_pong, then dh_cur and d_rh (held until each call
    # returns), and the barrier's counter, which the calls zero
    scratch = [_nan(b, h) for _ in range(4)]
    # the barriers' counters, one 32-word line a row group (the C
    # functions zero them)
    assert lib.fused_gru_sync_words(b) == 32 * -(-b // 16)
    sync = torch.full((lib.fused_gru_sync_words(b),), 12345,
                      dtype=torch.int32)
    fplan, bplan = (ctypes.c_int * 9)(), (ctypes.c_int * 9)()
    assert lib.fused_gru_fwd_f32(
        *_ptrs(*inputs, *outs, *scratch[:2], sync), t, b, h,
        ctypes.addressof(fplan), None) == 0
    want = fg.fused_gru_fwd_plain(*inputs)
    dh_all, dh0_direct = fg.fold_last(cts[0], cts[1], lengths)
    grads = [_nan(*a.shape) for a in (x, w, h0)]
    splits = lib.fused_gru_dw_splits(t, b, h)
    dw_parts = _nan(splits, h, 3 * h)
    assert lib.fused_gru_bwd_f32(
        *_ptrs(w, h0, lengths, want[0], want[2], dh_all, *grads,
               *scratch[2:], dw_parts, sync), t, b, h, splits,
        ctypes.addressof(bplan), None) == 0
    grads[2] = grads[2] + dh0_direct
    return outs, grads, list(fplan), list(bplan) + [splits]


def check(inputs, cts, outs, grads, lens):
    want = fg.fused_gru_fwd_plain(*inputs)
    for name, got, ref in zip(("h_all", "h_last", "gates"), outs, want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)
    zero = [i for i, n in enumerate(lens) if n == 0]
    np.testing.assert_array_equal(outs[1][zero].numpy(),
                                  inputs[2][zero].numpy())
    ref_grads = fg.fused_gru_bwd_plain(*inputs[1:], want[0], want[2], *cts)
    for name, got, ref in zip(("dx", "dw", "dh0"), grads, ref_grads):
        np.testing.assert_allclose(
            got.numpy(), ref.numpy(), rtol=0,
            atol=ATOL * max(float(ref.abs().max()), 1.0), err_msg=name)
    # a zero-length row's dh_last reaches dh0 unchanged
    np.testing.assert_array_equal(grads[2][zero].numpy(),
                                  cts[1][zero].numpy())


@pytest.mark.parametrize("t,b,h,lens", CASES)
def test_cuda_source_matches_plain_twins(lib, t, b, h, lens):
    inputs, cts = _inputs(t, b, h, lens, seed=len(lens) + h)
    outs, grads, fplan, bplan = run_kernels(lib, inputs, cts)
    # one block a tile, the whole W strip resident (in quads of 4 rows,
    # or of 4 columns of W_c and of W_ur), all of A staged at once
    tiles, quads = -(-b // 16) * -(-h // 16), -(-h // 4)
    assert fplan[:7] == [tiles, 1, SMS, tiles, fplan[4], quads, 4 * quads]
    assert bplan[3] == tiles and bplan[5] == quads + -(-2 * h // 4)
    assert (fplan[8], bplan[8]) == (2 * t - 1, 2 * t)
    check(inputs, cts, outs, grads, lens)


def test_cuda_source_fewer_blocks_than_tiles(lib):
    """3 blocks for 3 x 5 tiles: each block walks 5 tiles over two W
    strips (one resident, one streamed) and one tile past its 4 slots;
    the dW reduction runs in two row splits of 80 rows."""
    t, b, h = 4, 40, 70
    lens = [i % 5 for i in range(b)]
    inputs, cts = _inputs(t, b, h, lens, seed=7)
    outs, grads, fplan, bplan = run_kernels(lib, inputs, cts, sms=3)
    assert fplan[:4] == [15, 1, 3, 3] and fplan[7] == 4
    assert bplan[3] == 3 and bplan[9] == 2
    check(inputs, cts, outs, grads, lens)


def test_cuda_source_streamed_w(lib):
    """A shared-memory limit under the W strip: the forward keeps 27 of
    its 35 quads of rows resident, the backward 71 of its 105 quads of
    columns (all 35 of W_c's, 36 of W_ur's 70), and stage B's 280 k of A
    come in two chunks of 256 and 24."""
    t, b, h = 3, 5, 140
    lens = [3, 0, 1, 3, 2]
    inputs, cts = _inputs(t, b, h, lens, seed=11)
    outs, grads, fplan, bplan = run_kernels(lib, inputs, cts, sms=9,
                                            smem=36000)
    assert (fplan[3], fplan[5], fplan[6], fplan[7]) == (9, 27, 140, 1)
    assert (bplan[3], bplan[5], bplan[6]) == (9, 71, 256)
    check(inputs, cts, outs, grads, lens)


def test_cuda_source_rerun_is_bitwise_equal(lib):
    """The same call twice gives the same bits: every sum in a fixed
    order, no atomics but the barrier's counter."""
    t, b, h = 5, 20, 40
    lens = [i % 6 for i in range(b)]
    inputs, cts = _inputs(t, b, h, lens, seed=3)
    first = run_kernels(lib, inputs, cts, sms=4)
    second = run_kernels(lib, inputs, cts, sms=4)
    for a, c in zip(first[0] + first[1], second[0] + second[1]):
        assert torch.equal(a, c)


def test_barrier_floor_runs_the_plans_grid(lib):
    """The barrier floor's launch takes its kernel's plan and steps
    through the same number of the same barriers."""
    sync = torch.zeros(64, dtype=torch.int32)
    for sms, counters in ((SMS, (0, 32)), (4, (0,))):
        lib.emu_configure(sms, SMEM)
        for backward, barriers in ((0, 5), (1, 6)):
            plan = (ctypes.c_int * 9)()
            assert lib.fused_gru_barrier_floor(
                sync.data_ptr(), 3, 20, 40, backward,
                ctypes.addressof(plan), None) == 0
            assert list(plan)[3] == min(6, sms)
            assert list(plan)[8] == barriers
            # one counter a row group with a block a tile (2 x 3 tiles),
            # else one for the grid; sense-reversing: a counter's low bits
            # are 0 after each barrier, its top bit flipped once a barrier
            for i in counters:
                assert int(sync[i]) & 0x7fffffff == 0
                assert (int(sync[i]) >> 31) & 1 == barriers % 2


def _load_step_split():
    """gru_step_split.py, which splits a forward step's time on the card
    by marking and editing copies of fused_gru.cu."""
    path = SOURCE.parents[2] / "gru_step_split.py"
    spec = importlib.util.spec_from_file_location("gru_step_split", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


STEP_SPLIT = _load_step_split()


@pytest.mark.parametrize("variant", sorted(STEP_SPLIT.VARIANTS))
def test_step_split_edits_apply_to_the_source(variant):
    """Every edit of the step-split script (its marks, then each variant's
    own) still finds its one place in the current source."""
    text = STEP_SPLIT.instrumented(SOURCE.read_text())
    for i in range(STEP_SPLIT.MARKS):
        assert f"MARK({i})" in text or f"MARK_LANDED({i})" in text
    for old, new in STEP_SPLIT.VARIANTS[variant]:
        text = STEP_SPLIT._edit(text, old, new)


def test_step_split_marks_every_phase_and_changes_nothing(lib, tmp_path):
    """The instrumented source, on the emulated card: the same bits out
    as the source itself, and every phase of every step of every block
    marked in order."""
    ilib = compile_source(tmp_path,
                          STEP_SPLIT.instrumented(SOURCE.read_text()))
    ilib.split_set_trace.argtypes = [ctypes.c_void_p]
    t, b, h = 4, 20, 40
    lens = [i % 5 for i in range(b)]
    inputs, cts = _inputs(t, b, h, lens, seed=5)
    trace = torch.zeros(1024 * t * STEP_SPLIT.MARKS, dtype=torch.int64)
    assert ilib.split_set_trace(trace.data_ptr()) == 0
    marked = run_kernels(ilib, inputs, cts)
    assert ilib.split_set_trace(None) == 0
    plain = run_kernels(lib, inputs, cts)
    for a, c in zip(marked[0] + marked[1], plain[0] + plain[1]):
        assert torch.equal(a, c)
    blocks = marked[2][3]
    tr = trace.view(1024, t, STEP_SPLIT.MARKS)
    assert int(tr[blocks:].abs().sum()) == 0
    steps = tr[:blocks].reshape(blocks, -1)
    assert bool((steps > 0).all())
    assert bool((steps[:, 1:] >= steps[:, :-1]).all())
