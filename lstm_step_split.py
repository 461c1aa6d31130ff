"""Where a step of the persistent fused-LSTM kernels spends its time.

Builds instrumented copies of ``csrc/fused_lstm.cu`` into
``build/lstm_step_split/`` (clock64 marks by thread 0 of every block at
each phase of a step of its first tile; nothing else changes) and runs
the forward and the backward at the LM's shape (T64 B64 H512,
chip_smoke.py's ragged lengths) on the card, then prints the mean cycles
of each phase over steps 10-53 and all blocks. Forward:

  A landed        the step start (after the barrier) to the first of
                  warp 0's two copy groups of its 64 k of h_{t-1} in
                  shared memory
  products        the rest of warp 0's gate product (3xTF32 mma.sync;
                  the second group lands behind the first's products)
  partials in     the other warps' products, the partials' stores and
                  the block barrier
  epilogue        the gates, the cell update, the masks and the store
                  of h_t
  barrier         the grid barrier's arrive, the other stores of the
                  step and the x prefetch, and the barrier's wait

Backward (a step walks t down):

  A landed, products   the same for the gate recompute from h_all[t-1]
  barrier wait    what is left of step t+1's grid barrier
  reduce          the sum of step t+1's 32 partials of dh_prev (copied
                  into shared memory), the other warps' products and the
                  block barriers
  epilogue        dh, dc, the dgates and their stores, the block barrier
  partial product warp 0's dgates W_strip^T and its stores
  arrive          the block barrier and the arrive of the grid barrier

Two more copies time the same steps without one part of the work (their
outputs are wrong and unchecked): ``no_a_copy`` never copies A (the
products read whatever shared memory holds) and ``no_products`` issues
no mma.sync (nor the operand splits and W reads that feed them). Their
differences from the instrumented kernel split the products into L2
reads and arithmetic. Two more time other TF32 splits of the operands
(``grid::split_tf32`` in csrc/grid_sync.cuh): ``rna_split`` rounds hi
and lo with cvt.rna.tf32.f32, ``trunc_split`` passes v itself as hi and
v less its truncation as lo (both read truncated by the tensor cores).
A measurement of the design, not a route of any op. Run on a machine
with the card and nvcc, from the repository root:

    python3 lstm_step_split.py

It first times mma_tf32 alone (16 independent multiplies a warp, 8 warps
a block, a block an SM): the rate the products could reach.
tests/test_torch_fused_lstm_cuda_source.py holds ``instrumented`` and
every variant's edits against the current source on the CPU.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "paddle_tpu_torch" / "csrc"
OUT = ROOT / "build" / "lstm_step_split"
FWD_PHASES = ("A landed", "products", "partials in", "epilogue")
BWD_PHASES = ("A landed", "products", "barrier wait", "reduce", "epilogue",
              "partial product")
MARKS = 8


def _edit(text, old, new):
    assert text.count(old) == 1, old
    return text.replace(old, new)


def instrumented(text: str) -> str:
    """fused_lstm.cu with the steps' phase marks (see the module doc)."""
    text = _edit(text, '#include "rnn_tile.cuh"\n', '''#include "rnn_tile.cuh"
__device__ unsigned long long* g_trace;
__device__ unsigned long long g_landed[1024];
#define MARK(k) if (threadIdx.x == 0 && i == 0 && g_trace) \\
  g_trace[((size_t)blockIdx.x * p.T + t) * 8 + (k)] = clock64();
#define MARK_LANDED(k) if (threadIdx.x == 0 && i == 0 && g_trace) \\
  g_trace[((size_t)blockIdx.x * p.T + t) * 8 + (k)] = g_landed[blockIdx.x];
''')
    text = _edit(text, '''      grid::cp_async_wait(1);
      __syncwarp();
      multiply(0, half);''', '''      grid::cp_async_wait(1);
      __syncwarp();
      if (threadIdx.x == 0 && c0 == s0) g_landed[blockIdx.x] = clock64();
      multiply(0, half);''')
    # forward
    text = _edit(text, '''      if (i > 0) __syncthreads();  // the last tile's epilogue read red
''', '''      if (i > 0) __syncthreads();  // the last tile's epilogue read red
      MARK(0)
''')
    text = _edit(text, '''      store_partial(sum, red);
      grid::cp_async_wait_all();  // x_t of the first tile
      __syncthreads();
      if (valid) {''', '''      MARK_LANDED(1) MARK(2)
      store_partial(sum, red);
      grid::cp_async_wait_all();  // x_t of the first tile
      __syncthreads();
      MARK(3)
      if (valid) {''')
    text = _edit(text, '''        }
      }
    }
    // other blocks read only h_t''', '''        }
      }
      MARK(4)
    }
    // other blocks read only h_t''')
    # backward
    text = _edit(text, '''      if (i > 0) __syncthreads();  // the last tile has read red and dg
''', '''      if (i > 0) __syncthreads();  // the last tile has read red and dg
      MARK(0)
''')
    text = _edit(text, '''      store_partial(sum, red);
      // step t+1's partials are in once its barrier has completed
      if (i == 0 && t + 1 < p.T) barrier.wait(arrived);
''', '''      MARK_LANDED(1) MARK(2)
      store_partial(sum, red);
      // step t+1's partials are in once its barrier has completed
      if (i == 0 && t + 1 < p.T) barrier.wait(arrived);
      MARK(3)
''')
    text = _edit(text, '''      grid::cp_async_wait_all();  // x_t of the first tile
      __syncthreads();
      float dgate[4] = {};''', '''      grid::cp_async_wait_all();  // x_t of the first tile
      __syncthreads();
      MARK(4)
      float dgate[4] = {};''')
    text = _edit(text, '''      __syncthreads();  // dg is complete
''', '''      __syncthreads();  // dg is complete
      MARK(5)
''')
    text = _edit(text, '''                      min(kRows, B - r0));
    }
    arrived = barrier.arrive();''', '''                      min(kRows, B - r0));
      MARK(6)
    }
    arrived = barrier.arrive();''')
    return text + '''
extern "C" int split_set_trace(void* ptr) {
  return cudaMemcpyToSymbol(g_trace, &ptr, sizeof(ptr));
}

// The rate of mma_tf32 alone: each warp of 8 issues n rounds of 16
// independent multiplies; cycles[block] = the block's clock64 span.
__global__ void __launch_bounds__(kThreads, 1)
split_mma_rate_kernel(long long* cycles, float* sink, int n) {
  float acc[16][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b[2] = {blockIdx.x, blockIdx.x + 1};
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) grid::mma_tf32(acc[j], a, b);
  float sum[4] = {}, lo[4] = {};
#pragma unroll
  for (int j = 0; j < 16; ++j) grid::promote(sum, acc[j], lo);
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  sink[blockIdx.x * kThreads + threadIdx.x] = sum[0] + sum[1] + sum[2] + sum[3];
}

extern "C" int split_mma_rate(long long* cycles, float* sink, int blocks,
                              int n) {
  const dim3 grid_rate(blocks);
  split_mma_rate_kernel<<<grid_rate, kThreads, 0, nullptr>>>(cycles, sink, n);
  return cudaGetLastError();
}
'''


SOURCE = "fused_lstm.cu"
COPY = "grid::cp_async16(dst, a32 + (size_t)r * H + k);"
MMA = """  grid::mma_tf32(la, al, bh);
  grid::mma_tf32(lb, ah, bl);
  grid::mma_tf32(hi, ah, bh);"""
SPLIT = """  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));"""
RNA_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo)
      : "f"(v - __uint_as_float(hi)));"""
TRUNC_SPLIT = """  hi = __float_as_uint(v);
  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u));"""
# each variant's edits: (file of csrc/, old, new)
VARIANTS = {
    "instrumented": [],
    "no_a_copy": [(SOURCE, COPY, ";")],
    "no_products": [(SOURCE, MMA, "")],
    "rna_split": [("grid_sync.cuh", SPLIT, RNA_SPLIT)],
    "trunc_split": [("grid_sync.cuh", SPLIT, TRUNC_SPLIT)],
}


def variant(name, text):
    """{file: text} of variant `name`: the instrumented source `text` and
    the headers of csrc/, each with the variant's edits."""
    files = {h.name: h.read_text() for h in CSRC.glob("*.cuh")}
    files[SOURCE] = text
    for file, old, new in VARIANTS[name]:
        files[file] = _edit(files[file], old, new)
    return files


def build(name, text):
    """Compile one copy with the port's nvcc flags; its ctypes library."""
    from paddle_tpu_torch.ops.kernels import build as kbuild
    from paddle_tpu_torch.ops.kernels import fused_lstm as fl
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    for file, body in variant(name, text).items():
        (out / file).write_text(body)
    src, lib = out / SOURCE, out / "fused_lstm.so"
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    lib = fl.bind(ctypes.CDLL(str(lib)))
    lib.split_set_trace.argtypes = [ctypes.c_void_p]
    return lib


def _report(label, ms, tr, phases, steps, closing_label):
    """The mean cycles of each phase over `steps` (step order) of the
    traced blocks, and of the step's close (the next step's start less
    the last mark)."""
    tr = tr[tr[:, steps[0], 0] > 0]  # the blocks of the grid
    n = len(phases)
    cur, nxt = tr[:, steps[:-1], :], tr[:, steps[1:], :]
    step = nxt[:, :, 0] - cur[:, :, 0]
    print(f"{label}: {len(tr)} blocks, {ms:.4f} ms a call, a step "
          f"{step.mean():.0f} cycles", flush=True)
    for k, name in enumerate(phases):
        d = cur[:, :, k + 1] - cur[:, :, k]
        print(f"  {name:16s} {d.mean():8.0f} cycles", flush=True)
    print(f"  {closing_label:16s} {(nxt[:, :, 0] - cur[:, :, n]).mean():8.0f}"
          " cycles", flush=True)


def _mma_rate(lib, blocks=128, n=4096):
    """Print the cycles a mma_tf32 takes on an SM sub-partition (4 an SM,
    2 warps each here) when it issues nothing else."""
    import torch
    lib.split_mma_rate.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    cycles = torch.zeros(blocks, dtype=torch.int64, device="cuda")
    sink = torch.zeros(blocks * 256, device="cuda")
    for _ in range(2):  # the first launch warms up
        assert lib.split_mma_rate(cycles.data_ptr(), sink.data_ptr(), blocks,
                                  n) == 0
        torch.cuda.synchronize()
    per = cycles.double().mean().item() / (n * 16 * 8 / 4)
    print(f"mma_tf32 alone: {per:.2f} cycles a multiply on a sub-partition "
          f"({blocks} blocks of 8 warps, 16 independent chains a warp)",
          flush=True)


def main() -> int:
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import fused_lstm as fl
    if not torch.cuda.is_available():
        print("lstm_step_split: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    text = instrumented((CSRC / "fused_lstm.cu").read_text())
    _mma_rate(build("instrumented", text))
    gen = torch.Generator(device="cuda").manual_seed(2)
    t, b, h = cs.LSTM_T, cs.LSTM_BATCH, cs.LSTM_CFG["hid_dim"]
    inputs, cts = cs._lstm_inputs(gen, t, b, h, cs.lm_lengths()[1], False,
                                  False)
    saved = fl.fused_lstm_fwd_plain(*inputs)[:2]
    trace = torch.zeros(1024 * t * MARKS, dtype=torch.int64, device="cuda")
    library = fl._library
    try:
        for name in VARIANTS:
            lib = build(name, text)
            fl._library = lambda lib=lib: lib
            for label, fn, phases, steps, closing in (
                    ("forward", lambda: fl.fused_lstm_fwd(*inputs),
                     FWD_PHASES, list(range(10, 54)), "barrier"),
                    ("backward", lambda: fl.fused_lstm_bwd(*inputs, *saved,
                                                           *cts),
                     BWD_PHASES, list(range(53, 9, -1)), "arrive")):
                lib.split_set_trace(None)
                ms = cs.cuda_ms(fn, iters=20)
                trace.zero_()
                lib.split_set_trace(trace.data_ptr())
                fn()
                torch.cuda.synchronize()
                lib.split_set_trace(None)
                tr = trace.view(1024, t, MARKS).cpu().numpy().astype(
                    np.float64)
                _report(f"{name} {label}", ms, tr, phases, steps, closing)
    finally:
        fl._library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
