"""Where a step of the persistent fused-GRU forward kernel spends its time.

Builds instrumented copies of ``csrc/fused_gru.cu`` into
``build/gru_step_split/`` (clock64 marks by thread 0 of every block at
each phase of a step; nothing else changes) and runs the forward at the
book model's shape (T80 B64 H512, chip_smoke.py's ragged lengths) on the
card, then prints the mean cycles of each phase over steps 10-69 and all
blocks:

  stage-1 A landed   the barrier (or the step start) to the first copy
                     group of h_{t-1}'s rows in shared memory
  stage-1 products   the rest of the copies, the FMA and the warps'
                     reduce-scatter
  stage-1 epilogue   u, r, rh and their stores
  barrier 1          the grid barrier between the stages
  stage-2 A landed, stage-2 products, stage-2 epilogue: the same for rh
  barrier 2          the step's closing barrier (with the x prefetch wait)

Two more copies time the same steps without one part of the work (their
outputs are wrong and unchecked): ``no_a_copy`` never copies A (the
products read whatever shared memory holds) and ``no_fma`` skips the
product loop. Their differences from the instrumented kernel split the
products into L2 reads and arithmetic. A measurement of the design, not
a route of any op. Run on a machine with the card and nvcc, from the
repository root:

    python3 gru_step_split.py

tests/test_torch_fused_gru_cuda_source.py holds ``instrumented`` and
every variant's edits against the current source on the CPU.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "paddle_tpu_torch" / "csrc"
OUT = ROOT / "build" / "gru_step_split"
PHASES = ("stage-1 A landed", "stage-1 products", "stage-1 epilogue",
          "barrier 1", "stage-2 A landed", "stage-2 products",
          "stage-2 epilogue")
MARKS = 8


def _edit(text, old, new):
    assert text.count(old) == 1, old
    return text.replace(old, new)


def instrumented(text: str) -> str:
    """fused_gru.cu with the step's phase marks (see the module doc)."""
    text = _edit(text, '#include "rnn_tile.cuh"\n', '''#include "rnn_tile.cuh"
__device__ unsigned long long* g_trace;
__device__ unsigned long long g_landed[1024];
#define MARK(i) if (threadIdx.x == 0 && g_trace) \\
  g_trace[((size_t)blockIdx.x * p.T + t) * 8 + (i)] = clock64();
#define MARK_LANDED(i) if (threadIdx.x == 0 && g_trace) \\
  g_trace[((size_t)blockIdx.x * p.T + t) * 8 + (i)] = g_landed[blockIdx.x];
''')
    text = _edit(text, '''        grid::cp_async_wait(kLag);
      }
      __syncthreads();''', '''        grid::cp_async_wait(kLag);
      }
      __syncthreads();
      if (threadIdx.x == 0 && k0 == 0 && sub == 0)
        g_landed[blockIdx.x] = clock64();''')
    text = _edit(text, '''    grid::cp_async_wait_all();
    // stage 1: u and r of each tile, rh = r h_{t-1}''', '''    grid::cp_async_wait_all();
    MARK(0)
    // stage 1: u and r of each tile, rh = r h_{t-1}''')
    text = _edit(text, '''          as);
      if (valid) {
        const float u = sigmoidf''', '''          as);
      MARK_LANDED(1) MARK(2)
      if (valid) {
        const float u = sigmoidf''')
    text = _edit(text, '''    barrier.sync();
    // stage 2: c of each tile''', '''    MARK(3)
    barrier.sync();
    MARK(4)
    // stage 2: c of each tile''')
    text = _edit(text, '''          as);
      if (valid) {
        const float c = tanhf''', '''          as);
      MARK_LANDED(5) MARK(6)
      if (valid) {
        const float c = tanhf''')
    text = _edit(text, '''    grid::cp_async_commit();
    if (t + 1 < p.T) barrier.sync();''', '''    grid::cp_async_commit();
    MARK(7)
    if (t + 1 < p.T) barrier.sync();''')
    return text + '''
extern "C" int split_set_trace(void* ptr) {
  return cudaMemcpyToSymbol(g_trace, &ptr, sizeof(ptr));
}
'''


COPY = "grid::cp_async16(dst, a + r * lda + k0 + 4 * q);"
FMA_ROWS = "for (int r = 0; r < 8; ++r) {\n          const float4 av"
VARIANTS = {
    "instrumented": [],
    "no_a_copy": [(COPY, ";")],
    "no_fma": [(FMA_ROWS, FMA_ROWS.replace("r < 8", "r < 0"))],
}


def build(name, text):
    """Compile one copy with the port's nvcc flags; its ctypes library."""
    from paddle_tpu_torch.ops.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    for old, new in VARIANTS[name]:
        text = _edit(text, old, new)
    src, lib = OUT / f"fused_gru_{name}.cu", OUT / f"fused_gru_{name}.so"
    src.write_text(text)
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import fused_gru as fg
    if not torch.cuda.is_available():
        print("gru_step_split: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    text = instrumented((CSRC / "fused_gru.cu").read_text())
    gen = torch.Generator(device="cuda").manual_seed(3)
    t, b, h = cs.GRU_T, cs.GRU_BATCH, cs.GRU_NMT_CFG["hid_dim"]
    inputs, _ = cs._gru_inputs(gen, t, b, h, cs.gru_lengths()[1], False,
                               False)
    trace = torch.zeros(1024 * t * MARKS, dtype=torch.int64, device="cuda")
    library = fg._library
    try:
        for name in VARIANTS:
            lib = _bind(build(name, text))
            fg._library = lambda lib=lib: lib
            lib.split_set_trace(None)
            ms = cs.cuda_ms(lambda: fg.fused_gru_fwd(*inputs), iters=20)
            trace.zero_()
            lib.split_set_trace(trace.data_ptr())
            fg.fused_gru_fwd(*inputs)
            torch.cuda.synchronize()
            lib.split_set_trace(None)
            tr = trace.view(1024, t, MARKS).cpu().numpy().astype(np.float64)
            tr = tr[tr[:, 10, 0] > 0]  # the blocks of the grid
            phases = np.diff(tr, axis=2)[:, 10:70, :]
            closing = tr[:, 11:71, 0] - tr[:, 10:70, MARKS - 1]
            step = tr[:, 11:71, 0] - tr[:, 10:70, 0]
            print(f"{name}: {len(tr)} blocks, forward {ms:.4f} ms a call, "
                  f"a step {step.mean():.0f} cycles", flush=True)
            for i, label in enumerate(PHASES):
                print(f"  {label:18s} {phases[:, :, i].mean():8.0f} cycles",
                      flush=True)
            print(f"  {'barrier 2':18s} {closing.mean():8.0f} cycles",
                  flush=True)
    finally:
        fg._library = library
    return 0


def _bind(lib):
    """lib with the argument types fused_gru_fwd's launch uses."""
    lib.fused_gru_fwd_f32.argtypes = ([ctypes.c_void_p] * 10
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p] * 2)
    lib.fused_gru_fwd_f32.restype = ctypes.c_int
    lib.fused_gru_error_string.argtypes = [ctypes.c_int]
    lib.fused_gru_error_string.restype = ctypes.c_char_p
    lib.split_set_trace.argtypes = [ctypes.c_void_p]
    return lib


if __name__ == "__main__":
    sys.exit(main())
