"""The CUDA source of the fused-LSTM kernels, run on the CPU.

paddle_tpu_torch/csrc/fused_lstm.cu compiles only for a card, but its
logic — the persistent forward and backward kernels' tiles, ragged edges,
swizzled W strips (resident and streamed), per-warp A buffers, x prefetch
slots, ping-pong state and partials, the grid barrier, carries and masks,
the 3xTF32 products, and the dW/db reduction with its row splits — is
plain C++ over a small CUDA subset plus the PTX helpers of
csrc/grid_sync.cuh. This test compiles the unchanged source with the host
C++ compiler against the emulation of tests/test_torch_cuda_emulation.py
(shared with the fused-GRU source test): a cooperative launch runs EVERY
block of the grid at once, one std::thread per CUDA thread, so the grid
barrier runs as written; mma.sync m16n8k8 follows the PTX ISA's fragment
layout and truncates its float32 sums, as the tensor cores do. It holds
both C entry points against the plain twins of ops/kernels/fused_lstm.py
over shapes off every tile edge, zero-length rows, T = 1, B above one row
tile and nonzero initial states and last-state cotangents; a grid of
fewer blocks than tiles (each block walks several tiles of two strips,
and dW sums two row splits); a W strip that does not fit in shared
memory; and a rerun, which must be bitwise equal. It also holds
lstm_step_split.py's edits of the source (phase marks, variants) against
the current file and runs the marked source. It says nothing about
speed, about races that only a card's timing shows, or about the device
compiler; chip_smoke.py runs the real kernels on the card.

Tolerance: float32 (3xTF32), the same sums in another order: 1e-5
absolute forward, 1e-5 * max(|plain|, 1) backward.
"""
import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_lstm as fl
from test_torch_cuda_emulation import compile_grid_cuda, mutate

SOURCE = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc" \
    / "fused_lstm.cu"
ATOL = 1e-5
# the emulated card: an H100's SM count and opt-in shared memory per block
SMS, SMEM = 132, 232448
# bytes of the kernels' fixed buffers (A, partials, x slots; the
# backward's dgates) and of a k-step of 8 W rows (csrc/fused_lstm.cu)
FWD_FIXED, BWD_FIXED, STEP_BYTES = 79872, 84224, 2048

# (T, B, H, lengths)
CASES = [
    (3, 2, 16, [3, 0]),
    (5, 3, 40, [5, 2, 4]),
    (2, 35, 9, [i % 3 for i in range(35)]),
    (1, 5, 16, [1, 0, 1, 1, 0]),
    (3, 33, 130, [i % 4 for i in range(33)]),
]


def compile_source(out: Path, text: str) -> ctypes.CDLL:
    """`text` (a version of fused_lstm.cu) compiled against the emulation
    into out/, loaded, with its C entry points' argument types set."""
    lib = fl.bind(ctypes.CDLL(str(compile_grid_cuda(out, text,
                                                    "fused_lstm"))))
    lib.emu_configure.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return compile_source(tmp_path_factory.mktemp("fused_lstm_emulated"),
                          SOURCE.read_text())


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


def _nan(*shape):
    return torch.full(shape, float("nan"))


def run_kernels(lib, inputs, cts, sms=SMS, smem=SMEM, traces=None):
    """Both C entry points on the emulated card with `sms` SMs and `smem`
    bytes of shared memory a block: (forward outputs, backward outputs,
    forward plan, backward plan + [the dW reduction's row splits]). The
    backward reads the plain forward's h_all and c_all; the wrapper's part
    (fold the last-state cotangents) is done here. Outputs and scratch
    start as NaN, the barriers' counters as garbage (the calls zero
    them). traces: the phase marks' buffers of the forward and the
    backward (an instrumented source, see lstm_step_split.py)."""
    x, w, bias, h0, c0, lengths = inputs
    t, b, g4 = x.shape
    h = g4 // 4
    lib.emu_configure(sms, smem)
    outs = [_nan(t, b, h), _nan(t, b, h), _nan(b, h), _nan(b, h)]
    h_pong = _nan(b, h)
    assert lib.fused_lstm_sync_words(b) == 32 * -(-b // 16)
    sync = torch.full((lib.fused_lstm_sync_words(b),), 12345,
                      dtype=torch.int32)
    fplan, bplan = (ctypes.c_int * 7)(), (ctypes.c_int * 7)()
    if traces:
        lib.split_set_trace(traces[0].data_ptr())
    assert lib.fused_lstm_fwd_f32(
        *_ptrs(*inputs, *outs, h_pong, sync), t, b, h,
        ctypes.addressof(fplan), None) == 0
    want = fl.fused_lstm_fwd_plain(*inputs)
    dh_all, dc_all = fl.fold_last(*cts, lengths)
    grads = [_nan(*a.shape) for a in (x, w, bias, h0, c0)]
    partials = _nan(lib.fused_lstm_partial_floats(b, h))
    splits = lib.fused_lstm_dw_splits(t, b, h)
    dw_parts = _nan(splits, (h + 1) * g4)
    if traces:
        lib.split_set_trace(traces[1].data_ptr())
    assert lib.fused_lstm_bwd_f32(
        *_ptrs(x, w, bias, h0, c0, lengths, want[0], want[1], dh_all, dc_all,
               *grads, partials, dw_parts, sync), t, b, h, splits,
        ctypes.addressof(bplan), None) == 0
    if traces:
        lib.split_set_trace(None)
    return outs, grads, list(fplan), list(bplan) + [splits]


def check(inputs, cts, outs, grads):
    want = fl.fused_lstm_fwd_plain(*inputs)
    for name, got, ref in zip(("h_all", "c_all", "h_last", "c_last"), outs,
                              want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)
    ref_grads = fl.fused_lstm_bwd_plain(*inputs, want[0], want[1], *cts)
    for name, got, ref in zip(("dx", "dw", "db", "dh0", "dc0"), grads,
                              ref_grads):
        np.testing.assert_allclose(
            got.numpy(), ref.numpy(), rtol=0,
            atol=ATOL * max(float(ref.abs().max()), 1.0), err_msg=name)


@pytest.mark.parametrize("t,b,h,lens", CASES)
def test_cuda_source_matches_plain_twins(lib, t, b, h, lens):
    inputs, cts = _inputs(t, b, h, lens, seed=len(lens) + h)
    outs, grads, fplan, bplan = run_kernels(lib, inputs, cts)
    # one block a tile, the whole W strip resident, T-1 and T barriers
    tiles = -(-b // 16) * -(-h // 16)
    assert fplan == [tiles, 1, SMS, tiles, fplan[4], h, t - 1]
    assert fplan[4] == FWD_FIXED + STEP_BYTES * -(-h // 8)
    assert bplan[:7] == [tiles, 1, SMS, tiles, fplan[4] + BWD_FIXED -
                         FWD_FIXED, h, t]
    check(inputs, cts, outs, grads)


def test_cuda_source_fewer_blocks_than_tiles(lib):
    """4 blocks for 3 x 3 tiles: a block walks 2 or 3 tiles over two W
    strips (one resident, one streamed), the later ones with x read from
    device memory and their c state and carries there; the dW reduction
    runs in two row splits of 160 rows."""
    t, b, h = 8, 40, 40
    lens = [i % 9 for i in range(b)]
    inputs, cts = _inputs(t, b, h, lens, seed=7)
    outs, grads, fplan, bplan = run_kernels(lib, inputs, cts, sms=4)
    assert fplan[:4] == [9, 1, 4, 4] and bplan[3] == 4
    assert bplan[7] == 2
    check(inputs, cts, outs, grads)


def test_cuda_source_streamed_w(lib):
    """A shared-memory limit under the W strip: the forward keeps 104 of
    its 160 rows resident, the backward 88, and both read the rest from
    device memory every step (dW's ring then holds 2 stages)."""
    t, b, h = 3, 5, 160
    lens = [3, 0, 1, 3, 2]
    inputs, cts = _inputs(t, b, h, lens, seed=11)
    smem = BWD_FIXED + 11 * STEP_BYTES
    outs, grads, fplan, bplan = run_kernels(lib, inputs, cts, smem=smem)
    assert (fplan[3], fplan[5]) == (10, 104)
    assert (bplan[3], bplan[4], bplan[5]) == (10, smem, 88)
    check(inputs, cts, outs, grads)


def test_cuda_source_rerun_is_bitwise_equal(lib):
    """The same call twice gives the same bits: every sum in a fixed
    order, no atomics but the barrier's counters."""
    t, b, h = 4, 20, 40
    lens = [i % 5 for i in range(b)]
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
        for backward, barriers in ((0, 2), (1, 3)):
            plan = (ctypes.c_int * 7)()
            assert lib.fused_lstm_barrier_floor(
                sync.data_ptr(), 3, 20, 40, backward,
                ctypes.addressof(plan), None) == 0
            assert list(plan)[3] == min(6, sms)
            assert list(plan)[6] == barriers
            # one counter a row group with a block a tile (2 x 3 tiles),
            # else one for the grid; sense-reversing: a counter's low bits
            # are 0 after each barrier, its top bit flipped once a barrier
            for i in counters:
                assert int(sync[i]) & 0x7fffffff == 0
                assert (int(sync[i]) >> 31) & 1 == barriers % 2


def _bf16(t):
    return torch.full(t, float("nan"), dtype=torch.bfloat16)


def run_bf16(lib, inputs, cts):
    """The bf16 entry points on the emulated card: bf16 x and cotangents
    (the streams), float32 w, b, h0, c0 as the wrapper passes them; the
    backward reads the plain forward's bf16 h_all and c_all. Returns
    (h_all, c_all, and h_last, c_last rounded as the wrapper rounds
    them),
    (dx, dw, db, dh0, dc0), the float32 dgates scratch."""
    x, w, bias, h0, c0, lengths = inputs
    t, b, g4 = x.shape
    h = g4 // 4
    lib.emu_configure(SMS, SMEM)
    h_all, c_all = _bf16((t, b, h)), _bf16((t, b, h))
    state = [_nan(b, h) for _ in range(3)]
    sync = torch.full((lib.fused_lstm_sync_words(b),), 7, dtype=torch.int32)
    plan = (ctypes.c_int * 7)()
    assert lib.fused_lstm_fwd_bf16(
        *_ptrs(*inputs, h_all, c_all, *state, sync), t, b, h,
        ctypes.addressof(plan), None) == 0
    want = fl.fused_lstm_fwd_plain(*inputs)
    dh_all, dc_all = fl.fold_last(*cts, lengths)
    grads = [_bf16(x.shape)] + [_nan(*a.shape) for a in (w, bias, h0, c0)]
    partials = _nan(lib.fused_lstm_partial_floats(b, h))
    splits = lib.fused_lstm_dw_splits(t, b, h)
    dw_parts = _nan(splits, (h + 1) * g4)
    dgates = _nan(t, b, g4)
    assert lib.fused_lstm_bwd_bf16(
        *_ptrs(x, w, bias, h0, c0, lengths, want[0], want[1], dh_all, dc_all,
               *grads, partials, dw_parts, dgates, sync), t, b, h, splits,
        ctypes.addressof(plan), None) == 0
    return ([h_all, c_all] + [s.to(torch.bfloat16) for s in state[:2]],
            grads, dgates)


# (T, B, H, lengths) of the bf16 arm: a zero-length row, B above one row
# tile, H off the tile edge
BF16_CASES = [(3, 2, 16, [3, 0]), (4, 18, 24, [i % 5 for i in range(18)])]


@pytest.mark.parametrize("t,b,h,lens", BF16_CASES)
def test_cuda_source_bf16_matches_plain_twins(lib, t, b, h, lens):
    """The bf16 entry points against the twins in bf16 (bf16 streams,
    float32 w, b, h0, c0): bf16 outputs within one bf16 ulp plus 1e-5 of
    their sum of |terms|, the float32 ones (dW, db, dh0, dc0) at the
    float32 tolerance. dW is summed from the float32 dgates, which the
    kernel leaves in its scratch: dW from the rounded dx would miss."""
    inputs, cts = _inputs(t, b, h, lens, seed=21 + h)
    inputs = (inputs[0].bfloat16(),) + inputs[1:]
    cts = [c.bfloat16() for c in cts]
    outs, grads, dgates = run_bf16(lib, inputs, cts)
    want = fl.fused_lstm_fwd_plain(*inputs)
    x, w, bias, h0, c0, lengths = inputs
    h_prev = torch.cat([h0[None], want[0][:-1].float()])
    fwd_terms = fl.step_terms(h_prev, w, x, bias)
    for name, got, ref in zip(("h_all", "c_all", "h_last", "c_last"), outs,
                              want):
        assert got.dtype == torch.bfloat16
        assert fl.bf16_excess(got, ref, fwd_terms) <= 1.0, name
    ref = fl.fused_lstm_bwd_plain(*inputs, want[0], want[1], *cts)
    dh_all, dc_all = fl.fold_last(*cts, lengths)
    bwd_terms = fl.step_terms(ref[0].float(), w.t(), dh_all, dc_all)
    assert grads[0].dtype == torch.bfloat16
    assert fl.bf16_excess(grads[0], ref[0], bwd_terms) <= 1.0, "dx"
    for name, got, r in zip(("dw", "db", "dh0", "dc0"), grads[1:], ref[1:]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(), r.numpy(), rtol=0,
            atol=ATOL * max(float(r.abs().max()), 1.0), err_msg=name)
    # the scratch holds the unrounded dgates, whose rounding is dx
    assert torch.equal(dgates.to(torch.bfloat16), grads[0])
    rows = h_prev.reshape(-1, h)
    rounded = rows.t() @ grads[0].float().reshape(-1, 4 * h)
    assert float((rounded - ref[1]).abs().max()) > \
        ATOL * max(float(ref[1].abs().max()), 1.0)


# the lo passes of 3xTF32 into the hi*hi accumulator, k-step by k-step
_LO_INTO_HI = [("""  grid::mma_tf32(la, al, bh);
  grid::mma_tf32(lb, ah, bl);""", """  grid::mma_tf32(hi, al, bh);
  grid::mma_tf32(hi, ah, bl);""")]


def _dh0_mean_error(lib):
    """dh0's mean |error| against the float64 twin, relative to max|dh0|:
    T = 1, so dh0 is the reduce of one step's partials, each a 64-deep
    product (8 k-steps a warp)."""
    t, b, h = 1, 16, 64
    inputs, cts = _inputs(t, b, h, [1] * b, seed=5)
    _, grads, _, _ = run_kernels(lib, inputs, cts)
    x, w, bias, h0, c0, lengths = (v.double() if v.is_floating_point() else v
                                   for v in inputs)
    ref = fl.fused_lstm_bwd_plain(x, w, bias, h0, c0, lengths,
                                  *fl.fused_lstm_fwd_plain(
                                      x, w, bias, h0, c0, lengths)[:2],
                                  *(c.double() for c in cts))
    return float((grads[3].double() - ref[3]).abs().mean()) / float(
        ref[3].abs().max())


def test_lo_passes_apart_cut_the_truncation_error(tmp_path, lib):
    """Each add into a tensor-core accumulator truncates to the running
    sum's ulp, so the kernels sum the lo passes of 3xTF32 in an
    accumulator of their own and add it to the hi*hi sum once; with the
    lo passes added into the hi*hi accumulator k-step by k-step, dh0 errs
    at least 1.5x more."""
    mutant = compile_source(tmp_path, mutate(SOURCE.read_text(), _LO_INTO_HI))
    assert _dh0_mean_error(mutant) > 1.5 * _dh0_mean_error(lib)


def _load_step_split():
    """lstm_step_split.py, which splits a step's time on the card by
    marking and editing copies of fused_lstm.cu."""
    path = SOURCE.parents[2] / "lstm_step_split.py"
    spec = importlib.util.spec_from_file_location("lstm_step_split", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


STEP_SPLIT = _load_step_split()


@pytest.mark.parametrize("variant", sorted(STEP_SPLIT.VARIANTS))
def test_step_split_edits_apply_to_the_source(variant):
    """Every edit of the step-split script (its marks, then each variant's
    own) still finds its one place in the current source."""
    text = STEP_SPLIT.instrumented(SOURCE.read_text())
    for k in range(7):
        assert f"MARK({k})" in text or f"MARK_LANDED({k})" in text
    files = STEP_SPLIT.variant(variant, text)
    assert set(files) >= {"fused_lstm.cu", "grid_sync.cuh", "rnn_tile.cuh"}


def test_step_split_marks_every_phase_and_changes_nothing(lib, tmp_path):
    """The instrumented source, on the emulated card: the same bits out
    as the source itself, and every phase of every step of every block
    marked in order (5 marks a forward step, 7 a backward step, a step
    after the one before: forward in t, backward in reverse)."""
    ilib = compile_source(tmp_path,
                          STEP_SPLIT.instrumented(SOURCE.read_text()))
    ilib.split_set_trace.argtypes = [ctypes.c_void_p]
    t, b, h = 4, 20, 64  # every warp has a k-step (H / 8 = 8 warps)
    lens = [i % 5 for i in range(b)]
    inputs, cts = _inputs(t, b, h, lens, seed=5)
    traces = [torch.zeros(1024 * t * STEP_SPLIT.MARKS, dtype=torch.int64)
              for _ in range(2)]
    marked = run_kernels(ilib, inputs, cts, traces=traces)
    plain = run_kernels(lib, inputs, cts)
    for a, c in zip(marked[0] + marked[1], plain[0] + plain[1]):
        assert torch.equal(a, c)
    blocks = marked[2][3]
    for trace, marks, order in ((traces[0], 5, range(t)),
                                (traces[1], 7, range(t - 1, -1, -1))):
        tr = trace.view(1024, t, STEP_SPLIT.MARKS)
        assert int(tr[blocks:].abs().sum()) == 0
        steps = tr[:blocks][:, list(order), :marks].reshape(blocks, -1)
        assert bool((steps > 0).all())
        assert bool((steps[:, 1:] >= steps[:, :-1]).all())
