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

The emulation (tests/test_torch_cuda_emulation.py, shared with the
fused-LSTM source test): a cooperative launch runs EVERY block of the
grid at once, one std::thread per CUDA thread, so the kernels' own grid
barrier (a sense-reversing counter, csrc/grid_sync.cuh) runs as written
over std::atomic_ref; __syncthreads is a std::barrier per block;
`extern __shared__` is each block's own buffer, filled with NaN bytes so
that a read of an unwritten word shows. The emulated card's SM count and
shared-memory limit are set per test (emu_configure), which is how the
fewer-blocks and streamed-W cases are reached at small shapes. A
`<<<...>>>` launch (the dW kernel) runs one block at a time. It says
nothing about speed, about races that only a card's timing shows, or
about the device compiler; chip_smoke.py runs the real kernels on the
card.

Tolerance: float32, the same sums in another order: 1e-5 absolute
forward, 1e-5 * max(|plain|, 1) backward.
"""
import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_gru as fg
from paddle_tpu_torch.ops.kernels import fused_lstm as fl
from test_torch_cuda_emulation import compile_grid_cuda

SOURCE = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc" \
    / "fused_gru.cu"
ATOL = 1e-5
# the emulated card: an H100's SM count and opt-in shared memory per block
SMS, SMEM = 132, 232448

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


def compile_source(out: Path, text: str) -> ctypes.CDLL:
    """`text` (a version of fused_gru.cu) compiled against the emulation
    into out/, loaded, with its C entry points' argument types set."""
    lib = ctypes.CDLL(str(compile_grid_cuda(out, text, "fused_gru")))
    lib.fused_gru_fwd_f32.argtypes = ([ctypes.c_void_p] * 10
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p] * 2)
    lib.fused_gru_bwd_f32.argtypes = ([ctypes.c_void_p] * 13
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p] * 2)
    lib.fused_gru_fwd_bf16.argtypes = lib.fused_gru_fwd_f32.argtypes
    lib.fused_gru_bwd_bf16.argtypes = ([ctypes.c_void_p] * 15
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


def _bf16(*shape):
    return torch.full(shape, float("nan"), dtype=torch.bfloat16)


def run_bf16(lib, inputs, cts):
    """The bf16 entry points on the emulated card: bf16 x and cotangents
    (the streams), float32 w and h0 as the wrapper passes them; the
    backward reads the plain forward's bf16 h_all and x (no gates: it
    recomputes them). Returns (h_all, h_last rounded as the wrapper
    rounds it), (dx, dw, dh0 with the zero-length rows' dh_last added),
    and the backward's recomputed-gates and float32-dgates scratch."""
    x, w, h0, lengths = inputs
    t, b, g3 = x.shape
    h = g3 // 3
    lib.emu_configure(SMS, SMEM)
    h_all, h_last, gates = _bf16(t, b, h), _nan(b, h), _nan(t, b, 3 * h)
    scratch = [_nan(b, h) for _ in range(4)]
    sync = torch.full((lib.fused_gru_sync_words(b),), 7, dtype=torch.int32)
    plan = (ctypes.c_int * 9)()
    assert lib.fused_gru_fwd_bf16(
        *_ptrs(*inputs, h_all, h_last, gates, *scratch[:2], sync), t, b, h,
        ctypes.addressof(plan), None) == 0
    want = fg.fused_gru_fwd_plain(*inputs)
    dh_all, dh0_direct = fg.fold_last(cts[0], cts[1], lengths)
    dx, dw, dh0 = _bf16(t, b, 3 * h), _nan(h, 3 * h), _nan(b, h)
    recomputed, dgates = _nan(t, b, 3 * h), _nan(t, b, 3 * h)
    splits = lib.fused_gru_dw_splits(t, b, h)
    dw_parts = _nan(splits, h, 3 * h)
    assert lib.fused_gru_bwd_bf16(
        *_ptrs(x, w, h0, lengths, want[0], recomputed, dh_all, dx, dgates,
               dw, dh0, *scratch[2:], dw_parts, sync), t, b, h, splits,
        ctypes.addressof(plan), None) == 0
    return ((h_all, h_last.to(torch.bfloat16)), (dx, dw, dh0 + dh0_direct),
            recomputed, dgates)


# (T, B, H, lengths) of the bf16 arm: a zero-length row, B above one row
# tile, H off the tile edge and across two gate-recompute tiles
BF16_CASES = [(3, 2, 16, [3, 0]), (4, 18, 24, [i % 5 for i in range(18)])]


@pytest.mark.parametrize("t,b,h,lens", BF16_CASES)
def test_cuda_source_bf16_matches_plain_twins(lib, t, b, h, lens):
    """The bf16 entry points against the twins in bf16 (bf16 streams,
    float32 w and h0): h_all, h_last and dx within one bf16 ulp plus 1e-5
    of their sum of |terms|, dW and dh0 at the float32 tolerance. The
    backward recomputes the gates at the stored, rounded h_all (its
    scratch equals the twin's recompute, not the forward's gates) and
    sums dW from the float32 dgates (dW from the rounded dx would miss)."""
    inputs, cts = _inputs(t, b, h, lens, seed=31 + h)
    inputs = (inputs[0].bfloat16(),) + inputs[1:]
    cts = [c.bfloat16() for c in cts]
    outs, grads, recomputed, dgates = run_bf16(lib, inputs, cts)
    x, w, h0, lengths = inputs
    want = fg.fused_gru_fwd_plain(*inputs)
    h_prev = torch.cat([h0[None], want[0][:-1].float()])
    fwd_terms = fl.step_terms(h_prev, w, x)
    for name, got, ref in zip(("h_all", "h_last"), outs, want):
        assert got.dtype == torch.bfloat16
        assert fl.bf16_excess(got, ref, fwd_terms) <= 1.0, name
    gates = fg.gates_plain(x, w, h0, want[0])
    np.testing.assert_allclose(recomputed.numpy(), gates.numpy(), rtol=0,
                               atol=ATOL)
    assert float((want[2] - gates).abs().max()) > 10 * ATOL
    ref = fg.fused_gru_bwd_plain(w, h0, lengths, want[0], None, *cts, x=x)
    dh_all, _ = fg.fold_last(cts[0], cts[1], lengths)
    bwd_terms = fl.step_terms(ref[0].float(), w.t(), dh_all)
    assert grads[0].dtype == torch.bfloat16
    assert fl.bf16_excess(grads[0], ref[0], bwd_terms) <= 1.0, "dx"
    for name, got, r in zip(("dw", "dh0"), grads[1:], ref[1:]):
        np.testing.assert_allclose(
            got.numpy(), r.numpy(), rtol=0,
            atol=ATOL * max(float(r.abs().max()), 1.0), err_msg=name)
    assert torch.equal(dgates.to(torch.bfloat16), grads[0])
    rows = h_prev.reshape(-1, h)
    rounded = rows.t() @ grads[0].float().reshape(-1, 3 * h)[:, :2 * h]
    assert float((rounded - ref[1][:, :2 * h]).abs().max()) > \
        ATOL * max(float(ref[1].abs().max()), 1.0)


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
