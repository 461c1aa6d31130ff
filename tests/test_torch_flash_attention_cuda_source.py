"""The CUDA sources of the flash-attention kernels, run on the CPU.

paddle_tpu_torch/csrc/flash_attention_fwd.cu and flash_attention_bwd.cu
compile only for a card, but their logic — the pack kernels' hi/lo TF32
planes in the rows and cols layouts with the keys (queries) permuted
within each group of 8, the ring of copy stages, the 128-byte-swizzled
tiles, A fragments from registers (Q; K and V of dk/dv and dO of dq,
read from shared memory; P and dS read in place from the accumulator
before) and from
shared tiles (Q at D = 128), the 3xTF32 passes, the online softmax over
the key tiles, the per-tile promotion of long sums, the masks in the
reference's order, the causal tile skips and the strided bias — is plain
C++ over a small CUDA subset plus the PTX helpers of csrc/sm90_mma.cuh.
This test compiles both sources against the emulation of
tests/test_torch_cuda_emulation.py (its multiplies truncate their
float32 sums, as the tensor cores do) and holds the C entry points
against the plain twins of ops/kernels/flash_attention.py run in
float64: every head dim, Sq != Sk, Sq = 1, lengths that are not tile
multiples, key-row, dense and head-broadcast biases, causal and not, and
a fully masked row, and dq's bias_grad mode (the full-shape ds, zeros on
the tiles the causal skip never computes). Seven mutants must be caught:
3xTF32 with its lo products dropped, the pack's permutation of each group
of 8 off by one (in the forward and in dq), dV or dq summed in one
truncating accumulator over a long reduction, and the lo and hi*hi
passes interleaved in dq, in the forward and in dk/dv (the error
against float64 grows). A model of the truncation
pins the promotion threshold (kPromoteAfter).

The bfloat16 entry points (the same sources; bf16 operands read straight
from the inputs or from a bf16 cols plane, one bf16 pass a k-step, P and
dS rounded to bf16 as the A fragments of their products, bf16 outputs)
are held against the bf16 twins by ROADMAP B1's rule over every head
dim, Sq != Sk, lengths off the 64-row tiles, biases and causal; with
q = 0 (every live p exactly 1 in both) the forward is held without the
rounding term; a mutant that takes P's bf16 fragments from the wrong
accumulator rows must be caught. It says nothing about speed or about
the device compiler; chip_smoke.py runs the real kernels on the card.

Tolerance: the float32 kernels against the float64 twin, max |diff| <=
1e-5 of max(max |twin|, 1) for each output (O, lse, dq, ds, dk, dv):
3xTF32 keeps about float32's digits, the float32 twin would differ by
~1e-6. The masked row is held against the float32 twin: its -1e9 bias
absorbs the scores in float32 (a uniform softmax, as the reference
computes), not in float64. The bf16 kernels against the bf16 twins, per
element: one bf16 ulp at the larger of the two plus 1e-5 of the
output's sum of |terms| plus one ulp of each rounded operand (p or ds)
times its partner (1.5 for O's p, rounded at another scale):
flash_attention.bf16_limits.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as fa
from test_torch_cuda_emulation import compile_cuda, mutate, \
    truncating_3xtf32

CSRC = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
FWD = CSRC / "flash_attention_fwd.cu"
BWD = CSRC / "flash_attention_bwd.cu"
TILES = "flash_tiles.cuh"
RTOL = 1e-5
# how many times the lo-first pass order's mean error an interleaved
# order errs, at least, under the emulated truncation of the tensor
# cores' sums (measured on the CPU: forward 2.35x, dk/dv 2.56x; dq's
# test asks 1.5x too)
FWD_LO_FIRST_GAIN = 1.5
DKV_LO_FIRST_GAIN = 1.5


def _compile(out: Path, which, text=None, tiles_text=None):
    """The forward ("fwd") or backward ("bwd") library, from `text` (the
    source by default) and `tiles_text` (flash_tiles.cuh by default)."""
    headers = {TILES: tiles_text or (CSRC / TILES).read_text()}
    src, bind = (FWD, fa.bind) if which == "fwd" else (BWD, fa.bind_bwd)
    return bind(ctypes.CDLL(str(compile_cuda(
        out, text or src.read_text(), f"flash_{which}", headers))))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("flash_emulated")
    return _compile(out, "fwd"), _compile(out, "bwd")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd(lib, q, k, v, bias, causal, scale):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bias, strides = fa._bias_strides(bias, (b, h, sq, sk), "test")
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq)
    scratch = torch.empty(lib.flash_attention_fwd_scratch_bytes(b, h, sq, sk,
                                                                d),
                          dtype=torch.uint8)
    err = lib.flash_attention_fwd_f32(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(o), _ptr(lse),
        _ptr(scratch), b, h, sq, sk, d, *strides, int(causal), scale, None)
    assert err == 0
    return o, lse


def _bwd(lib, which, q, k, v, bias, do, lse, delta, causal, scale,
         bias_grad=False):
    """dq (and, with bias_grad, the full-shape ds in a zero-filled buffer,
    as the wrapper allocates it: (dq, ds)) or (dk, dv)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bias, strides = fa._bias_strides(bias, (b, h, sq, sk), "test")
    if which == "dq":
        out1 = torch.empty_like(q)
        out2 = torch.zeros(b, h, sq, sk) if bias_grad else None
    else:
        out1, out2 = torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(getattr(
        lib, f"flash_attention_bwd_{which}_scratch_bytes")(b, h, sq, sk, d),
        dtype=torch.uint8)
    err = getattr(lib, f"flash_attention_bwd_{which}_f32")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(out1), _ptr(out2), _ptr(scratch), b, h, sq, sk, d,
        *strides, int(causal), scale, None)
    assert err == 0
    if which == "dq":
        return (out1, out2) if bias_grad else out1
    return out1, out2


def _inputs(b, h, sq, sk, d, bias_shape, seed, mask_row=False):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, sq, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, h, sk, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, h, sk, d), np.float32))
    do = torch.from_numpy(rng.standard_normal((b, h, sq, d), np.float32))
    bias = None
    if bias_shape is not None:
        bias = torch.from_numpy(rng.standard_normal(bias_shape, np.float32))
        if mask_row:   # every key of batch 0 masked: a uniform softmax
            bias[0] = -1e9
    return q, k, v, do, bias


def _hold(got, want, what):
    for name, g, w in zip(("first", "second"), got, want):
        lim = RTOL * max(float(w.abs().max()), 1.0)
        err = float((g.double() - w).abs().max())
        assert err <= lim, f"{what} {name} output: {err:.3e} > {lim:.3e}"


# (B, H, Sq, Sk, D, bias shape or None, causal, mask a row): every head
# dim, Sq != Sk, Sq = 1, lengths off the 64-row tiles and the 32- and
# 16-row query tiles of dk/dv, key-row, dense and head-broadcast biases
CASES = [
    (1, 2, 70, 50, 16, (1, 2, 70, 50), False, False),
    (2, 1, 1, 90, 32, (2, 1, 1, 90), False, False),
    (2, 1, 45, 37, 32, (2, 1, 1, 37), False, True),
    (1, 1, 100, 130, 64, None, True, False),
    (1, 2, 33, 80, 64, (1, 1, 33, 80), True, False),
    (1, 2, 65, 40, 128, (1, 2, 1, 40), True, False),
]


@pytest.mark.parametrize("b,h,sq,sk,d,bias_shape,causal,mask_row", CASES)
def test_kernels_match_float64_twins(libs, b, h, sq, sk, d, bias_shape,
                                     causal, mask_row):
    fwd, bwd = libs
    q, k, v, do, bias = _inputs(b, h, sq, sk, d, bias_shape, sq + sk + d,
                                mask_row)
    scale = 1.0 / np.sqrt(d)
    # a -1e9 bias absorbs every score of a masked row in float32 (the
    # uniform softmax the reference computes), not in float64: that case
    # is held against the twin in float32
    ref = torch.float32 if mask_row else torch.float64
    args64 = [t.to(ref) if t is not None else None for t in (q, k, v, bias)]
    o64, lse64 = fa.flash_attention_fwd_plain(*args64, causal, scale)
    what = f"B{b} H{h} Sq{sq} Sk{sk} D{d} bias {bias_shape} causal {causal}"
    o, lse = _fwd(fwd, q, k, v, bias, causal, scale)
    _hold((o, lse), (o64, lse64), f"forward {what}")

    delta64 = fa._delta(o64, do.to(ref))
    lse32, delta32 = lse64.float(), delta64.float()
    dq = _bwd(bwd, "dq", q, k, v, bias, do, lse32, delta32, causal, scale)
    dk, dv = _bwd(bwd, "dkv", q, k, v, bias, do, lse32, delta32, causal,
                  scale)
    dq64, _ = fa.flash_attention_bwd_dq_plain(*args64, do.to(ref), lse64,
                                              delta64, causal, scale)
    dk64, dv64 = fa.flash_attention_bwd_dkv_plain(*args64, do.to(ref),
                                                  lse64, delta64, causal,
                                                  scale)
    _hold((dq,), (dq64,), f"dq {what}")
    _hold((dk, dv), (dk64, dv64), f"dk/dv {what}")


def test_dq_bias_grad_matches_float64_twin(libs):
    """dq's bias_grad mode: ds written from the accumulator layout into the
    zero-filled full-shape buffer, zeros on the key tiles the causal skip
    never computes, against the twin's ds in float64 (Sq != Sk, lengths
    off the 64-query blocks and 32-key tiles)."""
    _, bwd = libs
    b, h, sq, sk, d = 1, 2, 70, 130, 32
    q, k, v, do, bias = _inputs(b, h, sq, sk, d, (b, h, sq, sk), 11)
    scale = 1.0 / np.sqrt(d)
    args64 = [t.double() for t in (q, k, v, bias)]
    o64, lse64 = fa.flash_attention_fwd_plain(*args64, True, scale)
    delta64 = fa._delta(o64, do.double())
    dq, ds = _bwd(bwd, "dq", q, k, v, bias, do, lse64.float(),
                  delta64.float(), True, scale, bias_grad=True)
    dq64, ds64 = fa.flash_attention_bwd_dq_plain(
        *args64, do.double(), lse64, delta64, True, scale, bias_grad=True)
    _hold((dq, ds), (dq64, ds64), "dq bias_grad")
    # the first query block's tiles past key 63, and the second's past
    # key 127, are never computed
    assert not ds[:, :, :64, 64:].any() and not ds[:, :, 64:, 128:].any()
    assert ds[:, :, :64, :64].abs().min() < ds[:, :, :64, :64].abs().max()


# 3xTF32 with its lo products dropped in the forward's Q.K^T: one TF32 pass
_DROP_LO = [("""          if (pass == 0) {
            sm90::wgmma<kBK, false>(s, ql[kq], kk, kq > 0);
            sm90::wgmma<kBK, false>(s, qh[kq], kl, 1);
          } else {
            sm90::wgmma<kBK, false>(s, qh[kq], kk, 1);
          }
""", """          if (pass == 1)
            sm90::wgmma<kBK, false>(s, qh[kq], kk, kq > 0);
""")]

# the pack's permutation of each group of 8 off by one place: every key
# (query) meets its neighbour's probability
_PERM_OFF = [("  return u < 4 ? 2 * u : 2 * (u - 4) + 1;",
              "  return u < 4 ? 2 * u + 1 : 2 * (u - 4);")]

# dK and dV summed in the tensor cores' accumulators over every query
# tile, with no rounding add
_NO_PROMOTION = [
    ("""        float part[C::kN / 2];
""", """        float (&part)[C::kN / 2] =
            *reinterpret_cast<float(*)[C::kN / 2]>(sum + n0 / 2);
"""),
    ("""              sm90::wgmma<C::kN, false>(part, fl[j], bj, j > 0);""",
     """              sm90::wgmma<C::kN, false>(part, fl[j], bj, 1);"""),
    ("""        for (int i = 0; i < C::kN / 2; ++i) sum[n0 / 2 + i] += part[i];""",
     """        for (int i = 0; i < C::kN / 2; ++i) (void)part[i];"""),
]


def _fwd_error(fwd, seed=5):
    q, k, v, _, bias = _inputs(1, 1, 70, 90, 64, (1, 1, 1, 90), seed)
    o, lse = _fwd(fwd, q, k, v, bias, False, 0.125)
    o64, _ = fa.flash_attention_fwd_plain(q.double(), k.double(), v.double(),
                                          bias.double(), False, 0.125)
    return float((o.double() - o64).abs().max()) / float(o64.abs().max())


def test_dropping_tf32_lo_terms_is_caught(tmp_path, libs):
    fwd = _compile(tmp_path, "fwd", mutate(FWD.read_text(), _DROP_LO))
    assert _fwd_error(libs[0]) <= RTOL
    assert _fwd_error(fwd) > 10 * RTOL


def _dq_error(bwd, seed=6):
    q, k, v, do, bias = _inputs(1, 1, 70, 90, 64, (1, 1, 1, 90), seed)
    args64 = (q.double(), k.double(), v.double(), bias.double())
    o64, lse64 = fa.flash_attention_fwd_plain(*args64, False, 0.125)
    delta64 = fa._delta(o64, do.double())
    dq = _bwd(bwd, "dq", q, k, v, bias, do, lse64.float(), delta64.float(),
              False, 0.125)
    dq64, _ = fa.flash_attention_bwd_dq_plain(*args64, do.double(), lse64,
                                              delta64, False, 0.125)
    return float((dq.double() - dq64).abs().max()) / float(dq64.abs().max())


def test_permutation_off_by_one_is_caught(tmp_path):
    """The forward's P.V and dq's dS.K both read the accumulator as the A
    fragment against a pack permuted by perm8."""
    tiles = mutate((CSRC / TILES).read_text(), _PERM_OFF)
    fwd = _compile(tmp_path, "fwd", tiles_text=tiles)
    assert _fwd_error(fwd) > 1e-2
    bwd = _compile(tmp_path, "bwd", tiles_text=tiles)
    assert _dq_error(bwd) > 1e-2

# dq summed in the tensor cores' accumulators over every key tile, with no
# rounding add
_DQ_NO_PROMOTION = [
    ("""      float pdq[C::kDqN / 2];
""", """      float (&pdq)[C::kDqN / 2] =
          *reinterpret_cast<float(*)[C::kDqN / 2]>(dq + n0 / 2);
"""),
    ("""            sm90::wgmma<C::kDqN, false>(pdq, fl[j], bj, j > 0);""",
     """            sm90::wgmma<C::kDqN, false>(pdq, fl[j], bj, 1);"""),
    ("""      for (int i = 0; i < C::kDqN / 2; ++i) dq[n0 / 2 + i] += pdq[i];""",
     """      for (int i = 0; i < C::kDqN / 2; ++i) (void)pdq[i];"""),
]


# every product's passes interleaved k-step by k-step (lo*hi, hi*lo,
# hi*hi), as the forward and dk/dv issue them
_DQ_INTERLEAVED = [
    ("""    for (int pass = 0; pass < 2; ++pass)
#pragma unroll
      for (int kq = 0; kq < kDSteps; ++kq) {""",
     """    for (int kq = 0; kq < kDSteps; ++kq)
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {"""),
    ("""      for (int pass = 0; pass < 2; ++pass)  // lo passes first, as for S
#pragma unroll
        for (int i = 0; i < C::kGroup; ++i) {""",
     """      for (int i = 0; i < C::kGroup; ++i)
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {"""),
    ("""      for (int pass = 0; pass < 2; ++pass)  // lo passes first, as for S
#pragma unroll
        for (int j = 0; j < kKSteps; ++j) {""",
     """      for (int j = 0; j < kKSteps; ++j)
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {"""),
]


def _long_dv(bwd, sq=2048):
    """dV of one 64-key block over sq queries with dO > 0, so that every
    term of its sums has one sign and truncation errors add up: the
    largest error relative to max|dV|."""
    rng = np.random.default_rng(9)
    b, h, sk, d = 1, 1, 64, 16
    q = torch.from_numpy(rng.standard_normal((b, h, sq, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, h, sk, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, h, sk, d), np.float32))
    do = torch.from_numpy(rng.uniform(0.5, 1.5, (b, h, sq, d))
                          .astype(np.float32))
    args64 = (q.double(), k.double(), v.double(), None)
    o64, lse64 = fa.flash_attention_fwd_plain(*args64, False, 0.25)
    delta64 = fa._delta(o64, do.double())
    _, dv = _bwd(bwd, "dkv", q, k, v, None, do, lse64.float(),
                 delta64.float(), False, 0.25)
    _, dv64 = fa.flash_attention_bwd_dkv_plain(*args64, do.double(), lse64,
                                               delta64, False, 0.25)
    return float((dv.double() - dv64).abs().max()) / float(dv64.abs().max())


def _long_dq(bwd, sk=2048):
    """dq of one 64-query block over sk keys with K > 0 and a delta below
    every dp (the C entry point takes any lse and delta), so that every ds,
    and every term of dq's sums, has one sign and truncation errors add
    up: the largest error relative to max|dq|."""
    rng = np.random.default_rng(9)
    b, h, sq, d = 1, 1, 64, 16
    q = torch.from_numpy(0.1 * rng.standard_normal((b, h, sq, d),
                                                   np.float32))
    k = torch.from_numpy(rng.uniform(0.5, 1.5, (b, h, sk, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, h, sk, d), np.float32))
    do = torch.from_numpy(rng.standard_normal((b, h, sq, d), np.float32))
    args64 = (q.double(), k.double(), v.double(), None)
    _, lse64 = fa.flash_attention_fwd_plain(*args64, False, 0.25)
    delta64 = torch.full((b, h, sq), -50.0, dtype=torch.float64)
    dq = _bwd(bwd, "dq", q, k, v, None, do, lse64.float(), delta64.float(),
              False, 0.25)
    dq64, ds64 = fa.flash_attention_bwd_dq_plain(
        *args64, do.double(), lse64, delta64, False, 0.25, bias_grad=True)
    assert float(ds64.min()) > 0
    return float((dq.double() - dq64).abs().max()) / float(dq64.abs().max())


def test_no_promotion_on_a_long_reduction_is_caught(tmp_path, libs):
    bwd = _compile(tmp_path, "bwd", mutate(BWD.read_text(), _NO_PROMOTION))
    assert _long_dv(libs[1]) <= RTOL / 2
    assert _long_dv(bwd) > RTOL


def _dq_mean_error(bwd):
    """dq's mean |error| against the float64 twin, relative to max|dq|, at
    two 64-query blocks over 512 keys, D = 64, with scores of a few units
    (q scaled by 3)."""
    rng = np.random.default_rng(12)
    b, h, sq, sk, d = 1, 2, 64, 512, 64
    q = torch.from_numpy(3 * rng.standard_normal((b, h, sq, d), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, sk, d), np.float32))
            for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((b, h, sq, d), np.float32))
    args64 = (q.double(), k.double(), v.double(), None)
    o64, lse64 = fa.flash_attention_fwd_plain(*args64, False, 0.125)
    lse, delta = lse64.float(), fa._delta(o64, do.double()).float()
    dq = _bwd(bwd, "dq", q, k, v, None, do, lse, delta, False, 0.125)
    dq64, _ = fa.flash_attention_bwd_dq_plain(*args64, do.double(),
                                              lse.double(), delta.double(),
                                              False, 0.125)
    return float((dq.double() - dq64).abs().mean()) / float(
        dq64.abs().max())


def test_dq_lo_passes_first_cuts_the_truncation_error(tmp_path, libs):
    """Each add into a tensor-core accumulator truncates to the running
    sum's ulp, so dq issues every lo pass of a product before its hi*hi
    passes, and only those add at the sum's full size; with the passes
    interleaved k-step by k-step, dq errs at least 1.5x more."""
    bwd = _compile(tmp_path, "bwd", mutate(BWD.read_text(), _DQ_INTERLEAVED))
    assert _dq_mean_error(bwd) > 1.5 * _dq_mean_error(libs[1])


# the forward's and dk/dv's passes interleaved k-step by k-step (lo*hi,
# hi*lo, hi*hi), the order both issued before dq's lo-first order came to
# them
_FWD_INTERLEAVED = [
    ("""    for (int pass = 0; pass < 2; ++pass)
#pragma unroll
      for (int kq = 0; kq < kQSteps; ++kq) {""",
     """    for (int kq = 0; kq < kQSteps; ++kq)
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {"""),
    ("""    for (int pass = 0; pass < 2; ++pass)  // lo passes first, as for S
#pragma unroll
      for (int j = 0; j < kPSteps; ++j) {""",
     """    for (int j = 0; j < kPSteps; ++j)
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {"""),
]
_DKV_INTERLEAVED = [
    ("""      for (int pass = 0; pass < 2; ++pass)  // lo passes first, as dq's
#pragma unroll
        for (int i = 0; i < C::kGroup; ++i) {""",
     """      for (int i = 0; i < C::kGroup; ++i)
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {"""),
    ("""        for (int pass = 0; pass < 2; ++pass)  // lo passes first
#pragma unroll
          for (int j = 0; j < kQSteps; ++j) {""",
     """          for (int j = 0; j < kQSteps; ++j)
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {"""),
]


def _scored_inputs(seed=12):
    """Two 64-row blocks over 512 keys, D = 64, scores of a few units (q
    scaled by 3): the float64 twin's inputs and outputs."""
    rng = np.random.default_rng(seed)
    b, h, sq, sk, d = 1, 2, 128, 512, 64
    q = torch.from_numpy(3 * rng.standard_normal((b, h, sq, d), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, sk, d), np.float32))
            for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((b, h, sq, d), np.float32))
    args64 = (q.double(), k.double(), v.double(), None)
    o64, lse64 = fa.flash_attention_fwd_plain(*args64, False, 0.125)
    return (q, k, v, do), args64, o64, lse64


def _mean_error(got, want):
    return float((got.double() - want).abs().mean()) / float(
        want.abs().max())


def _fwd_mean_error(fwd):
    (q, k, v, _), _, o64, _ = _scored_inputs()
    o, _ = _fwd(fwd, q, k, v, None, False, 0.125)
    return _mean_error(o, o64)


def _dkv_mean_error(bwd):
    (q, k, v, do), args64, o64, lse64 = _scored_inputs()
    delta64 = fa._delta(o64, do.double())
    dk, dv = _bwd(bwd, "dkv", q, k, v, None, do, lse64.float(),
                  delta64.float(), False, 0.125)
    dk64, dv64 = fa.flash_attention_bwd_dkv_plain(*args64, do.double(),
                                                  lse64, delta64, False,
                                                  0.125)
    return _mean_error(dk, dk64) + _mean_error(dv, dv64)


def test_fwd_lo_passes_first_cuts_the_truncation_error(tmp_path, libs):
    """The forward issues every lo pass of S = Q.K^T and of P.V before the
    hi*hi passes, as dq does; with the passes interleaved k-step by
    k-step it errs at least FWD_LO_FIRST_GAIN times more."""
    fwd = _compile(tmp_path, "fwd", mutate(FWD.read_text(), _FWD_INTERLEAVED))
    assert _fwd_mean_error(fwd) > FWD_LO_FIRST_GAIN * _fwd_mean_error(libs[0])


def test_dkv_lo_passes_first_cuts_the_truncation_error(tmp_path, libs):
    """dk/dv issues every lo pass of S^T, dP^T, dV and dK before the hi*hi
    passes, as dq does; with the passes interleaved k-step by k-step it
    errs at least DKV_LO_FIRST_GAIN times more (dk and dv together)."""
    bwd = _compile(tmp_path, "bwd", mutate(BWD.read_text(), _DKV_INTERLEAVED))
    assert _dkv_mean_error(bwd) > DKV_LO_FIRST_GAIN * _dkv_mean_error(
        libs[1])


def test_dq_no_promotion_on_a_long_reduction_is_caught(tmp_path, libs):
    """dq over 2048 keys in one truncating accumulator misses the limit
    that the per-tile promotion holds."""
    bwd = _compile(tmp_path, "bwd", mutate(BWD.read_text(), _DQ_NO_PROMOTION))
    assert _long_dq(libs[1]) <= RTOL / 2
    assert _long_dq(bwd) > RTOL


def test_promotion_threshold_holds_the_float32_limit():
    """kPromoteAfter (flash_tiles.cuh): a product whose k-steps all go into
    one truncating accumulator stays within half the float32 limit up to
    that many multiplies on attention's terms (probabilities in [0, 1]
    times values of one sign), misses the limit over a whole training
    reduction (2048 queries: 768 multiplies), and a fresh accumulator a
    32-query tile (12 multiplies) added with a rounding add holds it."""
    after = int(re.search(r"constexpr int kPromoteAfter = (\d+);",
                          (CSRC / TILES).read_text()).group(1))
    rng = np.random.default_rng(0)

    def err(n, promote_every):
        p = rng.uniform(0, 1, (64, n)).astype(np.float32).astype(np.float64)
        x = rng.uniform(0.5, 1.5, (n, 16)).astype(np.float32).astype(
            np.float64)
        exact = p @ x
        got = truncating_3xtf32(p, x, promote_every)
        return np.abs(got - exact).max() / np.abs(exact).max()

    assert err(after // 3 * 8, 0) <= RTOL / 2
    assert err(2048, 0) > RTOL
    assert err(2048, 4) <= RTOL / 10


# -- bfloat16 ---------------------------------------------------------------

def _bf16(t):
    return t.to(torch.bfloat16).contiguous()


def _fwd16(lib, q, k, v, bias, causal, scale):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bias, strides = fa._bias_strides(bias, (b, h, sq, sk), "test")
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq)
    scratch = torch.empty(lib.flash_attention_fwd_bf16_scratch_bytes(
        b, h, sq, sk, d), dtype=torch.uint8)
    err = lib.flash_attention_fwd_bf16(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(o), _ptr(lse),
        _ptr(scratch), b, h, sq, sk, d, *strides, int(causal), scale, None)
    assert err == 0
    return o, lse


def _bwd16(lib, which, q, k, v, bias, do, lse, delta, causal, scale):
    """dq or (dk, dv) of the bf16 entry points."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bias, strides = fa._bias_strides(bias, (b, h, sq, sk), "test")
    if which == "dq":
        out1, out2 = torch.empty_like(q), None
    else:
        out1, out2 = torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(getattr(
        lib, f"flash_attention_bwd_{which}_bf16_scratch_bytes")(
            b, h, sq, sk, d), dtype=torch.uint8)
    err = getattr(lib, f"flash_attention_bwd_{which}_bf16")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(out1), _ptr(out2), _ptr(scratch), b, h, sq, sk, d,
        *strides, int(causal), scale, None)
    assert err == 0
    return out1 if which == "dq" else (out1, out2)


def _hold16(got, want, limit, what):
    """ROADMAP B1's bf16 rule per element: one bf16 ulp at the larger of
    the two, plus `limit` (fa.bf16_limits)."""
    assert got.dtype == want.dtype == torch.bfloat16, what
    got, want = got.double(), want.double()
    over = (got - want).abs() - fa.bf16_spacing(
        torch.maximum(got.abs(), want.abs())) - limit
    assert float(over.max()) <= 0, \
        f"{what}: {int((over > 0).sum())} elements over, worst by " \
        f"{float(over.max()):.3e}"


def _run16(libs, b, h, sq, sk, d, bias_shape, causal, seed, zero_q=False):
    """The bf16 kernels and their bf16 twins on one case: {output:
    (kernel, twin, limit)} and the kernel's and twin's lse."""
    fwd, bwd = libs
    q, k, v, do, bias = _inputs(b, h, sq, sk, d, bias_shape, seed)
    if zero_q:   # every live score 0: every live p exactly 1 in both
        q = torch.zeros_like(q)
    q, k, v, do = (_bf16(t) for t in (q, k, v, do))
    scale = 1.0 / np.sqrt(d)
    o_t, lse_t = fa.flash_attention_fwd_plain(q, k, v, bias, causal, scale)
    o, lse = _fwd16(fwd, q, k, v, bias, causal, scale)
    delta = fa._delta(o_t, do).contiguous()
    lim = fa.bf16_limits(q, k, v, bias, do, lse_t, delta, causal, scale,
                         rounding=not zero_q)
    out = {"O": (o, o_t, lim["o"])}
    out["dq"] = (_bwd16(bwd, "dq", q, k, v, bias, do, lse_t, delta, causal,
                        scale),
                 fa.flash_attention_bwd_dq_plain(q, k, v, bias, do, lse_t,
                                                 delta, causal, scale)[0],
                 lim["dq"])
    dk, dv = _bwd16(bwd, "dkv", q, k, v, bias, do, lse_t, delta, causal,
                    scale)
    dk_t, dv_t = fa.flash_attention_bwd_dkv_plain(q, k, v, bias, do, lse_t,
                                                  delta, causal, scale)
    out["dk"], out["dv"] = (dk, dk_t, lim["dk"]), (dv, dv_t, lim["dv"])
    return out, (lse, lse_t)


# (B, H, Sq, Sk, D, bias shape or None, causal): every head dim, Sq != Sk,
# lengths off the 64-row tiles, key-row, dense and head-broadcast biases
CASES16 = [
    (1, 2, 70, 50, 16, (1, 2, 70, 50), False),
    (2, 1, 45, 77, 32, (2, 1, 1, 77), True),
    (1, 1, 100, 130, 64, None, True),
    (1, 2, 65, 40, 128, (1, 2, 1, 40), False),
]


@pytest.mark.parametrize("b,h,sq,sk,d,bias_shape,causal", CASES16)
def test_bf16_kernels_match_bf16_twins(libs, b, h, sq, sk, d, bias_shape,
                                       causal):
    """The bf16 forward, dq and dk/dv against their bf16 twins (which
    round P and dS to bf16 before their products, as the Pallas kernels
    do) by B1's rule with bf16_limits' operand-rounding term (the kernel
    and its twin compute p and ds in another order; the forward rounds p
    at another scale); lse at 1e-5."""
    outs, (lse, lse_t) = _run16(libs, b, h, sq, sk, d, bias_shape, causal,
                                sq + sk + d)
    what = f"B{b} H{h} Sq{sq} Sk{sk} D{d} bias {bias_shape} causal {causal}"
    for name, (got, want, limit) in outs.items():
        _hold16(got, want, limit, f"{name} {what}")
    assert float((lse - lse_t).abs().max()) <= RTOL * max(
        float(lse_t.abs().max()), 1.0)


def test_bf16_forward_masks_hold_without_rounding_slack(libs):
    """With q = 0 every live score is 0 and every live p exactly 1 in the
    kernel and its twin, so O is held without the rounding term: a key
    masked or kept wrongly (bias, causal, a tile edge, Sk) moves O by a
    whole 1/l of a value."""
    outs, _ = _run16(libs, 2, 1, 70, 130, 64, (2, 1, 1, 130), True, 8,
                     zero_q=True)
    _hold16(*outs["O"], "O")


# the bf16 A fragment of an accumulator with its rows g and g + 8 swapped
_BF16_FRAGMENT_OFF = [
    ("  a[0] = sm90::bf16x2_rn(acc[8 * j], acc[8 * j + 1]);\n"
     "  a[1] = sm90::bf16x2_rn(acc[8 * j + 2], acc[8 * j + 3]);",
     "  a[1] = sm90::bf16x2_rn(acc[8 * j], acc[8 * j + 1]);\n"
     "  a[0] = sm90::bf16x2_rn(acc[8 * j + 2], acc[8 * j + 3]);")]


def test_bf16_fragment_mutant_is_caught(tmp_path, libs):
    """P's bf16 fragments taken from the wrong accumulator rows (the
    helper dq and dk/dv take dS's and P's from too) move O by O(1)."""
    tiles = mutate((CSRC / TILES).read_text(), _BF16_FRAGMENT_OFF)
    mutant = (_compile(tmp_path, "fwd", tiles_text=tiles), libs[1])
    outs, _ = _run16(mutant, 1, 1, 70, 90, 32, (1, 1, 1, 90), False, 5)
    with pytest.raises(AssertionError):
        _hold16(*outs["O"], "O")
