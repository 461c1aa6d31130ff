"""The CUDA source of the fused conv + BN kernels, run on the CPU.

paddle_tpu_torch/csrc/fused_conv.cu compiles only for a card, but its
logic — the 128-row tiles and both column tiles, the weight pack into
K-major TF32 hi/lo (or bf16) planes, the ring of copy stages and the
steps issued ahead, the 3x3 halo slab and its nine shifted windows, the
prologue applied once per staged element before the edge mask, the tap
masks, the A fragments and the 128-byte-swizzled B tile, the 3xTF32
split, the per-step promotion of long sums, the staged and the direct
output stores, the per-tile partial statistics and their reduction in
tile order — is plain C++ over a small CUDA subset plus the PTX helpers
of csrc/sm90_mma.cuh. This test compiles the source with the host C++
compiler against the emulation of that subset and of sm90_mma.cuh in
tests/test_torch_cuda_emulation.py (its multiplies truncate their
float32 sums, as the tensor cores do), and holds the float32 and bfloat16 C entry points against the plain twins
of ops/kernels/fused_conv.py: M not a multiple of the 128-row tile and
more than one row tile, images smaller than a tile and tiles that cross
image boundaries, a 1x1 image (every off-centre tap masked), odd C (the
plain-load slab), N on both sides of the 128-column switch and rows that
are not whole 16-byte chunks, ReLU without the affine, and stats off.
Two mutants must be caught: the affine applied after the edge mask (a
padded tap becomes relu(b)), and 3xTF32 with its lo products dropped. A
simulation of the tensor cores' truncating float32 sums pins the
promotion threshold. It says nothing about speed or about the device
compiler; chip_smoke.py runs the real kernels on the card.

Tolerance: float32, the same products summed in another order: outputs
atol 1e-5 * max(|plain|, 1), statistics 1e-5 of the sum of |terms|.
bfloat16: each output within one bf16 ulp (at the larger of the two)
plus 1e-5 of its sum of |terms|, statistics as in float32.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_conv as fc
from test_torch_cuda_emulation import compile_cuda, mutate, \
    truncating_3xtf32

SOURCE = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc" \
    / "fused_conv.cu"
RTOL = 1e-5
ROW_TILE = 128

# the prologue applied after the edge mask (a padded tap reads relu(b)):
# the in-place activation of the slab switched off, and each float32 A
# fragment element activated after its mask
_MASK_THEN_AFFINE = [
    ("    if (tap == 0 && prologue) {", "    if (false) {"),
    ("""          const float e[4] = {v0 ? word_f32(w0[u]) : 0.f,
                              v1 ? word_f32(w1[u]) : 0.f,
                              v0 ? word_f32(w0[u + 4]) : 0.f,
                              v1 ? word_f32(w1[u + 4]) : 0.f};
""", """          float e[4] = {v0 ? word_f32(w0[u]) : 0.f,
                        v1 ? word_f32(w1[u]) : 0.f,
                        v0 ? word_f32(w0[u + 4]) : 0.f,
                        v1 ? word_f32(w1[u + 4]) : 0.f};
          for (int r = 0; r < 4; ++r) {
            const int c = j * E::kBK + u + (r / 2) * 4;
            if (affine && c < p.C) e[r] = e[r] * p.a[c] + p.b[c];
            if (p.relu) e[r] = fmaxf(e[r], 0.f);
          }
"""),
]

# 3xTF32 with the two lo products dropped: a one-pass TF32 product
_DROP_LO = [
    ("""            sm90::wgmma<BN, false>(d, lo[ks], bk, ks | keep);
            sm90::wgmma<BN, false>(d, hi[ks], bk + kBPlane, 1);
            sm90::wgmma<BN, false>(d, hi[ks], bk, 1);
""", """            sm90::wgmma<BN, false>(d, hi[ks], bk, ks | keep);
"""),
]


def _compile(out: Path, text: str):
    lib = fc.bind(ctypes.CDLL(str(compile_cuda(out, text, "fused_conv"))))
    assert lib.fused_conv_row_tile() == ROW_TILE
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("fused_conv_emulated"),
                    SOURCE.read_text())


def _inputs(m, c, n, k_rows, affine, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, c, generator=g).to(dtype)
    w = (torch.randn(k_rows, n, generator=g) * 0.2).to(dtype)
    if not affine:
        return x, w, None, None
    return (x, w, torch.rand(c, generator=g) + 0.5,
            torch.randn(c, generator=g) * 0.5 + 0.3)


def _call(lib, three, x, w, a, b, n, relu, stats, img=(1, 1)):
    """Run one C entry point of x's dtype on CPU buffers: (out, stats or
    None)."""
    m, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty(m, n, dtype=x.dtype)
    st = torch.empty(2, n) if stats else None
    part = torch.empty(-(-m // ROW_TILE), 2, n) if stats else None
    wpack = torch.empty(lib.fused_conv_wpack_bytes(9 if three else 1, c, n,
                                                   int(bf16)),
                        dtype=torch.uint8)

    def ptr(t):
        return None if t is None else t.data_ptr()

    common = [ptr(x), ptr(w), ptr(a), ptr(b), ptr(out), ptr(part), ptr(st),
              ptr(wpack)]
    suffix = "bf16" if bf16 else "f32"
    if three:
        err = getattr(lib, f"fused_conv3x3_{suffix}")(
            *common, m, c, n, img[0], img[1], int(relu), None)
    else:
        err = getattr(lib, f"fused_conv1x1_{suffix}")(
            *common, m, c, n, int(relu), None)
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


def _bf16_ulp(v):
    """The spacing of bfloat16 values at |v| (0 at 0)."""
    mant, exp = torch.frexp(v.float())
    return torch.where(mant == 0, torch.zeros_like(v.float()),
                       torch.ldexp(torch.ones_like(v.float()), exp - 8))


def _hold_bf16(got, three, x, w, a, b, relu, img, what):
    """bfloat16 kernel vs bfloat16 twin: both round the same float32 sums,
    taken in another order, so each output element is within one bf16 ulp
    (at the larger of the two) plus RTOL of its sum of |terms|; the
    statistics of the float32 sums within RTOL of their sum of |terms|."""
    out, st = got
    act = fc._prologue(x, a, b, relu)   # rounded to bf16, as float32
    if three:
        ref32, _ = fc.conv3x3_bn_act_plain(act, w.float(), *img)
        terms_el, _ = fc.conv3x3_bn_act_plain(act.abs(), w.float().abs(),
                                              *img)
        want = fc.conv3x3_bn_act_plain(x, w, *img, a, b, relu, st is not None)
    else:
        ref32, _ = fc.conv1x1_bn_act_plain(act, w.float())
        terms_el, _ = fc.conv1x1_bn_act_plain(act.abs(), w.float().abs())
        want = fc.conv1x1_bn_act_plain(x, w, a, b, relu, st is not None)
    assert out.dtype == torch.bfloat16
    diff = (out.float() - want[0].float()).abs()
    tol = _bf16_ulp(torch.maximum(out.float().abs(), want[0].float().abs())) \
        + RTOL * terms_el
    worst = float((diff - tol).max())
    assert worst <= 0, f"{what}: an output is {worst:.3e} past its limit"
    if want[1] is None:
        assert st is None
        return
    terms = torch.stack([ref32.abs().sum(0), (ref32 * ref32).sum(0)])
    np.testing.assert_allclose(st.numpy(), want[1].numpy(), rtol=0,
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


# bfloat16 (M, K, N, affine, relu, stats): the 16-byte copy path (K 8, 72:
# two chunks, the second partial), the plain-load path (odd K), N across
# the column tiles
CASES_1X1_BF16 = [
    (200, 72, 130, True, True, True),
    (98, 8, 48, True, False, True),
    (130, 5, 64, False, True, True),
    (64, 9, 17, False, False, False),
]


@pytest.mark.parametrize("m,k,n,affine,relu,stats", CASES_1X1_BF16)
def test_conv1x1_source_bf16_matches_plain_twin(lib, m, k, n, affine, relu,
                                                stats):
    x, w, a, b = _inputs(m, k, n, k, affine, m + k + n, torch.bfloat16)
    got = _call(lib, False, x, w, a, b, n, relu, stats)
    _hold_bf16(got, False, x, w, a, b, relu, None, f"bf16 1x1 M{m} K{k} N{n}")


# bfloat16 (images, H, W, C, N, affine, relu, stats): tiles across image
# boundaries with C 16 (copy path), 1x1 images, odd C (plain loads)
CASES_3X3_BF16 = [
    (3, 9, 10, 16, 130, True, True, True),
    (5, 1, 1, 8, 16, True, True, True),
    (2, 7, 7, 5, 48, True, False, True),
]


@pytest.mark.parametrize("nb,h,w_,c,n,affine,relu,stats", CASES_3X3_BF16)
def test_conv3x3_source_bf16_matches_plain_twin(lib, nb, h, w_, c, n, affine,
                                                relu, stats):
    m = nb * h * w_
    x, w, a, b = _inputs(m, c, n, 9 * c, affine, m + c + n, torch.bfloat16)
    got = _call(lib, True, x, w, a, b, n, relu, stats, img=(h, w_))
    _hold_bf16(got, True, x, w, a, b, relu, (h, w_),
               f"bf16 3x3 {nb}x{h}x{w_} C{c} N{n}")


def test_conv1x1_source_3xtf32_holds_float32(lib):
    """3xTF32 over several chunks (K 100: 32-channel chunks, the last
    partial) on inputs spread over six binades holds the float32 limit."""
    m, k, n = 160, 100, 72
    x, w, a, b = _inputs(m, k, n, k, True, seed=11)
    x = x * torch.exp2(torch.randint(-3, 3, (m, k),
                                     generator=torch.Generator()
                                     .manual_seed(12)).float())
    got = _call(lib, False, x, w, a, b, n, True, True)
    want = fc.conv1x1_bn_act_plain(x, w, a, b, True, True)
    _hold(got, want, x, w, "3xTF32 1x1")


def test_affine_after_mask_mutant_is_caught(tmp_path):
    """The same source with the prologue applied after the edge mask (a
    padded tap reads relu(b) in place of 0) disagrees with the plain twin
    on the edge pixels, and only there."""
    mutant = _compile(tmp_path, mutate(SOURCE.read_text(),
                                        _MASK_THEN_AFFINE))
    nb, h, w_, c, n = 2, 7, 7, 5, 48
    x, w, a, b = _inputs(nb * h * w_, c, n, 9 * c, True, seed=1)
    got, _ = _call(mutant, True, x, w, a, b, n, True, False, img=(h, w_))
    want, _ = fc.conv3x3_bn_act_plain(x, w, h, w_, a, b, True, False)
    diff = (got - want).abs().reshape(nb, h, w_, n).amax(dim=(0, 3))
    interior = diff[1:-1, 1:-1]
    assert float(interior.max()) <= RTOL * float(want.abs().max())
    edge = torch.cat([diff[0], diff[-1], diff[:, 0], diff[:, -1]])
    assert float(edge.min()) > 1e-2


def test_dropping_tf32_lo_terms_is_caught(tmp_path):
    """The float32 path with the two lo products dropped (one TF32 pass)
    misses the float32 limit."""
    mutant = _compile(tmp_path, mutate(SOURCE.read_text(), _DROP_LO))
    m, k, n = 130, 64, 64
    x, w, a, b = _inputs(m, k, n, k, True, seed=3)
    got, _ = _call(mutant, False, x, w, a, b, n, True, False)
    want, _ = fc.conv1x1_bn_act_plain(x, w, a, b, True, False)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err > 10 * RTOL, err


def test_promotion_threshold_holds_the_float32_limit():
    """kPromoteAfter (the source's constant): a float32 conv whose
    k-steps all go into one truncating accumulator stays within half the
    float32 limit up to that many multiplies (K 256 with 3 passes: 96),
    misses the limit at K' 1152 (432), and the per-step promotion (a
    fresh accumulator every 4 k-steps, added with a rounding add) holds
    K' 1152 well inside it."""
    after = int(re.search(r"constexpr int kPromoteAfter = (\d+);",
                          SOURCE.read_text()).group(1))
    rng = np.random.default_rng(0)

    def err(k, promote_every):
        x = np.maximum(rng.standard_normal((64, k)), 0).astype(
            np.float32).astype(np.float64)
        w = (rng.standard_normal((k, 48)) / np.sqrt(k)).astype(
            np.float32).astype(np.float64)
        exact = x @ w
        got = truncating_3xtf32(x, w, promote_every)
        return np.abs(got - exact).max() / np.abs(exact).max()

    assert err(after // 3 * 8, 0) <= RTOL / 2
    assert err(1152, 0) > RTOL
    assert err(1152, 4) <= RTOL / 10
