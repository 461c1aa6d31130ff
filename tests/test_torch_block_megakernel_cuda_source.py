"""The CUDA source of the ghost-BN bottleneck block, run on the CPU.

paddle_tpu_torch/csrc/block_megakernel.cu compiles only for a card, but
its logic — the weight packs, the tensor-core implicit GEMMs and their
ring of copy stages, the 3x3's halo slab (and the strided variant's
window a dy) read by the taps at their offsets, the BN prologue applied
per row group before the edge mask, the 128-row tiles that cross ghost
groups and their statistics per group segment, the coefficients summed
per group in tile order, GEMM3's statistics and final passes, the
per-step promotion of long sums, the four variants, the bfloat16
rounding points — is plain C++ over a small CUDA subset plus the PTX
helpers of csrc/sm90_mma.cuh. This test compiles the source with the
host C++ compiler against the emulation of both in
tests/test_torch_cuda_emulation.py (its warpgroup multiplies truncate
their float32 sums, as the tensor cores do) and holds both C entry
points against the plain twins of ops/kernels/block_megakernel.py: tile
1, 2 and the whole batch, groups of 9 to 140 rows (row tiles that cross
groups, a group longer than one 128-row tile), 7x7 images at tile 1
(49-row groups across three row tiles), a 1x1 image (every off-centre
tap masked), odd Cm, an odd Cin (x rows that are not whole 16-byte
chunks: plain loads, and y stored element by element), Cin across the
128-column tile, every variant, and bfloat16. It holds acc2 (the 3x3's
accumulator, in the workspace) at K' 2304 against float64 at the fused
convs' float32 limit. Four mutants
must be caught: the BN affine applied after the edge mask (a padded tap
reads relu(b)), statistics taken over the whole batch in place of each
group, a row credited to the wrong group segment of its tile, and the
promotion of long sums switched off. megakernel_split.py's edits of
the source are held against it. It says nothing about speed or about
the device compiler; chip_smoke.py runs the real kernel on the card.

Tolerance: float32, the same products summed in another order and
renormalized by three ghost BNs: max |kernel - twin| <= 1e-4 * max|twin|
(chip_smoke.py's limit on the card). bfloat16: 2 ulps of max|twin|
(2 * 2^-7 * max|twin|): where the two orders of summation straddle a
rounding boundary of a tap or of h2, one value moves by one ulp, and the
output's own rounding adds another. acc2: 1e-5 of max|acc2| (the fused
convs' float32 limit, a sum of K' products in another order).
"""
import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import block_megakernel as bm
from test_torch_cuda_emulation import compile_cuda, mutate

SOURCE = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc" \
    / "block_megakernel.cu"
F32_RTOL = 1e-4
BF16_RTOL = 2 * 2.0 ** -7
ACC_RTOL = 1e-5

# the BN affine applied after the edge mask (a padded tap reads relu(b)):
# the in-place activation of the slab switched off, and each float32 A
# fragment element activated (with its row's group's coefficients) after
# its mask
_MASK_THEN_AFFINE = [
    ("      activate(o, j, slab, cur, av, bv);", ""),
    ("""          const float e[4] = {v0 ? word_f32(w0[u]) : 0.f,
                              v1 ? word_f32(w1[u]) : 0.f,
                              v0 ? word_f32(w0[u + 4]) : 0.f,
                              v1 ? word_f32(w1[u + 4]) : 0.f};
""", """          float e[4] = {v0 ? word_f32(w0[u]) : 0.f,
                        v1 ? word_f32(w1[u]) : 0.f,
                        v0 ? word_f32(w0[u + 4]) : 0.f,
                        v1 ? word_f32(w1[u + 4]) : 0.f};
          for (int r = 0; kFloatA && r < 4; ++r) {
            const int64_t gr = std::clamp<int64_t>(
                slab_first(o) + (r % 2 ? lr1 : lr0) + off, 0, p.M - 1);
            const int c = j * E::kBK + u + (r / 2) * 4;
            const float* ab = p.coef + (gr / p.G) * p.coef_stride;
            if (c < p.C) e[r] = fmaxf(e[r] * ab[c] + ab[p.C + c], 0.f);
          }
"""),
]
# statistics over every group's row tiles and rows: full-batch BN
_WHOLE_BATCH_STATS = [
    ("  const int g0 = g, g1 = g;",
     "  const int g0 = 0, g1 = gridDim.y - 1;"),
]
# each group's first row credited to the segment of the group before it
_WRONG_SEGMENT = [
    ("      int next = (first_g + 1) * p.G - row0;",
     "      int next = (first_g + 1) * p.G - row0 + 1;"),
]
# every reduction step's products into the one truncating accumulator
_NO_PROMOTION = [
    ("""  const bool promote = p.n_it * 4 * (E::kBf16 ? 1 : 3) >
                       (E::kBf16 ? kPromoteAfterBf16 : kPromoteAfter);""",
     "  const bool promote = false;"),
]


def _compile(out: Path, text: str):
    return bm.bind(ctypes.CDLL(str(compile_cuda(out, text,
                                                "block_megakernel"))))


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


def _call(lib, x, w1, w3, w2, bns, h, w, tile, variant, ws=None):
    """Run the C entry point of x's dtype on CPU buffers (ws: the
    workspace, allocated here when not given)."""
    n, hw, cin = x.shape
    cm = w1.shape[1]
    y = torch.empty_like(x)
    if ws is None:
        ws = torch.empty(lib.block_megakernel_workspace(n, hw, cin, cm,
                                                        tile))
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


# (n, H, W, Cin, Cm, tile): groups of 9 and 18 rows (tile 1, 2: row tiles
# cross 14 and 7 groups), 6x6 at the whole batch (36 rows a group, 144
# in all), a 10x14 group of 140 rows (two row tiles, the second 12 rows
# long), a 1x1 image (every off-centre tap masked), an odd Cm with Cin
# over one 128-column tile, 7x7 images at tile 1 (49-row groups across
# three row tiles), an odd Cin (plain-load x rows, y element by element)
CASES = [
    (4, 3, 3, 16, 8, 1),
    (4, 3, 3, 16, 8, 2),
    (4, 6, 6, 12, 8, 4),
    (2, 10, 14, 8, 8, 1),
    (6, 1, 1, 12, 8, 2),
    (2, 4, 5, 136, 5, 1),
    (6, 7, 7, 16, 8, 1),
    (3, 2, 3, 13, 6, 1),
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
    mutant = _compile(tmp_path, mutate(SOURCE.read_text(),
                                       _MASK_THEN_AFFINE))
    x, w1, w3, w2, bns = _inputs(2, 6, 6, 16, 8, seed=1)
    got = _call(mutant, x, w1, w3, w2, bns, 6, 6, 1, "full")
    want = bm.bottleneck_block_plain(x, w1, w3, w2, *bns, 6, 6, tile=1)
    assert _gap(got, want) > 1e-2


def test_whole_batch_statistics_mutant_is_caught(tmp_path):
    """The same source with the statistics taken over the whole batch
    disagrees with the twin at tile 1, and agrees with it where the tile
    is the whole batch (ghost BN is then batch BN)."""
    mutant = _compile(tmp_path, mutate(SOURCE.read_text(),
                                       _WHOLE_BATCH_STATS))
    x, w1, w3, w2, bns = _inputs(4, 3, 3, 16, 8, seed=2)
    got = _call(mutant, x, w1, w3, w2, bns, 3, 3, 1, "full")
    want = bm.bottleneck_block_plain(x, w1, w3, w2, *bns, 3, 3, tile=1)
    assert _gap(got, want) > 1e-2
    got = _call(mutant, x, w1, w3, w2, bns, 3, 3, 4, "full")
    want = bm.bottleneck_block_plain(x, w1, w3, w2, *bns, 3, 3, tile=4)
    assert _gap(got, want) <= F32_RTOL


def test_wrong_group_segment_mutant_is_caught(tmp_path):
    """The same source with each group's first row of a tile credited to
    the segment of the group before it disagrees with the twin where
    49-row groups cross 128-row tiles, and agrees where a group is the
    whole batch (one segment a tile)."""
    mutant = _compile(tmp_path, mutate(SOURCE.read_text(), _WRONG_SEGMENT))
    x, w1, w3, w2, bns = _inputs(6, 7, 7, 16, 8, seed=4)
    got = _call(mutant, x, w1, w3, w2, bns, 7, 7, 1, "full")
    want = bm.bottleneck_block_plain(x, w1, w3, w2, *bns, 7, 7, tile=1)
    assert _gap(got, want) > 1e-2
    got = _call(mutant, x, w1, w3, w2, bns, 7, 7, 6, "full")
    want = bm.bottleneck_block_plain(x, w1, w3, w2, *bns, 7, 7, tile=6)
    assert _gap(got, want) <= F32_RTOL


def _acc2_gap(lib, seed):
    """The 3x3's float32 accumulator at K' 2304 (Cm 256) from the
    workspace against float64 (2 x 5x5 images, tile 1): max |diff| over
    max|acc2|."""
    n, side, cin, cm, tile = 2, 5, 16, 256, 1
    x, w1, w3, w2, bns = _inputs(n, side, side, cin, cm, seed=seed)
    ws = torch.zeros(lib.block_megakernel_workspace(n, side * side, cin, cm,
                                                    tile))
    _call(lib, x, w1, w3, w2, bns, side, side, tile, "full", ws)
    m = n * side * side
    ldc = -(-cm // 8) * 8
    start = -(-m * ldc // 64) * 64  # acc2 follows acc1 [M, ldc]
    acc2 = ws[start:start + m * ldc].reshape(m, ldc)[:, :cm].double()
    h = (x.double().reshape(m, cin) @ w1.double()).reshape(n // tile, -1, cm)
    mean = h.mean(1, keepdim=True)
    var = (h * h).mean(1, keepdim=True) - mean * mean
    a = bns[0][0].double() / torch.sqrt(var + bm.EPS)
    h1 = torch.clamp_min(h * a + bns[0][1].double() - mean * a, 0)
    img = torch.nn.functional.pad(h1.reshape(n, side, side, cm),
                                  (0, 0, 1, 1, 1, 1))
    want = sum(img[:, t // 3:t // 3 + side, t % 3:t % 3 + side]
               @ w3[t].double() for t in range(9)).reshape(m, cm)
    return float((acc2 - want).abs().max() / want.abs().max())


def test_acc2_holds_the_float32_conv_limit(lib):
    """With the per-step promotion of long sums, the 3x3 at K' 2304 (864
    truncating TF32 multiplies) keeps acc2 within a tenth of the fused
    convs' float32 limit of float64."""
    assert _acc2_gap(lib, seed=5) <= ACC_RTOL / 10


def test_promotion_off_mutant_is_caught(tmp_path):
    """The same source with every reduction step's products summed in one
    truncating accumulator misses the float32 limit on acc2 at K' 2304
    (the fused convs' finding, PERF.md)."""
    mutant = _compile(tmp_path, mutate(SOURCE.read_text(), _NO_PROMOTION))
    assert _acc2_gap(mutant, seed=5) > ACC_RTOL


def _load_split():
    """megakernel_split.py, which times edited copies of the source on
    the card."""
    path = SOURCE.parents[2] / "megakernel_split.py"
    spec = importlib.util.spec_from_file_location("megakernel_split", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SPLIT = _load_split()


@pytest.mark.parametrize("variant", sorted(SPLIT.VARIANTS))
def test_split_edits_apply_to_the_source(variant):
    """Every edit of megakernel_split.py's variants finds its anchor once
    in the current source; only "kernel" leaves it as it is."""
    text = SOURCE.read_text()
    assert (SPLIT.edited(variant, text) == text) == (variant == "kernel")
