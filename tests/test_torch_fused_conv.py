"""The fused conv + BN plain twins of paddle_tpu_torch against the Pallas
kernels of paddle_tpu, interpreted on the CPU.

``conv1x1_bn_act_plain`` and ``conv3x3_bn_act_plain`` (the oracles the
CUDA kernels are held to, on the CPU by
tests/test_torch_fused_conv_cuda_source.py and on the card by
chip_smoke.py) against ``paddle_tpu.ops.pallas.fused_conv`` at the shapes
of tests/test_fused_conv.py, in float32: the 1x1 kernel with the
affine and ReLU prologue on and off (ReLU without the affine included)
and without statistics; the 3x3 kernel on its halo-DMA path (C 32), its
pixel-pair path (C 64) and its ``_conv3x3_small`` fallback, each with and
without the prologue. ``pack_w3x3`` must give the reference's layout.
The wrappers take the plain twins for CPU tensors (no launch counted)
and give shapes for meta tensors.

In bfloat16, as tests/test_fused_conv.py feeds the reference, the twins
must round the activated operand to bfloat16 before the product, as the
reference does (fused_conv.py's ``_conv1x1_kernel``, the 3x3's im2col
store, ``_conv3x3_small``): the 1x1 with the affine and ReLU, with the
ReLU alone and without statistics, and the 3x3 on its three paths, each
with the prologue; a twin that skips the rounding must be caught.

Tolerance: float32, the same products summed in another order: outputs
atol 1e-5 * max(|reference|, 1); statistics 1e-5 of the sum of |terms|.
bfloat16: both round float32 sums of the same products, taken in another
order, to bfloat16: outputs within one bfloat16 ulp of max|reference|;
statistics (of the float32 sums) 1e-5 of the sum of |terms|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas import fused_conv as ref_fc
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import fused_conv as fc

RTOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _affine(k, seed=2):
    rng = np.random.RandomState(seed)
    return ((rng.rand(k) + 0.5).astype(np.float32),
            (rng.randn(k) * 0.5 + 0.2).astype(np.float32))


def _hold(got, want):
    out, st = got
    ref_out = np.asarray(want[0])
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=0,
                               atol=RTOL * max(float(np.abs(ref_out).max()),
                                               1.0))
    if want[1] is None:
        assert st is None
        return
    terms = np.stack([np.abs(ref_out).sum(0), (ref_out ** 2).sum(0)])
    np.testing.assert_allclose(st.numpy(), np.asarray(want[1]), rtol=0,
                               atol=RTOL * float(terms.max()))


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("affine,relu,stats", [
    (False, False, True), (False, True, True), (True, False, True),
    (True, True, True), (False, False, False)])
def test_conv1x1_plain_twin_matches_pallas(affine, relu, stats):
    m, k, n = 256, 64, 128
    x, w = _rand((m, k), 0), _rand((k, n), 1, 0.1)
    a, b = _affine(k) if affine else (None, None)
    want = ref_fc.conv1x1_bn_act(
        jnp.asarray(x), jnp.asarray(w),
        None if a is None else jnp.asarray(a),
        None if b is None else jnp.asarray(b), relu=relu, stats=stats,
        block_m=64, interpret=True)
    got = fc.conv1x1_bn_act_plain(*_torch(x, w, a, b), relu, stats)
    _hold(got, want)


@pytest.mark.parametrize("c,block_m", [
    (32, 32),   # the halo-DMA path
    (64, 24),   # the pixel-pair path (C 64 -> 128-lane geometry)
    (32, 8),    # the _conv3x3_small fallback (block below the halo)
])
@pytest.mark.parametrize("prologue", [False, True])
def test_conv3x3_plain_twin_matches_pallas(c, block_m, prologue):
    nb, h, w_, co = 2, 8, 8, 48
    x = _rand((nb * h * w_, c), 0)
    wf = np.asarray(ref_fc.pack_w3x3(jnp.asarray(
        _rand((co, c, 3, 3), 1, 0.08))))
    a, b = _affine(c) if prologue else (None, None)
    want = ref_fc.conv3x3_bn_act(
        jnp.asarray(x), jnp.asarray(wf), h, w_,
        a=None if a is None else jnp.asarray(a),
        b=None if b is None else jnp.asarray(b), relu=prologue,
        stats=True, block_m=block_m, interpret=True)
    got = fc.conv3x3_bn_act_plain(*_torch(x, wf), h, w_, *_torch(a, b),
                                  relu=prologue, stats=True)
    _hold(got, want)


def test_pack_w3x3_matches_reference():
    w = _rand((5, 3, 3, 3), 4)
    np.testing.assert_array_equal(
        fc.pack_w3x3(torch.from_numpy(w)).numpy(),
        np.asarray(ref_fc.pack_w3x3(jnp.asarray(w))))
    with pytest.raises(ValueError, match="3x3"):
        fc.pack_w3x3(torch.zeros(2, 2, 1, 1))


def test_wrappers_take_plain_twins_on_cpu_and_shapes_on_meta():
    """CPU tensors run the plain twins (no launch counted); meta tensors
    get the output shapes, stats None when off; rows that are not whole
    images raise."""
    kernels.reset_launch_counts()
    x, w = torch.from_numpy(_rand((98, 5), 5)), \
        torch.from_numpy(_rand((45, 7), 6))
    out, st = fc.conv3x3_bn_act(x, w, 7, 7, relu=True)
    want = fc.conv3x3_bn_act_plain(x, w, 7, 7, relu=True)
    assert torch.equal(out, want[0]) and torch.equal(st, want[1])
    out, st = fc.conv1x1_bn_act(x, w[:5], stats=False)
    assert st is None and out.shape == (98, 7)
    assert kernels.launch_counts()["fused_conv1x1"] == 0
    assert kernels.launch_counts()["fused_conv3x3"] == 0
    meta = fc.conv3x3_bn_act(x.to("meta"), w.to("meta"), 7, 7)
    assert meta[0].shape == (98, 7) and meta[1].shape == (2, 7)
    assert fc.conv1x1_bn_act(x.to("meta"), w[:5].to("meta"),
                             stats=False)[1] is None
    with pytest.raises(ValueError, match="whole"):
        fc.conv3x3_bn_act(x, w, 5, 5)


def _bf16(shape, seed, scale=1.0):
    """bfloat16 values made with numpy from a seed, for both packages:
    (torch tensor, jax array) holding the same values."""
    t = torch.from_numpy(_rand(shape, seed, scale)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _hold_bf16(got, want):
    out, st = got
    assert out.dtype == torch.bfloat16
    ref_out = np.asarray(want[0].astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref_out).max())) - 7)
    np.testing.assert_allclose(out.float().numpy(), ref_out, rtol=0,
                               atol=ulp)
    if want[1] is None:
        assert st is None
        return
    terms = np.stack([np.abs(ref_out).sum(0), (ref_out ** 2).sum(0)])
    np.testing.assert_allclose(st.numpy(), np.asarray(want[1]), rtol=0,
                               atol=RTOL * float(terms.max()))


def _bf16_conv1x1(affine, relu, stats):
    m, k, n = 256, 64, 128
    (x, xj), (w, wj) = _bf16((m, k), 0), _bf16((k, n), 1, 0.1)
    a, b = _affine(k) if affine else (None, None)
    want = ref_fc.conv1x1_bn_act(
        xj, wj, None if a is None else jnp.asarray(a),
        None if b is None else jnp.asarray(b), relu=relu, stats=stats,
        block_m=64, interpret=True)
    got = fc.conv1x1_bn_act_plain(x, w, *_torch(a, b), relu, stats)
    return got, want


@pytest.mark.parametrize("affine,relu,stats", [
    (True, True, True), (False, True, True), (True, True, False)])
def test_conv1x1_plain_twin_matches_pallas_bf16(affine, relu, stats):
    _hold_bf16(*_bf16_conv1x1(affine, relu, stats))


@pytest.mark.parametrize("c,block_m", [(32, 32), (64, 24), (32, 8)])
def test_conv3x3_plain_twin_matches_pallas_bf16(c, block_m):
    nb, h, w_, co = 2, 8, 8, 48
    x, xj = _bf16((nb * h * w_, c), 0)
    w, wj = _bf16((9 * c, co), 1, 0.08)
    a, b = _affine(c)
    want = ref_fc.conv3x3_bn_act(xj, wj, h, w_, a=jnp.asarray(a),
                                 b=jnp.asarray(b), relu=True, stats=True,
                                 block_m=block_m, interpret=True)
    got = fc.conv3x3_bn_act_plain(x, w, h, w_, *_torch(a, b), relu=True,
                                  stats=True)
    _hold_bf16(got, want)


def test_bf16_twin_without_the_rounding_is_caught(monkeypatch):
    """A twin that keeps the activated operand in float32 (the fault of
    the port before its bf16 kernels: its statistics differ from the
    reference's by about 0.08 at max 456) misses the limits."""
    def unrounded(x, a, b, relu):
        xf = x.float()
        if a is not None:
            xf = xf * a.float()[None, :] + b.float()[None, :]
        return torch.clamp_min(xf, 0.0) if relu else xf

    monkeypatch.setattr(fc, "_prologue", unrounded)
    with pytest.raises(AssertionError):
        _hold_bf16(*_bf16_conv1x1(True, True, True))
