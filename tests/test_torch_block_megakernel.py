"""The ghost-BN bottleneck block of paddle_tpu_torch against the Pallas
kernels of paddle_tpu, interpreted on the CPU.

``bottleneck_block_plain`` (the oracle the CUDA kernel is held to, on the
CPU by tests/test_torch_block_megakernel_cuda_source.py and on the card
by chip_smoke.py) against ``paddle_tpu.ops.pallas.block_megakernel``'s
``bottleneck_block`` in interpret mode and its oracle
``bottleneck_block_reference``, at the shapes of
tests/test_block_megakernel.py (4 images of 6x6, Cin 256, Cm 128), at
tile 1 and 2 in float32 and in bfloat16, and the ports of that file's
tap-orientation and edge-masking tests. ``roll_micro_block_plain``
against the micro's ``_kernel`` (benchmarks/megakernel_roll_micro.py)
in each variant, interpreted at a small size: the module's shape
constants and its ``pl`` are monkeypatched (the reference is not
edited). The wrappers take the plain twin for CPU tensors (no launch
counted), give shapes for meta tensors and keep the reference's checks
as ValueError.

Tolerance: float32 rtol = atol = 2e-4, the JAX package's own
kernel-vs-oracle tolerance (tests/test_block_megakernel.py). bfloat16:
atol 2 ulps of max|reference| (2 * 2^-7 * max): both round the taps, h2
and y at the same points, but the float32 sums before them run in
another order, so a value lying on a rounding boundary may round one ulp
apart, and the output's own rounding adds one more.
"""
import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from paddle_tpu.ops.pallas.block_megakernel import (
    bottleneck_block as jax_block, bottleneck_block_reference)
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import block_megakernel as bm

RTOL = ATOL = 2e-4
BF16_ULPS = 2 * 2.0 ** -7
_MICRO = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "megakernel_roll_micro.py"

# the eager oracle dispatches op by op (~2.5 s a call on the CPU)
_oracle = jax.jit(bottleneck_block_reference,
                  static_argnames=("h_img", "w_img", "tile"))


def _mk(n=4, h=6, w=6, cin=256, cm=128, seed=0, dtype=np.float32):
    """tests/test_block_megakernel.py's inputs, as numpy arrays."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h * w, cin) * 0.5).astype(dtype)
    w1 = (rng.randn(cin, cm) / np.sqrt(cin)).astype(dtype)
    w3 = (rng.randn(9, cm, cm) / np.sqrt(9 * cm)).astype(dtype)
    w2 = (rng.randn(cm, cin) / np.sqrt(cm)).astype(dtype)
    bns = [np.stack([rng.rand(c) + 0.5, rng.randn(c) * 0.1]).astype(
        np.float32) for c in (cm, cm, cin)]
    return x, w1, w3, w2, bns


def _port(x, w1, w3, w2, bns, dtype=torch.float32):
    return ([torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
             for a in (x, w1, w3, w2)],
            [torch.from_numpy(p) for p in bns])


@pytest.mark.parametrize("tile", [1, 2])
def test_plain_twin_matches_pallas_kernel_and_oracle(tile):
    x, w1, w3, w2, bns = _mk()
    (tx, tw1, tw3, tw2), tbns = _port(x, w1, w3, w2, bns)
    got = bm.bottleneck_block_plain(tx, tw1, tw3, tw2, *tbns, 6, 6,
                                    tile=tile).numpy()
    kern = jax_block(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                     jnp.asarray(w2), *bns, h_img=6, w_img=6, tile=tile,
                     interpret=True)
    ref = _oracle(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                  jnp.asarray(w2), *bns, h_img=6, w_img=6, tile=tile)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tile", [1, 2])
def test_plain_twin_matches_oracle_bf16(tile):
    x, w1, w3, w2, bns = _mk()
    args = [jnp.asarray(a, jnp.bfloat16) for a in (x, w1, w3, w2)]
    ref = np.asarray(_oracle(*args, *bns, h_img=6, w_img=6, tile=tile),
                     np.float32)
    # the same bf16 values in the port
    (tx, tw1, tw3, tw2), tbns = _port(
        *[np.asarray(a, np.float32) for a in args], bns, torch.bfloat16)
    got = bm.bottleneck_block_plain(tx, tw1, tw3, tw2, *tbns, 6, 6,
                                    tile=tile)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=BF16_ULPS * float(np.abs(ref).max()))


def test_tap_orientation():
    """A single bright pixel blurs to its 3x3 neighbourhood with the
    matching tap weights (tap t scales by t+1): pins the tap's sign and
    the masks against the reference's oracle."""
    n, h, w, cin, cm = 2, 6, 6, 128, 128
    x = np.zeros((n, h * w, cin), np.float32)
    x[0, 2 * w + 3, :] = 1.0   # image 0, (h=2, w=3)
    w1 = np.eye(cin, cm, dtype=np.float32)
    w3 = np.stack([np.eye(cm, dtype=np.float32) * (t + 1)
                   for t in range(9)])
    w2 = np.eye(cm, cin, dtype=np.float32)
    bns = [np.stack([np.ones(c), np.zeros(c)]).astype(np.float32)
           for c in (cm, cm, cin)]
    (tx, tw1, tw3, tw2), tbns = _port(x, w1, w3, w2, bns)
    got = bm.bottleneck_block_plain(tx, tw1, tw3, tw2, *tbns, h, w,
                                    tile=1).numpy()
    ref = _oracle(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                  jnp.asarray(w2), *bns, h_img=h, w_img=w, tile=1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    # image 1 saw no signal: after ghost BN its rows are beta-constant,
    # so its output is spatially uniform
    np.testing.assert_allclose(got[1] - got[1][0:1, :], 0.0, atol=1e-5)


def test_edge_masking():
    """Bright pixels at opposite corners of two images: taps reaching
    outside the image contribute zero, never a wrapped row."""
    n, h, w, cin, cm = 2, 6, 6, 128, 128
    x = np.zeros((n, h * w, cin), np.float32)
    x[0, 0, :] = 1.0
    x[1, (h - 1) * w + (w - 1), :] = 1.0
    rng = np.random.RandomState(1)
    w1 = rng.randn(cin, cm).astype(np.float32) * 0.1
    w3 = rng.randn(9, cm, cm).astype(np.float32) * 0.1
    w2 = rng.randn(cm, cin).astype(np.float32) * 0.1
    bns = [np.stack([np.ones(c), np.zeros(c)]).astype(np.float32)
           for c in (cm, cm, cin)]
    (tx, tw1, tw3, tw2), tbns = _port(x, w1, w3, w2, bns)
    got = bm.bottleneck_block_plain(tx, tw1, tw3, tw2, *tbns, h, w,
                                    tile=2).numpy()
    ref = _oracle(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                  jnp.asarray(w2), *bns, h_img=h, w_img=w, tile=2)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.fixture
def micro(monkeypatch):
    """benchmarks/megakernel_roll_micro.py at 4 images of 6x6, Cin = Cm =
    128, tile 2, its pallas_call interpreted."""
    spec = importlib.util.spec_from_file_location("megakernel_roll_micro",
                                                  _MICRO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in dict(BS=4, CIN=128, CM=128, SIDE=6, TILE=2).items():
        monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    return mod


@pytest.mark.parametrize("variant", bm.VARIANTS)
def test_micro_plain_twin_matches_pallas(micro, variant):
    x, w1, w3, w2, bns = _mk(cin=128)
    x = x.reshape(4 * 36, 128)
    want = micro.block(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                       jnp.asarray(w2), *[jnp.asarray(p) for p in bns],
                       variant)
    (tx, tw1, tw3, tw2), tbns = _port(x, w1, w3, w2, bns)
    got = bm.roll_micro_block_plain(tx, tw1, tw3, tw2, *tbns, variant,
                                    side=6, tile=2)
    assert got.shape == tx.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_wrappers_take_the_twin_on_cpu_and_shapes_on_meta():
    x, w1, w3, w2, bns = _mk(n=2, h=3, w=3, cin=16, cm=8)
    (tx, tw1, tw3, tw2), tbns = _port(x, w1, w3, w2, bns)
    kernels.reset_launch_counts()
    y = bm.bottleneck_block(tx, tw1, tw3, tw2, *tbns, 3, 3, tile=2)
    assert torch.equal(y, bm.bottleneck_block_plain(tx, tw1, tw3, tw2,
                                                    *tbns, 3, 3, tile=2))
    flat = tx.reshape(18, 16)
    for variant in bm.VARIANTS:
        ym = bm.roll_micro_block(flat, tw1, tw3, tw2, *tbns, variant, 3, 1)
        assert torch.equal(ym, bm.roll_micro_block_plain(
            flat, tw1, tw3, tw2, *tbns, variant, 3, 1))
    assert kernels.launch_counts()["block_megakernel"] == 0
    assert kernels.launch_counts()["megakernel_roll_micro"] == 0
    meta = [t.to("meta") for t in (tx, tw1, tw3, tw2)]
    out = bm.bottleneck_block(*meta, *tbns, 3, 3, tile=1)
    assert out.device.type == "meta" and out.shape == tx.shape
    out = bm.roll_micro_block(meta[0].reshape(18, 16), *meta[1:], *tbns,
                              "strided", 3, 2)
    assert out.device.type == "meta" and out.shape == (18, 16)


def test_wrappers_keep_the_reference_checks():
    x, w1, w3, w2, bns = _mk(n=3, h=3, w=3, cin=16, cm=8)
    (tx, tw1, tw3, tw2), tbns = _port(x, w1, w3, w2, bns)
    with pytest.raises(ValueError, match="whole tiles"):
        bm.bottleneck_block(tx, tw1, tw3, tw2, *tbns, 3, 3, tile=2)
    with pytest.raises(ValueError, match="rows an image"):
        bm.bottleneck_block(tx, tw1, tw3, tw2, *tbns, 3, 4, tile=1)
    with pytest.raises(ValueError, match="weights"):
        bm.bottleneck_block(tx, tw2, tw3, tw2, *tbns, 3, 3, tile=1)
    with pytest.raises(ValueError, match="variant"):
        bm.roll_micro_block(tx.reshape(27, 16), tw1, tw3, tw2, *tbns,
                            "rolled", 3, 1)
    with pytest.raises(ValueError, match="whole tiles"):
        bm.roll_micro_block(tx.reshape(27, 16), tw1, tw3, tw2, *tbns,
                            "full", 3, 2)
