"""paddle_tpu_torch flash-attention forward vs the JAX package's Pallas
kernel (interpret mode on the CPU, as tests/test_pallas.py runs it).

On the CPU the port's wrapper takes its plain torch version; the CUDA
kernel itself is checked against that plain version on the card by
chip_smoke.py. Inputs come from a seeded numpy RandomState and go
through both packages; O and lse are compared at float32 tolerance
(rtol=1e-4, atol=1e-5).
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as port_fa

# the package re-exports the function under the module's name
_ref_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

RTOL, ATOL = 1e-4, 1e-5


def _inputs(b, h, sq, sk, d, bias_kind, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, sk, d).astype(np.float32)
    v = rng.randn(b, h, sk, d).astype(np.float32)
    bias = None
    if bias_kind == "keyrow":
        live = rng.randint(sk // 2, sk + 1, size=b)
        bias = np.where(np.arange(sk)[None, :] < live[:, None], 0.0,
                        -1e9).astype(np.float32)[:, None, None, :]
    elif bias_kind == "full":
        bias = (0.5 * rng.randn(b, h, sq, sk)).astype(np.float32)
        drop = rng.rand(b, h, sq, sk) < 0.1
        drop[..., 0] = False          # every row keeps a live key
        bias = np.where(drop, -1e9, bias).astype(np.float32)
    return q, k, v, bias


def _reference(q, k, v, bias, causal):
    o, lse = _ref_fa._fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias),
        1.0 / np.sqrt(q.shape[-1]), causal, 32, 32, True)
    return np.asarray(o), np.asarray(lse)[..., 0]


def _port(q, k, v, bias, causal):
    o, lse = port_fa.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), causal=causal)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", ["none", "keyrow", "full"])
def test_plain_matches_pallas(causal, bias_kind):
    q, k, v, bias = _inputs(2, 2, 80, 80, 16, bias_kind)
    o_ref, lse_ref = _reference(q, k, v, bias, causal)
    o, lse = _port(q, k, v, bias, causal)
    np.testing.assert_allclose(o, o_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse, lse_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sq,sk,causal", [(40, 72, False), (40, 72, True),
                                          (72, 40, True), (77, 77, True)])
def test_plain_matches_pallas_ragged(sq, sk, causal):
    """Sq != Sk, and lengths that are no multiple of any tile: the
    Pallas kernel pads and masks, the port's plain version must agree."""
    q, k, v, bias = _inputs(1, 2, sq, sk, 16, "keyrow", seed=1)
    o_ref, lse_ref = _reference(q, k, v, bias, causal)
    o, lse = _port(q, k, v, bias, causal)
    np.testing.assert_allclose(o, o_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse, lse_ref, rtol=RTOL, atol=ATOL)


def test_wrapper_takes_plain_path_on_cpu_without_counting():
    q, k, v, bias = (torch.from_numpy(a) for a in
                     _inputs(1, 2, 24, 24, 16, "keyrow", seed=2))
    before = port_fa.flash_attention_fwd.launches
    o, lse = port_fa.flash_attention_fwd(q, k, v, bias, causal=True)
    o_p, lse_p = port_fa.flash_attention_fwd_plain(q, k, v, bias,
                                                   causal=True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert port_fa.flash_attention_fwd.launches == before


@pytest.mark.parametrize("bad", ["dtype", "strided", "head_dim", "shape",
                                 "bias_dtype"])
def test_kernel_input_checks_raise(bad):
    """What the CUDA kernel cannot take is refused before any launch."""
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    v = torch.zeros(1, 2, 8, 16)
    bias = None
    if bad == "dtype":
        q = q.double()
    elif bad == "strided":
        q = torch.zeros(1, 8, 2, 16).transpose(1, 2)
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 2, 8, 24) for _ in range(3))
    elif bad == "shape":
        k = torch.zeros(1, 2, 8, 32)
    else:
        bias = torch.zeros(1, 1, 1, 8, dtype=torch.float64)
    with pytest.raises((TypeError, ValueError)):
        port_fa._check_inputs(q, k, v, bias)
