"""paddle_tpu_torch flash-attention forward vs the JAX package's Pallas
kernel (interpret mode on the CPU, as tests/test_pallas.py runs it).

On the CPU the port's wrapper takes its plain torch version; the CUDA
kernel itself is checked against that plain version on the card by
chip_smoke.py. Inputs come from a seeded numpy RandomState and go
through both packages; O and lse are compared at float32 tolerance
(rtol=1e-4, atol=1e-5). In bfloat16 (the dtype the NMT step reaches
flash in under AMP) O is held per element by one bf16 ulp plus 1e-5 of
its sum of |terms| (ROADMAP B1's rule), lse at 1e-5.
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


# -- bfloat16 ---------------------------------------------------------------

def hold_bf16(got, want, limit, what):
    """B1's bf16 rule per element: |got - want| <= one bf16 ulp (at the
    larger of the two) + `limit` (1e-5 of the sum of |terms|, from
    port_fa.bf16_limits)."""
    got, want = got.double(), want.double()
    slack = port_fa.bf16_spacing(torch.maximum(got.abs(), want.abs())) \
        + limit
    over = (got - want).abs() - slack
    assert float(over.max()) <= 0, \
        f"{what}: {int((over > 0).sum())} elements over, worst by " \
        f"{float(over.max()):.3e}"


@pytest.mark.parametrize("causal,bias_kind", [(False, "full"),
                                              (True, "keyrow")])
def test_plain_matches_pallas_bf16(causal, bias_kind):
    """bf16 q, k, v: the twin rounds P to bf16 before P.V and returns a
    bf16 O, as the Pallas kernel does. Both round P at the row's max (the
    Pallas kernel's key block covers the row), so O is held by B1's rule
    without the operand-rounding term of bf16_limits; lse (float32) at
    1e-5."""
    q, k, v, bias = _inputs(2, 2, 80, 80, 16, bias_kind, seed=5)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    o_ref, lse_ref = _ref_fa._fwd(
        qb, kb, vb, None if bias is None else jnp.asarray(bias),
        1.0 / np.sqrt(16), causal, 128, 128, True)
    assert o_ref.dtype == jnp.bfloat16
    tq, tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (qb, kb, vb))
    tb = None if bias is None else torch.from_numpy(bias)
    o, lse = port_fa.flash_attention_fwd_plain(tq, tk, tv, tb, causal=causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    limit = port_fa.bf16_limits(tq, tk, tv, tb, torch.zeros_like(tq), lse,
                                torch.zeros_like(lse), causal,
                                rounding=False)["o"]
    o_ref = torch.from_numpy(np.asarray(o_ref.astype(jnp.float32)))
    hold_bf16(o, o_ref, limit, "O")
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               rtol=1e-5, atol=1e-5)
