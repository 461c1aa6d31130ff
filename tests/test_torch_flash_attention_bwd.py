"""paddle_tpu_torch flash-attention backward vs the JAX package's Pallas
backward (interpret mode on the CPU, as tests/test_pallas.py runs it).

On the CPU the port's wrappers take their plain torch twins; the CUDA
kernels themselves are checked against those twins on the card by
chip_smoke.py. Inputs come from a seeded numpy RandomState; the forward's
O and lse (from the port's plain forward, which
tests/test_torch_flash_attention.py holds against the Pallas forward) and
dO go into both packages' backward, and dq, dk, dv and the exact bias
gradient are compared at float32 tolerance (rtol=1e-4, atol=1e-5).
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
BLOCK = 32   # Pallas tile in interpret mode: two tiles per axis


def _inputs(b, h, sq, sk, d, bias_shape, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, sk, d).astype(np.float32)
    v = rng.randn(b, h, sk, d).astype(np.float32)
    do = rng.randn(b, h, sq, d).astype(np.float32)
    bias = None
    if bias_shape == "keyrow":                       # [b, 1, 1, sk]
        live = rng.randint(sk // 2, sk + 1, size=b)
        bias = np.where(np.arange(sk)[None, :] < live[:, None], 0.0,
                        -1e9).astype(np.float32)[:, None, None, :]
    elif bias_shape is not None:
        bias = (0.5 * rng.randn(*bias_shape)).astype(np.float32)
    return q, k, v, bias, do


def _t(a):
    return None if a is None else torch.from_numpy(a)


# (B, H, Sq, Sk, D, bias, causal, bias_grad): D 16 and 32; Sq = Sk and
# Sq != Sk; no bias, a key-row mask, a full and a head-broadcast bias;
# causal on and off; bias_grad off and on (the key-row case reduces the
# bias gradient over heads and query rows). Each case compiles the
# Pallas kernels anew, so the list stays short.
CASES = [
    (1, 2, 48, 48, 16, None, False, False),
    (2, 2, 48, 48, 16, "keyrow", True, True),
    (2, 2, 40, 56, 32, (2, 2, 40, 56), False, True),
    (2, 2, 56, 40, 32, (2, 1, 56, 40), True, False),
]


@pytest.mark.parametrize("b,h,sq,sk,d,bias_shape,causal,bias_grad", CASES)
def test_plain_bwd_matches_pallas(b, h, sq, sk, d, bias_shape, causal,
                                  bias_grad):
    q, k, v, bias, do = _inputs(b, h, sq, sk, d, bias_shape)
    scale = 1.0 / np.sqrt(d)
    o, lse = port_fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), _t(bias),
                                               causal=causal)
    o, lse = o.numpy(), lse.numpy()
    ref = _ref_fa._bwd(
        (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
         None if bias is None else jnp.asarray(bias), jnp.asarray(o),
         jnp.asarray(lse)[..., None]),
        jnp.asarray(do), scale, causal, BLOCK, BLOCK, True, bias_grad)
    got = port_fa.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), _t(bias), _t(o), _t(lse), _t(do),
        causal=causal, sm_scale=scale, bias_grad=bias_grad)
    for name, r, g in zip(("dq", "dk", "dv"), ref[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    if bias is None:
        assert got[3] is None
    elif bias_grad:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]),
                                   rtol=RTOL, atol=ATOL, err_msg="dbias")
    else:
        # the reference's constant-mask gradient is zero; the port's
        # wrapper returns None and FlashAttention fills in the zeros
        assert got[3] is None and not np.asarray(ref[3]).any()


def test_flash_attention_gradcheck_float64():
    """FlashAttention's backward (the plain twins on the CPU) against
    finite differences in float64, bias gradient included."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, n, 4)).requires_grad_(True)
               for n in (5, 6, 6))
    bias = torch.from_numpy(0.5 * rng.randn(1, 1, 5, 6)).requires_grad_(True)
    for causal in (False, True):
        assert torch.autograd.gradcheck(
            lambda q, k, v, bias: port_fa.flash_attention(
                q, k, v, bias, causal=causal, bias_grad=True),
            (q, k, v, bias), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_flash_attention_constant_mask_gets_zero_grad():
    """Without bias_grad the mask is a constant: its gradient is zero,
    and q, k, v get the same gradients as torch autograd through the
    plain forward."""
    q, k, v, bias, do = (_t(a) for a in _inputs(1, 2, 12, 12, 16,
                                                (1, 1, 12, 12), seed=4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    out = port_fa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    assert not grads[3].any()
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_out, _ = port_fa.flash_attention_fwd_plain(*ref_leaves, bias,
                                                   causal=True)
    ref_grads = torch.autograd.grad(ref_out, ref_leaves, do)
    for g, r in zip(grads[:3], ref_grads):
        torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL)


def test_bwd_wrappers_take_plain_path_on_cpu_without_counting():
    q, k, v, bias, do = (_t(a) for a in _inputs(1, 2, 24, 24, 16, "keyrow",
                                                seed=2))
    o, lse = port_fa.flash_attention_fwd_plain(q, k, v, bias, causal=True)
    before = (port_fa.flash_attention_bwd_dq.launches,
              port_fa.flash_attention_bwd_dkv.launches)
    got = port_fa.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=True)
    want = port_fa.flash_attention_bwd_plain(q, k, v, bias, o, lse, do,
                                             causal=True)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert (port_fa.flash_attention_bwd_dq.launches,
            port_fa.flash_attention_bwd_dkv.launches) == before


@pytest.mark.parametrize("bad", ["do_shape", "do_strided", "lse_shape",
                                 "delta_dtype"])
def test_bwd_kernel_input_checks_raise(bad):
    """What the CUDA kernels cannot take is refused before any launch."""
    q = k = v = do = torch.zeros(1, 2, 8, 16)
    lse = delta = torch.zeros(1, 2, 8)
    if bad == "do_shape":
        do = torch.zeros(1, 2, 8, 32)
    elif bad == "do_strided":
        do = torch.zeros(1, 8, 2, 16).transpose(1, 2)
    elif bad == "lse_shape":
        lse = torch.zeros(1, 2, 8, 1)
    else:
        delta = delta.double()
    with pytest.raises(ValueError):
        port_fa._check_bwd_inputs(q, k, v, None, do, lse, delta, "bwd")


# -- bfloat16 ---------------------------------------------------------------

@pytest.mark.parametrize("causal,bias_shape", [(True, "keyrow"),
                                               (False, (2, 1, 40, 56))])
def test_plain_bwd_matches_pallas_bf16(causal, bias_shape):
    """bf16 q, k, v, O and dO (the port's bf16 forward), float32 lse: the
    twins round p and ds to bf16 before p^T.dO, ds.K and ds^T.Q and
    return dq, dk and dv in bf16, as the Pallas kernels do; each is held
    per element by one bf16 ulp plus 1e-5 of its sum of |terms|
    (ROADMAP B1's rule: port_fa.bf16_limits without its operand-rounding
    term; the two round p and ds computed in the same order here)."""
    from test_torch_flash_attention import hold_bf16
    sq, sk = (48, 48) if bias_shape == "keyrow" else (40, 56)
    q, k, v, bias, do = _inputs(2, 2, sq, sk, 32, bias_shape, seed=6)
    tq, tk, tv, tdo = (_t(a).to(torch.bfloat16) for a in (q, k, v, do))
    tb = _t(bias)
    scale = 1.0 / np.sqrt(32)
    o, lse = port_fa.flash_attention_fwd_plain(tq, tk, tv, tb,
                                               causal=causal)
    assert o.dtype == torch.bfloat16

    def jx(t):
        if t is None:
            return None
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    ref = _ref_fa._bwd((jx(tq), jx(tk), jx(tv), jx(tb), jx(o),
                        jnp.asarray(lse.numpy())[..., None]),
                       jx(tdo), scale, causal, BLOCK, BLOCK, True, False)
    got = port_fa.flash_attention_bwd_plain(tq, tk, tv, tb, o, lse, tdo,
                                            causal=causal, sm_scale=scale)
    delta = port_fa._delta(o, tdo)
    limits = port_fa.bf16_limits(tq, tk, tv, tb, tdo, lse, delta, causal,
                                 scale, rounding=False)
    for name, r, g in zip(("dq", "dk", "dv"), ref[:3], got[:3]):
        assert r.dtype == jnp.bfloat16 and g.dtype == torch.bfloat16, name
        hold_bf16(g, torch.from_numpy(np.asarray(r.astype(jnp.float32))),
                  limits[name], name)
