"""The fused-LSTM plain twins of paddle_tpu_torch against the Pallas
kernels of paddle_tpu (interpret mode on the CPU) and the scan oracle of
tests/test_fused_lstm.py.

The CUDA kernels themselves build and run only on a card (chip_smoke.py
holds them against these twins there); here the twins stand for them,
and FusedLSTM (the autograd.Function whose backward is the backward
kernel's twin) is held against jax.vjp of the interpreted kernel.
Cases: full lengths, ragged lengths, a zero-length row, T = 1, nonzero
h0/c0 and nonzero dh_last/dc_last cotangents; T <= 8, H <= 16.

Tolerances (float32, the same sums in another order; the measured gap
is ~5e-8 forward and ~5e-7 backward): forward atol 1e-5, backward
atol 1e-5 * max|g| per tensor.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.fused_lstm import fused_lstm as ref_fused_lstm
from paddle_tpu_torch.ops.kernels import fused_lstm as port
from test_fused_lstm import _scan_lstm

FWD_ATOL = 1e-5
BWD_ATOL_FRAC = 1e-5

# (label, T, B, H, lengths, nonzero h0/c0, nonzero last-state cotangents)
CASES = [
    ("full", 6, 4, 8, [6, 6, 6, 6], False, False),
    ("ragged", 7, 4, 16, [7, 2, 5, 1], True, False),
    ("zero_length", 6, 4, 8, [0, 3, 6, 1], True, True),
    ("t1", 1, 3, 8, [1, 0, 1], True, True),
    ("state_and_last", 8, 2, 16, [8, 4], True, True),
]


def _data(t, b, h, lens, state, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, b, 4 * h).astype(np.float32) * 0.5
    w = rng.randn(h, 4 * h).astype(np.float32) * 0.3
    bias = rng.randn(4 * h).astype(np.float32) * 0.1
    scale = 0.5 if state else 0.0
    h0 = rng.randn(b, h).astype(np.float32) * scale
    c0 = rng.randn(b, h).astype(np.float32) * scale
    return x, w, bias, h0, c0, np.asarray(lens, np.int32)


def _cotangents(t, b, h, last, seed):
    rng = np.random.RandomState(seed + 100)
    dh_all = rng.randn(t, b, h).astype(np.float32)
    dc_all = rng.randn(t, b, h).astype(np.float32)
    scale = 1.0 if last else 0.0
    return (dh_all, dc_all, rng.randn(b, h).astype(np.float32) * scale,
            rng.randn(b, h).astype(np.float32) * scale)


def _jax(a):
    return tuple(jnp.asarray(x) for x in a)


def _torch(a):
    return tuple(torch.from_numpy(np.array(x)) for x in a)


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """Inputs, cotangents and the reference's forward and vjp, once per
    case: (port inputs, port cotangents, ref forward, ref grads)."""
    label, t, b, h, lens, state, last = request.param
    seed = CASES.index(request.param)
    inputs = _data(t, b, h, lens, state, seed)
    cts = _cotangents(t, b, h, last, seed)
    ref_out, vjp = jax.vjp(
        lambda *a: ref_fused_lstm(*a, jnp.asarray(inputs[5]), True),
        *_jax(inputs[:5]))
    ref_grads = vjp(_jax(cts))
    return (inputs, cts, [np.asarray(o) for o in ref_out],
            [np.asarray(g) for g in ref_grads])


def test_plain_fwd_matches_pallas_and_scan(case):
    inputs, _, ref_out, _ = case
    got = port.fused_lstm_fwd_plain(*_torch(inputs))
    oracle = _scan_lstm(*_jax(inputs))
    for name, g, r, o in zip(("h_all", "c_all", "h_last", "c_last"), got,
                             ref_out, oracle):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=FWD_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(o), rtol=0,
                                   atol=FWD_ATOL, err_msg=f"{name} (scan)")


def test_plain_bwd_matches_pallas_vjp(case):
    inputs, cts, _, ref_grads = case
    t_in = _torch(inputs)
    h_all, c_all, _, _ = port.fused_lstm_fwd_plain(*t_in)
    got = port.fused_lstm_bwd_plain(*t_in, h_all, c_all, *_torch(cts))
    for name, g, r in zip(("dx", "dw", "db", "dh0", "dc0"), got, ref_grads):
        np.testing.assert_allclose(
            g.numpy(), r, rtol=0,
            atol=BWD_ATOL_FRAC * max(float(np.abs(r).max()), 1.0),
            err_msg=name)


def test_fused_lstm_autograd_matches_pallas_vjp(case):
    """FusedLSTM's backward (the CPU twin of the backward kernel) through
    torch.autograd.grad, as the __vjp__ replay calls it."""
    inputs, cts, ref_out, ref_grads = case
    leaves = [t.requires_grad_(True) for t in _torch(inputs[:5])]
    outs = port.fused_lstm(*leaves, torch.from_numpy(inputs[5]))
    for o, r in zip(outs, ref_out):
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=0,
                                   atol=FWD_ATOL)
    grads = torch.autograd.grad(outs, leaves, _torch(cts))
    for name, g, r in zip(("dx", "dw", "db", "dh0", "dc0"), grads,
                          ref_grads):
        np.testing.assert_allclose(
            g.numpy(), r, rtol=0,
            atol=BWD_ATOL_FRAC * max(float(np.abs(r).max()), 1.0),
            err_msg=name)


def test_unused_outputs_count_as_zero_cotangents():
    """Only h_all gets a cotangent (the lstm op's Hidden): the backward
    equals the reference's vjp with zeros for the other three."""
    inputs = _data(5, 3, 8, [5, 2, 0], True, seed=7)
    dh_all = np.random.RandomState(8).randn(5, 3, 8).astype(np.float32)
    _, vjp = jax.vjp(
        lambda *a: ref_fused_lstm(*a, jnp.asarray(inputs[5]), True),
        *_jax(inputs[:5]))
    zeros = np.zeros((3, 8), np.float32)
    ref = vjp(_jax((dh_all, np.zeros_like(dh_all), zeros, zeros)))
    leaves = [t.requires_grad_(True) for t in _torch(inputs[:5])]
    h_all = port.fused_lstm(*leaves, torch.from_numpy(inputs[5]))[0]
    grads = torch.autograd.grad(h_all, leaves, torch.from_numpy(dh_all))
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=BWD_ATOL_FRAC * 10)


def test_wrappers_take_plain_path_on_cpu_without_counting():
    inputs = _torch(_data(4, 2, 8, [4, 2], True, seed=3))
    before = (port.fused_lstm_fwd.launches, port.fused_lstm_bwd.launches)
    got = port.fused_lstm_fwd(*inputs)
    want = port.fused_lstm_fwd_plain(*inputs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cts = _torch(_cotangents(4, 2, 8, True, seed=3))
    got = port.fused_lstm_bwd(*inputs, *want[:2], *cts)
    for g, w in zip(got, port.fused_lstm_bwd_plain(*inputs, *want[:2],
                                                    *cts)):
        assert torch.equal(g, w)
    assert (port.fused_lstm_fwd.launches,
            port.fused_lstm_bwd.launches) == before


def test_meta_tensors_get_shapes_only():
    """Build-time shape inference traces the lstm op on "meta" tensors:
    the wrappers return outputs of the right shape without a time
    loop."""
    t, b, h = 13, 97, 16
    x = torch.empty(t, b, 4 * h, device="meta")
    w = torch.empty(h, 4 * h, device="meta")
    bias = torch.empty(4 * h, device="meta")
    h0 = c0 = torch.empty(b, h, device="meta")
    lengths = torch.empty(b, dtype=torch.int32, device="meta")
    outs = port.fused_lstm_fwd(x, w, bias, h0, c0, lengths)
    assert [tuple(o.shape) for o in outs] == [(t, b, h), (t, b, h), (b, h),
                                              (b, h)]
    grads = port.fused_lstm_bwd(x, w, bias, h0, c0, lengths, outs[0],
                                outs[1], outs[0], None)
    assert [tuple(g.shape) for g in grads] == [(t, b, 4 * h), (h, 4 * h),
                                               (4 * h,), (b, h), (b, h)]
    assert all(o.device.type == "meta" for o in outs + grads)


@pytest.mark.parametrize("bad", ["dtype", "strided", "lengths_dtype",
                                 "w_shape", "state_shape"])
def test_kernel_input_checks_raise(bad):
    """What the CUDA kernels cannot take is refused before any launch."""
    x = torch.zeros(4, 2, 32)
    w, bias = torch.zeros(8, 32), torch.zeros(32)
    h0 = c0 = torch.zeros(2, 8)
    lengths = torch.zeros(2, dtype=torch.int32)
    if bad == "dtype":
        x = x.double()
    elif bad == "strided":
        x = torch.zeros(2, 4, 32).transpose(0, 1)
    elif bad == "lengths_dtype":
        lengths = lengths.long()
    elif bad == "w_shape":
        w = torch.zeros(8, 16)
    else:
        h0 = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        port._check("fused_lstm_fwd", x, w, bias, h0, c0, lengths)
