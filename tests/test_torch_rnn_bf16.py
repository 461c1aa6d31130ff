"""The bf16 arms of the fused-LSTM and fused-GRU plain twins of
paddle_tpu_torch against the Pallas kernels of paddle_tpu (interpret
mode on the CPU), in the dtype mixes the programs pass them under AMP.

The Pallas kernels take any float dtype: they widen every operand to
float32, carry the state and every sum in float32, and round each output
to its own input's dtype at store (h_all, c_all, h_last, c_last and dx to
x's, dW to W's, dh0/dc0 to h0's/c0's; dW and db summed from the float32
dgates). The twins (the port's route on the CPU, and the CUDA kernels'
yardstick on the card) do the same in torch. Mixes:

- LSTM ``lm``: bf16 x, h0, c0 (zeros) and float32 w, b: the LSTM LM under
  AMP (x comes out of a bf16 ``mul``; h0, c0 are zeros in x's dtype);
- LSTM ``bf16``: everything bf16, nonzero h0, c0 and last-state
  cotangents, a zero-length row;
- LSTM ``state``: float32 x with a bf16 h0, c0;
- GRU ``nmt``: float32 x (the op adds the float32 bias, which promotes),
  float32 w, a bf16 h0: the book NMT under AMP; its dh0 comes out as the
  reference's kernel dh0 (bf16) plus a zero-length row's float32 h_last
  cotangent, which jnp promotes to float32;
- GRU ``bf16``: bf16 x and h0 with float32 w (a bias-free ``dynamic_gru``
  under AMP), nonzero h0, a zero-length row and an h_last cotangent;
- GRU ``w_bf16``: bf16 x, w and h0.

Every output and gradient has the reference's dtype. bf16 values hold
within one bf16 ulp of the stored value plus 1e-5 of their sum of
|terms| (``fused_lstm.bf16_excess`` <= 1 with ``fused_lstm.step_terms``);
float32 values within 1e-5 (forward, absolute) and 1e-5 * max|g|
(backward), as tests/test_torch_fused_lstm.py holds the float32 twins.

A pinning test: a GRU backward twin that reads the forward's gates (taken
from its float32 state) where the reference recomputes them at the
stored, rounded h_all misses the reference on bf16 streams.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.fused_gru import fused_gru as ref_fused_gru
from paddle_tpu.ops.pallas.fused_lstm import fused_lstm as ref_fused_lstm
from paddle_tpu_torch.ops.kernels import fused_gru as fg
from paddle_tpu_torch.ops.kernels import fused_lstm as fl

FWD_ATOL = 1e-5
BWD_ATOL_FRAC = 1e-5
F32, BF16 = torch.float32, torch.bfloat16
_JAX = {F32: jnp.float32, BF16: jnp.bfloat16}


def _jax(t):
    """A torch tensor as a JAX array of its dtype (bf16 through float32,
    exact)."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _torch(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16)
    return torch.from_numpy(np.array(a))


def _dtype(a):
    return str(a.dtype).replace("torch.", "")


def _hold(name, got, want, terms):
    """got (port) against want (reference, as torch): the same dtype, and
    the bf16 rule or the float32 tolerance."""
    assert _dtype(got) == _dtype(want), (name, got.dtype, want.dtype)
    if got.dtype == BF16:
        assert fl.bf16_excess(got, want, terms) <= 1.0, name
    else:
        np.testing.assert_allclose(
            got.double().numpy(), want.double().numpy(), rtol=0,
            atol=terms, err_msg=name)


def _rnd(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


# -- LSTM ---------------------------------------------------------------------

# (label, T, B, H, lengths, x, w/b, h0/c0 dtypes, nonzero state and
# last-state cotangents)
LSTM_CASES = [
    ("lm", 6, 4, 8, [6, 3, 5, 2], BF16, F32, BF16, False),
    ("bf16", 5, 3, 16, [5, 0, 2], BF16, BF16, BF16, True),
    ("state", 4, 2, 8, [4, 1], F32, F32, BF16, True),
]


@functools.lru_cache(maxsize=None)
def _lstm_case(label):
    """(inputs, cotangents) in the case's dtypes, the reference's forward
    and vjp (as torch tensors), and the port's through FusedLSTM; once
    per case."""
    case = next(c for c in LSTM_CASES if c[0] == label)
    _, t, b, h, lens, xdt, wdt, sdt, state = case
    g = torch.Generator().manual_seed(LSTM_CASES.index(case))
    scale = 0.5 if state else 0.0
    inputs = (_rnd(g, t, b, 4 * h, scale=0.5).to(xdt),
              _rnd(g, h, 4 * h, scale=0.3).to(wdt),
              _rnd(g, 4 * h, scale=0.1).to(wdt),
              _rnd(g, b, h, scale=scale).to(sdt),
              _rnd(g, b, h, scale=scale).to(sdt))
    lengths = torch.tensor(lens, dtype=torch.int32)
    outs, vjp = jax.vjp(
        lambda *a: ref_fused_lstm(*a, jnp.asarray(lens, jnp.int32), True),
        *[_jax(v) for v in inputs])
    last = 1.0 if state else 0.0
    cts = (_rnd(g, t, b, h).to(xdt), _rnd(g, t, b, h).to(xdt),
           (_rnd(g, b, h) * last).to(xdt), (_rnd(g, b, h) * last).to(xdt))
    ref_grads = vjp(tuple(_jax(c) for c in cts))
    leaves = [v.clone().requires_grad_(True) for v in inputs]
    port_out = fl.fused_lstm(*leaves, lengths)
    port_grads = torch.autograd.grad(port_out, leaves, cts)
    return dict(inputs=inputs, lengths=lengths, cts=cts,
                ref_out=[_torch(o) for o in outs],
                ref_grads=[_torch(v) for v in ref_grads],
                port_out=[o.detach() for o in port_out],
                port_grads=port_grads)


@pytest.mark.parametrize("label", [c[0] for c in LSTM_CASES])
def test_lstm_twins_match_pallas_in_bf16(label):
    c = _lstm_case(label)
    x, w, bias, h0, c0 = c["inputs"]
    h_prev = torch.cat([h0[None].float(), c["ref_out"][0][:-1].float()])
    fwd_terms = fl.step_terms(h_prev, w, x, bias)
    for name, got, want in zip(("h_all", "c_all", "h_last", "c_last"),
                               c["port_out"], c["ref_out"]):
        assert got.dtype == x.dtype
        _hold(name, got, want, fwd_terms if got.dtype == BF16 else FWD_ATOL)
    dh_all, dc_all = fl.fold_last(*c["cts"], c["lengths"])
    bwd_terms = fl.step_terms(c["ref_grads"][0].float(), w.t(), dh_all,
                              dc_all)
    for name, got, want, inp in zip(("dx", "dw", "db", "dh0", "dc0"),
                                    c["port_grads"], c["ref_grads"],
                                    c["inputs"]):
        assert got.dtype == inp.dtype, name
        _hold(name, got, want, bwd_terms if got.dtype == BF16 else
              BWD_ATOL_FRAC * max(float(want.abs().max()), 1.0))


def test_lstm_bwd_twin_sums_dw_from_float32_dgates():
    """dW and db from the twin's float32 dgates, not from the rounded dx:
    on bf16 streams (the lm mix, float32 w) the two differ by far more
    than the float32 tolerance, and the twin is on the reference's
    side."""
    c = _lstm_case("lm")
    x, w, bias, h0, c0 = c["inputs"]
    h_all = c["port_out"][0]
    rows = torch.cat([h0[None].float(), h_all[:-1].float()]).reshape(
        -1, w.shape[0])
    rounded = rows.t() @ c["port_grads"][0].float().reshape(rows.shape[0],
                                                              -1)
    want = c["ref_grads"][1]
    tol = BWD_ATOL_FRAC * max(float(want.abs().max()), 1.0)
    assert float((c["port_grads"][1] - want).abs().max()) <= tol
    assert float((rounded - want).abs().max()) > 10 * tol


# -- GRU ----------------------------------------------------------------------

# (label, T, B, H, lengths, x, w, h0 dtypes, nonzero h0 and h_last
# cotangent)
GRU_CASES = [
    ("nmt", 6, 4, 8, [6, 0, 5, 2], F32, F32, BF16, True),
    ("bf16", 5, 3, 16, [5, 0, 2], BF16, F32, BF16, True),
    ("w_bf16", 4, 2, 8, [4, 1], BF16, BF16, BF16, False),
]


def _gru_inputs(g, t, b, h, xdt, wdt, sdt, state):
    scale = 0.5 if state else 0.0
    return (_rnd(g, t, b, 3 * h, scale=0.5).to(xdt),
            _rnd(g, h, 3 * h, scale=0.3).to(wdt),
            _rnd(g, b, h, scale=scale).to(sdt))


@functools.lru_cache(maxsize=None)
def _gru_case(label):
    case = next(c for c in GRU_CASES if c[0] == label)
    _, t, b, h, lens, xdt, wdt, sdt, state = case
    g = torch.Generator().manual_seed(10 + GRU_CASES.index(case))
    inputs = _gru_inputs(g, t, b, h, xdt, wdt, sdt, state)
    lengths = torch.tensor(lens, dtype=torch.int32)
    outs, vjp = jax.vjp(
        lambda *a: ref_fused_gru(*a, jnp.asarray(lens, jnp.int32), True),
        *[_jax(v) for v in inputs])
    cts = (_rnd(g, t, b, h).to(xdt),
           (_rnd(g, b, h) * (1.0 if state else 0.0)).to(xdt))
    ref_grads = vjp(tuple(_jax(c) for c in cts))
    leaves = [v.clone().requires_grad_(True) for v in inputs]
    port_out = fg.fused_gru(*leaves, lengths)
    port_grads = torch.autograd.grad(port_out, leaves, cts)
    x, w, h0 = inputs
    fwd = fg.fused_gru_fwd_plain(x, w, h0, lengths)
    recompute = x.dtype == BF16
    plain_grads = fg.fused_gru_bwd_plain(
        w, h0, lengths, fwd[0], None if recompute else fwd[2], *cts,
        x=x if recompute else None)
    return dict(inputs=inputs, lengths=lengths, cts=cts, fwd=fwd,
                ref_out=[_torch(o) for o in outs],
                ref_grads=[_torch(v) for v in ref_grads],
                port_out=[o.detach() for o in port_out],
                port_grads=port_grads, plain_grads=plain_grads)


def _gru_terms(c):
    x, w, h0 = c["inputs"]
    h_prev = torch.cat([h0[None].float(), c["ref_out"][0][:-1].float()])
    dh_all, _ = fg.fold_last(*c["cts"], c["lengths"])
    return (fl.step_terms(h_prev, w, x),
            fl.step_terms(c["ref_grads"][0].float(), w.t(), dh_all))


@pytest.mark.parametrize("label", [c[0] for c in GRU_CASES])
def test_gru_twins_match_pallas_in_bf16(label):
    c = _gru_case(label)
    x, w, h0 = c["inputs"]
    fwd_terms, bwd_terms = _gru_terms(c)
    for name, got, want in zip(("h_all", "h_last"), c["port_out"],
                               c["ref_out"]):
        assert got.dtype == x.dtype
        _hold(name, got, want, fwd_terms if got.dtype == BF16 else FWD_ATOL)
    # the plain backward's dtypes are the reference's (dh0 of the nmt mix
    # promoted to float32 by the zero-length row's h_last cotangent);
    # through autograd each gradient takes its input's dtype
    for name, got, want, inp, grad in zip(
            ("dx", "dw", "dh0"), c["plain_grads"], c["ref_grads"],
            c["inputs"], c["port_grads"]):
        _hold(name, got, want, bwd_terms if got.dtype == BF16 else
              BWD_ATOL_FRAC * max(float(want.abs().max()), 1.0))
        assert grad.dtype == inp.dtype
        assert torch.equal(grad, got.to(inp.dtype)), name


@pytest.mark.parametrize("label", ["bf16", "w_bf16"])
def test_gru_bwd_twin_with_float32_state_gates_is_caught(label):
    """On bf16 streams the reference recomputes u, r, c at the stored,
    rounded h_all; the forward's gates came from its float32 state. A
    twin that reads those gates (the float32 arm's shortcut) misses the
    reference's dW by more than the float32 tolerance, or its dx by more
    than the bf16 rule, where the recomputing twin holds."""
    c = _gru_case(label)
    x, w, h0 = c["inputs"]
    shortcut = fg.fused_gru_bwd_plain(w, h0, c["lengths"], c["fwd"][0],
                                      c["fwd"][2], *c["cts"])
    _, bwd_terms = _gru_terms(c)
    dw_want = c["ref_grads"][1].float()
    tol = BWD_ATOL_FRAC * max(float(dw_want.abs().max()), 1.0)
    assert float((c["plain_grads"][1].float() - dw_want).abs().max()) <= tol
    assert float((shortcut[1].float() - dw_want).abs().max()) > tol or \
        fl.bf16_excess(shortcut[0], c["ref_grads"][0], bwd_terms) > 1.0
    assert not torch.equal(c["fwd"][2], fg.gates_plain(x, w, h0,
                                                       c["fwd"][0]))


def test_bf16_wrappers_check_dtypes():
    """The kernels' input check takes float32 or bf16 streams, all alike,
    and float32 or bf16 small tensors; float16, float64 and mixed streams
    raise, naming the dtype."""
    x = torch.zeros(3, 2, 32, dtype=BF16)
    w, bias = torch.zeros(8, 32), torch.zeros(32, dtype=BF16)
    h0 = c0 = torch.zeros(2, 8, dtype=BF16)
    lengths = torch.zeros(2, dtype=torch.int32)
    fl._check("fused_lstm_fwd", x, w, bias, h0, c0, lengths)
    for bad in (dict(x=x.half()), dict(w=w.double()),
                dict(h0=h0.half())):
        args = dict(x=x, w=w, b=bias, h0=h0, c0=c0)
        args.update(bad)
        with pytest.raises(ValueError, match="float16|float64"):
            fl._check("fused_lstm_fwd", args["x"], args["w"], args["b"],
                      args["h0"], args["c0"], lengths)
    with pytest.raises(ValueError, match="streams"):
        fl._check("fused_lstm_bwd", x, w, bias, h0, c0, lengths,
                  h_all=torch.zeros(3, 2, 8))
    xg = torch.zeros(3, 2, 24, dtype=BF16)
    fg._check("fused_gru_fwd", "x", torch.zeros(8, 24), h0, lengths, x=xg)
    with pytest.raises(ValueError, match="streams"):
        fg._check("fused_gru_bwd", "x", torch.zeros(8, 24), h0, lengths,
                  x=xg, h_all=torch.zeros(3, 2, 8),
                  dh_all=torch.zeros(3, 2, 8, dtype=BF16))
    with pytest.raises(ValueError, match="float16"):
        fg._check("fused_gru_fwd", "x", torch.zeros(8, 24), h0.half(),
                  lengths, x=xg)
