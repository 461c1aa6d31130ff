"""Variable-length sequence ops over ragged batches, the LSTM and the GRU.

The port's copy of the part of ``paddle_tpu/ops/sequence_ops.py`` the
LSTM LM and the GRU encoder-decoder run: ``sequence_pool`` (level 1, all
six pool types), ``lstm`` and ``gru``, with ``_as_ragged``,
``_pool_padded`` and ``_masked_scan_rnn``.
Ragged data is (padded [n, maxlen, ...], int32 lengths), see
core/lod.py; every op here is registered ragged-aware and masks by the
lengths itself.

``lstm`` keeps the reference's two routes. The kernel route, for the
standard activations without peepholes, runs ``FusedLSTM``
(ops/kernels/fused_lstm.py): the hand-written CUDA kernels on CUDA
tensors, their plain twins on CPU tensors. The ``__pallas__`` attr, or
else PADDLE_TPU_PALLAS_LSTM (default "1"), picks it as the reference's
``pallas_dispatch`` does (``kernel_route``): "1" only where the op's
tensors lie on a CUDA card (the reference: only on a TPU), "force"
anywhere (the reference interprets its kernel off the TPU). "0" (or any
other value) takes the scan route, a torch loop over time, which also
serves peepholes and the other activations. The executor stamps the knob
onto the op before a run, as the reference's does (core/dispatch.py). ``gru`` has the same two routes, over ``FusedGRU``
(ops/kernels/fused_gru.py) and PADDLE_TPU_PALLAS_GRU, with the bias
folded into the input before the kernel as the reference does. The other
sequence ops and the nested levels wait for later slices.
"""
from __future__ import annotations

from functools import partial

import torch

from .. import flags
from ..core.lod import RaggedPair
from ..core.registry import register_op
from .kernels.fused_gru import fused_gru
from .kernels.fused_lstm import fused_lstm

# Every op in this module consumes/produces RaggedPair values natively.
register_op_SEQ = partial(register_op, ragged_aware=True)


def _as_ragged(x) -> RaggedPair:
    if isinstance(x, RaggedPair):
        return x
    # Dense [n, t, ...] with all lengths = t.
    lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                         device=x.device)
    return RaggedPair(x, lengths)


def _pool_padded(x: RaggedPair, ptype: str):
    """Pool the time axis of a level-1 ragged batch -> dense [n, *feat]."""
    data, lengths = x.data, x.lengths
    mask = x.mask()
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    maskf = mask.to(data.dtype)
    denom_shape = (-1,) + (1,) * (data.ndim - 2)
    if ptype == "SUM":
        return torch.sum(data * maskf, dim=1)
    if ptype == "AVERAGE":
        denom = torch.clamp(lengths, min=1).to(data.dtype)
        return torch.sum(data * maskf, dim=1) / denom.reshape(denom_shape)
    if ptype == "SQRT":
        denom = torch.sqrt(torch.clamp(lengths, min=1).to(data.dtype))
        return torch.sum(data * maskf, dim=1) / denom.reshape(denom_shape)
    if ptype == "MAX":
        neg = torch.finfo(data.dtype).min
        # amax splits the gradient evenly among ties, as jnp.max does
        return torch.amax(torch.where(mask, data, torch.full_like(data, neg)),
                          dim=1)
    if ptype == "LAST":
        idx = torch.clamp(lengths - 1, min=0).long()
        idx = idx.reshape((-1, 1) + (1,) * (data.ndim - 2))
        return torch.gather(data, 1, idx.expand((-1, 1) + data.shape[2:])
                            ).squeeze(1)
    if ptype == "FIRST":
        return data[:, 0]
    raise ValueError(f"unknown pooltype {ptype}")


@register_op_SEQ("sequence_pool")
def _sequence_pool(ctx):
    x = ctx.input("X")
    ptype = ctx.attr("pooltype", "AVERAGE").upper()
    ctx.set_output("Out", _pool_padded(_as_ragged(x), ptype))


# -- recurrent nets ---------------------------------------------------------

def _masked_scan_rnn(step, xs, init_states, lengths):
    """Run `step` over time axis 1 of xs, freezing state past each row's
    length; step(carry, x_t) -> (carry, out_t), carry a tuple. Returns
    (final carry, outputs stacked on axis 1, zero past each length)."""
    carry = tuple(init_states)
    outs = []
    for t in range(xs.shape[1]):
        new_carry, out_t = step(carry, xs[:, t])
        is_tuple = isinstance(out_t, tuple)
        alive0 = t < lengths

        def keep(o):
            return alive0.reshape((-1,) + (1,) * (o.ndim - 1))

        carry = tuple(torch.where(keep(n), n, o)
                      for n, o in zip(new_carry, carry))
        masked = tuple(o * keep(o).to(o.dtype)
                       for o in (out_t if is_tuple else (out_t,)))
        outs.append(masked if is_tuple else masked[0])
    if outs and isinstance(outs[0], tuple):
        return carry, tuple(torch.stack(o, dim=1) for o in zip(*outs))
    return carry, torch.stack(outs, dim=1)


_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": lambda x: x}


def kernel_route(attr, knob_env, x) -> bool:
    """Whether an RNN op over tensor `x` takes its kernel route, by the
    reference's ``pallas_dispatch`` policy on the op's `__pallas__` attr,
    else its knob (PADDLE_TPU_PALLAS_LSTM or _GRU): "force" anywhere,
    "1" where x lies on a CUDA card, anything else never."""
    knob = attr if attr is not None else flags.get(knob_env)
    return knob == "force" or (knob == "1" and x.is_cuda)


def _reverse_index(lengths, t):
    """[n, t] source positions that reverse each row's valid prefix:
    (len-1-pos) mod t, with the floor-mod sign of jnp's %."""
    pos = torch.arange(t, device=lengths.device, dtype=lengths.dtype)
    return torch.remainder(lengths[:, None] - 1 - pos[None, :], t).long()


def _take_time(data, idx):
    return torch.gather(data, 1, idx[..., None].expand(-1, -1,
                                                       data.shape[2]))


@register_op_SEQ("lstm")
def _lstm(ctx):
    """Dynamic LSTM over ragged input (reference: lstm_op.cc).

    Input: ragged [n, t, 4h] (already projected by a mul op, as in the
    reference), Weight [h, 4h] recurrent weights, Bias [1, 4h], or
    [1, 7h] with the peephole weights W_ic, W_fc, W_oc after the gate
    bias. Gate order i, c, f, o. Outputs Hidden and Cell (ragged), and
    LastH and LastC, the state after each row's last step.
    """
    x = _as_ragged(ctx.input("Input"))
    w = ctx.input("Weight")
    b = ctx.input("Bias")
    h_dim = w.shape[0]
    n = x.data.shape[0]
    gate_act = _ACT[ctx.attr("gate_activation", "sigmoid")]
    cell_act = _ACT[ctx.attr("cell_activation", "tanh")]
    cand_act = _ACT[ctx.attr("candidate_activation", "tanh")]
    is_reverse = ctx.attr("is_reverse", False)

    data = x.data
    if is_reverse:
        idx = _reverse_index(x.lengths, data.shape[1])
        data = _take_time(data, idx)

    h0 = ctx.input("H0")
    c0 = ctx.input("C0")
    zeros = dict(dtype=data.dtype, device=data.device)
    h0 = h0 if h0 is not None else torch.zeros((n, h_dim), **zeros)
    c0 = c0 if c0 is not None else torch.zeros((n, h_dim), **zeros)

    use_peepholes = ctx.attr("use_peepholes", False) and b is not None \
        and b.reshape(-1).shape[0] >= 7 * h_dim
    if use_peepholes:
        bflat = b.reshape(-1)
        w_ic = bflat[4 * h_dim:5 * h_dim].reshape(1, -1)
        w_fc = bflat[5 * h_dim:6 * h_dim].reshape(1, -1)
        w_oc = bflat[6 * h_dim:7 * h_dim].reshape(1, -1)

    eligible = (
        not use_peepholes
        and ctx.attr("gate_activation", "sigmoid") == "sigmoid"
        and ctx.attr("cell_activation", "tanh") == "tanh"
        and ctx.attr("candidate_activation", "tanh") == "tanh")
    if eligible and kernel_route(ctx.attr("__pallas__"),
                                 "PADDLE_TPU_PALLAS_LSTM", data):
        bias = b.reshape(-1)[:4 * h_dim] if b is not None else \
            torch.zeros((4 * h_dim,), **zeros)
        h_tm, c_tm, h_last, c_last = fused_lstm(
            data.transpose(0, 1).contiguous(), w.contiguous(), bias,
            h0.contiguous(), c0.contiguous(), x.lengths)
        hidden = h_tm.transpose(0, 1)
        cells = c_tm.transpose(0, 1)
    else:
        def step(carry, x_t):
            h_prev, c_prev = carry
            gates = x_t + h_prev @ w
            if b is not None:
                gates = gates + b.reshape(1, -1)[:, :4 * h_dim]
            i, c_hat, f, o = torch.split(gates, h_dim, dim=-1)
            if use_peepholes:
                i = i + w_ic * c_prev
                f = f + w_fc * c_prev
            i = gate_act(i)
            f = gate_act(f)
            c = f * c_prev + i * cand_act(c_hat)
            if use_peepholes:
                o = o + w_oc * c
            o = gate_act(o)
            h = o * cell_act(c)
            return (h, c), (h, c)

        (h_last, c_last), (hidden, cells) = _masked_scan_rnn(
            step, data, (h0, c0), x.lengths)
    if is_reverse:
        hidden = _take_time(hidden, idx)
        cells = _take_time(cells, idx)
    ctx.set_output("Hidden", RaggedPair(hidden, x.lengths))
    ctx.set_output("Cell", RaggedPair(cells, x.lengths))
    ctx.set_output("LastH", h_last)
    ctx.set_output("LastC", c_last)


@register_op_SEQ("gru")
def _gru(ctx):
    """Dynamic GRU over ragged input (reference: gru_op.cc).

    Input: ragged [n, t, 3h] (already projected by a mul op), Weight
    [h, 3h] packing the [h, 2h] update/reset and [h, h] candidate
    weights, Bias [1, 3h], optional H0 [n, h]. Gate order u, r, c.
    Outputs Hidden (ragged) and LastH, the state after each row's last
    step (H0 for a zero-length row).
    """
    x = _as_ragged(ctx.input("Input"))
    w = ctx.input("Weight")
    b = ctx.input("Bias")
    h_dim = w.shape[0]
    n = x.data.shape[0]
    gate_act = _ACT[ctx.attr("gate_activation", "sigmoid")]
    cand_act = _ACT[ctx.attr("activation", "tanh")]
    w_ur = w[:, :2 * h_dim]
    w_c = w[:, 2 * h_dim:]

    h0 = ctx.input("H0")
    h0 = h0 if h0 is not None else torch.zeros(
        (n, h_dim), dtype=x.data.dtype, device=x.data.device)

    data = x.data
    is_reverse = ctx.attr("is_reverse", False)
    if is_reverse:
        # reverse each sequence's valid prefix (as the lstm op does)
        idx = _reverse_index(x.lengths, data.shape[1])
        data = _take_time(data, idx)

    eligible = (ctx.attr("gate_activation", "sigmoid") == "sigmoid"
                and ctx.attr("activation", "tanh") == "tanh")
    if eligible and kernel_route(ctx.attr("__pallas__"),
                                 "PADDLE_TPU_PALLAS_GRU", data):
        gdata = data if b is None else data + b.reshape(1, 1, -1)
        h_tm, h_last = fused_gru(gdata.transpose(0, 1).contiguous(),
                                 w.contiguous(), h0.contiguous(), x.lengths)
        hidden = h_tm.transpose(0, 1)
    else:
        def step(carry, x_t):
            (h_prev,) = carry
            if b is not None:
                x_t = x_t + b.reshape(1, -1)
            xu, xr, xc = torch.split(x_t, h_dim, dim=-1)
            ur = h_prev @ w_ur
            hu, hr = torch.split(ur, h_dim, dim=-1)
            u = gate_act(xu + hu)
            r = gate_act(xr + hr)
            c = cand_act(xc + (r * h_prev) @ w_c)
            h = u * h_prev + (1 - u) * c
            return (h,), h

        (h_last,), hidden = _masked_scan_rnn(step, data, (h0,), x.lengths)
    if is_reverse:
        hidden = _take_time(hidden, idx)
    ctx.set_output("Hidden", RaggedPair(hidden, x.lengths))
    ctx.set_output("LastH", h_last)
