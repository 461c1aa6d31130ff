"""Variable-length sequence ops over ragged batches, and the RNNs.

The port's copy of ``paddle_tpu/ops/sequence_ops.py``, all 26 op types:
the sequence_* ops, nested_sequence_flatten/pack, sequence_conv and
row_conv, the scan RNNs (lstm, gru, lstmp) and the one-step cells
(lstm_unit, gru_unit), CTC (warpctc, ctc_greedy_decoder, ctc_align) and
multihead_seq_attention. Ragged data is (padded [n, maxlen, ...], int32
lengths), see core/lod.py; every op here but the two cells is registered
ragged-aware and masks by the lengths itself. sequence_pool,
sequence_last_step and sequence_first_step also take a 2-level
RaggedNested and pool its token level, keeping the outer level;
nested_sequence_flatten peels one level off a RaggedNested or RaggedTree
(padding slots become length-0 rows) and nested_sequence_pack puts dense
per-sub-sequence rows back under a nested value's outer lengths.

Each op's gradient comes through torch autograd (the ``__vjp__`` op), as
the reference's comes through jax.vjp. Where jnp promotes a bf16 operand
against a float32 one (a product with a float32 weight under AMP), the
port promotes too (``_promoted``); torch's matmul and einsum would
refuse the mix. The CTC recursion is a python loop over time under
autograd; the decoders and sequence_erase compact with a stable argsort
or a scatter into a trash slot, as the reference does.

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
folded into the input before the kernel as the reference does. lstmp has
only the scan.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from .. import flags
from ..core.lod import RaggedNested, RaggedPair, RaggedTree
from ..core.registry import register_op
from .kernels.fused_gru import fused_gru
from .kernels.fused_lstm import fused_lstm
from .tensor_ops import jnp_reshape

# Every op in this module but the one-step cells consumes/produces ragged
# values natively.
register_op_SEQ = partial(register_op, ragged_aware=True)


def _as_ragged(x) -> RaggedPair:
    if isinstance(x, RaggedPair):
        return x
    if isinstance(x, (RaggedNested, RaggedTree)):
        raise ValueError(
            "this sequence op works on level-1 ragged input but got a "
            "2-level (nested) ragged value — reduce the token level first "
            "(sequence_pool / sequence_last_step) or flatten it with "
            "nested_sequence_flatten")
    # Dense [n, t, ...] with all lengths = t.
    lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                         device=x.device)
    return RaggedPair(x, lengths)


def _promoted(*xs):
    """xs in their common dtype, as jnp promotes the operands of a
    product (bf16 with float32 -> float32)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _mm(a, b):
    return torch.matmul(*_promoted(a, b))


def _einsum(eq, a, b):
    return torch.einsum(eq, *_promoted(a, b))


def _expand_to(idx, data):
    """A [n, t] index over data's dims 0-1, broadcast over its feature
    dims (torch.gather wants the index at the output's full shape)."""
    idx = idx.long().reshape(idx.shape + (1,) * (data.ndim - 2))
    return idx.expand(idx.shape[:2] + data.shape[2:])


def _take_along_time(data, idx):
    """data[i, idx[i, j], ...]: jnp.take_along_axis on axis 1."""
    return torch.gather(data, 1, _expand_to(idx, data))


def _feat_mask(mask, data):
    """A [n, t] mask shaped to multiply data [n, t, *feat]."""
    return mask.reshape(mask.shape + (1,) * (data.ndim - 2)).to(data.dtype)


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
        # a length-0 row reads its slot 0, as the reference's max(len-1, 0)
        idx = torch.clamp(lengths - 1, min=0)[:, None]
        return _take_along_time(data, idx).squeeze(1)
    if ptype == "FIRST":
        return data[:, 0]
    raise ValueError(f"unknown pooltype {ptype}")


def _pool_nested(x: RaggedNested, ptype: str) -> RaggedPair:
    """Pool the innermost (token) level of a 2-level ragged batch; the
    result keeps the outer level (reference LoD semantics: pooling one
    level of a 2-level LoDTensor yields a 1-level LoDTensor)."""
    out_flat = _pool_padded(x.flatten(), ptype)
    n, s = x.data.shape[:2]
    return RaggedPair(out_flat.reshape((n, s) + out_flat.shape[1:]),
                      x.sub_lengths)


def _pool(x, ptype):
    if isinstance(x, RaggedNested):
        return _pool_nested(x, ptype)
    return _pool_padded(_as_ragged(x), ptype)


@register_op_SEQ("sequence_pool")
def _sequence_pool(ctx):
    ctx.set_output("Out", _pool(ctx.input("X"),
                                ctx.attr("pooltype", "AVERAGE").upper()))


@register_op_SEQ("sequence_last_step")
def _sequence_last_step(ctx):
    ctx.set_output("Out", _pool(ctx.input("X"), "LAST"))


@register_op_SEQ("sequence_first_step")
def _sequence_first_step(ctx):
    ctx.set_output("Out", _pool(ctx.input("X"), "FIRST"))


@register_op_SEQ("nested_sequence_flatten")
def _nested_sequence_flatten(ctx):
    """Nested ragged -> one level shallower, over a batch of n*max_sub
    roots (padding slots have length 0). 2-level input yields a level-1
    ragged batch the RNN/sequence ops consume directly; a depth-k
    RaggedTree yields depth k-1 (apply repeatedly to peel an
    arbitrary-depth LoD — lod_tensor.h:55-107)."""
    x = ctx.input("X")
    if not isinstance(x, (RaggedNested, RaggedTree)):
        raise ValueError("nested_sequence_flatten needs a nested ragged "
                         "input (feed a LoDTensor with >= 2 LoD levels)")
    ctx.set_output("Out", x.flatten())


@register_op_SEQ("nested_sequence_pack", no_grad_slots=["Ref"])
def _nested_sequence_pack(ctx):
    """Dense per-sub-sequence rows [n*max_sub, *feat] (e.g. the inner
    encoder's last states) -> level-1 ragged [n, max_sub, *feat] with the
    outer lengths of Ref (2-level ragged or deeper RaggedTree). Inverse
    of nested_sequence_flatten after the inner levels are reduced away."""
    x = ctx.input("X")
    ref = ctx.input("Ref")
    if not isinstance(ref, (RaggedNested, RaggedTree)):
        raise ValueError("nested_sequence_pack needs a nested ragged Ref")
    if isinstance(x, (RaggedPair, RaggedNested, RaggedTree)):
        raise ValueError(
            "nested_sequence_pack expects DENSE per-sub-sequence rows "
            "[n*max_sub, *feat]; got a ragged value whose inner levels "
            "are still present — reduce them first (sequence_last_step / "
            "sequence_pool)")
    n, s = ref.data.shape[:2]
    outer = ref.sub_lengths if isinstance(ref, RaggedNested) \
        else ref.lengths[0]
    # jnp_reshape refuses with jnp's message, which build-time shape
    # inference records on the op as the reference's does (its trace
    # cannot see that X's batch is n * max_sub of Ref's)
    ctx.set_output("Out", RaggedPair(
        jnp_reshape(x, (n, s) + tuple(x.shape[1:])), outer))


@register_op_SEQ("sequence_softmax")
def _sequence_softmax(ctx):
    x = _as_ragged(ctx.input("X"))
    mask = x.mask()
    column = x.data.ndim == 3 and x.data.shape[-1] == 1
    logits = torch.where(mask, x.data.squeeze(-1) if column else x.data,
                         torch.tensor(-math.inf, dtype=x.data.dtype,
                                      device=x.data.device))
    probs = torch.softmax(logits, dim=1)
    probs = torch.where(mask, probs, torch.zeros_like(probs))
    if column:
        probs = probs[..., None]
    ctx.set_output("Out", RaggedPair(probs, x.lengths))


@register_op_SEQ("sequence_expand", no_grad_slots=["Y"])
def _sequence_expand(ctx):
    """Repeat each row of X per the ragged structure of Y
    (reference: sequence_expand_op.cc, level-0 broadcast form)."""
    x = ctx.input("X")          # dense [n, ...]
    y = _as_ragged(ctx.input("Y"))
    xd = x.data if isinstance(x, RaggedPair) else x
    out = torch.repeat_interleave(xd[:, None], y.data.shape[1], dim=1)
    ctx.set_output("Out", RaggedPair(out, y.lengths))


@register_op_SEQ("sequence_concat")
def _sequence_concat(ctx):
    """Concatenate along the time axis, each row's valid prefixes one
    after another: every piece lands through a one-hot [n, t, total]
    product, as the reference builds it (exact: one term a slot)."""
    xs = [_as_ragged(v) for v in ctx.inputs("X")]
    total_max = sum(x.data.shape[1] for x in xs)
    first = xs[0].data
    n = first.shape[0]
    out = torch.zeros((n, total_max) + tuple(first.shape[2:]),
                      dtype=first.dtype, device=first.device)
    lengths = xs[0].lengths
    for x in xs[1:]:
        lengths = lengths + x.lengths
    pos = torch.zeros((n,), dtype=torch.int32, device=first.device)
    t_idx = torch.arange(total_max, dtype=torch.int32, device=first.device)
    for x in xs:
        src_t = torch.arange(x.data.shape[1], dtype=torch.int32,
                             device=first.device)
        dest = pos[:, None] + src_t[None, :]
        valid = src_t[None, :] < x.lengths[:, None]
        onehot = (dest[:, :, None] == t_idx[None, None, :]) \
            & valid[:, :, None]
        out = out + torch.einsum("nst,ns...->nt...",
                                 onehot.to(x.data.dtype), x.data)
        pos = pos + x.lengths
    ctx.set_output("Out", RaggedPair(out, lengths))


@register_op_SEQ("sequence_reshape")
def _sequence_reshape(ctx):
    x = _as_ragged(ctx.input("X"))
    new_dim = ctx.attr("new_dim")
    n, t = x.data.shape[:2]
    d = x.data.shape[2] if x.data.ndim > 2 else 1
    out = x.data.reshape(n, (t * d) // new_dim, new_dim)
    ctx.set_output("Out", RaggedPair(out, (x.lengths * d) // new_dim))


@register_op_SEQ("sequence_slice", no_grad_slots=["Offset", "Length"])
def _sequence_slice(ctx):
    x = _as_ragged(ctx.input("X"))
    offset = ctx.input("Offset").reshape(-1).to(torch.int32)
    length = ctx.input("Length").reshape(-1).to(torch.int32)
    maxlen = x.data.shape[1]
    t = torch.arange(maxlen, dtype=torch.int32, device=x.data.device)
    src = torch.clamp(offset[:, None] + t[None, :], max=maxlen - 1)
    out = _take_along_time(x.data, src)
    mask = t[None, :] < length[:, None]
    ctx.set_output("Out", RaggedPair(out * _feat_mask(mask, out), length))


@register_op_SEQ("sequence_erase", no_grad_slots=["X"])
def _sequence_erase(ctx):
    x = _as_ragged(ctx.input("X"))
    data = x.data
    keep = torch.ones(data.shape[:2], dtype=torch.bool, device=data.device)
    for tok in ctx.attr("tokens", []):
        keep &= (data.squeeze(-1) if data.ndim == 3 else data) != tok
    keep &= x.mask()
    # compact kept tokens to the left (stable)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    gathered = _take_along_time(data, order)
    new_len = keep.sum(dim=1).to(torch.int32)
    t = torch.arange(data.shape[1], dtype=torch.int32, device=data.device)
    mask = t[None, :] < new_len[:, None]
    ctx.set_output("Out", RaggedPair(gathered * _feat_mask(mask, data),
                                     new_len))


def _time_shifted(data, shift):
    """data rolled by -shift along time, zero where t + shift leaves
    [0, t): the context window's column `shift`."""
    t = data.shape[1]
    tt = torch.arange(t, device=data.device)
    valid = ((tt + shift >= 0) & (tt + shift < t))[None, :, None]
    rolled = torch.roll(data, -shift, dims=1)
    return torch.where(valid, rolled, torch.zeros_like(rolled))


@register_op_SEQ("sequence_conv")
def _sequence_conv(ctx):
    """Context-window projection over each sequence
    (reference: sequence_conv_op.cc / ContextProjection function). The
    window reads the padded data as it lies (past a row's length too),
    as the reference's does; the output is masked to each length."""
    x = _as_ragged(ctx.input("X"))
    w = ctx.input("Filter")  # [ctx_len * d, out_d]
    ctx_len = ctx.attr("contextLength", 3)
    ctx_start = ctx.attr("contextStart", -(ctx_len // 2))
    data = x.data  # [n, t, d]
    ctxmat = torch.cat([_time_shifted(data, ctx_start + i)
                        for i in range(ctx_len)], dim=-1)
    out = _einsum("ntc,co->nto", ctxmat, w)
    ctx.set_output("Out", RaggedPair(out * _feat_mask(x.mask(), out),
                                     x.lengths))


@register_op_SEQ("row_conv")
def _row_conv(ctx):
    """Lookahead convolution (reference: row_conv_op.cc): out[t] = sum_i
    x[t + i] * w[i] over the future context; the product promotes, as
    jnp's does."""
    x = _as_ragged(ctx.input("X"))
    w = ctx.input("Filter")  # [future_ctx, d]
    data = x.data
    outs = torch.zeros_like(data)
    for i in range(w.shape[0]):
        outs = outs + _time_shifted(data, i) * w[i][None, None]
    ctx.set_output("Out", RaggedPair(outs * _feat_mask(x.mask(), data),
                                     x.lengths))


@register_op_SEQ("sequence_mask", no_grad_slots=["X"])
def _sequence_mask(ctx):
    lengths = ctx.input("X").reshape(-1)
    maxlen = ctx.attr("maxlen", -1)
    if maxlen <= 0:
        raise ValueError("sequence_mask needs a static maxlen attr")
    pos = torch.arange(maxlen, dtype=lengths.dtype, device=lengths.device)
    ctx.set_output("Y", (pos[None, :] < lengths[:, None]).to(torch.float32))


@register_op_SEQ("sequence_pad")
def _sequence_pad(ctx):
    x = _as_ragged(ctx.input("X"))
    ctx.set_output("Out", x.data)
    ctx.set_output("Length", x.lengths.to(torch.int64))


@register_op_SEQ("sequence_unpad", no_grad_slots=["Length"])
def _sequence_unpad(ctx):
    lengths = ctx.input("Length").reshape(-1).to(torch.int32)
    ctx.set_output("Out", RaggedPair(ctx.input("X"), lengths))


@register_op_SEQ("sequence_reverse")
def _sequence_reverse(ctx):
    """Reverse each sequence's valid prefix, padding stays in place
    (reference: sequence_reverse_op.h)."""
    x = _as_ragged(ctx.input("X"))
    t = torch.arange(x.data.shape[1], dtype=torch.int32,
                     device=x.data.device)[None, :]
    lens = x.lengths.to(torch.int32)[:, None]
    src = torch.where(t < lens, lens - 1 - t, t)
    ctx.set_output("Y", RaggedPair(_take_along_time(x.data, src),
                                   x.lengths))


# -- CTC (reference: warpctc_op.cc wraps the warp-ctc CUDA lib;
# ctc_align_op.cc / Python ctc_greedy_decoder) ------------------------------

NEG_INF = -1e30


def _ctc_loss_single_batch(logits, logit_lens, labels, label_lens, blank):
    """CTC negative log-likelihood via the standard alpha recursion in log
    space, vectorized over the batch and looped over time.

    logits: [B, T, C] raw (pre-softmax); labels: int [B, L] padded.
    """
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    B, T, C = logp.shape
    L = labels.shape[1]
    U = 2 * L + 1
    dev = logp.device
    # extended label sequence with interleaved blanks: [B, U]
    ext = torch.full((B, U), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.to(torch.int64)
    # allow the s-2 skip where ext[s] is a real label != ext[s-2]
    skip_ok = torch.zeros((B, U), dtype=torch.bool, device=dev)
    skip_ok[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    # states beyond 2*label_len are invalid
    spos = torch.arange(U, device=dev)[None, :]
    label_lens = label_lens.to(torch.int64)
    state_valid = spos <= 2 * label_lens[:, None]
    neg = torch.full((B, U), NEG_INF, dtype=logp.dtype, device=dev)

    alpha = torch.where((spos <= 1) & state_valid,
                        torch.gather(logp[:, 0], 1, ext), neg)
    for t in range(1, T):
        emit = torch.gather(logp[:, t], 1, ext)
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg[:, :2], alpha[:, :-2]], dim=1)
        prev2 = torch.where(skip_ok, prev2, neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2) \
            + emit
        merged = torch.where(state_valid, merged, neg)
        # frozen past each sequence's end: carry alpha unchanged
        alive = (t < logit_lens)[:, None]
        alpha = torch.where(alive, merged, alpha)
    end1 = 2 * label_lens                          # final blank state
    end2 = torch.clamp(2 * label_lens - 1, min=0)  # final label state
    a1 = torch.gather(alpha, 1, end1[:, None])[:, 0]
    a2 = torch.gather(alpha, 1, end2[:, None])[:, 0]
    a2 = torch.where(label_lens > 0, a2, neg[:, 0])
    return -torch.logaddexp(a1, a2)


@register_op_SEQ("warpctc", no_grad_slots=["Label"])
def _warpctc(ctx):
    """CTC loss over ragged logits/labels (reference: warpctc_op.cc).
    Gradients flow through the recursion via autograd, as the
    reference's through its scan."""
    logits = _as_ragged(ctx.input("Logits"))
    label = _as_ragged(ctx.input("Label"))
    lab = label.data
    if lab.ndim == 3 and lab.shape[-1] == 1:
        lab = lab[..., 0]
    nll = _ctc_loss_single_batch(logits.data, logits.lengths, lab,
                                 label.lengths, ctx.attr("blank", 0))
    if ctx.attr("norm_by_times", False):
        nll = nll / torch.clamp(logits.lengths, min=1).to(nll.dtype)
    ctx.set_output("Loss", nll[:, None].to(logits.data.dtype))


def _compact(ids, keep):
    """The kept ids of each row moved to its front, zeros after: a
    scatter to cumsum positions, the dropped ones into a trash slot at
    T (the reference's static-shape compaction). -> (ids [B, T, 1]
    int32, int32 lengths)."""
    B, T = ids.shape
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    buf = torch.zeros((B, T + 1), dtype=torch.int32, device=ids.device)
    buf.scatter_(1, torch.where(keep, pos, T).long(), ids)
    return buf[:, :T, None], keep.to(torch.int32).sum(dim=1).to(torch.int32)


def _repeat_of_prev(ids):
    first = torch.full((ids.shape[0], 1), -1, dtype=torch.int32,
                       device=ids.device)
    return ids == torch.cat([first, ids[:, :-1]], dim=1)


@register_op_SEQ("ctc_greedy_decoder", no_grad_slots=["Input"])
def _ctc_greedy_decoder(ctx):
    """Best-path decode: argmax per frame, merge repeats, drop blanks
    (reference: Python ctc_greedy_decoder + ctc_align_op.cc)."""
    x = _as_ragged(ctx.input("Input"))  # [B, T, C] probs or logits
    best = torch.argmax(x.data, dim=-1).to(torch.int32)   # [B, T]
    keep = (best != ctx.attr("blank", 0)) & ~_repeat_of_prev(best) \
        & x.mask()
    ctx.set_output("Out", RaggedPair(*_compact(best, keep)))


@register_op_SEQ("ctc_align", no_grad_slots=["Input"])
def _ctc_align(ctx):
    """Merge repeated tokens (optional) then drop blanks (reference:
    ctc_align_op.cc)."""
    x = _as_ragged(ctx.input("Input"))      # [B, T, 1] or [B, T] token ids
    ids = x.data
    if ids.ndim == 3 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    ids = ids.to(torch.int32)
    keep = (ids != ctx.attr("blank", 0)) & x.mask()
    if ctx.attr("merge_repeated", True):
        keep = keep & ~_repeat_of_prev(ids)
    ctx.set_output("Output", RaggedPair(*_compact(ids, keep)))


# -- single-step RNN cells (reference: lstm_unit_op.cc, gru_unit_op.cc) ---

@register_op("lstm_unit")
def _lstm_unit(ctx):
    """One LSTM step on pre-projected gates (reference: lstm_unit_op.cc).
    X: [n, 4d] packed i, g (c_hat), f, o; C_prev: [n, d]. forget_bias is
    added to f before its sigmoid."""
    x = ctx.input("X")
    c_prev = ctx.input("C_prev")
    fb = ctx.attr("forget_bias", 0.0)
    d = c_prev.shape[-1]
    i, g, f, o = x[:, :d], x[:, d:2 * d], x[:, 2 * d:3 * d], x[:, 3 * d:]
    c = torch.sigmoid(f + fb) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    ctx.set_output("C", c)
    ctx.set_output("H", torch.sigmoid(o) * torch.tanh(c))


@register_op("gru_unit")
def _gru_unit(ctx):
    """One GRU step (reference: gru_unit_op.cc). Input: [n, 3d] projected
    x contributions; HiddenPrev [n, d]; Weight [d, 3d]; Bias [1, 3d]."""
    x = ctx.input("Input")
    h_prev = ctx.input("HiddenPrev")
    w = ctx.input("Weight")
    b = ctx.input("Bias")
    d = h_prev.shape[-1]
    if b is not None:
        x = x + b.reshape(1, -1)
    xu, xr, xc = x[:, :d], x[:, d:2 * d], x[:, 2 * d:]
    u = torch.sigmoid(xu + _mm(h_prev, w[:, :d]))
    r = torch.sigmoid(xr + _mm(h_prev, w[:, d:2 * d]))
    c = torch.tanh(xc + _mm(r * h_prev, w[:, 2 * d:]))
    h = u * h_prev + (1.0 - u) * c
    ctx.set_output("Gate", torch.cat([u, r, c], dim=-1))
    ctx.set_output("ResetHiddenPrev", r * h_prev)
    ctx.set_output("Hidden", h)


@register_op_SEQ("multihead_seq_attention")
def _multihead_seq_attention(ctx):
    """Multi-head self/cross attention over RAGGED sequences (the v2
    networks.multi_head_attention composition, reference:
    trainer_config_helpers/networks.py:1580 — one ragged op, padding
    keys masked exactly; the dense-tensor path is the op
    'scaled_dot_product_attention')."""
    q = _as_ragged(ctx.input("Q"))
    k = _as_ragged(ctx.input("K"))
    v = _as_ragged(ctx.input("V"))
    heads = ctx.attr("num_heads", 1)
    qp = _einsum("btd,de->bte", q.data, ctx.input("WQ"))
    kp = _einsum("btd,de->bte", k.data, ctx.input("WK"))
    vp = _einsum("btd,de->bte", v.data, ctx.input("WV"))
    b, t, d = qp.shape
    dh = d // heads

    def split(x):
        return x.reshape(b, x.shape[1], heads, dh).transpose(1, 2)

    qs, ks, vs = split(qp), split(kp), split(vp)
    scores = _einsum("bhqd,bhkd->bhqk", qs, ks) / torch.sqrt(
        torch.tensor(dh, dtype=qp.dtype, device=qp.device))
    scores = torch.where(k.mask()[:, None, None, :], scores,
                         torch.tensor(-1e30, dtype=scores.dtype,
                                      device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = _einsum("bhqk,bhkd->bhqd", probs, vs).transpose(1, 2) \
        .reshape(b, t, d)
    out = _einsum("btd,de->bte", out, ctx.input("WO"))
    out = out * _feat_mask(q.mask(), out)
    ctx.set_output("Out", RaggedPair(out, q.lengths))


# -- recurrent nets ---------------------------------------------------------

def _masked_scan_rnn(step, xs, init_states, lengths):
    """Run `step` over time axis 1 of xs, freezing state past each row's
    length; step(carry, x_t) -> (carry, out_t), carry a tuple. Returns
    (final carry, outputs stacked on axis 1, zero past each length)."""
    carry = tuple(init_states)
    outs = []
    for t in range(xs.shape[1]):
        new_carry, out_t = step(carry, xs[:, t])
        for n_, o_ in zip(new_carry, carry):
            if n_.dtype != o_.dtype:
                # lax.scan's rule, which the reference's scan runs under
                raise TypeError(
                    f"scan body function carry input and carry output "
                    f"must have equal types: {o_.dtype} in, {n_.dtype} out")
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
        data = _take_along_time(data, idx)

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
        hidden = _take_along_time(hidden, idx)
        cells = _take_along_time(cells, idx)
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
        data = _take_along_time(data, idx)

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
        hidden = _take_along_time(hidden, idx)
    ctx.set_output("Hidden", RaggedPair(hidden, x.lengths))
    ctx.set_output("LastH", h_last)


@register_op_SEQ("lstmp")
def _lstmp(ctx):
    """LSTM with recurrent projection (reference: lstmp_op.cc): cell size
    d, projected hidden size p; the recurrence runs on the projection.
    The scan route only (the reference has no kernel for it); its
    products promote as jnp's do, and its carry keeps its dtype as
    lax.scan's must (under AMP both packages raise there)."""
    x = _as_ragged(ctx.input("Input"))       # [n, t, 4d] pre-projected
    w = ctx.input("Weight")                  # [p, 4d]
    w_proj = ctx.input("ProjWeight")         # [d, p]
    b = ctx.input("Bias")
    d, p = w_proj.shape
    n = x.data.shape[0]
    gate_act = _ACT[ctx.attr("gate_activation", "sigmoid")]
    cell_act = _ACT[ctx.attr("cell_activation", "tanh")]
    cand_act = _ACT[ctx.attr("candidate_activation", "tanh")]
    proj_act = _ACT[ctx.attr("proj_activation", "tanh")]
    zeros = dict(dtype=x.data.dtype, device=x.data.device)

    h0 = ctx.input("H0")
    c0 = ctx.input("C0")
    if h0 is None:
        r0 = torch.zeros((n, p), **zeros)
    else:
        r0 = _mm(h0, w_proj) if h0.shape[-1] == d else h0
    c0 = c0 if c0 is not None else torch.zeros((n, d), **zeros)

    use_peepholes = ctx.attr("use_peepholes", False) and b is not None \
        and b.reshape(-1).shape[0] >= 7 * d
    if use_peepholes:
        bflat = b.reshape(-1)
        w_ic = bflat[4 * d:5 * d].reshape(1, -1)
        w_fc = bflat[5 * d:6 * d].reshape(1, -1)
        w_oc = bflat[6 * d:7 * d].reshape(1, -1)

    def step(carry, x_t):
        r_prev, c_prev = carry
        gates = x_t + _mm(r_prev, w)
        if b is not None:
            gates = gates + b.reshape(1, -1)[:, :4 * d]
        i, c_hat, f, o = torch.split(gates, d, dim=-1)
        if use_peepholes:
            i = i + w_ic * c_prev
            f = f + w_fc * c_prev
        c = gate_act(f) * c_prev + gate_act(i) * cand_act(c_hat)
        if use_peepholes:
            o = o + w_oc * c
        h = gate_act(o) * cell_act(c)
        r = proj_act(_mm(h, w_proj))
        return (r, c), (r, c)

    (r_last, c_last), (proj, cells) = _masked_scan_rnn(
        step, x.data, (r0, c0), x.lengths)
    ctx.set_output("Projection", RaggedPair(proj, x.lengths))
    ctx.set_output("Cell", RaggedPair(cells, x.lengths))
    ctx.set_output("LastH", r_last)
    ctx.set_output("LastC", c_last)
