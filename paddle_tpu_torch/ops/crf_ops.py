"""Linear-chain CRF ops: forward-algorithm likelihood and Viterbi decode.

The port's copy of ``paddle_tpu/ops/crf_ops.py`` (reference:
paddle/fluid/operators/linear_chain_crf_op.{h,cc}, crf_decoding_op.h).
The transition parameter is [num_tags + 2, num_tags]: rows 0 and 1 are
the start and end weights. Ragged data is (padded [B, T, D], lengths);
the time recursion is a host loop over the padded length whose state
updates are ``torch.where`` selects by the lengths, as the JAX package's
lax.scan masks them, so rows of any length share one loop. The gradient
of linear_chain_crf comes through torch autograd (the ``__vjp__`` op),
as the reference's comes through jax.vjp; crf_decoding has none. No
hand kernel: the JAX package computes both in lax.scan outside any
Pallas kernel.
"""
from __future__ import annotations

import torch

from ..core.lod import RaggedPair
from .sequence_ops import _as_ragged, register_op_SEQ


def _crf_components(transition):
    # rows 0 and 1 carry the start and end weights
    return transition[0], transition[1], transition[2:]


def _valid(lengths, T):
    return torch.arange(T, device=lengths.device)[None, :] \
        < lengths[:, None]


def _nll(emission, lengths, label, transition):
    """Negative log-likelihood per sequence. emission [B, T, D], label
    [B, T] int64."""
    start, stop, trans = _crf_components(transition)
    T = emission.shape[1]
    valid = _valid(lengths, T)                       # [B, T]

    # log Z by the forward algorithm
    alpha = start[None, :] + emission[:, 0]          # [B, D]
    for t in range(1, T):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emission[:, t]
        alpha = torch.where(valid[:, t, None], new, alpha)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=-1)

    # the gold path's score
    em_gold = torch.gather(emission, 2, label[..., None]).squeeze(-1)
    zero = torch.zeros((), dtype=emission.dtype, device=emission.device)
    score = start[label[:, 0]] + torch.sum(
        torch.where(valid, em_gold, zero), dim=1)
    if T > 1:
        trans_gold = trans[label[:, :-1], label[:, 1:]]   # [B, T-1]
        score = score + torch.sum(
            torch.where(valid[:, 1:], trans_gold, zero), dim=1)
    last = torch.clamp(lengths.to(torch.int64) - 1, min=0)
    last_tag = torch.gather(label, 1, last[:, None])[:, 0]
    score = score + stop[last_tag]
    return log_z - score


def _labels(value):
    lab = _as_ragged(value).data
    if lab.ndim == 3:
        lab = lab.squeeze(-1)
    return lab.to(torch.int64)


@register_op_SEQ("linear_chain_crf", no_grad_slots=["Label"])
def _linear_chain_crf(ctx):
    em = _as_ragged(ctx.input("Emission"))
    transition = ctx.input("Transition")
    nll = _nll(em.data, em.lengths, _labels(ctx.input("Label")), transition)
    ctx.set_output("LogLikelihood", nll[:, None])
    # the reference's hand-written backward reads these; autograd does
    # not, but the slots stay wired as in the JAX package
    ctx.set_output("Alpha", em.data)
    ctx.set_output("EmissionExps", em.data)
    ctx.set_output("TransitionExps", transition)


@register_op_SEQ("crf_decoding", no_grad_slots=["Emission", "Transition",
                                                "Label"])
def _crf_decoding(ctx):
    em = _as_ragged(ctx.input("Emission"))
    start, stop, trans = _crf_components(ctx.input("Transition"))
    emission, lengths = em.data, em.lengths
    T = emission.shape[1]
    valid = _valid(lengths, T)

    # Viterbi forward: best scores and backpointers
    delta = start[None, :] + emission[:, 0]
    back = []
    for t in range(1, T):
        cand = delta[:, :, None] + trans[None]       # [B, D_prev, D]
        back.append(torch.argmax(cand, dim=1))       # first max, as jnp
        new = torch.amax(cand, dim=1) + emission[:, t]
        delta = torch.where(valid[:, t, None], new, delta)

    # sequences end at length - 1: the best last tag there, then the
    # backpointers walked in reverse, the tag frozen for t >= length
    tag = torch.argmax(delta + stop[None, :], dim=-1)    # [B]
    last = lengths.to(torch.int64) - 1
    path = [tag]
    for t in range(T - 2, -1, -1):
        prev = torch.gather(back[t], 1, tag[:, None])[:, 0]
        tag = torch.where((t + 1) <= last, prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)                # [B, T]
    path = torch.where(valid, path, torch.zeros_like(path))

    label = ctx.input("Label")
    if label is not None:
        # with a gold Label, per-position correctness (the reference's
        # crf_decoding_op.h behaviour)
        out = (path == _labels(label)).to(torch.int64) * valid
        ctx.set_output("ViterbiPath", RaggedPair(out[..., None], lengths))
    else:
        ctx.set_output("ViterbiPath", RaggedPair(path[..., None], lengths))
