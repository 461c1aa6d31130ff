"""Metric ops: the port's ``accuracy`` of ``paddle_tpu/ops/metric_ops.py``
(reference: accuracy_op.cc). auc and precision_recall wait for a later
slice."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("accuracy", no_grad_slots=["Out", "Indices", "Label"])
def _accuracy(ctx):
    """Top-k accuracy from top_k's Indices [N, k] and Label [N, 1]:
    Accuracy (float32 scalar), Correct and Total (int32 scalars)."""
    indices = ctx.input("Indices")
    lab = ctx.input("Label").reshape(-1, 1).to(indices.dtype)
    correct = torch.any(indices == lab, dim=1)
    num_correct = torch.sum(correct.to(torch.int32)).to(torch.int32)
    total = indices.shape[0]
    ctx.set_output("Accuracy", (num_correct.float() / total).reshape(()))
    ctx.set_output("Correct", num_correct.reshape(()))
    ctx.set_output("Total", torch.full((), total, dtype=torch.int32,
                                       device=indices.device))
