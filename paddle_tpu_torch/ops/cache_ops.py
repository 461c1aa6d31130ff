"""KV-cache update ops for incremental decode (serving/generation).

The cache is persistable scope state shaped [slots, heads, max_seq, d].
An op here reads the cache var and writes its output back to the SAME
var name. The JAX package gets an in-place update from buffer donation;
here the rule writes into the scope's tensor in place, so no step copies
the whole cache.

The start indices follow jax.lax.dynamic_update_slice: a negative start
counts from the end (numpy style), and then the start is CLAMPED so that
the update fits — a slot index past the last slot writes the last slot,
a position at or past max_seq writes row max_seq - 1. Plain torch
indexing would raise or write elsewhere, so the rules map the indices
first (_dus_start). It runs on the device: no host sync.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _dus_start(index, dim: int, size: int):
    """jax.lax.dynamic_update_slice's start index along one dim of
    extent `dim` for an update of extent `size`."""
    index = index.long()
    index = torch.where(index < 0, index + dim, index)
    return index.clamp(0, dim - size)


@register_op("kv_cache_write", no_grad_slots=["Slot"])
def _kv_cache_write(ctx):
    """Prefill path: write one request's full-prompt K or V rows into
    its cache slot.

    Cache: [slots, h, max_seq, d]; New: [1, h, S, d] (S <= max_seq);
    Slot: [1] int — the in-flight batch slot index. Rows [0, S) of the
    slot are overwritten; rows beyond S keep whatever the previous
    occupant left (masked out by the decode-step attention mask).
    """
    cache = ctx.input("Cache")
    new = ctx.input("New").to(cache.dtype)
    s = new.shape[2]
    if s > cache.shape[2] or new.shape[0] != 1:
        raise ValueError(f"kv_cache_write: New {tuple(new.shape)} does not "
                         f"fit one slot of Cache {tuple(cache.shape)}")
    slot = _dus_start(ctx.input("Slot").reshape(1), cache.shape[0], 1)
    cache[:, :, :s].index_copy_(0, slot, new)
    ctx.set_output("Out", cache)


@register_op("kv_cache_append", no_grad_slots=["Pos"])
def _kv_cache_append(ctx):
    """Decode path: append one token's K or V row per slot, at each
    slot's own position.

    Cache: [slots, h, max_seq, d]; New: [slots, h, 1, d]; Pos: [slots]
    int — per-slot write position. Inactive slots point Pos at 0; the
    garbage row is overwritten by that slot's next prefill and is never
    attended to meanwhile (the additive mask covers only live rows).
    """
    cache = ctx.input("Cache")
    new = ctx.input("New").to(cache.dtype)
    pos = _dus_start(ctx.input("Pos").reshape(-1), cache.shape[2], 1)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, pos] = new[:, :, 0]
    ctx.set_output("Out", cache)
