"""DataFeeder: reader tuples -> feed dict (reference:
python/paddle/fluid/data_feeder.py DataFeeder.feed — converts a batch of
per-sample tuples to LoDTensors per data var; v2's `feeding` dict).

The port's copy of ``paddle_tpu/data_feeder.py`` at LoD level 1: dense
vars become stacked numpy arrays; lod_level=1 vars become RaggedPair
(padded data + lengths) of numpy arrays, which the executor uploads.
Padding length defaults to the longest sequence in the batch, bucketed
up to `pad_multiple`. Nested LoD (lod_level >= 2) waits for ROADMAP A4.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .core.lod import LoDTensor, RaggedPair


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None,
                 pad_multiple: int = 16, sub_pad_multiple: int = 4,
                 max_lens: Optional[Dict[str, int]] = None,
                 freeze: bool = False):
        self.feed_vars = list(feed_list)
        # the device feed_device uploads to (None: the first CUDA card)
        self.place = place
        self.pad_multiple = pad_multiple
        # lod_level=2 sub-sequence axis bucketing: in the JAX package's
        # signature, but only nested feeds read it, and they wait for
        # ROADMAP A4
        if sub_pad_multiple != 4:
            raise NotImplementedError(
                "DataFeeder: sub_pad_multiple buckets nested (lod_level "
                ">= 2) feeds, which wait for ROADMAP A4")
        self.max_lens = max_lens or {}
        # freeze=True returns read-only owning arrays (the JAX executor
        # caches those device-side by identity; the port uploads every
        # feed). Off by default so callers may mutate fed arrays in place.
        self.freeze = freeze

    def feed(self, batch: Sequence[Sequence]) -> Dict[str, object]:
        """batch: iterable of per-sample tuples aligned with feed_list."""
        out: Dict[str, object] = {}
        for i, var in enumerate(self.feed_vars):
            name = var if isinstance(var, str) else var.name
            lod_level = 0 if isinstance(var, str) else (var.lod_level or 0)
            dtype = "float32" if isinstance(var, str) else var.dtype
            column = [sample[i] for sample in batch]
            if lod_level >= 2:
                raise NotImplementedError(
                    f"DataFeeder: var {name!r} has lod_level {lod_level}; "
                    "the port feeds level-1 LoD only, nested LoD waits for "
                    "ROADMAP A4")
            if lod_level > 0:
                out[name] = self._ragged(name, column, dtype, var)
            else:
                arr = np.asarray(column, dtype=np.dtype(dtype))
                shape = None if isinstance(var, str) else var.shape
                if shape is not None and len(shape) >= 1 and arr.ndim == 1:
                    arr = arr.reshape(len(column), *[
                        d for d in shape[1:] if d and d > 0] or [1])
                if self.freeze:
                    # reshape yields views (owndata=False): materialize
                    # first, so the frozen array owns its data
                    if not arr.flags.owndata:
                        arr = arr.copy()
                    arr.flags.writeable = False
                out[name] = arr
        return out

    def feed_device(self, batch: Sequence[Sequence]) -> Dict[str, object]:
        """`feed()` plus the host->device upload (core.executor
        ``device_feed``, to this feeder's place). This is the form the
        FeedPrefetcher parks — uploading batch N+1 while batch N
        computes — and `Executor.run` takes it as it is."""
        from .core.executor import device_feed
        return device_feed(self.feed(batch), self.place)

    @staticmethod
    def _feat_dims(var):
        if not isinstance(var, str) and var.shape:
            # declared [-1?, feat...]: per-step feature dims after batch
            return [d for d in var.shape[1:] if d and d > 0]
        return None

    @staticmethod
    def _to_step_array(seq, np_dtype, feat):
        """One flat-or-shaped sequence -> [steps, *feat]."""
        a = np.asarray(seq, np_dtype)
        if feat and a.ndim == 1:
            a = a.reshape(len(a) // int(np.prod(feat)), *feat) \
                if np.prod(feat) > 1 else a.reshape(len(a), *feat)
        elif a.ndim == 1:
            a = a.reshape(len(a), 1)
        return a

    def _ragged(self, name, column, dtype, var):
        np_dtype = np.dtype(dtype)
        feat = self._feat_dims(var)
        arrs = [self._to_step_array(seq, np_dtype, feat)
                for seq in column]
        max_len = self.max_lens.get(name)
        if max_len is None:
            longest = max((a.shape[0] for a in arrs), default=1)
            m = self.pad_multiple
            max_len = ((longest + m - 1) // m) * m
        else:
            # a hard cap truncates (the standard bucketing behavior);
            # to_padded would otherwise fail on longer sequences
            arrs = [a[:max_len] for a in arrs]
        lod = LoDTensor.from_sequences(arrs, feat_shape=feat,
                                       dtype=np_dtype)
        padded, lengths = lod.to_padded(max_len=max_len)
        return RaggedPair(padded, lengths)
