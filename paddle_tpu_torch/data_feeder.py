"""DataFeeder: reader tuples -> feed dict (reference:
python/paddle/fluid/data_feeder.py DataFeeder.feed — converts a batch of
per-sample tuples to LoDTensors per data var; v2's `feeding` dict).

The port's copy of ``paddle_tpu/data_feeder.py``: dense vars become
stacked numpy arrays; lod_level=1 vars become RaggedPair (padded data +
lengths), lod_level=2 vars RaggedNested and deeper ones RaggedTree, all
of numpy arrays, which the executor uploads. The token dim pads to the
longest sequence in the batch, bucketed up to `pad_multiple`; a nested
var's sub-sequence dim buckets up to `sub_pad_multiple`.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .core.lod import LoDTensor, RaggedNested, RaggedPair, RaggedTree


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None,
                 pad_multiple: int = 16, sub_pad_multiple: int = 4,
                 max_lens: Optional[Dict[str, int]] = None,
                 freeze: bool = False):
        self.feed_vars = list(feed_list)
        # the device feed_device uploads to (None: the first CUDA card)
        self.place = place
        self.pad_multiple = pad_multiple
        # lod_level=2 sub-sequence axis bucketing (1 disables; keeps
        # compile signatures stable when sentence counts vary)
        self.sub_pad_multiple = max(1, int(sub_pad_multiple))
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
            if lod_level >= 3:
                out[name] = self._tree(name, column, dtype, var, lod_level)
            elif lod_level == 2:
                out[name] = self._nested(name, column, dtype, var)
            elif lod_level > 0:
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
        """One flat-or-shaped sequence -> [steps, *feat] (the shared
        flat-token reshape convention of every LoD level)."""
        a = np.asarray(seq, np_dtype)
        if feat and a.ndim == 1:
            a = a.reshape(len(a) // int(np.prod(feat)), *feat) \
                if np.prod(feat) > 1 else a.reshape(len(a), *feat)
        elif a.ndim == 1:
            a = a.reshape(len(a), 1)
        return a

    def _nested(self, name, column, dtype, var):
        """lod_level=2 var: each sample is a list of sub-sequences
        (paragraph -> sentences -> tokens); -> RaggedNested via the
        2-level LoDTensor conversion. Applies the same flat-token
        reshape convention, max_lens cap (token level), and
        pad_multiple bucketing as the level-1 path."""
        np_dtype = np.dtype(dtype)
        feat = self._feat_dims(var)
        max_tok = self.max_lens.get(name)
        nested = []
        longest_tok = 1
        longest_sub = 1
        for sample in column:
            subs = []
            for seq in sample:
                a = self._to_step_array(seq, np_dtype, feat)
                if max_tok is not None:
                    a = a[:max_tok]  # hard cap truncates (bucketing)
                subs.append(a)
                longest_tok = max(longest_tok, a.shape[0])
            nested.append(subs)
            longest_sub = max(longest_sub, len(subs))
        m = self.pad_multiple
        pad_tok = max_tok if max_tok is not None else \
            ((longest_tok + m - 1) // m) * m
        # the sub-sequence axis buckets too so batches with varying
        # sentence counts reuse compile signatures
        m2 = self.sub_pad_multiple
        pad_sub = ((longest_sub + m2 - 1) // m2) * m2
        data, sub_l, tok_l = LoDTensor.from_nested_sequences(
            nested, feat_shape=feat, dtype=np_dtype).to_nested_padded(
                max_sub=pad_sub, max_tok=pad_tok)
        return RaggedNested(data, sub_l, tok_l)

    def _tree(self, name, column, dtype, var, depth):
        """lod_level>=3 var: each sample is depth-(k-1) nested lists of
        token sequences -> RaggedTree via the depth-k LoDTensor
        conversion (reference: arbitrary-depth LoD,
        lod_tensor.h:55-107). Applies the flat-token reshape at leaves,
        the max_lens cap on the token level, and pad_multiple bucketing
        on the token dim."""
        np_dtype = np.dtype(dtype)
        feat = self._feat_dims(var)
        max_tok = self.max_lens.get(name)

        def conv(node, level):
            if level == depth - 1:
                a = self._to_step_array(node, np_dtype, feat)
                return a if max_tok is None else a[:max_tok]
            return [conv(c, level + 1) for c in node]

        nested = [conv(sample, 0) for sample in column]
        lt = LoDTensor.from_depth_sequences(
            nested, depth, feat_shape=tuple(feat or ()), dtype=np_dtype)
        # bucket the token dim so varying batch contents reuse compile
        # signatures; group-count dims pad to the batch max
        m = self.pad_multiple
        tok_max = int(np.max(np.diff(lt.lod[-1]))) if len(lt.lod[-1]) > 1 \
            else 1
        max_dims = [None] * (depth - 1) + [((tok_max + m - 1) // m) * m]
        data, lengths = lt.to_tree_padded(max_dims=max_dims)
        return RaggedTree(data, tuple(lengths))

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
