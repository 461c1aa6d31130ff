"""Ragged (variable-length sequence) values.

The port's copy of the level-1 part of ``paddle_tpu/core/lod.py``. The
reference carries variable-length sequences as LoDTensor: a dense buffer
plus level-of-detail offset tables (reference: lod_tensor.h:55-107).
In-graph, a ragged batch is dense padded data plus a lengths vector, and
ops mask: ``RaggedPair`` over torch tensors. ``LoDTensor`` is the numpy
host container that converts between offset-based LoD and padded form at
the feed/fetch boundary. Nested ragged values (RaggedNested, RaggedTree)
are not ported yet.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


class RaggedPair:
    """In-graph ragged value: (padded data, per-sequence lengths).

    data: [num_seqs, max_len, *feature_dims] (padded with zeros)
    lengths: int32 [num_seqs], on data's device
    """

    __slots__ = ("data", "lengths")

    def __init__(self, data, lengths):
        self.data = data
        self.lengths = lengths

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def mask(self) -> torch.Tensor:
        """[num_seqs, max_len] boolean validity mask."""
        max_len = self.data.shape[1]
        pos = torch.arange(max_len, dtype=torch.int32,
                           device=self.lengths.device)[None, :]
        return pos < self.lengths[:, None]

    def __repr__(self):
        return (f"RaggedPair(data={tuple(self.data.shape)}, "
                f"lengths={tuple(self.lengths.shape)})")


def lod_to_lengths(lod_level0: Sequence[int]) -> np.ndarray:
    """Offsets [0, 3, 5, 9] -> lengths [3, 2, 4]."""
    off = np.asarray(lod_level0, dtype=np.int64)
    return (off[1:] - off[:-1]).astype(np.int32)


def lengths_to_lod(lengths: Sequence[int]) -> List[int]:
    out = [0]
    for l in lengths:
        out.append(out[-1] + int(l))
    return out


def _concat_or_empty(arrs: List[np.ndarray], feat_shape, dtype) -> np.ndarray:
    """Concatenate sequence arrays; when there is no element to infer
    feature dims/dtype from (no arrays, or every array empty and
    feature-dim-less), fall back to the caller's hints so empty batches
    stay rank/dtype-consistent with non-empty ones."""
    if not arrs:
        return np.zeros((0,) + tuple(feat_shape), dtype=dtype)
    flat = np.concatenate(arrs, axis=0)
    if flat.size == 0 and feat_shape and \
            flat.shape[1:] != tuple(feat_shape):
        return np.zeros((0,) + tuple(feat_shape), dtype=dtype)
    return flat


class LoDTensor:
    """Host-side ragged tensor: flat data + LoD offsets (reference parity).

    Only level-1 LoD is carried into the graph (as RaggedPair) by the
    port so far.
    """

    def __init__(self, data: np.ndarray,
                 lod: Optional[List[List[int]]] = None):
        self.data = np.asarray(data)
        self.lod = lod or []

    @classmethod
    def from_sequences(cls, seqs: List[np.ndarray],
                       feat_shape=(), dtype=np.float32) -> "LoDTensor":
        """feat_shape/dtype only matter for an all-empty batch, where no
        element exists to infer them from."""
        arrs = [np.asarray(s) for s in seqs]
        flat = _concat_or_empty(arrs, feat_shape, dtype)
        return cls(flat, [lengths_to_lod([len(s) for s in seqs])])

    def sequences(self) -> List[np.ndarray]:
        if not self.lod:
            return [self.data]
        off = self.lod[0]
        return [self.data[off[i]:off[i + 1]] for i in range(len(off) - 1)]

    def to_padded(self, max_len: Optional[int] = None):
        """-> (padded [n, max_len, *feat], lengths int32 [n])."""
        seqs = self.sequences()
        lengths = np.asarray([len(s) for s in seqs], dtype=np.int32)
        ml = int(max_len or (lengths.max() if len(lengths) else 0))
        feat = self.data.shape[1:]
        out = np.zeros((len(seqs), ml) + tuple(feat), dtype=self.data.dtype)
        for i, s in enumerate(seqs):
            out[i, :len(s)] = s
        return out, lengths

    @classmethod
    def from_padded(cls, padded: np.ndarray,
                    lengths: np.ndarray) -> "LoDTensor":
        seqs = [padded[i, :int(l)] for i, l in enumerate(lengths)]
        return cls.from_sequences(seqs)

    def __repr__(self):
        return f"LoDTensor(shape={self.data.shape}, lod={self.lod})"
