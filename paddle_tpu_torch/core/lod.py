"""Ragged (variable-length sequence) values.

The port's copy of ``paddle_tpu/core/lod.py``. The reference carries
variable-length sequences as LoDTensor: a dense buffer plus
level-of-detail offset tables (reference: lod_tensor.h:55-107).
In-graph, a ragged batch is dense padded data plus lengths, and ops
mask: ``RaggedPair`` (one LoD level), ``RaggedNested`` (two) and
``RaggedTree`` (three or more), over torch tensors. ``LoDTensor`` is the
numpy host container that converts between offset-based LoD and padded
form at the feed/fetch boundary.

``ragged_parts``/``ragged_like`` take any of the three apart into its
tensors (data first, then the lengths) and put it back together: the
executor uploads, clones and copies ragged values through them, and
``with_data`` re-wraps new data with a value's lengths (the LoD rule
"output lod = input lod" of core/registry.py run_op).
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


def _positions(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(m, dtype=torch.int32, device=like.device)


class RaggedNested:
    """In-graph two-level ragged value (reference: 2-level LoD, e.g.
    paragraph -> sentence -> token; lod_tensor.h:55-107 and the
    RecurrentGradientMachine nested-sequence case).

    data: [n_outer, max_sub, max_tok, *feature_dims] (zero padded)
    sub_lengths: int32 [n_outer]          — sub-sequences per outer seq
    tok_lengths: int32 [n_outer, max_sub] — tokens per sub-sequence
    """

    __slots__ = ("data", "sub_lengths", "tok_lengths")

    def __init__(self, data, sub_lengths, tok_lengths):
        self.data = data
        self.sub_lengths = sub_lengths
        self.tok_lengths = tok_lengths

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def sub_mask(self) -> torch.Tensor:
        """[n_outer, max_sub] validity of sub-sequence slots."""
        pos = _positions(self.data.shape[1], self.sub_lengths)[None, :]
        return pos < self.sub_lengths[:, None]

    def mask(self) -> torch.Tensor:
        """[n_outer, max_sub, max_tok] token validity mask."""
        pos = _positions(self.data.shape[2], self.tok_lengths)[None, None, :]
        return (pos < self.tok_lengths[:, :, None]) \
            & self.sub_mask()[:, :, None]

    def flatten(self) -> RaggedPair:
        """View the sub-sequences as one level-1 ragged batch of
        n_outer*max_sub rows (padding slots appear as length-0 rows)."""
        n, s = self.data.shape[:2]
        tok = torch.where(self.sub_mask(), self.tok_lengths,
                          torch.zeros_like(self.tok_lengths))
        return RaggedPair(self.data.reshape((n * s,) + self.data.shape[2:]),
                          tok.reshape(n * s))

    def __repr__(self):
        return (f"RaggedNested(data={tuple(self.data.shape)}, "
                f"tok_lengths={tuple(self.tok_lengths.shape)})")


class RaggedTree:
    """In-graph ragged value of nesting depth k >= 3 (reference:
    arbitrary-depth LoD, lod_tensor.h:55-107 — e.g. doc -> paragraph ->
    sentence -> token is depth 3). Depths 1 and 2 keep their own forms
    (RaggedPair / RaggedNested).

    data: [n0, m1, ..., mk, *feature_dims] (zero padded; k+1 ragged dims)
    lengths: tuple of k int32 tensors; lengths[i] has shape
        [n0, m1, ..., mi] and counts each level-(i+1) group's children.
    """

    __slots__ = ("data", "lengths")

    def __init__(self, data, lengths):
        self.data = data
        self.lengths = tuple(lengths)

    @property
    def depth(self) -> int:
        return len(self.lengths)

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def level_mask(self, i: int) -> torch.Tensor:
        """[n0, m1, ..., m_{i+1}] validity of level-(i+1) slots (not
        intersected with ancestor validity)."""
        m = self.data.shape[i + 1]
        pos = _positions(m, self.lengths[i]).reshape((1,) * (i + 1) + (m,))
        return pos < self.lengths[i][..., None]

    def mask(self) -> torch.Tensor:
        """Innermost validity [n0, m1, ..., mk]: a slot is valid iff
        every ancestor slot is."""
        out = None
        k = self.depth
        for i in range(k):
            m = self.level_mask(i)
            m = m.reshape(m.shape + (1,) * (k - 1 - i))
            out = m if out is None else (out & m)
        return out

    def flatten(self):
        """Collapse the top two ragged dims: depth k -> depth k-1 over a
        batch of n0*m1 roots (invalid slots become empty subtrees).
        Returns a RaggedNested when the result has depth 2."""
        n0, m1 = self.data.shape[:2]
        valid = self.level_mask(0)                      # [n0, m1]
        data = self.data.reshape((n0 * m1,) + self.data.shape[2:])
        l1 = self.lengths[1]
        l0 = torch.where(valid, l1, torch.zeros_like(l1)).reshape(n0 * m1)
        rest = [l.reshape((n0 * m1,) + l.shape[2:])
                for l in self.lengths[2:]]
        if 1 + len(rest) == 2:
            return RaggedNested(data, l0, rest[0])
        return RaggedTree(data, (l0,) + tuple(rest))

    def __repr__(self):
        return (f"RaggedTree(depth={self.depth}, "
                f"data={tuple(self.data.shape)})")


RAGGED_TYPES = (RaggedPair, RaggedNested, RaggedTree)


def ragged_parts(value) -> list:
    """The tensors of a ragged value, data first and then its lengths
    (outer level first); [value] for anything else."""
    if isinstance(value, RaggedPair):
        return [value.data, value.lengths]
    if isinstance(value, RaggedNested):
        return [value.data, value.sub_lengths, value.tok_lengths]
    if isinstance(value, RaggedTree):
        return [value.data, *value.lengths]
    return [value]


def ragged_like(template, parts):
    """A value of `template`'s kind from `parts` (ragged_parts' order)."""
    if isinstance(template, RaggedPair):
        return RaggedPair(*parts)
    if isinstance(template, RaggedNested):
        return RaggedNested(*parts)
    if isinstance(template, RaggedTree):
        return RaggedTree(parts[0], parts[1:])
    return parts[0]


def with_data(template, data):
    """`data` with the lengths of the ragged value `template`."""
    return ragged_like(template, [data] + ragged_parts(template)[1:])


def ragged_lead(value) -> int:
    """How many leading dims of a ragged value's data are ragged dims:
    2 (batch, time), 3 for RaggedNested, depth + 1 for RaggedTree."""
    if isinstance(value, RaggedTree):
        return value.depth + 1
    return 3 if isinstance(value, RaggedNested) else 2


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

    The executor carries one LoD level into the graph as a RaggedPair,
    two as a RaggedNested and three or more as a RaggedTree.
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

    # ---- two-level (nested) conversions ---------------------------------
    @classmethod
    def from_nested_sequences(
            cls, nested: List[List[np.ndarray]],
            feat_shape=(), dtype=np.float32) -> "LoDTensor":
        """nested[i][j] = tokens of sub-sequence j of outer sequence i.
        feat_shape/dtype are the empty-batch hints (see from_sequences)."""
        subs = [np.asarray(s) for outer in nested for s in outer]
        flat = _concat_or_empty(subs, feat_shape, dtype)
        lod0 = lengths_to_lod([len(outer) for outer in nested])
        lod1 = lengths_to_lod([len(s) for s in subs])
        return cls(flat, [lod0, lod1])

    def nested_sequences(self) -> List[List[np.ndarray]]:
        if len(self.lod) != 2:
            raise ValueError("nested_sequences needs exactly 2-level LoD "
                             f"(got {len(self.lod)} level(s))")
        outer_off, inner_off = self.lod[0], self.lod[1]
        out = []
        for i in range(len(outer_off) - 1):
            subs = []
            for j in range(outer_off[i], outer_off[i + 1]):
                subs.append(self.data[inner_off[j]:inner_off[j + 1]])
            out.append(subs)
        return out

    def to_nested_padded(self, max_sub: Optional[int] = None,
                         max_tok: Optional[int] = None):
        """-> (data [n, max_sub, max_tok, *feat], sub_lengths int32 [n],
        tok_lengths int32 [n, max_sub])."""
        nested = self.nested_sequences()
        n = len(nested)
        sub_lengths = np.asarray([len(o) for o in nested], dtype=np.int32)
        ms = int(max_sub or (sub_lengths.max() if n else 0))
        tok_lengths = np.zeros((n, ms), dtype=np.int32)
        for i, outer in enumerate(nested):
            for j, s in enumerate(outer):
                tok_lengths[i, j] = len(s)
        mt = int(max_tok or (tok_lengths.max() if tok_lengths.size else 0))
        feat = self.data.shape[1:]
        out = np.zeros((n, ms, mt) + tuple(feat), dtype=self.data.dtype)
        for i, outer in enumerate(nested):
            for j, s in enumerate(outer):
                out[i, j, :len(s)] = s
        return out, sub_lengths, tok_lengths

    @classmethod
    def from_nested_padded(cls, data: np.ndarray, sub_lengths: np.ndarray,
                           tok_lengths: np.ndarray) -> "LoDTensor":
        nested = [
            [data[i, j, :int(tok_lengths[i, j])]
             for j in range(int(sub_lengths[i]))]
            for i in range(data.shape[0])]
        return cls.from_nested_sequences(nested)

    # ---- arbitrary-depth (k >= 1) conversions ---------------------------
    @classmethod
    def from_depth_sequences(cls, nested: List, depth: int,
                             feat_shape=(), dtype=np.float32) -> "LoDTensor":
        """Depth-k nested python lists -> LoDTensor with k LoD levels.
        nested is lists nested `depth` deep whose leaves are token
        arrays [len, *feat] (reference: arbitrary-depth LoD,
        lod_tensor.h:55-107). depth=1/2 match
        from_sequences/from_nested_sequences."""
        lods = [[0] for _ in range(depth)]
        leaves: List[np.ndarray] = []

        def walk(node, level):
            if level == depth - 1:
                a = np.asarray(node)
                leaves.append(a)
                lods[level].append(lods[level][-1] + len(a))
            else:
                for child in node:
                    walk(child, level + 1)
                lods[level].append(lods[level][-1] + len(node))

        for top in nested:
            walk(top, 0)
        flat = _concat_or_empty(leaves, feat_shape, dtype)
        return cls(flat, lods)

    def to_tree_padded(self, max_dims: Optional[Sequence[int]] = None):
        """-> (data [n0, m1, ..., mk, *feat], [k lengths arrays]) — the
        dense form RaggedTree carries in-graph. max_dims optionally pads
        each ragged dim (m1..mk) to a fixed size (bucketing)."""
        k = len(self.lod)
        if k < 1:
            raise ValueError("to_tree_padded needs at least 1 LoD level")
        counts = [lod_to_lengths(l) for l in self.lod]
        n0 = len(counts[0])
        dims = []
        for i in range(k):
            longest = int(counts[i].max()) if len(counts[i]) else 0
            if max_dims is not None and max_dims[i] is not None:
                if longest > int(max_dims[i]):
                    raise ValueError(
                        f"LoD level {i} has a group of {longest} > "
                        f"max_dims[{i}]={max_dims[i]}")
                longest = int(max_dims[i])
            dims.append(max(longest, 1))
        feat = self.data.shape[1:]
        data = np.zeros((n0,) + tuple(dims) + tuple(feat),
                        dtype=self.data.dtype)
        lengths = [np.zeros((n0,) + tuple(dims[:i]), np.int32)
                   for i in range(k)]

        # walk the offset tables: entity e at level i owns children
        # [lod[i][e], lod[i][e+1]) at level i+1; the innermost offsets
        # partition data rows into token runs (lod_tensor.h contract)
        def fill_tokens(level, ent, index):
            start, end = self.lod[level][ent], self.lod[level][ent + 1]
            lengths[level][index] = end - start
            if level == k - 1:
                data[index][: end - start] = self.data[start:end]
            else:
                for j, child in enumerate(range(start, end)):
                    fill_tokens(level + 1, child, index + (j,))

        for e in range(n0):
            fill_tokens(0, e, (e,))
        return data, lengths

    @classmethod
    def from_tree_padded(cls, data: np.ndarray,
                         lengths: Sequence[np.ndarray]) -> "LoDTensor":
        """Inverse of to_tree_padded."""
        k = len(lengths)
        lods = [[0] for _ in range(k)]
        rows: List[np.ndarray] = []

        def walk(level, index):
            n = int(lengths[level][index])
            lods[level].append(lods[level][-1] + n)
            if level == k - 1:
                rows.append(data[index][:n])
            else:
                for j in range(n):
                    walk(level + 1, index + (j,))

        for e in range(data.shape[0]):
            walk(0, (e,))
        feat = data.shape[k + 1:]
        flat = _concat_or_empty(rows, feat, data.dtype)
        return cls(flat, lods)

    def __repr__(self):
        return f"LoDTensor(shape={self.data.shape}, lod={self.lod})"
