"""MQ2007 LETOR learning-to-rank dataset (reference:
python/paddle/dataset/mq2007.py — query-grouped 46-dim feature vectors
with graded relevance 0..2; readers in pointwise / pairwise / listwise /
plain_txt formats).

Zero-egress environment: the default readers serve a deterministic
synthetic corpus with the same schema and the same four generator
formats; `load_from_text` parses the real LETOR svmlight-style format
(`<rel> qid:<id> 1:<v> 2:<v> ... #docid=...`) when a downloaded copy is
available.
"""
from __future__ import annotations

import itertools
from typing import List, Optional

import numpy as np

from .common import rng_for

FEATURE_DIM = 46
__all__ = ["Query", "QueryList", "load_from_text", "train", "test",
           "pointwise", "pairwise", "listwise", "plain_txt",
           "FEATURE_DIM"]


class Query:
    """One judged document of one query."""

    __slots__ = ("query_id", "relevance_score", "feature_vector",
                 "description")

    def __init__(self, query_id: int, relevance_score: int,
                 feature_vector, description: str = ""):
        self.query_id = int(query_id)
        self.relevance_score = int(relevance_score)
        self.feature_vector = np.asarray(feature_vector, np.float32)
        self.description = description


class QueryList:
    """All judged documents of one query id."""

    def __init__(self, query_id: int,
                 queries: Optional[List[Query]] = None):
        self.query_id = int(query_id)
        self.querylist: List[Query] = list(queries or [])

    def append(self, q: Query):
        self.querylist.append(q)

    def __len__(self):
        return len(self.querylist)

    def __iter__(self):
        return iter(self.querylist)


def load_from_text(filepath: str, shuffle: bool = False,
                   fill_missing: float = -1.0) -> List[QueryList]:
    """Parse the LETOR text format into QueryLists (reference:
    mq2007.py load_from_text)."""
    by_qid = {}
    with open(filepath) as f:
        for line in f:
            body = line.split("#", 1)[0].strip()
            if not body:
                continue
            parts = body.split()
            rel = int(parts[0])
            qid = int(parts[1].split(":", 1)[1])
            feats = np.full((FEATURE_DIM,), fill_missing, np.float32)
            for tok in parts[2:]:
                k, v = tok.split(":", 1)
                i = int(k) - 1
                if 0 <= i < FEATURE_DIM:
                    feats[i] = float(v)
            desc = line.split("#", 1)[1].strip() if "#" in line else ""
            ql = by_qid.get(qid)
            if ql is None:
                ql = by_qid[qid] = QueryList(qid)
            ql.append(Query(qid, rel, feats, description=desc))
    out = list(by_qid.values())
    if shuffle:
        np.random.shuffle(out)
    return out


def _synthetic_querylists(split: str, n_queries: int,
                          docs_per_query: int = 8) -> List[QueryList]:
    """Deterministic synthetic LETOR corpus: relevance correlates with a
    fixed linear scoring of the features, so rankers can actually learn."""
    rng = rng_for("mq2007", split)
    w = np.linspace(-1.0, 1.0, FEATURE_DIM).astype(np.float32)
    out = []
    for qid in range(n_queries):
        ql = QueryList(qid)
        x = rng.randn(docs_per_query, FEATURE_DIM).astype(np.float32)
        score = x @ w + 0.3 * rng.randn(docs_per_query)
        # graded relevance by within-query score tercile
        order = np.argsort(np.argsort(score))
        rel = (3 * order // docs_per_query).astype(int)  # 0..2
        for d in range(docs_per_query):
            ql.append(Query(qid, int(rel[d]), x[d]))
        out.append(ql)
    return out


def pointwise(querylists):
    """-> (relevance, feature_vector) per document."""
    def reader():
        for ql in querylists:
            for q in ql:
                yield q.relevance_score, q.feature_vector
    return reader


def pairwise(querylists):
    """-> (label=1, hi_features, lo_features) for each ordered pair with
    different relevance within one query (reference gen_pair)."""
    def reader():
        for ql in querylists:
            for a, b in itertools.combinations(ql, 2):
                if a.relevance_score == b.relevance_score:
                    continue
                hi, lo = (a, b) if a.relevance_score > b.relevance_score \
                    else (b, a)
                yield np.ones((1,), np.float32), hi.feature_vector, \
                    lo.feature_vector
    return reader


def plain_txt(querylists):
    """-> (query_id, relevance, feature_vector) per document (reference
    gen_plain_txt)."""
    def reader():
        for ql in querylists:
            for q in ql:
                yield ql.query_id, q.relevance_score, q.feature_vector
    return reader


def listwise(querylists):
    """-> (relevance_scores [n_docs], features [n_docs, 46]) per query."""
    def reader():
        for ql in querylists:
            rels = np.asarray([q.relevance_score for q in ql], np.float32)
            feats = np.stack([q.feature_vector for q in ql])
            yield rels, feats
    return reader


_FORMATS = {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise, "plain_txt": plain_txt}


def _reader(split: str, format: str, n_queries: int):
    if format not in _FORMATS:
        raise ValueError(f"unknown mq2007 format {format!r}; choose from "
                         f"{sorted(_FORMATS)}")
    return _FORMATS[format](_synthetic_querylists(split, n_queries))


def train(format: str = "pairwise"):
    return _reader("train", format, n_queries=120)


def test(format: str = "pairwise"):
    return _reader("test", format, n_queries=30)
