"""UCI Housing regression dataset (reference:
python/paddle/dataset/uci_housing.py — 13 features, scalar price).
Parses the real whitespace-separated `housing.data` (506x14) from the
cache dir when present, with the reference's feature normalization
(uci_housing.py:49-60: (x - avg) / (max - min)) and 404/102 split;
otherwise synthesizes a linear-regression corpus so fit_a_line
converges the same way."""
import os

import numpy as np

from .common import cache_path, rng_for

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS", "RAD", "TAX",
    "PTRATIO", "B", "LSTAT",
]

_W = np.linspace(-1.0, 1.0, 13).astype(np.float32)
_TRAIN_N = 404   # reference: first 404 rows train, rest test


def _real_data():
    path = cache_path("uci_housing", "housing.data")
    if not os.path.exists(path):
        return None
    data = np.loadtxt(path).astype(np.float32)
    maxs, mins, avgs = data.max(0), data.min(0), data.mean(0)
    for i in range(13):
        data[:, i] = (data[:, i] - avgs[i]) / (maxs[i] - mins[i])
    return data


def _make(split: str, n: int):
    def reader():
        real = _real_data()
        if real is not None:
            rows = real[:_TRAIN_N] if split == "train" else real[_TRAIN_N:]
            for row in rows:
                yield row[:13], row[13:14]
            return
        rng = rng_for("uci_housing", split)
        x = rng.randn(n, 13).astype(np.float32)
        y = (x @ _W + 0.1 * rng.randn(n)).astype(np.float32).reshape(n, 1)
        for i in range(n):
            yield x[i], y[i]
    return reader


def train():
    return _make("train", 404)


def test():
    return _make("test", 102)
