"""MNIST digits (reference: python/paddle/dataset/mnist.py — 784-dim
float image scaled to [-1, 1] + int label). Loads the real IDX files from
the cache dir when present; otherwise synthesizes class-separable images
(per-class template + noise) so recognize_digits actually converges."""
import gzip
import os

import numpy as np

from .common import cache_path, rng_for

_N_TRAIN, _N_TEST = 8192, 1024


def _real_files(split):
    base = cache_path("mnist")
    img = os.path.join(base, f"{split}-images-idx3-ubyte.gz")
    lab = os.path.join(base, f"{split}-labels-idx1-ubyte.gz")
    return (img, lab) if os.path.exists(img) and os.path.exists(lab) else None


def _read_real(split):
    img_path, lab_path = _real_files(split)
    with gzip.open(img_path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[4:8], "big")
    images = np.frombuffer(data, np.uint8, offset=16).reshape(n, 784)
    images = images.astype(np.float32) / 127.5 - 1.0
    with gzip.open(lab_path, "rb") as f:
        ldata = f.read()
    labels = np.frombuffer(ldata, np.uint8, offset=8).astype(np.int64)
    return images, labels


def _synthetic(split, n):
    rng = rng_for("mnist", "templates")
    templates = rng.rand(10, 784).astype(np.float32) * 2 - 1
    rng = rng_for("mnist", split)
    labels = rng.randint(0, 10, n).astype(np.int64)
    images = templates[labels] + 0.3 * rng.randn(n, 784).astype(np.float32)
    return np.clip(images, -1, 1).astype(np.float32), labels


def _reader(split, n):
    def reader():
        if _real_files("train" if split == "train" else "t10k"):
            images, labels = _read_real("train" if split == "train" else "t10k")
        else:
            images, labels = _synthetic(split, n)
        for i in range(len(labels)):
            yield images[i], int(labels[i])
    return reader


def train():
    return _reader("train", _N_TRAIN)


def test():
    return _reader("test", _N_TEST)
