"""CIFAR-10/100 (reference: python/paddle/dataset/cifar.py — 3072-dim
float image in [0,1] + int label). Loads the real pickle-tar archives
(cifar-10-python.tar.gz / cifar-100-python.tar.gz) from the cache dir
when present (reference cifar.py:40-56 reader_creator); otherwise
synthesizes class-separable images."""
import os
import pickle
import re
import tarfile

import numpy as np

from .common import cache_path, rng_for


def _real_archive(archive: str):
    path = cache_path("cifar", f"{archive}-python.tar.gz")
    return path if os.path.exists(path) else None


def _read_real(archive, member_re, label_key):
    """Iterate the real archive: members matching `member_re` are
    pickled dicts of b'data' uint8[N,3072] and a label list."""
    with tarfile.open(_real_archive(archive), mode="r:*") as tf:
        names = sorted(n for n in tf.getnames() if re.search(member_re, n))
        for name in names:
            batch = pickle.load(tf.extractfile(name), encoding="bytes")
            data = np.asarray(batch[b"data"], np.uint8)
            data = data.astype(np.float32) / 255.0
            labels = batch[label_key]
            for i in range(len(labels)):
                yield data[i], int(labels[i])


def _make(name, split, n, num_classes):
    archive = "cifar-10" if num_classes == 10 else "cifar-100"
    if num_classes == 10:
        member_re = r"data_batch" if split == "train" else r"test_batch"
        label_key = b"labels"
    else:
        member_re = r"/train$" if split == "train" else r"/test$"
        label_key = b"fine_labels"

    def reader():
        if _real_archive(archive):
            yield from _read_real(archive, member_re, label_key)
            return
        rng = rng_for(name, "templates")
        templates = rng.rand(num_classes, 3072).astype(np.float32)
        rng = rng_for(name, split)
        labels = rng.randint(0, num_classes, n).astype(np.int64)
        images = templates[labels] + 0.2 * rng.randn(n, 3072).astype(np.float32)
        images = np.clip(images, 0, 1).astype(np.float32)
        for i in range(n):
            yield images[i], int(labels[i])
    return reader


def train10():
    return _make("cifar10", "train", 4096, 10)


def test10():
    return _make("cifar10", "test", 512, 10)


def train100():
    return _make("cifar100", "train", 4096, 100)


def test100():
    return _make("cifar100", "test", 512, 100)
