"""Oxford-102 flowers (reference: python/paddle/dataset/flowers.py —
3x224x224 float image + label). Parses the real archive set from the
cache dir when present (reference flowers.py:40-120: `102flowers.tgz`
of jpgs, `imagelabels.mat` 1-based labels, `setid.mat` split ids);
otherwise synthesizes class-separable images."""
import io
import os
import re
import tarfile

import numpy as np

from .common import cache_path, rng_for

_N_CLASSES = 102


def _real_base():
    base = cache_path("flowers")
    need = ("102flowers.tgz", "imagelabels.mat", "setid.mat")
    return base if all(os.path.exists(os.path.join(base, f))
                       for f in need) else None


def _real_reader(setid_key):
    def reader():
        from PIL import Image
        from scipy.io import loadmat
        base = _real_base()
        labels = loadmat(os.path.join(base, "imagelabels.mat"))
        labels = np.asarray(labels["labels"]).reshape(-1)  # 1-based
        ids = loadmat(os.path.join(base, "setid.mat"))[setid_key]
        ids = set(int(i) for i in np.asarray(ids).reshape(-1))
        with tarfile.open(os.path.join(base, "102flowers.tgz"),
                          mode="r:*") as tf:
            for name in sorted(tf.getnames()):
                m = re.search(r"image_(\d+)\.jpg$", name)
                if not m or int(m.group(1)) not in ids:
                    continue
                img = Image.open(io.BytesIO(
                    tf.extractfile(name).read())).convert("RGB")
                img = img.resize((224, 224))
                arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
                yield arr, int(labels[int(m.group(1)) - 1]) - 1
    return reader


def _make(split, n):
    def reader():
        rng = rng_for("flowers", "templates")
        templates = rng.rand(_N_CLASSES, 3, 8, 8).astype(np.float32)
        rng = rng_for("flowers", split)
        for _ in range(n):
            label = int(rng.randint(0, _N_CLASSES))
            base = np.kron(templates[label], np.ones((1, 28, 28),
                                                     np.float32))
            img = base + 0.1 * rng.randn(3, 224, 224).astype(np.float32)
            yield np.clip(img, 0, 1).astype(np.float32), label
    return reader


def train(mapper=None, buffered_size=None, use_xmap=None):
    if _real_base():
        return _real_reader("trnid")
    return _make("train", 512)


def test(mapper=None, buffered_size=None, use_xmap=None):
    if _real_base():
        return _real_reader("tstid")
    return _make("test", 64)


def valid(mapper=None, buffered_size=None, use_xmap=None):
    if _real_base():
        return _real_reader("valid")
    return _make("valid", 64)
