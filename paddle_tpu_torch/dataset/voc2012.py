"""Pascal VOC2012 segmentation (reference: python/paddle/dataset/
voc2012.py — (image, segmentation label map) pairs). Parses the real
`VOCtrainval_11-May-2012.tar` from the cache dir when present
(reference voc2012.py:30-76: ImageSets/Segmentation split lists,
JPEGImages jpgs, SegmentationClass palette pngs); otherwise
synthesizes labeled blobs."""
import io
import os
import tarfile

import numpy as np

from .common import cache_path, rng_for

_N_CLASSES = 21


def _real_archive():
    path = cache_path("voc2012", "VOCtrainval_11-May-2012.tar")
    return path if os.path.exists(path) else None


def _real_reader(split):
    def reader():
        from PIL import Image
        with tarfile.open(_real_archive(), mode="r:*") as tf:
            members = {m.name: m for m in tf.getmembers()}

            def find(suffix):
                return next(n for n in members if n.endswith(suffix))

            ids = tf.extractfile(find(
                f"ImageSets/Segmentation/{split}.txt")).read() \
                .decode().split()
            jpeg_dir = os.path.dirname(find("JPEGImages/" + ids[0] + ".jpg"))
            seg_dir = os.path.dirname(find(
                "SegmentationClass/" + ids[0] + ".png"))
            for img_id in ids:
                img = Image.open(io.BytesIO(tf.extractfile(
                    f"{jpeg_dir}/{img_id}.jpg").read())).convert("RGB")
                arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
                seg = Image.open(io.BytesIO(tf.extractfile(
                    f"{seg_dir}/{img_id}.png").read()))
                label = np.asarray(seg, np.int32)  # palette indices
                # VOC marks void/boundary pixels with palette index 255;
                # the module contract is labels in [0, 21), so void maps
                # to background — a 21-class loss would otherwise get
                # out-of-range indices that JAX clamps/zeros silently
                label = np.where(label >= _N_CLASSES, 0, label)
                yield arr, label
    return reader


def _make(split, n, hw=64):
    def reader():
        rng = rng_for("voc2012", split)
        for _ in range(n):
            img = rng.rand(3, hw, hw).astype(np.float32)
            label = np.zeros((hw, hw), np.int32)
            for _ in range(3):
                c = int(rng.randint(1, _N_CLASSES))
                x0, y0 = rng.randint(0, hw - 8, 2)
                w, h = rng.randint(4, 16, 2)
                label[y0:y0 + h, x0:x0 + w] = c
                img[:, y0:y0 + h, x0:x0 + w] += c / _N_CLASSES
            yield np.clip(img, 0, 1), label
    return reader


def train():
    if _real_archive():
        return _real_reader("train")
    return _make("train", 256)


def test():
    if _real_archive():
        return _real_reader("val")   # VOC2012 test labels are withheld;
    return _make("test", 32)         # the reference also evaluates on val


def val():
    if _real_archive():
        return _real_reader("val")
    return _make("val", 32)
