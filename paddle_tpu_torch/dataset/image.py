"""Image preprocessing utilities (reference: python/paddle/dataset/image.py
— load/resize/crop/flip/transform helpers used by the image-classification
pipelines). The reference uses OpenCV; this implementation uses PIL +
numpy (both baked into the environment) with the same function surface
and HWC-uint8 conventions.
"""
from __future__ import annotations

import io
import tarfile
from typing import Sequence

import numpy as np

__all__ = ["load_image", "load_image_bytes", "resize_short", "to_chw",
           "center_crop", "random_crop", "left_right_flip",
           "simple_transform", "load_and_transform",
           "batch_images_from_tar"]


def _pil():
    from PIL import Image
    return Image


def load_image_bytes(bytes_, is_color: bool = True) -> np.ndarray:
    """Decode an encoded image from memory -> HWC uint8 (or HW if gray)."""
    im = _pil().open(io.BytesIO(bytes_))
    im = im.convert("RGB" if is_color else "L")
    return np.asarray(im)


def load_image(file: str, is_color: bool = True) -> np.ndarray:
    im = _pil().open(file)
    im = im.convert("RGB" if is_color else "L")
    return np.asarray(im)


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Scale so the SHORTER edge becomes `size`, preserving aspect."""
    h, w = im.shape[:2]
    if h < w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    pim = _pil().fromarray(im)
    pim = pim.resize((nw, nh), _pil().BILINEAR)
    return np.asarray(pim)


def to_chw(im: np.ndarray, order: Sequence[int] = (2, 0, 1)) -> np.ndarray:
    """HWC -> CHW (the layout conv2d expects)."""
    if im.ndim == 2:
        im = im[:, :, None]
    return im.transpose(tuple(order))


def center_crop(im: np.ndarray, size: int,
                is_color: bool = True) -> np.ndarray:
    h, w = im.shape[:2]
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")
    top = (h - size) // 2
    left = (w - size) // 2
    return im[top:top + size, left:left + size]


def random_crop(im: np.ndarray, size: int, is_color: bool = True,
                rng: np.random.RandomState = None) -> np.ndarray:
    rng = rng or np.random
    h, w = im.shape[:2]
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")
    top = rng.randint(0, h - size + 1)
    left = rng.randint(0, w - size + 1)
    return im[top:top + size, left:left + size]


def left_right_flip(im: np.ndarray, is_color: bool = True) -> np.ndarray:
    return im[:, ::-1]


def simple_transform(im: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool, is_color: bool = True,
                     mean=None) -> np.ndarray:
    """resize_short -> crop (random+flip for train, center for eval) ->
    CHW float32, optionally mean-subtracted (reference: simple_transform)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2):
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    im = to_chw(im).astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1:  # per-channel
            if mean.shape[0] != im.shape[0]:
                raise ValueError(
                    f"per-channel mean has {mean.shape[0]} entries but "
                    f"the image has {im.shape[0]} channel(s)")
            mean = mean[:, None, None]
        im -= mean
    return im


def load_and_transform(filename: str, resize_size: int, crop_size: int,
                       is_train: bool, is_color: bool = True,
                       mean=None) -> np.ndarray:
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file: str, dataset_name: str,
                          img2label: dict, num_per_batch: int = 1024):
    """Read images from a tar, batch into .npz files next to the tar, and
    return the batch-file list path (reference: batch_images_from_tar,
    which pickles; .npz is the numpy-native equivalent)."""
    import hashlib
    import os
    # cache key covers the label map and batch size — changing either
    # must re-batch rather than serve stale batches
    key = hashlib.md5(repr((sorted(img2label.items()),
                            num_per_batch)).encode()).hexdigest()[:10]
    out_path = f"{data_file}_{dataset_name}_{key}_batch"
    meta_file = os.path.join(out_path, "batch_file_list.txt")
    if os.path.isfile(meta_file):
        return meta_file
    os.makedirs(out_path, exist_ok=True)
    data, labels, files = [], [], []
    n_batch = 0

    def flush():
        nonlocal data, labels, n_batch
        if not data:
            return
        fname = os.path.join(out_path, f"batch_{n_batch}.npz")
        np.savez(fname,
                 data=np.asarray(data, dtype=object),
                 labels=np.asarray(labels))
        files.append(fname)
        data, labels = [], []
        n_batch += 1

    with tarfile.open(data_file) as tf:
        for member in tf.getmembers():
            if not member.isfile() or member.name not in img2label:
                continue
            raw = tf.extractfile(member).read()
            data.append(raw)
            labels.append(img2label[member.name])
            if len(data) == num_per_batch:
                flush()
    flush()
    with open(meta_file, "w") as f:
        f.write("\n".join(files) + "\n")
    return meta_file
