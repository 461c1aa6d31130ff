"""IMDB movie-review sentiment (reference: python/paddle/dataset/imdb.py —
word-id sequence + binary label; word_dict built by frequency over the
aclImdb corpus). Parses the real `aclImdb_v1.tar.gz` from the cache dir
when present (reference imdb.py:36-100: tokenize, build_dict with
cutoff, pos label 0 / neg label 1); otherwise synthesizes two sentiment
word populations so understand_sentiment converges."""
import os
import re
import tarfile

import numpy as np

from .common import build_freq_dict, cache_path, rng_for

_VOCAB = 5149  # reference IMDB cutoff-150 vocab is ~5148 words + <unk>


def _real_archive():
    path = cache_path("imdb", "aclImdb_v1.tar.gz")
    return path if os.path.exists(path) else None


def tokenize(text: str):
    """Reference imdb.py:36 tokenize: lowercase word stream with
    punctuation stripped."""
    return re.findall(r"[a-z']+", text.lower())


def _real_docs(split_re):
    """Stream matching members in ARCHIVE order: a gz-backed tarfile
    re-decompresses from byte 0 on every backward seek, so sorted-name
    random access would cost O(members x archive) per epoch."""
    with tarfile.open(_real_archive(), mode="r:*") as tf:
        for m in tf:
            if m.isfile() and re.search(split_re, m.name):
                text = tf.extractfile(m).read().decode("utf-8", "replace")
                yield tokenize(text)


def word_dict(cutoff: int = 150):
    """Frequency-sorted dict over train+test with a min-count cutoff +
    trailing <unk> (reference imdb.py:60 word_dict = build_dict over
    aclImdb/(train|test)/(pos|neg), cutoff 150)."""
    path = _real_archive()
    if path:
        return build_freq_dict(
            lambda: _real_docs(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$"),
            cache_key=("imdb", path, os.path.getmtime(path), cutoff),
            cutoff=cutoff)
    return {("w%d" % i): i for i in range(_VOCAB)}


def _real_reader(split, word_idx=None):
    def reader():
        idx = word_idx or word_dict()
        unk = idx["<unk>"]
        # pos first (label 0), then neg (label 1), like the reference's
        # chained pos/neg reader creators
        for label, pol in ((0, "pos"), (1, "neg")):
            pat = rf"aclImdb/{split}/{pol}/.*\.txt$"
            for words in _real_docs(pat):
                yield [idx.get(w, unk) for w in words], label
    return reader


def _make(split, n, seq_lo=20, seq_hi=100):
    def reader():
        rng = rng_for("imdb", split)
        half = _VOCAB // 2
        active = 400  # Zipf-like active vocab per sentiment class
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(seq_lo, seq_hi))
            # positive reviews draw mostly from the upper half of the vocab
            main = rng.randint(half, half + active, length) if label else \
                rng.randint(0, active, length)
            noise_mask = rng.rand(length) < 0.1
            noise = rng.randint(0, _VOCAB, length)
            ids = np.where(noise_mask, noise, main).astype(np.int64)
            yield list(map(int, ids)), label
    return reader


def train(word_idx=None):
    if _real_archive():
        return _real_reader("train", word_idx)
    return _make("train", 2048)


def test(word_idx=None):
    if _real_archive():
        return _real_reader("test", word_idx)
    return _make("test", 256)
