"""PTB language-model corpus (reference: python/paddle/dataset/imikolov.py —
n-gram tuples or sequence pairs from Penn Treebank). Parses the real
`simple-examples.tgz` (./data/ptb.train.txt / ptb.valid.txt) from the
cache dir when present (reference imikolov.py:33-100: frequency dict
with min_word_freq, <s>/<e>/<unk> markers, NGRAM windows or SEQ pairs);
otherwise synthesizes Markov-ish id streams over a fixed vocab."""
import os
import tarfile

import numpy as np

from .common import build_freq_dict, cache_path, rng_for

N = 5  # default n-gram order used by the word2vec book chapter
_VOCAB = 2074  # reference build_dict(min_freq=50) size is ~2073 + <unk>


class DataType:
    NGRAM = 1
    SEQ = 2


def _real_archive():
    path = cache_path("imikolov", "simple-examples.tgz")
    return path if os.path.exists(path) else None


def _real_sentences(member_suffix):
    with tarfile.open(_real_archive(), mode="r:*") as tf:
        name = next(n for n in tf.getnames()
                    if n.endswith(member_suffix))
        for line in tf.extractfile(name).read().decode().splitlines():
            words = line.strip().split()
            if words:
                yield words


def build_dict(min_word_freq: int = 50):
    path = _real_archive()
    if path:
        # the PTB text carries literal "<unk>" tokens; the reference
        # drops them from the count and re-appends <unk> at the end
        return build_freq_dict(
            lambda: ([w for w in words if w != "<unk>"]
                     for words in _real_sentences("data/ptb.train.txt")),
            cache_key=("imikolov", path, os.path.getmtime(path),
                       min_word_freq),
            cutoff=min_word_freq)
    return {("w%d" % i): i for i in range(_VOCAB)}


def _real_reader(member_suffix, word_idx, n, data_type):
    def reader():
        idx = word_idx or build_dict()
        unk = idx["<unk>"]
        for words in _real_sentences(member_suffix):
            # reference: sentence wrapped in <s>/<e>; both map through
            # the dict (absent markers fall back to <unk>)
            ids = [idx.get(w, unk)
                   for w in ["<s>"] + words + ["<e>"]]
            if data_type == DataType.NGRAM:
                if len(ids) >= n:
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n:i])
            else:
                yield ids[:-1], ids[1:]
    return reader


def _stream(split, length):
    # order-1 Markov chain over a Zipf-like active vocab => n-grams are
    # genuinely predictive and learnable from a small corpus
    _ACTIVE = 300
    rng = rng_for("imikolov", "trans")
    trans = rng.randint(0, _ACTIVE, (_ACTIVE, 2))
    rng = rng_for("imikolov", split)
    ids = np.empty(length, np.int64)
    ids[0] = rng.randint(_ACTIVE)
    choices = rng.randint(0, 2, length)
    noise = rng.rand(length) < 0.05
    for i in range(1, length):
        ids[i] = rng.randint(_VOCAB) if noise[i] else \
            trans[ids[i - 1] % _ACTIVE, choices[i]]
    return ids


def _make(split, word_idx, n, data_type, total):
    def reader():
        ids = _stream(split, total)
        if data_type == DataType.NGRAM:
            for i in range(len(ids) - n + 1):
                yield tuple(int(w) for w in ids[i:i + n])
        else:
            sent_len = 20
            for i in range(0, len(ids) - sent_len - 1, sent_len):
                src = [int(w) for w in ids[i:i + sent_len]]
                trg = [int(w) for w in ids[i + 1:i + sent_len + 1]]
                yield src, trg
    return reader


def train(word_idx=None, n=N, data_type=DataType.NGRAM):
    if _real_archive():
        return _real_reader("data/ptb.train.txt", word_idx, n, data_type)
    return _make("train", word_idx, n, data_type, 60000)


def test(word_idx=None, n=N, data_type=DataType.NGRAM):
    if _real_archive():
        return _real_reader("data/ptb.valid.txt", word_idx, n, data_type)
    return _make("test", word_idx, n, data_type, 6000)
