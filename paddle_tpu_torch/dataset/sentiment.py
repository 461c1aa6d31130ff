"""Movie-review sentiment via NLTK corpus in the reference (reference:
python/paddle/dataset/sentiment.py — the nltk movie_reviews corpus,
pos/neg .txt files). Parses a real extracted corpus from the cache dir
(`sentiment/movie_reviews/{pos,neg}/*.txt`) when present; otherwise
shares imdb's synthetic generator. Same schema as imdb: (ids, label)."""
import os

from . import imdb
from .common import build_freq_dict, cache_path


def _real_dir():
    base = cache_path("sentiment", "movie_reviews")
    return base if os.path.isdir(os.path.join(base, "pos")) else None


def _real_docs(polarity):
    base = _real_dir()
    d = os.path.join(base, polarity)
    for fname in sorted(os.listdir(d)):
        if fname.endswith(".txt"):
            with open(os.path.join(d, fname), encoding="utf-8",
                      errors="replace") as f:
                yield imdb.tokenize(f.read())


def get_word_dict():
    base = _real_dir()
    if base:
        return build_freq_dict(
            lambda: (words for pol in ("pos", "neg")
                     for words in _real_docs(pol)),
            cache_key=("sentiment", base, os.path.getmtime(base)))
    return imdb.word_dict()


def _real_reader(lo_frac, hi_frac):
    """The reference's nltk corpus has no split files; it slices each
    polarity's document list (sentiment.py train/test 80/20)."""
    def reader():
        idx = get_word_dict()
        unk = idx["<unk>"]
        for label, pol in ((0, "pos"), (1, "neg")):
            docs = list(_real_docs(pol))
            lo = int(len(docs) * lo_frac)
            hi = int(len(docs) * hi_frac)
            for words in docs[lo:hi]:
                yield [idx.get(w, unk) for w in words], label
    return reader


def train():
    if _real_dir():
        return _real_reader(0.0, 0.8)
    return imdb._make("sentiment-train", 1024)


def test():
    if _real_dir():
        return _real_reader(0.8, 1.0)
    return imdb._make("sentiment-test", 128)
