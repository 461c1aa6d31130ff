"""WMT16 en↔de pairs (reference: python/paddle/dataset/wmt16.py — same
(src, trg, trg_next) schema as wmt14 with configurable language pair
and frequency-built vocabularies). Parses real parallel text
(`wmt16/{split}.{en,de}` line-aligned files in the cache dir, vocab by
descending frequency under the dict-size cap with <s>/<e>/<unk> first,
reference wmt16.py:64-120); otherwise shares wmt14's synthetic
generator."""
import os

from . import wmt14
from .common import build_freq_dict, cache_path

START, END, UNK = wmt14.START, wmt14.END, wmt14.UNK


def _real_base():
    base = cache_path("wmt16")
    return base if os.path.exists(os.path.join(base, "train.en")) else None


def _lines(base, split, lang):
    with open(os.path.join(base, f"{split}.{lang}"),
              encoding="utf-8") as f:
        return [ln.rstrip("\n") for ln in f]


def _build_dict(base, lang, dict_size):
    """<s>/<e>/<unk> then words by descending train-split frequency,
    capped at dict_size (reference wmt16.py:64 __build_dict)."""
    train_path = os.path.join(base, f"train.{lang}")
    return build_freq_dict(
        lambda: (ln.split() for ln in _lines(base, "train", lang)),
        cache_key=("wmt16", train_path, os.path.getmtime(train_path),
                   dict_size),
        leading=("<s>", "<e>", "<unk>"), cap=dict_size, unk=None)


def _real_reader(split, src_dict_size, trg_dict_size, src_lang):
    trg_lang = "de" if src_lang == "en" else "en"

    def reader():
        base = _real_base()
        src_dict = _build_dict(base, src_lang, src_dict_size)
        trg_dict = _build_dict(base, trg_lang, trg_dict_size)
        src_lines = _lines(base, split, src_lang)
        trg_lines = _lines(base, split, trg_lang)
        for src, trg in zip(src_lines, trg_lines):
            if not src.strip() or not trg.strip():
                continue
            src_ids = [src_dict.get(w, UNK) for w in src.split()]
            trg_ids = [trg_dict.get(w, UNK) for w in trg.split()]
            yield (src_ids, [START] + trg_ids, trg_ids + [END])
    return reader


def train(src_dict_size=1000, trg_dict_size=1000, src_lang="en"):
    if _real_base():
        return _real_reader("train", src_dict_size, trg_dict_size,
                            src_lang)
    return wmt14._make("wmt16-train", 4096,
                       min(src_dict_size, trg_dict_size))


def test(src_dict_size=1000, trg_dict_size=1000, src_lang="en"):
    if _real_base():
        return _real_reader("test", src_dict_size, trg_dict_size,
                            src_lang)
    return wmt14._make("wmt16-test", 512,
                       min(src_dict_size, trg_dict_size))


def get_dict(lang, dict_size, reverse=False):
    base = _real_base()
    if base:
        d = _build_dict(base, lang, dict_size)
    else:
        d = {("%s%d" % (lang, i)): i for i in range(dict_size)}
    return {v: k for k, v in d.items()} if reverse else d
