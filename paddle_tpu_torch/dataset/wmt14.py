"""WMT14 fr→en translation pairs (reference: python/paddle/dataset/
wmt14.py — sample = (src_ids, trg_ids, trg_ids_next) with <s>/<e>/<unk>).
Parses the real preprocessed layout from the cache dir when present
(reference wmt14.py:40-110: `src.dict`/`trg.dict` word-per-line files
with <s>/<e>/<unk> leading, and train/ test/ dirs of `src\ttrg` line
files); otherwise synthesizes invertible-mapping pairs so
machine_translation learns."""
import os

from .common import cache_path, rng_for

START, END, UNK = 0, 1, 2
_DICT = 1000  # reference default dict_size=30000; small synthetic vocab


def _real_base():
    base = cache_path("wmt14")
    return base if os.path.exists(os.path.join(base, "src.dict")) else None


def _load_dict(base, which, dict_size):
    with open(os.path.join(base, f"{which}.dict"), encoding="utf-8") as f:
        words = [ln.rstrip("\n") for ln in f if ln.strip()]
    return {w: i for i, w in enumerate(words[:dict_size])}


def _real_reader(subdir, dict_size):
    def reader():
        base = _real_base()
        src_dict = _load_dict(base, "src", dict_size)
        trg_dict = _load_dict(base, "trg", dict_size)
        d = os.path.join(base, subdir)
        for fname in sorted(os.listdir(d)):
            with open(os.path.join(d, fname), encoding="utf-8") as f:
                for line in f:
                    if "\t" not in line:
                        continue
                    src, trg = line.rstrip("\n").split("\t")[:2]
                    src_ids = [src_dict.get(w, UNK) for w in src.split()]
                    trg_ids = [trg_dict.get(w, UNK) for w in trg.split()]
                    yield (src_ids, [START] + trg_ids, trg_ids + [END])
    return reader


def _make(split, n, dict_size):
    def reader():
        rng = rng_for("wmt14", split)
        # deterministic word-to-word mapping = a learnable translation;
        # Zipf-like active vocab keeps the task learnable from a small corpus
        active = min(300, dict_size - 3)
        perm = rng_for("wmt14", "perm").permutation(dict_size - 3) + 3
        for _ in range(n):
            length = int(rng.randint(3, 12))
            src = rng.randint(3, 3 + active, length)
            trg = perm[src - 3]
            src_ids = [int(w) for w in src]
            trg_ids = [START] + [int(w) for w in trg]
            trg_next = [int(w) for w in trg] + [END]
            yield src_ids, trg_ids, trg_next
    return reader


def train(dict_size=_DICT):
    if _real_base():
        return _real_reader("train", dict_size)
    return _make("train", 4096, dict_size)


def test(dict_size=_DICT):
    if _real_base():
        return _real_reader("test", dict_size)
    return _make("test", 512, dict_size)


def get_dict(dict_size=_DICT, reverse=False):
    base = _real_base()
    if base:
        src = _load_dict(base, "src", dict_size)
        trg = _load_dict(base, "trg", dict_size)
    else:
        src = {("s%d" % i): i for i in range(dict_size)}
        trg = {("t%d" % i): i for i in range(dict_size)}
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg
