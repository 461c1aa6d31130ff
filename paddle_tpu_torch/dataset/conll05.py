"""CoNLL-2005 semantic role labeling (reference: python/paddle/dataset/
conll05.py — sample = (word_seq, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
verb_seq, mark_seq, label_seq) for label_semantic_roles). Parses the
real column-format corpus from the cache dir when present (reference
conll05.py:46-180: words file + bracketed props file, one sample per
predicate column, span tags IOB-ified via the target dict); otherwise
synthesizes sequences where labels depend on word/verb/mark so the CRF
converges."""
import gzip
import os

import numpy as np

from .common import cache_path, rng_for

_WORD_VOCAB, _VERB_VOCAB, _NUM_LABELS = 2000, 100, 59  # ref label dict ~59


def _real_base():
    base = cache_path("conll05")
    return base if os.path.exists(os.path.join(base, "wordDict.txt")) \
        else None


def _open_maybe_gz(base, stem):
    for name in (stem, stem + ".gz"):
        path = os.path.join(base, name)
        if os.path.exists(path):
            if name.endswith(".gz"):
                return gzip.open(path, "rt", encoding="utf-8")
            return open(path, encoding="utf-8")
    raise FileNotFoundError(f"{stem}[.gz] not under {base}")


def _load_real_dict(base, fname):
    with open(os.path.join(base, fname), encoding="utf-8") as f:
        return {ln.strip(): i for i, ln in enumerate(f) if ln.strip()}


def _sentences(fh):
    """Blank-line-separated column sentences."""
    rows = []
    for line in fh:
        line = line.strip()
        if not line:
            if rows:
                yield rows
                rows = []
        else:
            rows.append(line.split())
    if rows:
        yield rows
    fh.close()


def _iob(tags):
    """Bracketed span tags ("(A0*", "*", "*)") -> IOB labels
    (reference conll05.py:104-128 corpus_reader label pass)."""
    labels, cur = [], None
    for tag in tags:
        if tag.startswith("("):
            cur = tag[1:tag.index("*")]
            labels.append("B-" + cur)
        elif cur is not None:
            labels.append("I-" + cur)
        else:
            labels.append("O")
        if tag.endswith(")"):
            cur = None
    return labels


def _real_reader(split):
    def reader():
        base = _real_base()
        word_dict = _load_real_dict(base, "wordDict.txt")
        verb_dict = _load_real_dict(base, "verbDict.txt")
        label_dict = _load_real_dict(base, "targetDict.txt")
        unk = word_dict.get("<unk>", 0)
        words_fh = _open_maybe_gz(base, f"{split}.words")
        props_fh = _open_maybe_gz(base, f"{split}.props")
        for wrows, prows in zip(_sentences(words_fh),
                                _sentences(props_fh)):
            words = [r[0] for r in wrows]
            length = len(words)
            n_pred = len(prows[0]) - 1
            for p in range(n_pred):
                tags = [r[1 + p] for r in prows]
                labels = _iob(tags)
                pred_pos = next(i for i, t in enumerate(tags)
                                if t.startswith("(V"))
                verb = verb_dict.get(prows[pred_pos][0], 0)
                mark = [1 if lab.endswith("-V") else 0 for lab in labels]
                word_ids = [word_dict.get(w.lower(), unk) for w in words]
                ctx = []
                for off in (-2, -1, 0, 1, 2):
                    q = pred_pos + off
                    cid = word_ids[q] if 0 <= q < length else unk
                    ctx.append([cid] * length)
                yield (word_ids, ctx[0], ctx[1], ctx[2], ctx[3], ctx[4],
                       [verb] * length, mark,
                       [label_dict.get(lab, 0) for lab in labels])
    return reader


def get_dict():
    base = _real_base()
    if base:
        return (_load_real_dict(base, "wordDict.txt"),
                _load_real_dict(base, "verbDict.txt"),
                _load_real_dict(base, "targetDict.txt"))
    word_dict = {("w%d" % i): i for i in range(_WORD_VOCAB)}
    verb_dict = {("v%d" % i): i for i in range(_VERB_VOCAB)}
    label_dict = {("l%d" % i): i for i in range(_NUM_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    rng = rng_for("conll05", "emb")
    n_words = len(get_dict()[0])
    return rng.randn(n_words, 32).astype(np.float32)


def _make(split, n):
    def reader():
        rng = rng_for("conll05", split)
        label_of = rng_for("conll05", "rule").randint(
            0, _NUM_LABELS, (_WORD_VOCAB, 2))
        active = 400  # Zipf-like active vocab => learnable small corpus
        for _ in range(n):
            length = int(rng.randint(5, 25))
            words = rng.randint(0, active, length)
            verb = int(rng.randint(0, _VERB_VOCAB))
            pred_pos = int(rng.randint(0, length))
            mark = [1 if i == pred_pos else 0 for i in range(length)]
            labels = [int(label_of[w, m]) for w, m in zip(words, mark)]
            ctx = []
            for off in (-2, -1, 0, 1, 2):
                p = min(max(pred_pos + off, 0), length - 1)
                ctx.append([int(words[p])] * length)
            word_seq = [int(w) for w in words]
            verb_seq = [verb] * length
            yield (word_seq, ctx[0], ctx[1], ctx[2], ctx[3], ctx[4],
                   verb_seq, mark, labels)
    return reader


def test():
    if _real_base():
        return _real_reader("test.wsj")
    return _make("test", 512)


def train():
    if _real_base():
        return _real_reader("train.wsj")
    return _make("train", 2048)
