"""paddle_tpu_torch.dataset against paddle_tpu.dataset.

- Synthetic path (no file under DATA_HOME): for every module, the first
  samples of every reader creator, and every dictionary, table and
  helper value, equal the reference's exactly: the same types, dtypes,
  shapes, values and structure (numpy scalars and Python ints told
  apart), for the same seeds.
- Real-file path: small archives in each corpus' real format, built
  inline as tests/test_dataset_archives.py builds them (cifar pickle-tar,
  the UCI housing table, aclImdb tar, PTB tgz, the nltk movie_reviews
  tree, ml-1m zip, CoNLL-05 column files, VOC tar, the flowers archive
  set, WMT-14 dicts and bitext, WMT-16 parallel text, MNIST IDX, LETOR
  text), read through both packages from one temporary DATA_HOME: every
  sample and every dictionary equal.
- ``common.download`` through an injected ``fetch`` (nothing reaches the
  network), as tests/test_resilience.py holds the reference's: the
  retries after a dropped transfer with a fresh ``.part`` file an
  attempt and no ``.part`` left, a corrupt cached copy discarded and
  re-fetched, an md5 mismatch exhausting its retries with nothing
  cached, and the ``dataset.download`` fault point ridden by the retry.
- The image helpers (load, resize, crops, flip, transform, the
  tar-to-npz batching) on the same inputs.
"""
import gzip
import hashlib
import io
import itertools
import os
import pickle
import tarfile
import zipfile

import numpy as np
import pytest

import paddle_tpu.dataset as REF
import paddle_tpu_torch.dataset as PORT
from paddle_tpu_torch.resilience import FaultInjector
from paddle_tpu_torch.resilience.retry import RetryPolicy

FIRST = 6


@pytest.fixture(autouse=True)
def data_home(monkeypatch, tmp_path):
    """Both packages' DATA_HOME at one empty temporary directory and
    their vocabulary and table memos empty."""
    home = tmp_path / "data_home"
    home.mkdir()
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.common, "DATA_HOME", str(home))
        monkeypatch.setattr(pkg.common, "_FREQ_DICT_CACHE", {})
        monkeypatch.setattr(pkg.movielens, "_TABLES_CACHE", {})
    return home


def _kind(v):
    """A value's type, the port's dataset classes named as the
    reference's."""
    t = type(v)
    return t.__module__.replace("paddle_tpu_torch.", "paddle_tpu."), \
        t.__qualname__


def _same(a, b, where="sample"):
    """Equal values of equal types, recursively."""
    assert _kind(a) == _kind(b), f"{where}: {type(a)} vs {type(b)}"
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=True), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        _same(vars(a), vars(b), f"{where}.__dict__")
    elif hasattr(type(a), "__slots__"):
        for slot in type(a).__slots__:
            _same(getattr(a, slot), getattr(b, slot), f"{where}.{slot}")
    else:
        assert a == b or (a != a and b != b), f"{where}: {a!r} vs {b!r}"


def _first(reader, n=FIRST):
    return list(itertools.islice(reader(), n))


# -- the synthetic path ------------------------------------------------------

#: module -> callables of the module that give readers (creators) or
#: values, each applied to the reference's and the port's module
SYNTHETIC = {
    "uci_housing": {"train": lambda m: m.train(), "test": lambda m: m.test()},
    "mnist": {"train": lambda m: m.train(), "test": lambda m: m.test()},
    "cifar": {"train10": lambda m: m.train10(),
              "test10": lambda m: m.test10(),
              "train100": lambda m: m.train100(),
              "test100": lambda m: m.test100()},
    "imdb": {"word_dict": lambda m: m.word_dict(),
             "train": lambda m: m.train(), "test": lambda m: m.test(),
             "tokenize": lambda m: m.tokenize("A <br />Great, GREAT film!")},
    "imikolov": {"build_dict": lambda m: m.build_dict(),
                 "train": lambda m: m.train(),
                 "test": lambda m: m.test(n=3),
                 "train_seq": lambda m: m.train(
                     data_type=m.DataType.SEQ)},
    "sentiment": {"get_word_dict": lambda m: m.get_word_dict(),
                  "train": lambda m: m.train(), "test": lambda m: m.test()},
    "movielens": {"max_user_id": lambda m: m.max_user_id(),
                  "max_movie_id": lambda m: m.max_movie_id(),
                  "max_job_id": lambda m: m.max_job_id(),
                  "age_table": lambda m: m.age_table(),
                  "movie_categories": lambda m: m.movie_categories(),
                  "get_movie_title_dict":
                      lambda m: m.get_movie_title_dict(),
                  "train": lambda m: m.train(), "test": lambda m: m.test()},
    "conll05": {"get_dict": lambda m: m.get_dict(),
                "get_embedding": lambda m: m.get_embedding(),
                "train": lambda m: m.train(), "test": lambda m: m.test()},
    "wmt14": {"train": lambda m: m.train(), "test": lambda m: m.test(),
              "get_dict": lambda m: m.get_dict(),
              "get_dict_reverse": lambda m: m.get_dict(reverse=True)},
    "wmt16": {"train": lambda m: m.train(), "test": lambda m: m.test(),
              "train_de": lambda m: m.train(src_lang="de"),
              "get_dict": lambda m: m.get_dict("en", 1000),
              "get_dict_reverse": lambda m: m.get_dict("de", 300,
                                                       reverse=True)},
    "flowers": {"train": lambda m: m.train(), "test": lambda m: m.test(),
                "valid": lambda m: m.valid()},
    "voc2012": {"train": lambda m: m.train(), "test": lambda m: m.test(),
                "val": lambda m: m.val()},
    "mq2007": {f"{split}_{fmt}": (lambda m, s=split, f=fmt:
                                  getattr(m, s)(f))
               for split in ("train", "test")
               for fmt in ("pairwise", "pointwise", "listwise",
                           "plain_txt")},
}


def _value(fn, module):
    got = fn(module)
    return _first(got) if callable(got) else got


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_samples_equal_reference(name):
    for what, fn in SYNTHETIC[name].items():
        ref = _value(fn, getattr(REF, name))
        port = _value(fn, getattr(PORT, name))
        assert ref is not None and (not isinstance(ref, list) or ref), what
        _same(ref, port, f"{name}.{what}")


def test_synthetic_readers_are_deterministic():
    """Each creator's reader yields the same samples on every pass (the
    seeds are per dataset and split, not per call)."""
    for name, fn in (("mnist", lambda m: m.train()),
                     ("imikolov", lambda m: m.train()),
                     ("movielens", lambda m: m.test())):
        reader = fn(getattr(PORT, name))
        _same(_first(reader), _first(reader), name)


def test_common_helpers_equal_reference(tmp_path):
    for name, split in (("mnist", "train"), ("cifar", "templates")):
        _same(REF.common.rng_for(name, split).randint(0, 1 << 30, 8),
              PORT.common.rng_for(name, split).randint(0, 1 << 30, 8))
    docs = [["b", "a", "c", "a"], ["c", "a", "d"], ["e"]]
    for kw in ({}, dict(cutoff=2), dict(leading=("<s>", "<e>"), cap=4),
               dict(unk=None)):
        _same(REF.common.build_freq_dict(lambda: docs, ("k", str(kw)),
                                         **kw),
              PORT.common.build_freq_dict(lambda: docs, ("k", str(kw)),
                                          **kw), str(kw))
    path = tmp_path / "f.bin"
    path.write_bytes(b"payload" * 1000)
    assert PORT.common.md5file(str(path)) == REF.common.md5file(str(path))
    assert PORT.common.cache_path("a", "b") == REF.common.cache_path("a",
                                                                     "b")
    assert PORT.common.DOWNLOAD_RETRY.max_attempts == \
        REF.common.DOWNLOAD_RETRY.max_attempts


# -- the real-file path ------------------------------------------------------

def _add_bytes(tf, name, payload):
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tf.addfile(info, io.BytesIO(payload))


def _cifar(home):
    base = home / "cifar"
    base.mkdir()
    rng = np.random.RandomState(0)
    with tarfile.open(base / "cifar-10-python.tar.gz", "w:gz") as tf:
        for member, n in (("cifar-10-batches-py/data_batch_1", 6),
                          ("cifar-10-batches-py/data_batch_2", 4),
                          ("cifar-10-batches-py/test_batch", 3)):
            batch = {b"data": rng.randint(0, 256, (n, 3072), dtype=np.uint8),
                     b"labels": [int(v) for v in rng.randint(0, 10, n)]}
            _add_bytes(tf, member, pickle.dumps(batch))
    with tarfile.open(base / "cifar-100-python.tar.gz", "w:gz") as tf:
        for member, n in (("cifar-100-python/train", 5),
                          ("cifar-100-python/test", 2)):
            batch = {b"data": rng.randint(0, 256, (n, 3072), dtype=np.uint8),
                     b"fine_labels": [int(v) for v in
                                      rng.randint(0, 100, n)]}
            _add_bytes(tf, member, pickle.dumps(batch))
    return {"train10": lambda m: m.train10(), "test10": lambda m: m.test10(),
            "train100": lambda m: m.train100(),
            "test100": lambda m: m.test100()}


def _uci_housing(home):
    base = home / "uci_housing"
    base.mkdir()
    data = np.random.RandomState(2).rand(450, 14).astype(np.float32) * 10
    np.savetxt(base / "housing.data", data, fmt="%.4f")
    return {"train": lambda m: m.train(), "test": lambda m: m.test()}


def _mnist(home):
    base = home / "mnist"
    base.mkdir()
    rng = np.random.RandomState(6)
    for split, n in (("train", 5), ("t10k", 3)):
        images = rng.randint(0, 256, (n, 784), dtype=np.uint8)
        labels = rng.randint(0, 10, n).astype(np.uint8)
        with gzip.open(base / f"{split}-images-idx3-ubyte.gz", "wb") as f:
            f.write((2051).to_bytes(4, "big") + n.to_bytes(4, "big")
                    + (28).to_bytes(4, "big") * 2 + images.tobytes())
        with gzip.open(base / f"{split}-labels-idx1-ubyte.gz", "wb") as f:
            f.write((2049).to_bytes(4, "big") + n.to_bytes(4, "big")
                    + labels.tobytes())
    return {"train": lambda m: m.train(), "test": lambda m: m.test()}


def _imdb(home):
    base = home / "imdb"
    base.mkdir()
    docs = {
        "aclImdb/train/pos/0_9.txt": b"A wonderful movie, truly great!",
        "aclImdb/train/pos/1_8.txt": b"Great acting and a great plot.",
        "aclImdb/train/neg/0_2.txt": b"Terrible. Awful pacing, bad jokes.",
        "aclImdb/test/pos/0_7.txt": b"great fun",
        "aclImdb/test/neg/0_3.txt": b"bad, awful",
    }
    with tarfile.open(base / "aclImdb_v1.tar.gz", "w:gz") as tf:
        for name, payload in docs.items():
            _add_bytes(tf, name, payload)
    return {"word_dict": lambda m: m.word_dict(cutoff=1),
            "train": lambda m: m.train(m.word_dict(cutoff=1)),
            "test": lambda m: m.test()}


def _imikolov(home):
    base = home / "imikolov"
    base.mkdir()
    with tarfile.open(base / "simple-examples.tgz", "w:gz") as tf:
        _add_bytes(tf, "./simple-examples/data/ptb.train.txt",
                   b"the cat sat on the mat\nthe dog sat\n")
        _add_bytes(tf, "./simple-examples/data/ptb.valid.txt",
                   b"the cat sat\n")
    return {"build_dict": lambda m: m.build_dict(min_word_freq=1),
            "train": lambda m: m.train(m.build_dict(min_word_freq=1), n=3),
            "train_seq": lambda m: m.train(m.build_dict(min_word_freq=1),
                                           n=3, data_type=m.DataType.SEQ),
            "test": lambda m: m.test(m.build_dict(min_word_freq=1), n=3)}


def _sentiment(home):
    for pol, texts in (("pos", ["good film", "nice good story"]),
                       ("neg", ["bad film", "dull bad script"])):
        d = home / "sentiment" / "movie_reviews" / pol
        d.mkdir(parents=True)
        for i, t in enumerate(texts):
            (d / f"cv{i}.txt").write_text(t)
    return {"get_word_dict": lambda m: m.get_word_dict(),
            "train": lambda m: m.train(), "test": lambda m: m.test()}


def _movielens(home):
    base = home / "movielens"
    base.mkdir()
    users = "1::M::25::6::12345\n2::F::50::3::54321\n"
    movies = ("10::Toy Story (1995)::Animation|Comedy\n"
              "20::Heat (1995)::Action\n")
    ratings = "".join(f"{u}::{m}::{r}::97830000{i}\n"
                      for i, (u, m, r) in enumerate(
                          [(1, 10, 5), (1, 20, 3), (2, 10, 4),
                           (2, 20, 2)] * 3))
    with zipfile.ZipFile(base / "ml-1m.zip", "w") as zf:
        zf.writestr("ml-1m/users.dat", users)
        zf.writestr("ml-1m/movies.dat", movies)
        zf.writestr("ml-1m/ratings.dat", ratings)
    return {k: v for k, v in SYNTHETIC["movielens"].items()}


def _conll05(home):
    base = home / "conll05"
    base.mkdir()
    (base / "wordDict.txt").write_text(
        "\n".join(["<unk>", "the", "cat", "chased", "a", "mouse"]) + "\n")
    (base / "verbDict.txt").write_text("chase\nrun\n")
    (base / "targetDict.txt").write_text(
        "\n".join(["O", "B-A0", "I-A0", "B-V", "B-A1", "I-A1"]) + "\n")
    (base / "test.wsj.words").write_text("The\ncat\nchased\na\nmouse\n\n")
    with gzip.open(base / "test.wsj.props.gz", "wt") as f:
        f.write("- (A0*\n- *)\nchase (V*)\n- (A1*\n- *)\n\n")
    return {"get_dict": lambda m: m.get_dict(),
            "get_embedding": lambda m: m.get_embedding(),
            "test": lambda m: m.test()}


def _voc2012(home):
    from PIL import Image
    base = home / "voc2012"
    base.mkdir()
    rng = np.random.RandomState(3)

    def png(arr, palette):
        img = Image.fromarray(arr.astype(np.uint8), mode="P")
        img.putpalette(palette)
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        return buf.getvalue()

    def jpg(hw):
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 256, (hw, hw, 3), dtype=np.uint8)) \
            .save(buf, format="JPEG")
        return buf.getvalue()

    palette = sum(([i, 0, 0] for i in range(256)), [])
    seg = np.zeros((16, 16), np.uint8)
    seg[4:8, 4:8] = 7
    seg[0, 1] = 255
    root = "VOCdevkit/VOC2012"
    with tarfile.open(base / "VOCtrainval_11-May-2012.tar", "w") as tf:
        _add_bytes(tf, f"{root}/ImageSets/Segmentation/train.txt",
                   b"2007_000001\n")
        _add_bytes(tf, f"{root}/ImageSets/Segmentation/val.txt",
                   b"2007_000001\n")
        _add_bytes(tf, f"{root}/JPEGImages/2007_000001.jpg", jpg(16))
        _add_bytes(tf, f"{root}/SegmentationClass/2007_000001.png",
                   png(seg, palette))
    return {"train": lambda m: m.train(), "val": lambda m: m.val(),
            "test": lambda m: m.test()}


def _flowers(home):
    from PIL import Image
    from scipy.io import savemat
    base = home / "flowers"
    base.mkdir()
    rng = np.random.RandomState(4)
    with tarfile.open(base / "102flowers.tgz", "w:gz") as tf:
        for i in (1, 2, 3):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 256, (32, 48, 3),
                                        dtype=np.uint8)).save(buf,
                                                              format="JPEG")
            _add_bytes(tf, f"jpg/image_{i:05d}.jpg", buf.getvalue())
    savemat(base / "imagelabels.mat",
            {"labels": np.array([[5, 9, 5]], np.float64)})
    savemat(base / "setid.mat", {"trnid": np.array([[1, 3]]),
                                 "valid": np.array([[2]]),
                                 "tstid": np.array([[2]])})
    return {"train": lambda m: m.train(), "valid": lambda m: m.valid(),
            "test": lambda m: m.test()}


def _wmt14(home):
    base = home / "wmt14"
    (base / "train").mkdir(parents=True)
    (base / "test").mkdir()
    (base / "src.dict").write_text(
        "\n".join(["<s>", "<e>", "<unk>", "le", "chat", "noir"]) + "\n")
    (base / "trg.dict").write_text(
        "\n".join(["<s>", "<e>", "<unk>", "the", "cat", "black"]) + "\n")
    (base / "train" / "part-00").write_text(
        "le chat\tthe cat\nle chat noir\tthe black cat\n")
    (base / "test" / "part-00").write_text("le inconnu\tthe dog\n")
    return {k: v for k, v in SYNTHETIC["wmt14"].items()}


def _wmt16(home):
    base = home / "wmt16"
    base.mkdir()
    (base / "train.en").write_text("a cat sat\na dog sat\n")
    (base / "train.de").write_text("eine katze sass\nein hund sass\n")
    (base / "test.en").write_text("a cat\n")
    (base / "test.de").write_text("eine katze\n")
    return {"train": lambda m: m.train(), "test": lambda m: m.test(),
            "get_dict": lambda m: m.get_dict("en", 50),
            "tiny": lambda m: m.get_dict("en", 4),
            "get_dict_reverse": lambda m: m.get_dict("de", 50,
                                                     reverse=True)}


REAL = {"cifar": _cifar, "uci_housing": _uci_housing, "mnist": _mnist,
        "imdb": _imdb, "imikolov": _imikolov, "sentiment": _sentiment,
        "movielens": _movielens, "conll05": _conll05, "voc2012": _voc2012,
        "flowers": _flowers, "wmt14": _wmt14, "wmt16": _wmt16}


@pytest.mark.parametrize("name", sorted(REAL))
def test_real_archives_read_as_reference_reads_them(name, data_home):
    """Each module reads the archive under DATA_HOME (not its synthetic
    corpus) and yields the reference's samples, every one of them."""
    calls = REAL[name](data_home)
    for what, fn in calls.items():
        ref = _value_all(fn, getattr(REF, name))
        port = _value_all(fn, getattr(PORT, name))
        _same(ref, port, f"{name}.{what}")


def _value_all(fn, module):
    got = fn(module)
    return list(got()) if callable(got) else got


def test_real_paths_are_taken(data_home):
    """The archives above replace the synthetic corpora (their sample
    counts are the archives')."""
    _cifar(data_home)
    _uci_housing(data_home)
    assert len(list(PORT.cifar.train10()())) == 10
    assert len(list(PORT.cifar.test100()())) == 2
    assert len(list(PORT.uci_housing.test()())) == 46


def test_mq2007_letor_text_equal_reference(tmp_path):
    path = tmp_path / "Fold1.txt"
    rng = np.random.RandomState(5)
    lines = []
    for qid, rels in ((10, [2, 0, 1]), (11, [0, 1])):
        for rel in rels:
            feats = " ".join(f"{k}:{rng.rand():.3f}" for k in range(1, 47))
            lines.append(f"{rel} qid:{qid} {feats} #docid = D{qid}-{rel}")
    path.write_text("\n".join(lines) + "\n")
    ref = REF.mq2007.load_from_text(str(path))
    port = PORT.mq2007.load_from_text(str(path))
    _same(ref, port, "load_from_text")
    for fmt in ("pairwise", "pointwise", "listwise", "plain_txt"):
        _same(list(getattr(REF.mq2007, fmt)(ref)()),
              list(getattr(PORT.mq2007, fmt)(port)()), fmt)


# -- image helpers -----------------------------------------------------------

def test_image_helpers_equal_reference(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(8)
    im = rng.randint(0, 256, (40, 56, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(im).save(buf, format="PNG")
    png = buf.getvalue()
    (tmp_path / "a.png").write_bytes(png)
    for what, fn in {
            "load_image_bytes": lambda m: m.load_image_bytes(png),
            "load_image_gray": lambda m: m.load_image(
                str(tmp_path / "a.png"), is_color=False),
            "resize_short": lambda m: m.resize_short(im, 24),
            "to_chw": lambda m: m.to_chw(im),
            "center_crop": lambda m: m.center_crop(im, 32),
            "random_crop": lambda m: m.random_crop(
                im, 32, rng=np.random.RandomState(1)),
            "left_right_flip": lambda m: m.left_right_flip(im),
            "eval_transform": lambda m: m.simple_transform(
                im, 36, 32, False, mean=[1.0, 2.0, 3.0]),
            "train_transform": lambda m: (np.random.seed(3),
                                          m.simple_transform(
                                              im, 36, 32, True))[1],
            "load_and_transform": lambda m: m.load_and_transform(
                str(tmp_path / "a.png"), 36, 32, False)}.items():
        _same(fn(REF.image), fn(PORT.image), what)
    with pytest.raises(ValueError):
        PORT.image.center_crop(im, 64)
    with pytest.raises(ValueError):
        PORT.image.simple_transform(im, 36, 32, False, mean=[1.0, 2.0])
    tars = []
    for who in ("ref", "port"):
        d = tmp_path / who
        d.mkdir()
        with tarfile.open(d / "imgs.tar", "w") as tf:
            for i in range(5):
                _add_bytes(tf, f"img_{i}.png", png)
        tars.append(str(d / "imgs.tar"))
    labels = {f"img_{i}.png": i % 2 for i in range(5)}
    metas = [m.batch_images_from_tar(t, "unit", labels, num_per_batch=2)
             for m, t in zip((REF.image, PORT.image), tars)]
    lists = [open(m).read().split() for m in metas]
    assert [os.path.basename(f) for f in lists[0]] == \
        [os.path.basename(f) for f in lists[1]]
    for r, p in zip(*lists):
        with np.load(r, allow_pickle=True) as a, \
                np.load(p, allow_pickle=True) as b:
            _same(list(a["data"]), list(b["data"]))
            _same(a["labels"], b["labels"])


# -- common.download, through an injected fetch ------------------------------

def test_download_retries_and_cleans_partial_file(data_home):
    payload = b"archive-bytes"
    md5 = hashlib.md5(payload).hexdigest()
    state = {"n": 0}
    part_paths = []

    def fetch(url, path):
        state["n"] += 1
        assert path not in part_paths and os.path.getsize(path) == 0
        assert path.endswith(".part")
        part_paths.append(path)
        with open(path, "wb") as f:
            if state["n"] < 3:
                f.write(payload[:4])
                raise ConnectionError("link dropped mid-transfer")
            f.write(payload)

    p = PORT.common.download("http://example.invalid/data.tgz", "unit",
                             md5sum=md5,
                             retry=RetryPolicy(max_attempts=3,
                                               base_delay_s=0.001,
                                               jitter=0.0),
                             fetch=fetch)
    assert state["n"] == 3 and len(set(part_paths)) == 3
    assert p == PORT.common.cache_path("unit", "data.tgz")
    with open(p, "rb") as f:
        assert f.read() == payload
    assert not [f for f in os.listdir(os.path.dirname(p))
                if f.endswith(".part")]
    # a cached copy that verifies is served without a transfer
    assert PORT.common.download("http://example.invalid/data.tgz", "unit",
                                md5sum=md5, fetch=None) == p


def test_download_discards_corrupt_cache_and_md5_failure(data_home):
    payload = b"real-data"
    md5 = hashlib.md5(payload).hexdigest()
    fname = PORT.common.cache_path("unit", "f.bin")
    os.makedirs(os.path.dirname(fname))
    with open(fname, "wb") as f:
        f.write(b"corrupt-cached-copy")

    def fetch(url, path):
        with open(path, "wb") as f:
            f.write(payload)

    p = PORT.common.download("http://example.invalid/f.bin", "unit",
                             md5sum=md5, retry=RetryPolicy(max_attempts=1),
                             fetch=fetch)
    with open(p, "rb") as f:
        assert f.read() == payload

    def bad_fetch(url, path):
        with open(path, "wb") as f:
            f.write(b"garbage")

    with pytest.raises(IOError, match="md5"):
        PORT.common.download("http://example.invalid/g.bin", "unit",
                             md5sum=md5,
                             retry=RetryPolicy(max_attempts=2,
                                               base_delay_s=0.001,
                                               jitter=0.0),
                             fetch=bad_fetch)
    assert not os.path.exists(PORT.common.cache_path("unit", "g.bin"))
    assert not [f for f in os.listdir(PORT.common.cache_path("unit"))
                if f.endswith(".part")]


def test_download_fault_point(data_home):
    def fetch(url, path):
        with open(path, "wb") as f:
            f.write(b"x")

    with FaultInjector() as fi:
        fi.on("dataset.download", raises=ConnectionError, times=1)
        p = PORT.common.download(
            "http://example.invalid/h.bin", "unit",
            retry=RetryPolicy(max_attempts=2, base_delay_s=0.001,
                              jitter=0.0), fetch=fetch)
        assert fi.triggered("dataset.download") == 1
    assert os.path.exists(p)
    # an injected fault the policy does not retry fails the download,
    # with no file left behind
    with FaultInjector() as fi:
        fi.on("dataset.download", times=1)
        with pytest.raises(RuntimeError):
            PORT.common.download("http://example.invalid/i.bin", "unit",
                                 retry=RetryPolicy(max_attempts=3),
                                 fetch=fetch)
    assert os.listdir(PORT.common.cache_path("unit")) == ["h.bin"]
