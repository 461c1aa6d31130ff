"""Dataset infrastructure.

The reference's dataset modules download public corpora into a home cache
(reference: python/paddle/dataset/common.py — DATA_HOME, download with md5
verification). This environment has no network egress, so every dataset
module here produces *deterministic synthetic data with the real schema*
(same sample structure, dtypes, vocab semantics) unless the real files are
already present under DATA_HOME, in which case they are loaded. Model code
is agnostic to which path produced the samples.

The port's copy of ``paddle_tpu/dataset/common.py``: the same DATA_HOME
(``PADDLE_TPU_DATA_HOME``), seeds and vocabulary builder; ``download``
runs through the port's ``resilience.retry.RetryPolicy`` and fires the
``dataset.download`` fault point before each attempt.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, Optional

import numpy as np

from ..resilience import faults
from ..resilience.retry import RetryPolicy

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))

#: downloads are the classic transient-failure I/O: retry a few times
#: with jittered exponential backoff before giving up
DOWNLOAD_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.1,
                             max_delay_s=5.0)


def cache_path(*parts) -> str:
    return os.path.join(DATA_HOME, *parts)


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module: str, md5sum: Optional[str] = None,
             save_name: Optional[str] = None,
             retry: Optional[RetryPolicy] = None,
             fetch: Optional[Callable[[str, str], None]] = None) -> str:
    """Fetch `url` into DATA_HOME/<module>/ and return the cached path
    (reference: python/paddle/dataset/common.py download, rebuilt on the
    unified retry layer).

    Crash/corruption safety: the transfer writes to a `.part` file that
    is md5-verified and then atomically renamed into place, so the cache
    never contains a partial archive; a failed or interrupted attempt
    deletes its `.part` before the next retry, and a cached file that no
    longer matches `md5sum` is discarded and re-fetched rather than
    served corrupt.

    fetch(url, path): injectable transfer fn (tests, mirrors); defaults
    to urllib. retry: RetryPolicy, default `DOWNLOAD_RETRY`.
    """
    dirname = cache_path(module)
    os.makedirs(dirname, exist_ok=True)
    fname = os.path.join(dirname, save_name or url.split("/")[-1])
    if os.path.exists(fname):
        if md5sum is None or md5file(fname) == md5sum:
            return fname
        try:
            os.remove(fname)  # stale/corrupt cache entry
        except FileNotFoundError:
            pass  # a concurrent downloader already removed/replaced it

    def _fetch_once() -> str:
        # unique temp per attempt: concurrent downloaders (multiprocess
        # reader workers on a cold cache) must not interleave into one
        # shared .part file or delete each other's in-progress transfer
        import tempfile
        fd, part = tempfile.mkstemp(
            dir=dirname, prefix=os.path.basename(fname) + ".",
            suffix=".part")
        os.close(fd)
        try:
            faults.fire("dataset.download")
            if fetch is not None:
                fetch(url, part)
            else:
                import urllib.request
                urllib.request.urlretrieve(url, part)
            if md5sum is not None and md5file(part) != md5sum:
                raise IOError(
                    f"downloaded {url} fails md5 verification "
                    f"(expected {md5sum})")
            os.replace(part, fname)
        except BaseException:
            if os.path.exists(part):
                os.remove(part)
            raise
        return fname

    policy = retry if retry is not None else DOWNLOAD_RETRY
    return policy.call(_fetch_once, name="dataset.download")


def rng_for(name: str, split: str) -> np.random.RandomState:
    """Deterministic per-(dataset, split) RNG for synthetic generation."""
    seed = int.from_bytes(hashlib.sha256(
        f"{name}:{split}".encode()).digest()[:4], "little")
    return np.random.RandomState(seed)


_FREQ_DICT_CACHE: dict = {}


def build_freq_dict(docs_fn, cache_key, cutoff: int = 1,
                    leading=(), cap=None, unk="<unk>"):
    """Shared corpus-vocabulary builder (reference: the per-dataset
    build_dict functions in python/paddle/dataset/{imdb,imikolov,
    wmt16}.py all follow this shape): count words over `docs_fn()`
    (an iterable of token lists), keep those with count >= cutoff
    ranked by (-count, word), prefix `leading` specials, cap total size
    at `cap`, and append `unk` if not already present. Memoized by
    `cache_key` — readers rebuild their dicts every epoch, and a corpus
    scan is the expensive part."""
    if cache_key in _FREQ_DICT_CACHE:
        return _FREQ_DICT_CACHE[cache_key]
    freq: dict = {}
    for words in docs_fn():
        for w in words:
            freq[w] = freq.get(w, 0) + 1
    ranked = sorted(((w, c) for w, c in freq.items() if c >= cutoff),
                    key=lambda kv: (-kv[1], kv[0]))
    words = list(leading) + [w for w, _c in ranked]
    if cap is not None:
        words = words[:cap]
    d = {w: i for i, w in enumerate(words)}
    if unk is not None and unk not in d:
        d[unk] = len(d)
    _FREQ_DICT_CACHE[cache_key] = d
    return d
