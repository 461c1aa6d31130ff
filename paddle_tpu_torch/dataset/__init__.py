"""Dataset modules (reference: python/paddle/dataset/ — 14 corpora).

The port's copy of ``paddle_tpu/dataset/``, module for module: each
exposes creator functions returning readers (zero-arg callables yielding
samples) with the reference's sample schemas. Data is synthetic when the
real corpus is not under ``common.DATA_HOME`` (see common.py), and for
the same seed the synthetic path yields the JAX package's samples
exactly (dtypes, structure, vocabularies). The real-file loaders read
only files already under DATA_HOME; nothing downloads unless
``common.download`` is called. Plain numpy and the standard library:
the samples feed the port's readers and DataFeeder on the host.
"""
from . import (cifar, common, conll05, flowers, image, imdb, imikolov,
               mnist, movielens, mq2007, sentiment, uci_housing, voc2012,
               wmt14, wmt16)

__all__ = [
    "cifar", "common", "conll05", "flowers", "image", "imdb", "imikolov",
    "mnist", "movielens", "mq2007", "sentiment", "uci_housing", "voc2012",
    "wmt14", "wmt16",
]
