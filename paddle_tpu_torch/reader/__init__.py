"""Reader creators and decorators, and the Trainer's feed prefetcher.

The port's copy of ``paddle_tpu/reader/__init__.py`` (reference:
python/paddle/reader/decorator.py:29-236 — map_readers, shuffle, chain,
compose, buffered, firstn, xmap_readers — and python/paddle/v2/minibatch.py
`batch`). A reader is a zero-arg callable returning an iterator of
samples; decorators wrap readers into new readers. `double_buffer` adds
host-side prefetch on a background thread; `device_prefetch` uploads
batches to the card ahead of the step that reads them; `FeedPrefetcher`
runs the Trainer's feed conversion and upload for batch N+1 while batch
N computes.

Not ported yet: ``multiprocess_batch_reader`` and the streaming input
service (``StreamingInputService``, ``iter_stream``, ``RawDecoder``),
ROADMAP A11.
"""
from __future__ import annotations

import itertools
import queue as _queue
import random as _random
import threading
from typing import Any, Callable, List

import numpy as np
import torch

from ..core.executor import (await_upload, pinned_upload, resolve_device,
                             upload_on_side_stream)
from ..resilience import faults

__all__ = [
    "map_readers", "shuffle", "chain", "compose", "buffered", "firstn",
    "xmap_readers", "batch", "double_buffer", "cache", "ComposeNotAligned",
    "FeedPrefetcher", "device_prefetch",
]


class ComposeNotAligned(ValueError):
    pass


def map_readers(func: Callable, *readers):
    """Apply func to the items of each reader, zipped."""
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)
    return reader


def shuffle(reader, buf_size: int, seed=None):
    """Buffered shuffle: fill a buffer of buf_size samples, yield shuffled."""
    def shuffled_reader():
        rng = _random.Random(seed)
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                for s in buf:
                    yield s
                buf = []
        if buf:
            rng.shuffle(buf)
            for s in buf:
                yield s
    return shuffled_reader


def chain(*readers):
    """Concatenate readers: all of r1's samples, then r2's, ..."""
    def reader():
        return itertools.chain(*[r() for r in readers])
    return reader


def compose(*readers, check_alignment: bool = True):
    """Zip readers into tuples of their samples (flattening tuple samples)."""
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(o) for o in outputs), ())
    return reader


class _ReaderError:
    """Exception carrier: errors in producer threads re-raise in the
    consumer rather than masquerading as end-of-data."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def buffered(reader, size: int):
    """Background-thread buffer of up to `size` samples (prefetch)."""
    _end = object()

    def buffered_reader():
        q: _queue.Queue = _queue.Queue(maxsize=size)

        def fill():
            try:
                for sample in reader():
                    q.put(sample)
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                q.put(_ReaderError(e))
                return
            q.put(_end)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            s = q.get()
            if s is _end:
                return
            if isinstance(s, _ReaderError):
                raise s.exc
            yield s
    return buffered_reader


def firstn(reader, n: int):
    def firstn_reader():
        return itertools.islice(reader(), n)
    return firstn_reader


def xmap_readers(mapper: Callable, reader, process_num: int,
                 buffer_size: int, order: bool = False):
    """Apply mapper with a pool of worker threads, optionally in order."""
    _end = object()

    def ordered_reader():
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(process_num)
        futs: _queue.Queue = _queue.Queue(buffer_size)

        def feed():
            try:
                for sample in reader():
                    futs.put(pool.submit(mapper, sample))
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                futs.put(_ReaderError(e))
                return
            futs.put(_end)

        threading.Thread(target=feed, daemon=True).start()
        while True:
            f = futs.get()
            if f is _end or isinstance(f, _ReaderError):
                pool.shutdown(wait=False)
                if isinstance(f, _ReaderError):
                    raise f.exc
                return
            yield f.result()

    def unordered_reader():
        in_q: _queue.Queue = _queue.Queue(buffer_size)
        out_q: _queue.Queue = _queue.Queue(buffer_size)

        def feed():
            try:
                for sample in reader():
                    in_q.put(sample)
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                out_q.put(_ReaderError(e))
            finally:
                for _ in range(process_num):
                    in_q.put(_end)

        live = [process_num]
        lock = threading.Lock()

        def work():
            while True:
                sample = in_q.get()
                if sample is _end:
                    with lock:
                        live[0] -= 1
                        if live[0] == 0:
                            out_q.put(_end)
                    return
                out_q.put(mapper(sample))

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()
        while True:
            item = out_q.get()
            if item is _end:
                return
            if isinstance(item, _ReaderError):
                raise item.exc
            yield item

    return ordered_reader if order else unordered_reader


def cache(reader):
    """Materialize the reader on first call; replay from memory after.
    Full materialization (not incremental append) so an abandoned first
    iteration cannot corrupt the memo."""
    memo: List[Any] = []
    done = [False]

    def cached_reader():
        if not done[0]:
            memo[:] = list(reader())
            done[0] = True
        return iter(memo)
    return cached_reader


def batch(reader, batch_size: int, drop_last: bool = False):
    """Group samples into lists of batch_size (reference: paddle.batch).

    Fires the `reader.next` fault point once per yielded batch, so chaos
    tests can make the input pipeline stall (delay_s) or fail mid-pass
    (see resilience/faults.py; inert when no injector is armed)."""
    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                faults.fire("reader.next")
                yield b
                b = []
        if b and not drop_last:
            faults.fire("reader.next")
            yield b
    return batch_reader


def double_buffer(reader, size: int = 2):
    """Prefetch decorated batches on a background thread so host input
    assembly overlaps device compute."""
    return buffered(reader, size)


class FeedPrefetcher:
    """Double-buffered feed pipeline for the Trainer's event loop.

    A bounded background thread pulls batches from `batch_iter`, runs
    `convert` on each (feed-dict assembly + host->device upload — the
    host half of a training step) and parks up to `depth` (default 2)
    converted feeds, so batch N+1's feed work overlaps batch N's device
    compute. The consumer side is a plain iterator.

    Contract (the JAX package's):
      * fires the `reader.next` fault point once per PULLED batch, in
        the producer thread (resilience/faults.py). Wrapping a
        `reader.batch()` reader (which fires the same point per YIELDED
        batch) doubles the point's call rate: arm schedules accordingly,
        or pass fire_faults=False;
      * any producer-side exception — from the reader, from `convert`,
        or injected — re-raises in the consumer on the next pull, after
        which the prefetcher is closed;
      * `close()` is idempotent, unblocks a producer stuck on the full
        queue, and joins the thread with a timeout (no
        `feed-prefetcher-*` thread outlives its loop).
    The JAX package's profiler events and span hand-off are not wired
    here yet (ROADMAP A11); `adopt_span` accepts a span and does
    nothing.
    """

    _END = object()
    _ids = itertools.count()

    def __init__(self, batch_iter, convert: Callable = None,
                 depth: int = 2, fire_faults: bool = True):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = iter(batch_iter)
        self._convert = convert if convert is not None else (lambda b: b)
        self._fire_faults = bool(fire_faults)
        self._q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._fill, name=f"feed-prefetcher-{next(self._ids)}",
            daemon=True)
        self._thread.start()

    # -- producer ------------------------------------------------------
    def adopt_span(self, ctx) -> None:
        """Step-span attribution of producer work: not wired yet
        (ROADMAP A11); a no-op here."""

    def _fill(self):
        try:
            while not self._stop.is_set():
                try:
                    raw = next(self._it)
                except StopIteration:
                    self._put(self._END)
                    return
                if self._fire_faults:
                    faults.fire("reader.next")
                if not self._put(("feed", self._convert(raw))):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._put(("err", e))

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to close(): never blocks
        longer than the poll interval while the queue is full."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    # -- consumer ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        # re-check _done AFTER waking: a cross-thread close() may have
        # raced a final producer put into the drained queue — a feed
        # item received after close is DISCARDED (close's contract),
        # not delivered
        if item is self._END or self._done:
            self._done = True
            self.close()
            raise StopIteration
        kind, payload = item
        if kind == "err":
            self._done = True
            self.close()
            raise payload
        return payload

    def occupancy(self) -> int:
        """Converted feeds currently parked (the live queue depth, not
        the configured capacity): 0 means the next step will block on
        input."""
        return self._q.qsize()

    # -- lifecycle -----------------------------------------------------
    def close(self, timeout: float = 5.0):
        """Stop the producer and join its thread (at most `timeout`
        seconds). Safe to call twice; pending prefetched feeds are
        discarded."""
        self._done = True
        self._stop.set()
        # drain so a producer blocked on a full queue observes stop at
        # its next put poll
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        # wake a consumer blocked in __next__'s get() (close() may come
        # from another thread); a racing producer put makes Full
        # possible, and the consumer's post-wake _done check discards a
        # raced-in feed item either way
        try:
            self._q.put_nowait(self._END)
        except _queue.Full:
            pass
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def device_prefetch(reader, size: int = 2, device=None):
    """Device double-buffering (reference:
    operators/reader/create_double_buffer_reader_op.cc): a background
    thread uploads upcoming batches to `device` (None: the first CUDA
    card) while the current step computes. Batch samples may be arrays
    or (nested) tuples/lists/dicts of arrays; other leaves pass through.
    On the card each array goes through pinned memory with a
    non-blocking copy on a side stream, and the consumer's stream waits
    for that copy's event before the batch is handed out (the host does
    not wait)."""
    dev = resolve_device(device)

    def leaves(sample):
        if isinstance(sample, (tuple, list)):
            for s in sample:
                yield from leaves(s)
        elif isinstance(sample, dict):
            for s in sample.values():
                yield from leaves(s)
        elif isinstance(sample, torch.Tensor):
            yield sample

    def to_device(sample):
        if isinstance(sample, (tuple, list)):
            return type(sample)(to_device(s) for s in sample)
        if isinstance(sample, dict):
            return {k: to_device(v) for k, v in sample.items()}
        if isinstance(sample, (np.ndarray, torch.Tensor)):
            if dev.type != "cuda":
                return torch.as_tensor(sample).to(dev)
            return pinned_upload(sample, dev)
        return sample

    def upload(sample):
        if dev.type != "cuda":
            return to_device(sample), None
        return upload_on_side_stream(lambda: to_device(sample), dev)

    inner = buffered(map_readers(upload, reader), size)

    def device_ready_reader():
        for sample, ready in inner():
            if ready is not None:
                await_upload(ready, list(leaves(sample)), dev)
            yield sample

    return device_ready_reader
