"""Event-loop Trainer (reference: python/paddle/v2/trainer.py:37 — the
SGD class whose train() pumps a reader through forward/backward and fires
BeginPass/EndPass/BeginIteration/EndIteration events, v2/event.py; the
same loop fluid scripts hand-write around exe.run).

The port's copy of ``paddle_tpu/trainer.py``: one Executor runs each
step on the card (or on the CPU when the executor was built for it);
the event loop, asynchronous dispatch with lazy cost fetches,
`steps_per_dispatch`, the feed prefetcher, periodic checkpoints
(distributed/checkpoint.py) and test() evaluation live here on the
host.

The (main, startup) pair is verified once at setup, as the JAX
Trainer does (analysis/, PADDLE_TPU_VERIFY, on by default). Not ported
yet: the metrics, trace spans and attribution the JAX Trainer publishes
while its metrics registry is enabled (A11; the port runs the loop as
the JAX package does with the registry disabled), and
StreamingInputService readers (A11). Each refuses with
NotImplementedError where it is asked for.
"""
from __future__ import annotations

import warnings
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from .core.executor import STEP_VAR, device_feed
from .core.lod import LoDTensor
from .core.scope import global_scope


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass:
    def __init__(self, pass_id, metrics=None):
        self.pass_id = pass_id
        self.metrics = metrics or {}


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration:
    """End-of-iteration event. `cost`/`metrics` may be LAZY: when the
    Trainer dispatched the step asynchronously it hands the event a
    StepResult instead of materialized values, and reading `.cost` (or
    `.metrics`) forces the device fetch at that point. A handler that
    skips them on non-logged iterations keeps the pipeline unblocked; a
    handler that always reads them gets the synchronous behaviour,
    values bit-identical either way."""

    def __init__(self, pass_id, batch_id, cost=None, metrics=None,
                 result=None, metric_names=()):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self._cost = cost
        self._metrics = dict(metrics) if metrics is not None else None
        self._result = result
        self._metric_names = tuple(metric_names)

    @property
    def cost(self):
        if self._cost is None and self._result is not None:
            self._cost = _scalar_cost(self._result)
        return self._cost

    @property
    def metrics(self):
        if self._metrics is None:
            if self._result is not None:
                outs = self._result.fetches()
                self._metrics = {k: _dense(v) for k, v in
                                 zip(self._metric_names, outs[1:])}
            else:
                self._metrics = {}
        return self._metrics


class CheckpointConfig:
    """Periodic elastic checkpointing.

    retry:    optional resilience.RetryPolicy for the checkpoint I/O
              (each save's tmp-write phase retries as a unit).
    on_error: "warn" (default) — a save that still fails after retries
              is logged and counted (Trainer.checkpoint_failures) but
              does NOT kill training; the previous valid checkpoint
              remains the resume point. "raise" restores the old
              fail-stop behaviour.
    """

    def __init__(self, dirname: str, every_n_batches: int = 100,
                 max_keep: int = 3, retry=None, on_error: str = "warn"):
        if on_error not in ("warn", "raise"):
            raise ValueError(f"on_error must be 'warn' or 'raise', "
                             f"got {on_error!r}")
        self.dirname = dirname
        self.every_n_batches = every_n_batches
        self.max_keep = max_keep
        self.retry = retry
        self.on_error = on_error


class Trainer:
    """train() pumps reader batches through the program; each yielded
    batch is either a feed dict or a tuple routed through a DataFeeder
    built from `feed_order`. Steps run in the global scope
    (`scope_guard` picks another), on `executor`'s device: without an
    executor, a new Executor on the first CUDA card."""

    def __init__(self, loss, main_program=None, startup_program=None,
                 executor=None, feed_order: Optional[Sequence] = None,
                 fetch_metrics: Optional[Dict[str, object]] = None,
                 checkpoint_config: Optional[CheckpointConfig] = None,
                 feeder_kwargs: Optional[dict] = None):
        from .executor import Executor
        from .framework import (default_main_program,
                                default_startup_program)

        self.loss = loss
        self.main_program = main_program or default_main_program()
        self.startup_program = startup_program or \
            default_startup_program()
        self.exe = executor or Executor()
        self.fetch_metrics = dict(fetch_metrics or {})
        self.checkpoint_config = checkpoint_config
        self._feeder = None
        if feed_order:
            from .data_feeder import DataFeeder
            vars_ = [self.main_program.global_block().var(n)
                     if isinstance(n, str) else n for n in feed_order]
            self._feeder = DataFeeder(vars_, place=self.exe.device,
                                      **(feeder_kwargs or {}))
        self._started = False
        self.step = 0
        self.checkpoint_failures = 0
        self.last_checkpoint_error = None

    def _verify_programs(self):
        """Static verification of the (main, startup) pair, once at
        setup — the only gate that sees BOTH programs, so it is where
        uninitialized-persistable detection runs (a param the startup
        program never writes fails here with the var named, instead of
        as a scope KeyError mid-run). Uses the cheap no-retrace shape
        pass: trainer programs come from the layer calls, which already
        stamped coverage/conflict markers. PADDLE_TPU_VERIFY=0 opts
        out."""
        from .analysis import verify_enabled, verify_program
        from .analysis.passes import fast_passes
        if not verify_enabled():
            return
        fetch = [self.loss.name] + [getattr(v, "name", str(v))
                                    for v in self.fetch_metrics.values()]
        feeds = [v.name for v in self._feeder.feed_vars] \
            if self._feeder is not None else None
        verify_program(
            self.main_program, startup=self.startup_program,
            feed_names=feeds, fetch_names=fetch,
            donate=getattr(self.exe, "donate_state", False),
            # train() always dispatches sync=False: a donated-fetch
            # hazard in fetch_metrics must fail HERE, not on the first
            # step after startup + checkpoint restore already ran
            async_dispatch=True,
            passes=fast_passes(with_uninit=True),
            program_label="trainer main program",
        ).raise_if_errors(context="Trainer setup")

    # -- lifecycle --------------------------------------------------------
    def start(self, resume: bool = True):
        """Run startup (param init), then restore the newest valid
        checkpoint if configured (elastic resume)."""
        self._verify_programs()
        self.exe.run(self.startup_program)
        if resume and self.checkpoint_config:
            from .distributed.checkpoint import load_checkpoint
            meta = load_checkpoint(self.checkpoint_config.dirname,
                                   main_program=self.main_program,
                                   executor=self.exe,
                                   retry=self.checkpoint_config.retry)
            if meta:
                self.step = int(meta.get("step", 0))
        self._started = True
        return self

    def _to_feed(self, batch):
        if isinstance(batch, dict):
            return batch
        if self._feeder is None:
            raise ValueError(
                "reader yielded a tuple batch but no feed_order was given")
        return self._feeder.feed(batch)

    def _to_feed_device(self, batch):
        """_to_feed + host->device upload; runs on the prefetcher thread
        so the transfer overlaps the in-flight step's compute."""
        return device_feed(self._to_feed(batch), self.exe.device)

    # -- training loop ----------------------------------------------------
    def train(self, num_passes: int, reader: Callable[[], Iterable],
              event_handler: Optional[Callable] = None,
              steps_per_dispatch: int = 1, log_every: int = 1,
              prefetch: int = 0):
        """Event-loop training. steps_per_dispatch > 1 consumes K
        DISTINCT reader batches per dispatch: the feeds are stacked along
        a leading K axis and Executor.run(iterations=K,
        stacked_feed=True) runs them in turn, so SGD semantics are
        unchanged from K=1. Events fire once per DISPATCH with the final
        batch's cost/metrics; self.step advances by the number of
        batches consumed. A short tail (fewer than K batches left in the
        pass) runs one batch at a time. Stacking needs dense ndarray
        feeds of one shape; ragged feeds dispatch one batch at a time.

        Every step is dispatched asynchronously (Executor.run
        sync=False); `log_every` sets how often the Trainer itself
        materializes cost/metrics. On logged dispatches (every
        `log_every`-th, default every one) EndIteration carries concrete
        values; in between it carries a lazy StepResult handle, the host
        does not wait for the card, and up to `log_every` undelivered
        results stay in flight. Trained weights are bit-identical for
        any `log_every`. `prefetch` > 0 additionally runs feed
        conversion + device upload for batch N+1 on a bounded background
        FeedPrefetcher (depth `prefetch`, 2 = double buffering) while
        batch N computes; incompatible with steps_per_dispatch > 1
        (stacking needs host-side arrays).

        Checkpoint saves insert a device sync barrier first
        (Executor.synchronize), so a snapshot never tears across an
        in-flight step."""
        if getattr(reader, "is_streaming_input_service", False):
            raise NotImplementedError(
                "Trainer.train: StreamingInputService readers are not "
                "ported yet (ROADMAP A11)")
        if not self._started:
            self.start()
        handler = event_handler or (lambda e: None)
        fetch_names = list(self.fetch_metrics)
        fetch_list = [self.loss] + [self.fetch_metrics[k]
                                    for k in fetch_names]
        k = int(steps_per_dispatch)
        if k < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {k} — a zero "
                "dispatch would report cost 0.0 while training nothing")
        log_every = int(log_every)
        if log_every < 1:
            raise ValueError(
                f"log_every must be >= 1, got {log_every}")
        prefetch = int(prefetch)
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        if prefetch and k > 1:
            raise ValueError(
                "prefetch and steps_per_dispatch > 1 are mutually "
                "exclusive: stacking K batches needs host-side ndarray "
                "feeds, but the prefetcher uploads each batch to device")

        def _stackable(feeds):
            if len(feeds) < 2:
                return None
            names = set(feeds[0])
            if any(set(f) != names for f in feeds[1:]):
                return None
            stacked = {}
            for n in names:
                vals = [f[n] for f in feeds]
                if not all(isinstance(v, np.ndarray) for v in vals):
                    return None
                if any(v.shape != vals[0].shape for v in vals[1:]):
                    return None
                stacked[n] = np.stack(vals)
            return stacked

        for pass_id in range(num_passes):
            handler(BeginPass(pass_id))
            costs = []
            # undelivered StepResults, oldest first; bounded at
            # log_every so a huge pass can't pin one fetch buffer per
            # step
            pending = deque()

            def _drain(keep: int):
                while len(pending) > keep:
                    costs.append(_scalar_cost(pending.popleft()))

            dispatch_id = 0
            prefetcher = None
            if prefetch:
                from .reader import FeedPrefetcher
                prefetcher = FeedPrefetcher(iter(reader()),
                                            convert=self._to_feed_device,
                                            depth=prefetch)
                feed_iter = iter(prefetcher)
            else:
                feed_iter = (self._to_feed(b) for b in reader())
            try:
                while True:
                    group = []
                    for _ in range(k):
                        try:
                            feed = next(feed_iter)
                        except StopIteration:
                            break
                        if k > 1:
                            # accumulating K batches: snapshot ndarray
                            # feeds now, in case the reader reuses its
                            # buffers once the consumer advances
                            feed = {n: (np.array(v) if
                                        isinstance(v, np.ndarray) else v)
                                    for n, v in feed.items()}
                        group.append(feed)
                    if not group:
                        break
                    handler(BeginIteration(pass_id, dispatch_id))
                    stacked = _stackable(group) if len(group) == k \
                        and k > 1 else None
                    if stacked is not None:
                        res = self.exe.run(self.main_program, feed=stacked,
                                           fetch_list=fetch_list,
                                           iterations=k, stacked_feed=True,
                                           sync=False)
                    else:
                        for i, feed in enumerate(group):
                            res = self.exe.run(self.main_program,
                                               feed=feed,
                                               fetch_list=fetch_list,
                                               sync=False)
                            if i < len(group) - 1:
                                # non-stackable k>1 fallback: only the
                                # FINAL batch's result feeds the event
                                # and cost plumbing; materialize the rest
                                # here, as the sync loop did
                                res.fetches()
                    pending.append(res)
                    self.step += len(group)
                    logged = (dispatch_id + 1) % log_every == 0
                    ev = EndIteration(pass_id, dispatch_id, result=res,
                                      metric_names=fetch_names)
                    if logged:
                        ev.cost  # materialize: periodic sync point
                    handler(ev)
                    # logged dispatches flush everything in flight;
                    # others keep at most log_every results pending — but
                    # a checkpoint crossing drains fully first
                    if logged or self._checkpoint_due(len(group)):
                        _drain(0)
                    else:
                        _drain(log_every)
                    self._maybe_checkpoint(advanced=len(group))
                    dispatch_id += 1
                    if len(group) < k:
                        break
            finally:
                if prefetcher is not None:
                    prefetcher.close()
            _drain(0)
            handler(EndPass(pass_id, {
                "mean_cost": float(np.mean(costs)) if costs else None}))

    def _checkpoint_due(self, advanced: int) -> bool:
        """Did the last `advanced` steps cross an every_n_batches
        multiple? ("crossed" rather than "== 0": with
        steps_per_dispatch > 1 the counter advances in strides and may
        never land exactly on a multiple.)"""
        cc = self.checkpoint_config
        return bool(cc) and (self.step // cc.every_n_batches
                             > (self.step - advanced)
                             // cc.every_n_batches)

    def _maybe_checkpoint(self, advanced: int = 1):
        cc = self.checkpoint_config
        if self._checkpoint_due(advanced):
            from .distributed.checkpoint import save_checkpoint
            # (save_checkpoint itself runs the Executor.synchronize
            # barrier before snapshotting, covering every caller)
            try:
                save_checkpoint(cc.dirname, step=self.step,
                                main_program=self.main_program,
                                executor=self.exe, max_keep=cc.max_keep,
                                retry=cc.retry)
            except Exception as e:
                # checkpointing is off the training math path: a failed
                # save (after retries) must not kill the run unless
                # on_error="raise" — the last valid checkpoint stays the
                # resume point
                self.checkpoint_failures += 1
                self.last_checkpoint_error = e
                if cc.on_error == "raise":
                    raise
                warnings.warn(
                    f"checkpoint save at step {self.step} failed "
                    f"({e!r}); training continues, resume point is the "
                    "previous valid checkpoint", RuntimeWarning)

    # -- evaluation -------------------------------------------------------
    def test(self, reader: Callable[[], Iterable],
             fetch_list: Optional[List] = None) -> Dict[str, float]:
        """Mean of loss (+ metrics) over a test reader — no optimizer ops
        run because the fetches are computed on an inference-pruned clone
        (reference: v2 SGD.test, trainer.py:209)."""
        from .io import _prune

        fetch_list = fetch_list or [self.loss]
        names = [getattr(v, "name", v) for v in fetch_list]
        pruned = _prune(self.main_program, [], names)
        totals = {n: [] for n in names}
        scope = global_scope()
        step_before = scope.find(STEP_VAR)
        try:
            for batch in reader():
                feed = self._to_feed(batch)
                outs = self.exe.run(pruned, feed=feed, fetch_list=names)
                for n, v in zip(names, outs):
                    totals[n].append(
                        np.asarray(_dense(v), np.float64).mean())
        finally:
            # evaluation must not advance the step counter
            if step_before is not None:
                scope.set(STEP_VAR, step_before)
        return {n: float(np.mean(vs)) if vs else float("nan")
                for n, vs in totals.items()}

    def save_params(self, dirname: str):
        from . import io as pt_io
        pt_io.save_params(self.exe, dirname, self.main_program)

    def save_inference_model(self, dirname: str, feed_names, targets):
        from . import io as pt_io
        pt_io.save_inference_model(dirname, feed_names, targets, self.exe,
                                   main_program=self.main_program)


def _dense(v):
    return v.data if isinstance(v, LoDTensor) else v


def _scalar_cost(outs) -> float:
    """First fetched value (the loss) as a python float — the one cost
    extraction shared by EndIteration.cost and the pass-mean plumbing."""
    return float(np.asarray(_dense(outs[0])).reshape(-1)[0])
