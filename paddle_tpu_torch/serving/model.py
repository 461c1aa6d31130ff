"""ServableModel: an immutable frozen program + pinned device weights.

The port's copy of ``paddle_tpu/serving/model.py``. It wraps
`io.load_inference_model` output into the unit a serving engine
schedules: the pruned inference Program, its feed/fetch metadata, a
PRIVATE scope holding the persistable weights as tensors on the model's
device (so a co-resident training loop mutating the global scope can
never corrupt a live server), and a dedicated Executor whose compile
cache holds one planned step per (bucket shape, fetch signature) — on
the card, one CUDA graph each.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .. import io
from ..core.scope import Scope
from ..executor import Executor, scope_guard

__all__ = ["ServableModel"]

#: op type -> (output slot, input slot) pairs the op passes through
#: unchanged when its is_test attr is set
_TEST_PASS_THROUGH = {"batch_norm": (("MeanOut", "Mean"),
                                     ("VarianceOut", "Variance"))}


def _pass_through(op):
    """The output names `op` writes back as the very inputs it read (a
    test-mode batch_norm's running statistics)."""
    pairs = _TEST_PASS_THROUGH.get(op.type)
    if not pairs or not op.attrs.get("is_test", False):
        return set()
    return {o for out_slot, in_slot in pairs
            for o, i in zip(op.output(out_slot), op.input(in_slot))
            if o == i}


class ServableModel:
    """`device` names the torch device of a model that builds its own
    Executor (None: the first CUDA card; pass "cpu" on a machine without
    one). A shared `executor` brings its device with it."""

    def __init__(self, program, feed_names: List[str], fetch_vars,
                 scope: Scope, feed_specs: Dict[str, Dict],
                 fetch_specs: Dict[str, Dict],
                 version: Optional[str] = None,
                 executor: Optional[Executor] = None,
                 run_lock: Optional[threading.Lock] = None,
                 device=None):
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_vars = list(fetch_vars)
        self.fetch_names = [v if isinstance(v, str) else v.name
                            for v in fetch_vars]
        self.scope = scope
        self.feed_specs = dict(feed_specs)
        self.fetch_specs = dict(fetch_specs)
        #: deploy-time identity (save_inference_model model_version
        #: metadata, or assigned by the ModelHost); None = unversioned
        self.version = version
        # `executor`/`run_lock` let a ModelHost precompile a swap
        # candidate against the SAME compile cache the live version
        # serves from (the cache key includes program uid+version, so
        # steps of different model versions coexist); sharing an
        # executor requires sharing its run lock too — executor
        # internals are not thread-safe across versions either.
        if (executor is None) != (run_lock is None):
            raise ValueError("share executor and run_lock together "
                             "(executor internals are serialized by "
                             "the lock)")
        self.executor = executor if executor is not None \
            else Executor(place=device)
        self.device = self.executor.device
        self._engine = None  # set by ServingEngine.start()
        # Executor internals (compile cache + counters, scope step var,
        # deferred flags) are not thread-safe; serialize runs so
        # num_workers > 1 engines stay correct (workers still overlap
        # host-side batch assembly with the device run).
        self._run_lock = run_lock if run_lock is not None \
            else threading.Lock()
        self._check_frozen()
        self._verify()

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, dirname: str, model_filename: Optional[str] = None,
             params_filename: Optional[str] = None,
             executor: Optional[Executor] = None,
             run_lock: Optional[threading.Lock] = None,
             device=None) -> "ServableModel":
        """Load a `save_inference_model` directory (the port's JSON form
        or the JAX package's native one) into a private scope, the
        weights on `device` (or on the shared executor's)."""
        scope = Scope()
        exe = executor if executor is not None else Executor(place=device)
        with scope_guard(scope):
            prog, feed_names, fetch_vars, meta = io.load_inference_model(
                dirname, exe, model_filename=model_filename,
                params_filename=params_filename, return_meta=True)
        return cls(prog, feed_names, fetch_vars, scope,
                   meta["feed_specs"], meta["fetch_specs"],
                   version=meta.get("model_version"),
                   executor=executor, run_lock=run_lock,
                   device=exe.device)

    def _check_frozen(self):
        """A servable program must not write persistable state: an
        optimizer op left in the graph would silently train on traffic.
        Checked across ALL blocks — a write buried in a while/cond body
        mutates the pinned weights just the same. (The step counter is
        the executor's, not the program's.) A test-mode batch_norm lists
        its running statistics as MeanOut / VarianceOut and passes them
        through unchanged: that is no write (the JAX package counts it as
        one and so refuses every frozen program with a batch_norm,
        ROADMAP C13)."""
        offenders = []
        for block in self.program.desc.blocks:
            for op in block.ops:
                kept = _pass_through(op)
                for name in op.output_names():
                    v = block.find_var_recursive(name)
                    if v is not None and v.persistable and name not in kept:
                        offenders.append((op.type, name))
        if offenders:
            raise ValueError(
                "program is not frozen for inference — ops write "
                f"persistable vars: {offenders}; re-export with "
                "save_inference_model (which prunes the training graph)")

    def _verify(self):
        """Static verification of the frozen program at load time (a
        servable is pinned for the life of the server, so a malformed or
        truncated export must fail HERE, not on the first live request).
        Honors PADDLE_TPU_VERIFY=0."""
        from ..analysis import verify_enabled, verify_program
        if not verify_enabled():
            return
        verify_program(
            self.program, feed_names=self.feed_names,
            fetch_names=self.fetch_names,
            program_label="servable program",
        ).raise_if_errors(context="ServableModel load")

    # ------------------------------------------------------------------
    def run_direct(self, feed: Dict[str, Any], sync: bool = True):
        """One Executor.run against the pinned weights, bypassing the
        batcher. The engine's batch path and warmup both land here, so a
        request served through the engine is bit-identical to a direct
        run with the same padded batch. sync=False dispatches and
        returns a lazy StepResult (a frozen program writes no
        persistable state, so no fetch aliases a buffer a later step
        writes); only dispatch needs the run lock — materialization
        happens outside it."""
        with self._run_lock:
            return self.executor.run(self.program, feed=feed,
                                     fetch_list=self.fetch_names,
                                     scope=self.scope, sync=sync)

    def predict(self, feed: Dict[str, Any],
                timeout: Optional[float] = None):
        """Predict one request: through the attached engine (dynamic
        batching) when one is serving this model, else a direct run."""
        if self._engine is not None:
            return self._engine.predict(feed, timeout=timeout)
        return self.run_direct(feed)

    def serve(self, config=None, metrics=None, num_workers: int = 1,
              async_dispatch: bool = False, admission=None, health=None):
        """Create (but do not start) a ServingEngine bound to this model."""
        from .engine import ServingEngine
        return ServingEngine(self, config=config, metrics=metrics,
                             num_workers=num_workers,
                             async_dispatch=async_dispatch,
                             admission=admission, health=health)
