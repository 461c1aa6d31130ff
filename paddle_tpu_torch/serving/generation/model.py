"""GenerationModel: one decoder-LM's full program set (prefill /
decode-step / re-forward baseline), pinned weights, and KV-cache state
in a private scope, on one torch device.

The port's copy of ``paddle_tpu/serving/generation/model.py``, with its
static verification of every program at build (``_verify``, analysis/).
A generation model is a FAMILY of programs sharing one parameter set by
name (models/transformer.py build_decoder_lm), plus persistable
``kv_cache.*`` state the decode programs update in place. ``save``
freezes the re-forward program, the weights and the spec (the
``__generation__.json`` sidecar of io.save_inference_model); ``load``
rebuilds the set from the spec and loads the weights. Hosting N models
on one executor (GenerationHost) collides nothing, because the compile
key includes each program's uid and version.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from ... import flags, io
from ...core.executor import Executor
from ...core.scope import Scope
from ...executor import scope_guard
from ...models.transformer import (KV_CACHE_PREFIX, build_decoder_lm,
                                   kv_cache_names)

__all__ = ["GenerationSpec", "GenerationModel", "bucket_for"]


def bucket_for(n: int, buckets) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds every bucket."""
    for b in buckets:
        if n <= b:
            return int(b)
    return None


class GenerationSpec:
    """Everything needed to rebuild a generation program set around a
    saved checkpoint — rides ``save_inference_model`` meta (io.py) so
    an artifact is self-describing for token serving."""

    FIELDS = ("vocab_size", "max_seq_len", "slots", "prompt_buckets",
              "cache_buckets", "n_layer", "n_head", "d_model", "d_inner",
              "seed", "eos_id", "kv_cache_layout")

    def __init__(self, vocab_size, max_seq_len, slots=None,
                 prompt_buckets=None, cache_buckets=None,
                 n_layer=2, n_head=4, d_model=64, d_inner=128, seed=0,
                 eos_id=0,
                 kv_cache_layout="[slots, n_head, max_seq_len, d_key]"):
        if slots is None:
            slots = int(flags.get("PADDLE_TPU_DECODE_SLOTS"))
        if cache_buckets is None:
            cache_buckets = [
                int(x) for x in
                flags.get("PADDLE_TPU_DECODE_CACHE_BUCKETS").split(",")]
            # the flag default may exceed a small model's max_seq_len
            cache_buckets = [b for b in cache_buckets
                             if b <= int(max_seq_len)] \
                or [int(max_seq_len)]
        if prompt_buckets is None:
            prompt_buckets = list(cache_buckets)
        self.vocab_size = int(vocab_size)
        self.max_seq_len = int(max_seq_len)
        self.slots = int(slots)
        self.prompt_buckets = sorted(set(int(x) for x in prompt_buckets))
        self.cache_buckets = sorted(set(int(x) for x in cache_buckets))
        self.n_layer = int(n_layer)
        self.n_head = int(n_head)
        self.d_model = int(d_model)
        self.d_inner = int(d_inner)
        self.seed = int(seed)
        self.eos_id = int(eos_id)
        self.kv_cache_layout = str(kv_cache_layout)

    def to_dict(self) -> Dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    @classmethod
    def from_dict(cls, d: Dict) -> "GenerationSpec":
        return cls(**{f: d[f] for f in cls.FIELDS if f in d})

    def __eq__(self, other):
        return isinstance(other, GenerationSpec) and \
            self.to_dict() == other.to_dict()

    def __repr__(self):
        return f"GenerationSpec({self.to_dict()})"


class GenerationModel:
    """Program set + weights + KV-cache state for one decoder LM.

    ``executor``/``run_lock`` follow the ServableModel sharing contract:
    a GenerationHost passes the same pair to every hosted model so all
    their steps live in one compile cache, and runs are serialized by
    one lock. Without them the model builds its own Executor on
    `device` (None: the first CUDA card; "cpu" on a machine without
    one). The per-model scope keeps weights AND cache state private —
    two hosted models never alias each other's cache."""

    def __init__(self, programs: Dict, spec: GenerationSpec,
                 scope: Optional[Scope] = None,
                 executor: Optional[Executor] = None,
                 run_lock: Optional[threading.Lock] = None,
                 version: Optional[str] = None,
                 init_scope: bool = True, device=None):
        if (executor is None) != (run_lock is None):
            raise ValueError("share executor and run_lock together "
                             "(executor internals are serialized by "
                             "the lock)")
        self.programs = programs
        self.spec = spec
        self.scope = scope if scope is not None else Scope()
        self.executor = executor if executor is not None \
            else Executor(place=device)
        self.device = self.executor.device
        self._run_lock = run_lock if run_lock is not None \
            else threading.Lock()
        self.version = version
        self.cache_names = kv_cache_names(spec.n_layer)
        self._check_frozen()
        self._verify()
        if init_scope:
            with self._run_lock:
                self.executor.run(programs["startup"], scope=self.scope)

    @classmethod
    def build(cls, spec: GenerationSpec,
              executor: Optional[Executor] = None,
              run_lock: Optional[threading.Lock] = None,
              version: Optional[str] = None,
              device=None) -> "GenerationModel":
        """Fresh model (randomly initialized weights) from a spec, on
        the shared `executor`'s device or else on `device` — the first
        CUDA card unless the caller names another."""
        programs = build_decoder_lm(
            vocab_size=spec.vocab_size, max_seq_len=spec.max_seq_len,
            slots=spec.slots, prompt_buckets=spec.prompt_buckets,
            cache_buckets=spec.cache_buckets, n_layer=spec.n_layer,
            n_head=spec.n_head, d_model=spec.d_model,
            d_inner=spec.d_inner, seed=spec.seed)
        return cls(programs, spec, executor=executor, run_lock=run_lock,
                   version=version, device=device)

    @classmethod
    def load(cls, dirname: str, executor: Optional[Executor] = None,
             run_lock: Optional[threading.Lock] = None,
             device=None) -> "GenerationModel":
        """Load a ``save_inference_model`` artifact whose meta carries a
        generation spec (this package's or the JAX package's): rebuild
        the program set from the spec (param names are deterministic
        under isolated_name_scope), run startup (weights re-randomized,
        caches zeroed), then overwrite the weights from the
        checkpoint."""
        probe_exe = executor if executor is not None \
            else Executor(place=device)
        with scope_guard(Scope()):
            _prog, _feeds, _fetch, meta = io.load_inference_model(
                dirname, probe_exe, return_meta=True)
        gspec = meta.get("generation_spec")
        if not gspec:
            raise ValueError(
                f"artifact {dirname!r} carries no generation_spec — "
                "save it with io.save_inference_model(..., "
                "generation_spec=model.spec.to_dict()) or "
                "GenerationModel.save()")
        spec = GenerationSpec.from_dict(gspec)
        model = cls.build(spec, executor=executor, run_lock=run_lock,
                          version=meta.get("model_version"),
                          device=probe_exe.device)
        # overwrite the fresh random weights with the checkpoint's; the
        # full program's persistable set is exactly the weights (no
        # cache vars), so caches stay zero
        full = model.programs["full"][spec.prompt_buckets[-1]]
        with scope_guard(model.scope):
            io.load_vars(model.executor, dirname, full.main,
                         predicate=lambda v: v.persistable)
        return model

    def save(self, dirname: str, model_version: Optional[str] = None
             ) -> str:
        """Freeze the re-forward program + weights + generation spec.
        The full program has no cache ops, so the saved persistable set
        is the weights only — cache state never ships."""
        full = self.programs["full"][self.spec.prompt_buckets[-1]]
        block = full.main.global_block()
        with scope_guard(self.scope):
            io.save_inference_model(
                dirname, full.feed_names, [block.var(full.fetch_name)],
                self.executor, main_program=full.main,
                model_version=model_version,
                generation_spec=self.spec.to_dict())
        return dirname

    # ------------------------------------------------------------------
    def _check_frozen(self):
        """Generation programs may write persistable state ONLY under
        the kv_cache.* prefix — any other persistable write would
        silently mutate pinned weights on traffic."""
        offenders = []
        for mode in ("prefill", "decode", "full"):
            for bucket, lm in self.programs[mode].items():
                for block in lm.main.desc.blocks:
                    for op in block.ops:
                        for name in op.output_names():
                            v = block.find_var_recursive(name)
                            if v is not None and v.persistable and \
                                    not name.startswith(KV_CACHE_PREFIX):
                                offenders.append(
                                    (mode, bucket, op.type, name))
        if offenders:
            raise ValueError(
                "generation program set is not frozen — ops write "
                f"non-cache persistable vars: {offenders}")

    # ------------------------------------------------------------------
    def _verify(self):
        """Static verification of every program at build (startup
        included, so the cache vars' zero-fill satisfies the
        uninit-persistable pass). Honors PADDLE_TPU_VERIFY=0."""
        from ...analysis import verify_enabled, verify_program
        if not verify_enabled():
            return
        for mode in ("prefill", "decode", "full"):
            for bucket, lm in self.programs[mode].items():
                verify_program(
                    lm.main, startup=lm.startup,
                    feed_names=lm.feed_names,
                    fetch_names=[lm.fetch_name],
                    program_label=f"generation {mode}[{bucket}]",
                ).raise_if_errors(context="GenerationModel load")

    def run(self, lm, feed, fetch_names) -> List[np.ndarray]:
        """Run one program of the set under the model's lock and return
        the named fetches as numpy arrays."""
        with self._run_lock:
            return self.executor.run(lm.main, feed=feed,
                                     fetch_list=list(fetch_names),
                                     scope=self.scope)

    def run_prefill(self, prompt: List[int], slot: int) -> int:
        """Full-prompt forward for one request into `slot`'s cache
        rows; returns the first greedy token."""
        s = bucket_for(len(prompt), self.spec.prompt_buckets)
        if s is None:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest "
                f"prompt bucket {self.spec.prompt_buckets[-1]}")
        ids = np.zeros((1, s, 1), np.int64)
        ids[0, :len(prompt), 0] = prompt
        lm = self.programs["prefill"][s]
        out = self.run(lm, {
            "token_ids": ids,
            "lengths": np.asarray([len(prompt)], np.int64),
            "slot": np.asarray([slot], np.int64)}, [lm.fetch_name])[0]
        return int(out.reshape(-1)[0])

    def run_decode(self, tokens: np.ndarray, positions: np.ndarray,
                   bucket: int) -> np.ndarray:
        """One decode step over the whole slot array. tokens:
        [slots] int64 (last emitted token per slot), positions: [slots]
        int64 (cache write/attend position per slot). Returns [slots]
        next tokens."""
        lm = self.programs["decode"][int(bucket)]
        out = self.run(lm, {
            "token_ids": tokens.reshape(self.spec.slots, 1, 1)
            .astype(np.int64),
            "positions": positions.astype(np.int64)}, [lm.fetch_name])[0]
        return out.reshape(-1)

    def run_full(self, token_matrix: np.ndarray, lengths: np.ndarray,
                 bucket: int) -> np.ndarray:
        """Re-forward baseline step: full causal forward over the whole
        (padded) [slots, bucket] token matrix; returns [slots] next
        tokens at each row's last real position."""
        lm = self.programs["full"][int(bucket)]
        out = self.run(lm, {
            "token_ids": token_matrix.reshape(
                self.spec.slots, int(bucket), 1).astype(np.int64),
            "lengths": lengths.astype(np.int64)}, [lm.fetch_name])[0]
        return out.reshape(-1)

    # ------------------------------------------------------------------
    def last_cost(self):
        """Static cost of the most recent dispatch's program."""
        return self.executor.last_cost

    def last_memory(self):
        """Static memory plan (analysis/memory.py MemoryReport) of the
        most recent dispatch's program."""
        return self.executor.last_memory

    # ------------------------------------------------------------------
    def serve(self, config=None, metrics=None, health=None,
              mode: str = "cached"):
        """Create (but do not start) a GenerationEngine bound to this
        model."""
        from .engine import GenerationEngine
        return GenerationEngine(self, config=config, metrics=metrics,
                                health=health, mode=mode)
