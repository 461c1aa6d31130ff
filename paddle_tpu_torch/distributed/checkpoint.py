"""Elastic checkpoint/restore with integrity metadata.

The port's copy of ``paddle_tpu/distributed/checkpoint.py``, in the same
format, so a checkpoint written by either package loads in the other:
numbered ``checkpoint_<step>/`` directories, each holding the
persistables in one ``__params__.npz`` (io.save_persistables) and a
``meta.json`` with the payload's md5, the step and the scope's step
counter (``step_var``); atomic publication by renaming a tmp directory,
corrupt checkpoints skipped on load, retention pruning, and the
``checkpoint.write`` / ``checkpoint.read`` fault points. (Reference: the
Go pserver's md5-verified checkpoints, go/pserver/service.go:120-205.)
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Optional, Tuple

import torch

from ..core.executor import STEP_VAR
from ..core.scope import global_scope
from ..resilience import faults
from ..resilience.retry import RetryError, RetryPolicy


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _sweep_stale_tmp(dirname: str, min_age_s: float = 300.0) -> int:
    """Remove orphaned checkpoint_*.tmp entries (a crash mid-save leaves
    its tmp behind forever otherwise; loads already ignore them). Only
    entries untouched for `min_age_s` are swept, so a concurrent
    writer's in-progress tmp on a shared fs is never clobbered (saver
    election bounds writers to one per interval, not one ever).
    Returns the number actually removed."""
    swept = 0
    cutoff = time.time() - min_age_s
    for d in os.listdir(dirname):
        if not (d.startswith("checkpoint_") and d.endswith(".tmp")):
            continue
        path = os.path.join(dirname, d)
        try:
            if os.path.getmtime(path) > cutoff:
                continue  # fresh: possibly another writer mid-save
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
            swept += 1
        except OSError:
            continue  # undeletable/vanished entry: next sweep's problem
    return swept


def save_checkpoint(dirname: str, step: int, main_program=None,
                    executor=None, max_keep: int = 3,
                    extra_meta: Optional[dict] = None,
                    retry: Optional[RetryPolicy] = None) -> str:
    """Write checkpoint_<step>/ with params + md5 metadata; atomic publish
    via tmp-dir rename; prune to max_keep newest and sweep tmp dirs
    orphaned by earlier crashed saves. The tmp-write phase (everything
    before the atomic publish) is idempotent, so it retries as a unit
    under `retry` (default: single attempt)."""
    from .. import io as pt_io
    from ..framework import default_main_program

    program = main_program or default_main_program()
    # sync barrier: under async dispatch (Executor.run sync=False) the
    # scope's persistable arrays may still be in flight; snapshotting
    # must wait for the dispatched step so the checkpoint can never
    # tear across it, and an async step error surfaces here instead of
    # mid-write
    if executor is not None:
        executor.synchronize()
    os.makedirs(dirname, exist_ok=True)
    final = os.path.join(dirname, f"checkpoint_{step}")
    tmp = final + ".tmp"

    def _write_tmp() -> dict:
        faults.fire("checkpoint.write")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        payload = pt_io.save_persistables(executor, tmp, program)
        # the scope step counter is not a program persistable, but it
        # seeds per-step op randomness (dropout, augmentation) and LR
        # schedules — without it a resumed run replays the remaining
        # batches under DIFFERENT randomness than the uninterrupted
        # run (the sync barrier above already ran, so the value is
        # settled)
        step_var = global_scope().find(STEP_VAR)
        meta = {
            "step": int(step),
            "time": time.time(),
            "md5": _md5(payload),
            "payload": os.path.basename(payload),
        }
        if step_var is not None:
            meta["step_var"] = int(step_var)
        meta.update(extra_meta or {})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        return meta

    (retry or RetryPolicy.NONE).call(_write_tmp, name="checkpoint.write")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _sweep_stale_tmp(dirname)

    kept = sorted((d for d in os.listdir(dirname)
                   if d.startswith("checkpoint_")
                   and not d.endswith(".tmp")),
                  key=lambda d: int(d.rsplit("_", 1)[1]))
    for d in kept[:-max_keep]:
        shutil.rmtree(os.path.join(dirname, d), ignore_errors=True)
    return final


def latest_checkpoint(dirname: str,
                      retry: Optional[RetryPolicy] = None
                      ) -> Optional[Tuple[str, dict]]:
    """Newest checkpoint whose payload passes md5 verification; corrupt or
    partial ones are skipped (the reference verifies md5 before loading,
    go/pserver/service.go:175-205). With `retry`, each candidate's
    read+verify is retried first, so a TRANSIENT read error (NFS blip)
    on the newest checkpoint doesn't silently demote the resume point to
    an older step; only errors that persist through the policy — and
    genuine corruption, which raises nothing retryable — skip it."""
    if not os.path.isdir(dirname):
        return None
    policy = retry or RetryPolicy.NONE
    cands = sorted((d for d in os.listdir(dirname)
                    if d.startswith("checkpoint_")
                    and not d.endswith(".tmp")),
                   key=lambda d: int(d.rsplit("_", 1)[1]), reverse=True)

    def _read_verify(path: str) -> Optional[dict]:
        faults.fire("checkpoint.read")
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            payload = os.path.join(path, meta["payload"])
            return meta if _md5(payload) == meta["md5"] else None
        except FileNotFoundError:
            # a missing meta.json/payload is structural corruption (a
            # crashed save), not a transient read error: skip without
            # burning the retry budget
            return None

    for d in cands:
        path = os.path.join(dirname, d)
        try:
            meta = policy.call(_read_verify, path, name="checkpoint.read")
            if meta is not None:
                return path, meta
        except (OSError, ValueError, KeyError, RetryError):
            # RetryError: the policy's deadline expired mid-candidate —
            # treat like any exhausted read and fall back to the next
            continue
    return None


def load_checkpoint(dirname: str, main_program=None, executor=None,
                    retry: Optional[RetryPolicy] = None) -> Optional[dict]:
    """Restore params from the newest valid checkpoint; returns its
    metadata (incl. 'step') or None if nothing valid exists. `retry`
    applies per-candidate inside the scan (transient read errors don't
    demote the resume point — see latest_checkpoint) and separately to
    the restore itself (counter name 'checkpoint.restore'); the two are
    NOT nested, so attempts stay linear in max_attempts."""
    from .. import io as pt_io
    from ..framework import default_main_program

    program = main_program or default_main_program()
    policy = retry or RetryPolicy.NONE

    found = latest_checkpoint(dirname, retry=retry)
    if found is None:
        return None
    path, meta = found
    policy.call(pt_io.load_persistables, executor, path, program,
                name="checkpoint.restore")
    if meta.get("step_var") is not None:
        # restore the scope step counter saved beside the weights, so
        # per-step op randomness and LR schedules continue exactly
        # where the checkpointed run left off
        global_scope().set(STEP_VAR, torch.tensor(int(meta["step_var"]),
                                                  dtype=torch.int32))
    return meta
