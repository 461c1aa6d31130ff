"""Checkpoint and inference-model IO, and carrying weights into the port.

The port's copy of ``paddle_tpu/io.py``: save/load of persistable
variables in the same single-file ``__params__.npz`` form, and
save/load_inference_model in the JSON form the JAX package's loader
reads (``__model__.json``: the program's blocks plus ``feed_names``,
``fetch_names``, ``feed_specs``, ``fetch_specs`` and, when given,
``model_version`` and ``generation_spec``, with the ``__version__`` and
``__generation__.json`` sidecars). Like the JAX package, the functions
read and write the global scope (``scope_guard`` picks another).

``load_inference_model`` also reads the native PTIR binary ``__model__``
that the JAX package writes where its native IR library builds
(``native/ir.cc``), with a pure-Python decoder of that format
(``decode_ptir``). Not ported yet (ROADMAP A7): writing PTIR.
``save_inference_model`` verifies the frozen program before it writes
it (analysis/, PADDLE_TPU_VERIFY), as the JAX package's does.

``load_param_arrays`` is the port's own: the port's startup draws its
random weights from torch generators, not from JAX's PRNG, so a port
model and a JAX model built from one spec start from different weights.
It sets a model's state from arrays keyed by their reference names — for
example the JAX model's scope converted to numpy — after which both
packages compute the same function. For a training program's scope the
state is every value its startup wrote: the parameters, the optimizer's
accumulators (Adam's moments and beta powers) and the learning rate.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .core.executor import STEP_VAR, resolve_device, to_numpy
from .core.scope import Scope, global_scope
from .framework import Block, Program, default_main_program
from .models.transformer import KV_CACHE_PREFIX

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "inference_model_specs",
           "load_param_arrays"]

#: the file names the JAX package reads and writes
PARAMS_FILE = "__params__.npz"
MODEL_BINARY = "__model__"
MODEL_JSON = "__model__.json"
PTIR_MAGIC = b"PTIR"
PTIR_VERSION = 1


class PTIRError(ValueError):
    """A PTIR file that is truncated, of another version or malformed."""


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value, shift = 0, 0
    while pos < len(buf):
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise PTIRError("varint overflow")
    raise PTIRError("truncated varint")


def _ptir_value(buf: bytes, pos: int) -> Tuple[Any, int]:
    """One tagged value at `pos` (native/ir.cc ptir::Decoder::decode):
    0 null, 1 false, 2 true, 3 int (zigzag varint), 4 double (8 bytes
    little-endian), 5 str, 6 array, 7 object (varint count; a key is a
    varint length and its bytes)."""
    if pos >= len(buf):
        raise PTIRError("truncated value")
    tag = buf[pos]
    pos += 1
    if tag <= 2:
        return (None, False, True)[tag], pos
    if tag == 3:
        z, pos = _varint(buf, pos)
        return (z >> 1) ^ -(z & 1), pos
    if tag == 4:
        if len(buf) - pos < 8:
            raise PTIRError("truncated double")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == 5:
        n, pos = _varint(buf, pos)
        if len(buf) - pos < n:
            raise PTIRError("truncated string")
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if tag == 6:
        n, pos = _varint(buf, pos)
        items = []
        for _ in range(n):
            item, pos = _ptir_value(buf, pos)
            items.append(item)
        return items, pos
    if tag == 7:
        n, pos = _varint(buf, pos)
        obj = {}
        for _ in range(n):
            klen, pos = _varint(buf, pos)
            if len(buf) - pos < klen:
                raise PTIRError("truncated key")
            key = buf[pos:pos + klen].decode("utf-8")
            obj[key], pos = _ptir_value(buf, pos + klen)
        return obj, pos
    raise PTIRError(f"unknown tag {tag} at byte {pos - 1}")


def decode_ptir(data: bytes) -> Any:
    """The JSON value a native PTIR file holds (native/ir.cc ir_load): the
    magic b"PTIR", format-version byte 1, then one tagged value. Raises
    PTIRError on any other magic or version, and on a truncated or
    malformed value; bytes after the value are ignored, as there."""
    if len(data) < 5 or data[:4] != PTIR_MAGIC:
        raise PTIRError("not a PTIR file")
    if data[4] != PTIR_VERSION:
        raise PTIRError(f"unsupported PTIR version {data[4]}")
    return _ptir_value(data, 5)[0]


def inference_model_specs(program: Program, feed_names, fetch_names):
    """Per-var feed/fetch metadata {name: {shape, dtype, lod_level}} for a
    frozen program. -1 dims are dynamic (a leading -1 is the batch axis).
    Derived from the program's VarDescs."""
    block = program.global_block() if hasattr(program, "desc") \
        else program.blocks[0]

    def spec(name):
        v = block.var(name)
        v = v.desc if hasattr(v, "desc") else v
        return {"shape": list(v.shape) if v.shape is not None else None,
                "dtype": v.dtype, "lod_level": v.lod_level}

    return ({n: spec(n) for n in feed_names},
            {n: spec(n) for n in fetch_names})


def _vars_of(program: Program, predicate) -> List:
    return [v for v in program.list_vars() if predicate(v.desc)]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Write the global scope's value of every var of `vars` (or of every
    var of the program that `predicate` accepts, by default the
    persistable ones) into one .npz file; returns its path."""
    program = main_program or default_main_program()
    if vars is None:
        vars = _vars_of(program, predicate or (lambda v: v.persistable))
    os.makedirs(dirname, exist_ok=True)
    scope = global_scope()
    arrays = {}
    for v in vars:
        val = scope.find(v.name)
        if val is None:
            continue
        arrays[v.name] = to_numpy(val)
    path = os.path.join(dirname, filename or PARAMS_FILE)
    np.savez(path, **arrays)
    return path


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: v.is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: v.persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Set the global scope's value of every var of `vars` (or of the
    program's vars that `predicate` accepts) that the .npz file holds,
    as a tensor on the executor's device (the first CUDA card when no
    executor is given)."""
    program = main_program or default_main_program()
    if vars is None:
        vars = _vars_of(program, predicate or (lambda v: v.persistable))
    device = executor.device if executor is not None else resolve_device()
    scope = global_scope()
    with np.load(os.path.join(dirname, filename or PARAMS_FILE)) as data:
        for v in vars:
            if v.name in data:
                scope.set(v.name, torch.from_numpy(data[v.name]).to(device))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program,
              predicate=lambda v: v.is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program,
              predicate=lambda v: v.persistable, filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, model_version=None,
                         generation_spec=None):
    """Freeze program + params for inference: prune the program to what
    the targets need from the feeds, flip it to inference mode, and write
    it as JSON (``model_filename`` or ``__model__.json``) beside the
    persistables (``params_filename`` or ``__params__.npz``).
    `model_version` is an optional deploy identity and `generation_spec`
    an optional JSON-able dict of token-serving parameters; each also
    goes into a sidecar file, as the JAX package writes them."""
    program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    fetch_names = [t.name for t in target_vars]
    pruned = _prune(program, feeded_var_names, fetch_names)
    pruned = pruned.inference_optimize()
    # Verify the frozen artifact BEFORE it reaches disk: a broken export
    # (fetch pruned away, a dangling input) fails the save, not the
    # eventual load. PADDLE_TPU_VERIFY=0 opts out.
    from .analysis import verify_enabled, verify_program
    if verify_enabled():
        verify_program(
            pruned, feed_names=list(feeded_var_names),
            fetch_names=fetch_names,
            program_label="frozen inference program",
        ).raise_if_errors(context="save_inference_model")
    meta = dict(pruned.desc.to_dict())
    meta["feed_names"] = list(feeded_var_names)
    meta["fetch_names"] = fetch_names
    feed_specs, fetch_specs = inference_model_specs(
        pruned, feeded_var_names, fetch_names)
    meta["feed_specs"] = feed_specs
    meta["fetch_specs"] = fetch_specs
    version_path = os.path.join(dirname, "__version__")
    if model_version is not None:
        meta["model_version"] = str(model_version)
        with open(version_path, "w") as f:
            f.write(str(model_version))
    elif os.path.exists(version_path):
        # a stale sidecar would stamp the previous artifact's identity
        # onto the new weights
        os.remove(version_path)
    gen_path = os.path.join(dirname, "__generation__.json")
    if generation_spec is not None:
        meta["generation_spec"] = dict(generation_spec)
        with open(gen_path, "w") as f:
            json.dump(dict(generation_spec), f)
    elif os.path.exists(gen_path):
        os.remove(gen_path)
    with open(os.path.join(dirname, model_filename or MODEL_JSON), "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, program,
                      filename=params_filename or PARAMS_FILE)
    return dirname


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, return_meta=False):
    """Load a frozen model into the global scope. Returns (program,
    feed_names, fetch_vars); with return_meta=True a 4th element carries
    {"feed_specs", "fetch_specs", "model_version", "generation_spec"}.
    Reads a native PTIR ``__model__`` (decode_ptir) where there is one,
    else the JSON form."""
    bin_path = os.path.join(dirname, model_filename or MODEL_BINARY)
    json_path = os.path.join(dirname, model_filename or MODEL_JSON)
    meta = None
    if os.path.exists(bin_path):
        with open(bin_path, "rb") as f:
            data = f.read()
        if data[:4] == PTIR_MAGIC:
            try:
                meta = decode_ptir(data)
            except PTIRError as e:
                raise PTIRError(f"{bin_path}: {e}") from None
        else:  # a custom model_filename in the JSON form
            json_path = bin_path
    if meta is None:
        with open(json_path) as f:
            meta = json.load(f)
        meta = meta.get("program", meta) | {
            k: meta[k] for k in ("feed_names", "fetch_names", "feed_specs",
                                 "fetch_specs", "model_version",
                                 "generation_spec") if k in meta}
    from .core import ir
    prog = Program()
    prog.desc = ir.Program.from_dict(meta)
    prog._blocks = [Block(prog, bd) for bd in prog.desc.blocks]
    load_vars(executor, dirname, prog, predicate=lambda v: v.persistable,
              filename=params_filename or PARAMS_FILE)
    fetch_vars = [prog.global_block().var(n) for n in meta["fetch_names"]]
    if not return_meta:
        return prog, meta["feed_names"], fetch_vars
    if "feed_specs" in meta and "fetch_specs" in meta:
        feed_specs, fetch_specs = meta["feed_specs"], meta["fetch_specs"]
    else:
        feed_specs, fetch_specs = inference_model_specs(
            prog, meta["feed_names"], meta["fetch_names"])
    model_version = meta.get("model_version")
    vpath = os.path.join(dirname, "__version__")
    if model_version is None and os.path.exists(vpath):
        with open(vpath) as f:
            model_version = f.read().strip() or None
    generation_spec = meta.get("generation_spec")
    gpath = os.path.join(dirname, "__generation__.json")
    if generation_spec is None and os.path.exists(gpath):
        with open(gpath) as f:
            generation_spec = json.load(f)
    return prog, meta["feed_names"], fetch_vars, {
        "feed_specs": feed_specs, "fetch_specs": fetch_specs,
        "model_version": model_version,
        "generation_spec": generation_spec}


def _prune(program: Program, feed_names, fetch_names) -> Program:
    """Keep only the ops needed to compute fetch_names. Persistable vars
    (parameters) are roots: their values come from the saved file, so
    their producers (optimizer update ops) do not pull the training
    graph back in. The JAX package slices in its native IR library where
    that builds and in ``_prune_py`` elsewhere, with the same result; the
    port has ``_prune_py`` only."""
    pruned = Program()
    pruned.desc = _prune_py(program, fetch_names)
    pruned._blocks = [Block(pruned, bd) for bd in pruned.desc.blocks]
    return pruned


def _prune_py(program: Program, fetch_names):
    desc = program.desc.clone()
    block = desc.global_block

    def _persistable(name):
        v = block.find_var_recursive(name)
        return v is not None and v.persistable

    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        if any(n in needed for n in op.output_names()):
            keep.append(op)
            for n in op.input_names():
                if not _persistable(n):
                    needed.add(n)
    block.ops = list(reversed(keep))
    desc._bump_version()
    return desc


def load_param_arrays(model_or_scope, arrays: Dict[str, np.ndarray]
                      ) -> None:
    """Set every persistable non-``kv_cache.*`` variable of a
    GenerationModel (or every non-cache tensor of an initialized Scope,
    such as a train step's scope after its startup ran) from ``arrays``,
    on the device and in the dtype the variable already has. Raises
    KeyError on a missing or an extra name and ValueError on a shape or
    dtype mismatch, before anything is written. The step counter
    (``STEP_VAR``) is no weight: it is neither set nor required, and an
    array of that name is ignored."""
    scope = model_or_scope if isinstance(model_or_scope, Scope) \
        else model_or_scope.scope
    names = sorted(n for n in scope.local_names()
                   if not n.startswith(KV_CACHE_PREFIX) and n != STEP_VAR)
    missing = [n for n in names if n not in arrays]
    extra = sorted(n for n in arrays if n not in set(names)
                   and n != STEP_VAR)
    if missing or extra:
        raise KeyError(f"load_param_arrays: missing {missing}, extra "
                       f"{extra}")
    staged = {}
    for n in names:
        cur = scope.get(n)
        arr = np.asarray(arrays[n])
        want = str(cur.dtype).rsplit(".", 1)[-1]
        if tuple(arr.shape) != tuple(cur.shape) or arr.dtype.name != want:
            raise ValueError(
                f"load_param_arrays: {n!r} is {arr.dtype.name}"
                f"{list(arr.shape)}, the model holds {want}"
                f"{list(cur.shape)}")
        # np.array copies: the caller's arrays may be read-only views
        staged[n] = torch.from_numpy(np.array(arr)).to(cur.device)
    for n, t in staged.items():
        scope.set(n, t)
