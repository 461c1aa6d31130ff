"""Carry weights into the port by name.

The port's startup draws its random weights from torch generators, not
from JAX's PRNG, so a port model and a JAX model built from one spec
start from different weights. ``load_params`` sets a model's state
from arrays keyed by their reference names — for example the JAX
model's scope converted to numpy — after which both packages compute
the same function. For a training program's scope the state is every
value its startup wrote: the parameters, the optimizer's accumulators
(Adam's moments and beta powers) and the learning rate.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.scope import Scope
from .models.transformer import KV_CACHE_PREFIX


def load_params(model_or_scope, arrays: Dict[str, np.ndarray]) -> None:
    """Set every persistable non-``kv_cache.*`` variable of a
    GenerationModel (or every non-cache tensor of an initialized Scope,
    such as a train step's scope after its startup ran) from ``arrays``,
    on the device and in the dtype the variable already has. Raises
    KeyError on a missing or an extra name and ValueError on a shape or
    dtype mismatch, before anything is written."""
    scope = model_or_scope if isinstance(model_or_scope, Scope) \
        else model_or_scope.scope
    names = sorted(n for n in scope.local_names()
                   if not n.startswith(KV_CACHE_PREFIX))
    missing = [n for n in names if n not in arrays]
    extra = sorted(n for n in arrays if n not in set(names))
    if missing or extra:
        raise KeyError(f"load_params: missing {missing}, extra {extra}")
    staged = {}
    for n in names:
        cur = scope.get(n)
        arr = np.asarray(arrays[n])
        want = str(cur.dtype).rsplit(".", 1)[-1]
        if tuple(arr.shape) != tuple(cur.shape) or arr.dtype.name != want:
            raise ValueError(
                f"load_params: {n!r} is {arr.dtype.name}{list(arr.shape)}, "
                f"the model holds {want}{list(cur.shape)}")
        # np.array copies: the caller's arrays may be read-only views
        staged[n] = torch.from_numpy(np.array(arr)).to(cur.device)
    for n, t in staged.items():
        scope.set(n, t)
