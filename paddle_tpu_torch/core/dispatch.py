"""Kernel dispatch stamps, applied as the JAX package's executor applies
them.

The port's copy of the decision of ``KernelDispatch``
(``paddle_tpu/analysis/rewrite.py``), the rewrite pass that the JAX
executor runs on every program it compiles. It stamps the kernel route
onto the ops that have one, from the environment knobs:

- ``lstm`` (standard activations, no peepholes) and ``gru`` (sigmoid
  gate, tanh candidate) get ``__pallas__`` = PADDLE_TPU_PALLAS_LSTM /
  PADDLE_TPU_PALLAS_GRU when that knob is "1" or "force", over any stamp
  the op already carries; under "0" a stamp stays as it is;
- ``scaled_dot_product_attention`` without ``seq_axis`` gets
  ``use_flash`` = (knob == "force") when PADDLE_TPU_PALLAS_SDPA is
  "force" or "0"; under the default "1" the op's own stamp, or else its
  min-seq auto policy, decides;
- the ``fwd_op`` copy inside every ``__vjp__`` op gets the same stamp, so
  a replay takes the route of the op it replays.

``stamped(program)`` returns the program itself when no stamp changes,
else a stamped copy; the caller's program is never changed. The rest of
the JAX rewrite pipeline (folding, fusion outlining, buffer reuse) is
not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from .. import flags
from .ir import Program

_STD_LSTM = {"gate_activation": "sigmoid", "cell_activation": "tanh",
             "candidate_activation": "tanh"}


def knobs() -> Tuple[str, str, str]:
    """The (lstm, gru, sdpa) knob values in force now."""
    return (flags.get("PADDLE_TPU_PALLAS_LSTM"),
            flags.get("PADDLE_TPU_PALLAS_GRU"),
            flags.get("PADDLE_TPU_PALLAS_SDPA"))


def decision(op_type: str, attrs: Dict,
             knob: Tuple[str, str, str]) -> Optional[Tuple[str, object]]:
    """(attr, value) that KernelDispatch would set on an op of `op_type`
    with `attrs`, or None when it leaves the op as it is."""
    lstm, gru, sdpa = knob
    if op_type == "lstm":
        if lstm in ("1", "force") and not attrs.get("use_peepholes") \
                and all(attrs.get(k, d) == d for k, d in _STD_LSTM.items()) \
                and attrs.get("__pallas__") != lstm:
            return "__pallas__", lstm
    elif op_type == "gru":
        if gru in ("1", "force") \
                and attrs.get("gate_activation", "sigmoid") == "sigmoid" \
                and attrs.get("activation", "tanh") == "tanh" \
                and attrs.get("__pallas__") != gru:
            return "__pallas__", gru
    elif op_type == "scaled_dot_product_attention":
        if sdpa in ("force", "0") and not attrs.get("seq_axis") \
                and attrs.get("use_flash") != (sdpa == "force"):
            return "use_flash", sdpa == "force"
    return None


def _targets(program: Program):
    """(op type, attrs dict) of every op and every __vjp__'s fwd_op copy."""
    for blk in program.blocks:
        for op in blk.ops:
            yield op.type, op.attrs
            if op.type == "__vjp__":
                fwd = op.attrs.get("fwd_op") or {}
                if isinstance(fwd.get("attrs"), dict):
                    yield fwd.get("type"), fwd["attrs"]


def stamped(program: Program, knob: Tuple[str, str, str]) -> Program:
    """`program`, or a copy with the dispatch stamps of `knob` applied
    where any op's stamp changes."""
    if not any(decision(t, a, knob) for t, a in _targets(program)):
        return program
    copy = program.clone()
    for op_type, attrs in _targets(copy):
        hit = decision(op_type, attrs, knob)
        if hit is not None:
            attrs[hit[0]] = hit[1]
    return copy
