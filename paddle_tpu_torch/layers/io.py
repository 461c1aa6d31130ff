"""Input layers (the port's copy of ``data`` from
``paddle_tpu/layers/io.py``; the in-graph readers are not ported yet)."""
from __future__ import annotations

from ..framework import default_main_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         type=None, stop_gradient=True, main_program=None):
    """Declare an input variable fed at run time. With append_batch_size,
    -1 is prepended as the batch dim."""
    prog = main_program or default_main_program()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    var = prog.global_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient)
    return var
