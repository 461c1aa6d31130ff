"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

Same ProgramDesc IR, op types, slot names and attrs as the JAX package
(``paddle_tpu``), executed eagerly by PyTorch on one device — an NVIDIA
card by default. Kernels that the JAX package wrote in Pallas for the
TPU are hand-written CUDA for Hopper here (ops/kernels/, csrc/).

The port goes slice by slice: it serves the decoder LM
(models/transformer.py build_decoder_lm) through serving/generation,
and trains the Transformer NMT model (models/transformer.py
build_train: core/backward.py autodiff, optimizer.py Adam) through
Executor.run. It imports neither jax nor paddle_tpu.
"""
from . import ops  # noqa: F401  (registers every ported op)
from . import layers  # noqa: F401
from .core.scope import Scope, global_scope, reset_global_scope  # noqa: F401
from .executor import CPUPlace, CUDAPlace, Executor  # noqa: F401
from .framework import (Program, default_main_program,  # noqa: F401
                        default_startup_program, program_guard,
                        reset_default_programs)
from .io import load_params  # noqa: F401
