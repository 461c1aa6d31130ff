"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

Same ProgramDesc IR, op types, slot names and attrs as the JAX package
(``paddle_tpu``), executed eagerly by PyTorch on one device — an NVIDIA
card by default. Kernels that the JAX package wrote in Pallas for the
TPU are hand-written CUDA for Hopper here (ops/kernels/, csrc/).

The port goes slice by slice: it serves the decoder LM
(models/transformer.py build_decoder_lm) through serving/generation,
and trains the Transformer NMT model (models/transformer.py
build_train: core/backward.py autodiff, optimizer.py Adam), the
stacked-LSTM LM (models/lstm_lm.py) and GRU encoder-decoders
(layers.dynamic_gru) through Executor.run; io.py saves a trained
program as an inference model and loads it back. trainer.Trainer runs
the event loop over readers (reader/, data_feeder.py), with
asynchronous dispatch, iterations=K and checkpoints
(distributed/checkpoint.py); models/deepfm.py builds DeepFM. amp.py
turns on bf16 automatic mixed precision (PADDLE_TPU_AMP=1 or
amp.amp_guard()). layers/control_flow.py builds StaticRNN, DynamicRNN,
IfElse and While programs (ops/control_flow_ops.py runs them, an
unbounded While's gradient through the executor's probe-and-replay
WhileGrad). analysis/ verifies programs, prices them (cost model,
memory plan) and rewrites them (outlining a composed attention chain
onto the flash kernels) before the executors run them. dataset/ gives
the book's corpora (synthetic with the real schema unless the files are
under its DATA_HOME). serving/ serves frozen models (ServingEngine,
ModelHost with canary hot-swap) and decoder LMs (serving/generation,
GenerationHost), publishing to observability/ (metrics registry, spans,
attribution against the card's peak, flight recorder) and shedding load
through resilience/'s circuit breaker. It imports neither jax nor
paddle_tpu.
"""
from . import amp  # noqa: F401
from . import ops  # noqa: F401  (registers every ported op)
from . import layers  # noqa: F401
from .core.scope import Scope, global_scope, reset_global_scope  # noqa: F401
from .executor import (CPUPlace, CUDAPlace, Executor,  # noqa: F401
                       StepResult, scope_guard)
from .framework import (Program, default_main_program,  # noqa: F401
                        default_startup_program, program_guard,
                        reset_default_programs)
from . import io  # noqa: F401
from . import analysis  # noqa: F401  (verifier, cost, memory, rewrite)
from .io import load_param_arrays  # noqa: F401
from . import dataset, reader, resilience  # noqa: F401
from .layer_helper import LayerHelper, ParamAttr  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .reader import batch  # noqa: F401
from . import learning_rate_decay, optimizer  # noqa: F401
from . import profiler, observability, serving  # noqa: F401
