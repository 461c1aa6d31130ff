"""Registry of the environment flags the port reads.

The port's own copy of the entries of ``paddle_tpu/flags.py`` that its
modules use; the names and defaults are the JAX package's, so one
environment configures both — except PADDLE_TPU_PEAK_FLOPS, whose
default is the card's peak, not the TPU's.
"""
from __future__ import annotations

import os
from typing import Dict

# name -> (default, where it is read, what it does)
FLAGS: Dict[str, tuple] = {
    "PADDLE_TPU_AMP": (
        "0", "amp.py",
        "\"1\" turns bf16 automatic mixed precision on for the process "
        "(read at import; amp.enable / amp.amp_guard change it after): "
        "mul and conv2d take bf16 operands and return bf16, a mixed "
        "bf16/float32 elementwise pair computes in bf16. Part of the "
        "compile key"),
    "PADDLE_TPU_FLASH_MIN_SEQ": (
        "512", "ops/nn_ops.py",
        "minimum query and key length at which scaled_dot_product_attention "
        "on a CUDA tensor auto-routes to the flash-attention kernel; below "
        "it the naive composition runs"),
    "PADDLE_TPU_PALLAS_LSTM": (
        "1", "analysis/rewrite.py (kernel_dispatch pass), ops/sequence_ops.py",
        "lstm op route: \"1\" or \"force\" is stamped onto every eligible "
        "lstm op by the rewrite pipeline (over its __pallas__ attr; under "
        "PADDLE_TPU_OPTIMIZE=0 the op reads this knob itself); \"1\" takes the "
        "fused-LSTM kernel on CUDA tensors and the masked torch scan "
        "elsewhere, \"force\" the kernel anywhere (its plain twin on CPU "
        "tensors), \"0\" the scan (a stamp an op carries is kept)"),
    "PADDLE_TPU_PALLAS_GRU": (
        "1", "analysis/rewrite.py (kernel_dispatch pass), ops/sequence_ops.py",
        "gru op route, as PADDLE_TPU_PALLAS_LSTM for the lstm op, over the "
        "fused-GRU kernel"),
    "PADDLE_TPU_PALLAS_SDPA": (
        "1", "analysis/rewrite.py (kernel_dispatch pass)",
        "scaled_dot_product_attention route: \"force\" or \"0\" is stamped "
        "onto every attention op without seq_axis by the rewrite pipeline "
        "(use_flash "
        "true or false); \"1\" leaves the op's use_flash attr, or else its "
        "min-seq auto policy, in charge"),
    "PADDLE_TPU_CONV_LAYOUT": (
        "nchw", "ops/nn_ops.py",
        "conv2d memory layout: \"nhwc\" runs each conv on channels_last "
        "copies of its input and filter (the op's API stays NCHW); the "
        "default \"nchw\" runs it as given"),
    "PADDLE_TPU_DONATE_STATE": (
        "1", "core/executor.py",
        "default of Executor(donate_state=None) on the compiled path: \"1\" "
        "updates read-written state in place, in buffers the compiled step "
        "owns (the scope points at them); \"0\" leaves the tensors a caller "
        "held before a run as they were (a copy a step). Part of the "
        "compile key"),
    "PADDLE_TPU_CHECK_WHILE_BOUND": (
        "0", "core/executor.py",
        "\"1\" makes a bounded While that ended with its condition still "
        "true (its Exhausted flag: max_steps truncated the loop) raise at "
        "the run that fetched the flag; by default the flag is checked one "
        "run later and warns once per (program, flag) (read at import)"),
    "PADDLE_TPU_DECODE_SLOTS": (
        "4", "serving/generation/model.py",
        "default in-flight slot count of a generation model's "
        "continuous-batching array (per-request KV-cache rows; also "
        "the decode program's batch dimension)"),
    "PADDLE_TPU_DECODE_CACHE_BUCKETS": (
        "16,32,64", "serving/generation/model.py",
        "default cache-length buckets for the decode-step programs, "
        "comma-separated ascending; a step runs the smallest bucket "
        "covering the deepest active position"),
    "PADDLE_TPU_DECODE_MODEL_BUDGET": (
        "8", "serving/generation/host.py",
        "default per-model admission budget of a GenerationHost: max "
        "concurrently admitted (queued + in-flight) requests per "
        "hosted model before sheds with reason=model_budget"),
    "PADDLE_TPU_ATTRIBUTION": (
        "1", "observability/attribution.py (published from "
        "serving/engine.py, serving/generation/engine.py)",
        "live performance attribution: paddle_tpu_mfu / "
        "paddle_tpu_model_flops gauges; 0 disables publication (the "
        "disabled metrics registry also turns it off; "
        "set_attribution_enabled() overrides the env)"),
    "PADDLE_TPU_PEAK_FLOPS": (
        "989e12", "observability/attribution.py",
        "device peak FLOP/s the MFU gauge is normalized against "
        "(default: the dense bf16 tensor-core peak of an NVIDIA H100 80GB "
        "HBM3 at 700 W); read per step so tests can flip it"),
    "PADDLE_TPU_FLIGHT_RECORDER": (
        "1", "observability/flight_recorder.py",
        "failure flight recorder: bounded ring of recent profiler "
        "events dumped as a chrome-trace + JSON bundle when a failure "
        "trigger fires (circuit-breaker open, swap rollback, shed "
        "storm); 0 removes the listener entirely (zero overhead, "
        "nothing ever written)"),
    "PADDLE_TPU_FLIGHT_DIR": (
        "<tmpdir>/paddle_tpu_flightrec", "observability/flight_recorder.py",
        "directory flight-recorder dump bundles are written to "
        "(flightrec_<ms>_<pid>_<seq>_<reason>/, pruned to this "
        "process's newest 8)"),
    "PADDLE_TPU_VERIFY": (
        "1", "analysis/verifier.py (gates in core/executor.py, trainer.py, "
        "serving/generation/model.py, io.py)",
        "static program verification gates: pre-compile (every executor "
        "run, memoized per program version), trainer setup, generation "
        "model build and save_inference_model raise VerificationError on "
        "error-severity diagnostics; \"0\" disables every gate, the "
        "pre-compile memory gate included"),
    "PADDLE_TPU_OPTIMIZE": (
        "1", "analysis/rewrite.py (gate in core/executor.py)",
        "ProgramDesc rewrite pipeline on every compile-cache miss of both "
        "executors: constant folding, CSE, dead-op elimination, dead-"
        "gradient pruning, attention and SE-block outlining, kernel-"
        "dispatch stamps and in-place buffer reuse, each pass verified by "
        "fast_passes() and discarded on failure; \"0\" runs every program "
        "exactly as built (the ops then read their kernel knobs "
        "themselves)"),
    "PADDLE_TPU_INPLACE_REUSE": (
        "1", "analysis/rewrite.py (inplace_reuse pass)",
        "liveness-driven buffer reuse during rewrite: rename an op's "
        "output onto a dead same-signature buffer (value-preserving, root "
        "block only, never a persistable, donated, fed or fetched name); "
        "\"0\" keeps every var its own buffer"),
    "PADDLE_TPU_HBM_BYTES": (
        "", "analysis/memory.py (gate in core/executor.py)",
        "device-memory budget of the pre-compile memory gate, in bytes: a "
        "program whose static peak estimate exceeds it raises a "
        "VerificationError (top offenders and the high-water op) before "
        "it runs. Unset: the executor device's total memory as torch "
        "reports it on a CUDA card, and no gate on the CPU (which has no "
        "device memory to read); \"0\" disables the gate"),
}


def get(name: str) -> str:
    """Current value of a registered flag (env or default)."""
    if name not in FLAGS:
        raise KeyError(f"unknown flag {name!r}; see "
                       "paddle_tpu_torch.flags.FLAGS")
    return os.environ.get(name, FLAGS[name][0])
