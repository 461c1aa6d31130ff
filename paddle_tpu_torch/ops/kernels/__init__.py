"""Hand-written CUDA kernels for Hopper, each beside its plain torch twin.

One module per kernel family, named after the TPU kernels it replaces in
``paddle_tpu/ops/pallas/``; the CUDA sources live in
``paddle_tpu_torch/csrc/`` and are built at first use (build.py).
"""
from .block_megakernel import bottleneck_block, roll_micro_block  # noqa: F401
from .flash_attention import (flash_attention_bwd_dkv,  # noqa: F401
                              flash_attention_bwd_dkv_bf16,
                              flash_attention_bwd_dq,
                              flash_attention_bwd_dq_bf16,
                              flash_attention_fwd, flash_attention_fwd_bf16,
                              flash_attention_fwd_plain)
from .fused_conv import conv1x1_bn_act, conv3x3_bn_act  # noqa: F401
from .fused_gru import (fused_gru_bwd, fused_gru_bwd_bf16,  # noqa: F401
                        fused_gru_fwd, fused_gru_fwd_bf16)
from .fused_lstm import (fused_lstm_bwd, fused_lstm_bwd_bf16,  # noqa: F401
                         fused_lstm_fwd, fused_lstm_fwd_bf16)

#: every kernel wrapper of the port, for launch accounting
KERNELS = {"flash_attention_fwd": flash_attention_fwd,
           "flash_attention_bwd_dq": flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
           "flash_attention_fwd_bf16": flash_attention_fwd_bf16,
           "flash_attention_bwd_dq_bf16": flash_attention_bwd_dq_bf16,
           "flash_attention_bwd_dkv_bf16": flash_attention_bwd_dkv_bf16,
           "fused_lstm_fwd": fused_lstm_fwd,
           "fused_lstm_bwd": fused_lstm_bwd,
           "fused_lstm_fwd_bf16": fused_lstm_fwd_bf16,
           "fused_lstm_bwd_bf16": fused_lstm_bwd_bf16,
           "fused_gru_fwd": fused_gru_fwd,
           "fused_gru_bwd": fused_gru_bwd,
           "fused_gru_fwd_bf16": fused_gru_fwd_bf16,
           "fused_gru_bwd_bf16": fused_gru_bwd_bf16,
           "fused_conv1x1": conv1x1_bn_act,
           "fused_conv3x3": conv3x3_bn_act,
           "block_megakernel": bottleneck_block,
           "megakernel_roll_micro": roll_micro_block}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def credit_launches(counts):
    """Add `counts` ({name: launches}, negative to take some back) to the
    wrappers' counts: a CUDA graph replay launches what its capture
    recorded without running the wrappers, so the executor credits the
    capture's counts on every replay (core/executor.py)."""
    for name, n in counts.items():
        KERNELS[name].launches += n
