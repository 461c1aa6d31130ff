#!/usr/bin/env python3
"""Smoke test of paddle_tpu_torch on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. card name and power limit (nvidia-smi); build every CUDA kernel of
     the port from the sources in the checkout (one nvcc per source, all
     started together).
  2. each kernel against its plain torch version on the card, at the
     shapes the serving and training paths give it and over a sweep (of
     head dims, lengths, biases and causal for attention; of H, B, T,
     zero-length rows, initial states and last-state cotangents for the
     fused LSTM and the fused GRU; of the ResNet-50 bottleneck shapes,
     ragged row tiles, 1x1 images, odd channel counts, the affine, ReLU
     and statistics on and off for the fused convs; of the ResNet-50
     stages 2-4 at tiles 1, 2 and 4, 1x1 and 3x3 images, Cm 64, groups
     off the row tile, float32 and bfloat16 and the four variants for the
     ghost-BN bottleneck megakernel, which phases 11-12 time), with
     times: kernel, plain, library (one PyTorch call computing the same
     function, a yardstick the port never calls; for the GRU, which no
     PyTorch call computes, torch.nn.GRU at the same shape as a same-FLOP
     yardstick) and the card's lower bound for the work (for the flash
     kernels at the 3xTF32 rate of the tensor cores, with the FMA-rate
     bound beside it, and the flash backward total, dq + dk/dv, against
     the one PyTorch call that computes dq, dk and dv together; for the
     persistent fused-GRU kernels, a bitwise rerun, the barrier floor
     (the same grid through the same barriers with no products) and the
     backward's recurrence and dW reduction apart).
  3. serve the decoder LM at Transformer-base width through the port's
     entry points (GenerationModel.build -> GenerationEngine.submit):
     6 requests on 4 slots, continuous batching, KV cache. Launch
     counts are set to 0 just before and read just after; every token
     stream must equal the same port model's on the CPU (same weights,
     plain path) or differ only at a near tie of the CPU logits.
  4. train Transformer-base NMT (models.transformer.build_train at
     B4 x S2048, 6+6 layers, d512, vocabulary 32000, Adam) through
     Executor.run for 5 steps from seeded weights: once as built (every
     attention takes the flash kernels: S >= PADDLE_TPU_FLASH_MIN_SEQ),
     with the launch counts set to 0 just before and read just after,
     and once with use_flash=False stamped on every attention op and
     fwd_op copy (the naive route, same card, same weights). Losses and
     step-1 gradients must agree: every parameter's gradient per element
     against one more naive step whose ReLUs take the flash arm's masks,
     and by 2-norm against the free naive arm (see TRAIN_GRAD_NORM_RTOL).
  5. train the stacked-LSTM LM (models.lstm_lm.build_train as bench.py:668
     measures it: vocabulary 10000, emb 256, hidden 512, 2 layers, SGD lr
     1.0, B64 x T64 with the bench's ragged lengths in [32, 64]) through
     Executor.run for 5 steps from seeded weights: once as built (every
     lstm op takes the fused-LSTM kernels), with the launch counts set to
     0 just before and read just after, and once with __pallas__="0"
     stamped on every lstm op and fwd_op copy under
     PADDLE_TPU_PALLAS_LSTM=0 (the scan route: the executor stamps the
     knob over an op's stamp when it is "1" or "force"). Losses and
     every parameter's step-1 gradient must agree per element.
  6. train the GRU encoder-decoder of the book's machine-translation
     chapter (tests/test_book.py: embedding -> fc(3H) -> dynamic_gru for
     source and target, scaled_dot_product_attention(dec, enc, enc),
     concat, fc(V), softmax_with_cross_entropy, sequence_pool average,
     mean, Adam lr 3e-3) at the chapter's published width (dictionary
     30000, word vectors 512, encoder and decoder 512), B64 x T80 with
     ragged source and target lengths in [10, 80], through Executor.run
     for 5 steps from seeded weights: once as built (every gru op takes
     the fused-GRU kernels), with the launch counts set to 0 just before
     and read just after, and once with __pallas__="0" stamped on every
     gru op and fwd_op copy under PADDLE_TPU_PALLAS_GRU=0 (the scan
     route). Losses and every parameter's step-1 gradient must agree per
     element; a profiled step gives the fused-GRU kernels' device ms
     (forward, backward recurrence, dW) beside the step's.
  7. the inference entry point: the kernel-route model of phase 6 saved
     with io.save_inference_model, loaded with io.load_inference_model
     into a fresh Executor and scope and run on one feed; its logits must
     equal, bit for bit, those that one more run of the trained program
     fetches (whose forward reads the saved weights).
  8. train MNIST conv (models.mnist.build_train(net="conv"), Adam) at
     batch 64 for 5 steps on the card (every launch count must stay 0:
     no op dispatches a kernel there) and on the port's CPU path; losses
     and step-1 gradients must agree (see MNIST_LOSS_RTOL).
  9. train ResNet-50 as bench.py:221-226 does (1000 classes, 3x224x224,
     Momentum 0.9 at lr 0.1, batch 128, fp32 with TF32 off) for 5 steps:
     step ms, peak memory, launch counts (all 0) and a profiled step;
     then 2 steps at batch 4 on the card and on the CPU, held by losses,
     gradients and every batch_norm's running statistics (see
     RESNET_NOISE_FACTOR).
 10. the ResNet-50 bottleneck chain of benchmarks/conv_kernel_ab.py at
     its four stages (batch 128, 8 blocks each): the fused conv kernels
     against cuDNN convolutions with the port's batch_norm, held together
     after one block and after all, timed per block; both kernels must
     launch there.
 11. the megakernel chain of benchmarks/block_megakernel_ab.py: 8
     stacked identity bottlenecks at ResNet-50 stages 2-4 (batch 128),
     bfloat16 and float32, tiles 1, 2 and 4, as three arms: batch-BN
     (cuDNN + the port's batch_norm in float32), ghost composed (the
     plain twin) and the megakernel, held against the twin after one
     block and after all (a rerun bitwise equal), and at tile = N = 4
     against the batch-BN arm; timed per block; the megakernel must
     launch there.
 12. the roll micro of benchmarks/megakernel_roll_micro.py: stage 2,
     tile 2, bfloat16, 8 blocks of each variant (full, strided, nobn,
     noroll) held against its twin and timed; full - noroll is the cost
     of the shifts and masks, full - nobn that of the statistics.
 13. JSON lines of the kernels, serving, the three earlier trainings,
     MNIST, ResNet-50, the conv chain, the megakernel chain and the roll
     micro, then, last, the JSON result line.

cuDNN runs deterministic algorithms picked without timing
(torch.backends.cudnn.deterministic, benchmark off); phases 8-10
compare its convolutions with other summation orders.

Without a CUDA card, or outside a checkout, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# where the LSTM phases put their tensors: the card (a CPU rehearsal of
# the script's control flow may set "cpu"; it proves nothing about the
# kernels, whose wrappers then take their plain twins)
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 494.7e12

# kernel vs plain, float32: the two sum the same terms in another order
# (tiles of 64 keys, online rescaling), so they agree to ~1e-6; a wrong
# mask or tile edge shows up as O(1e-1) or more
KERNEL_ATOL = 1e-4
KERNEL_RTOL = 1e-4

# a GPU token stream may leave the CPU's only where the CPU's top-2
# logits are closer than this (float32 sums in another order differ by
# ~1e-5 after six layers; a real fault gives margins of ~1e-2)
TIE_MARGIN = 1e-3

SERVE_SPEC = dict(vocab_size=32000, max_seq_len=1024, slots=4,
                  prompt_buckets=[128, 512, 1024],
                  cache_buckets=[128, 256, 512, 1024], n_layer=6,
                  n_head=8, d_model=512, d_inner=2048, seed=0)
PROMPT_LENS = [60, 300, 600, 900, 1000, 120]
MAX_NEW_TOKENS = 32

# (label, S, live key rows): B=1, H=8, D=64, causal, key-row mask
ATTN_CASES = [("S512", 512, 450), ("S1024", 1024, 900), ("S777", 777, 700)]
MAIN_CASE = "S1024"
# the kernels each path runs
SERVING_KERNELS = ("flash_attention_fwd",)
NMT_TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv")
# (B, H, Sq, Sk, D, bias shape or None, causal)
COVERAGE_CASES = [
    (2, 3, 100, 130, 16, (2, 3, 100, 130), False),
    (2, 3, 130, 100, 32, (2, 1, 130, 100), True),
    (1, 2, 200, 200, 128, None, True),
    (4, 8, 1, 300, 64, (4, 1, 1, 300), False),
]

# the training path's attention: B4 H8 S2048 D64, non-causal, with the
# encoder/cross key-row mask [4,1,1,S] (no pads in the feeds) or the
# decoder self-attention bias [4,1,S,S] (pad mask + assigned triu(-1e9))
TRAIN_ATTN = (4, 8, 2048, 64)
BWD_MAIN_CASE = "keyrow"
# backward sweep: (B, H, Sq, Sk, D, bias shape or None, causal, bias_grad)
BWD_COVERAGE_CASES = [
    (2, 3, 100, 130, 16, (2, 3, 100, 130), False, True),
    (2, 3, 130, 100, 32, (2, 1, 130, 100), True, True),
    (2, 2, 77, 77, 64, (1, 2, 77, 77), True, True),
    (1, 2, 200, 200, 128, None, True, False),
    (4, 8, 1, 300, 64, (4, 1, 1, 300), False, True),
    (2, 4, 96, 96, 32, (2, 1, 96, 96), False, False),
    (1, 2, 150, 170, 128, (1, 2, 150, 170), True, True),
]

TRAIN_CFG = dict(src_vocab=32000, trg_vocab=32000, max_len=2048, n_layer=6,
                 n_head=8, d_model=512, d_inner=2048, lr=1e-3)
TRAIN_BATCH = 4
TRAIN_STEPS = 5
# flash vs naive route on the card, float32. The losses of 5 Adam steps
# agree to rtol 1e-4. The two routes round the forward differently (sums
# in another order, ~1e-6 relative), which flips the ReLU mask of the few
# FFN pre-activations lying within that noise of 0; each flip passes or
# stops one unit's whole gradient for one token, and so moves every
# gradient upstream of it by ~5e-4 of its 2-norm (an H100 run of this
# script: 2-11 flips per FFN of 16.8M inputs, 2-norm gap up to 9.6e-4).
# So every parameter's step-1 gradient is held per element against a
# naive step whose ReLUs are pinned to the flash arm's masks, which takes
# the flips out and leaves only rounding: rtol 1e-4, atol 1e-5 * max|g|.
# The weights of the Q and K projections get the larger of that atol and
# TRAIN_GRAD_NOISE_FACTOR times how far a one-ulp nudge of every weight
# moves their gradient (the same pinned step from nudged weights): their
# gradients pass through ds = p * (dp - delta), a difference of nearly
# equal terms wherever a row's values are alike, which amplifies the
# routes' rounding (an H100 run: up to 4.4e-4 * max|g| in the decoder,
# 8.7x the nudge's effect). The free naive arm's gradients are held by
# |g_flash - g_naive| / |g_naive| (2-norms) <= 2e-3, about 2x the gap the
# flips made. A fault in a kernel moves either by O(1).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL_FRAC = 1e-4, 1e-5
TRAIN_GRAD_NOISE_FACTOR = 30.0
TRAIN_GRAD_NORM_RTOL = 2e-3

# the stacked-LSTM LM as bench.py:668 measures it (BASELINE config 3)
LSTM_CFG = dict(vocab_size=10000, emb_dim=256, hid_dim=512, num_layers=2,
                lr=1.0)
LSTM_BATCH, LSTM_T = 64, 64
LSTM_STEPS = 5
# the kernel table's row: the LM's shape with the bench's ragged lengths
LSTM_MAIN_CASE = "ragged"
# fused-LSTM sweep: (T, B, H, lengths, nonzero h0/c0, nonzero dc_all and
# last-state cotangents): H 16/128/1024, B=1, T=1, zero-length rows, and
# an H and B off every tile edge
LSTM_COVERAGE_CASES = [
    (8, 4, 16, [0, 3, 8, 1], True, True),
    (5, 3, 128, [5, 2, 4], True, True),
    (6, 2, 1024, [6, 3], True, True),
    (7, 1, 128, [7], False, True),
    (1, 5, 128, [1, 0, 1, 1, 0], True, True),
    (16, 40, 100, [i % 17 for i in range(40)], True, True),
]
# kernel vs scan route of the LSTM LM and of the GRU NMT model on the
# card, float32. The routes compute the same function with the recurrent
# products summed in another order (the kernels' tiles vs cuBLAS); neither
# model has a ReLU, so nothing turns rounding into a discrete change. H100
# runs of this script: the 5 losses equal bit for bit, the step-1
# gradients within 2.4e-6 (LSTM) and 2.2e-6 (GRU) * max|g| (the recurrent
# weights; the rest within 3.4e-7). The limits leave 4x room over that; a
# wrong mask, carry or gate moves both by O(1).
RNN_LOSS_RTOL = 1e-4
RNN_GRAD_RTOL, RNN_GRAD_ATOL_FRAC = 1e-4, 1e-5
# the cuDNN yardstick must compute the kernel's function: its h_all
# agrees to float32 rounding (a gate-order slip gives O(0.1))
LSTM_LIBRARY_ATOL = 1e-4

# the book's machine-translation chapter at its published width
# (PaddlePaddle book ch. 8: dict_size 30000, word_vector_dim 512,
# encoder_size = decoder_size 512), Adam as tests/test_book.py trains it
GRU_NMT_CFG = dict(dict_size=30000, emb_dim=512, hid_dim=512, lr=3e-3)
# batch 64; source and target lengths uniform in [10, 80] from
# RandomState(0), padded to the wmt14 reader's 80-token cut
GRU_BATCH, GRU_T, GRU_MIN_LEN = 64, 80, 10
GRU_STEPS = 5
# fused GRU vs its plain twins: the forward within 1e-6 absolute (the same
# products summed in another order, 80 steps of a contracting recurrence);
# the backward as _max_err holds it
GRU_FWD_ATOL = 1e-6
# the kernel table's row: the book model's shape with its source lengths
GRU_MAIN_CASE = "ragged"
# fused-GRU sweep: (T, B, H, lengths, nonzero h0, h_last cotangent): H
# 64/256/512 and one off every tile edge, B 1/7/64, T 1/5/80, zero-length
# and full rows; H 1024 and 2048, whose W strips do not fit in shared
# memory (the persistent kernels stream the rest from L2)
GRU_COVERAGE_CASES = [
    (5, 7, 64, [5, 0, 3, 1, 5, 2, 0], True, True),
    (1, 7, 256, [1, 0, 1, 1, 0, 1, 1], True, True),
    (80, 1, 512, [80], True, True),
    (80, 64, 64, [(7 * i) % 81 for i in range(64)], True, True),
    (5, 64, 256, [i % 6 for i in range(64)], False, True),
    (80, 7, 512, [80, 0, 40, 79, 1, 80, 13], True, False),
    (16, 40, 100, [i % 17 for i in range(40)], True, True),
    (5, 8, 1024, [5, 0, 3, 5, 1, 4, 5, 2], True, True),
    (5, 8, 2048, [5, 3, 0, 5, 1, 4, 5, 2], True, True),
]
# the times of the per-step kernels the persistent ones replaced (two
# launches a step; PERF.md rows 6-7, NVIDIA H100 80GB HBM3, 700.00 W),
# printed beside the persistent kernels' times and kept out of the
# kernels line, which holds only this run's numbers
GRU_PER_STEP_MS = {("fused_gru_fwd", "ragged"): "1.3773-1.4124",
                   ("fused_gru_fwd", "full"): "1.3785-1.4097",
                   ("fused_gru_bwd", "ragged"): "2.2876-2.3312",
                   ("fused_gru_bwd", "full"): "2.2876-2.3312"}
# kernel name fragments of a fused-GRU call in a profile
GRU_KERNELS = {"forward": "gru_fwd_persistent", "backward recurrence":
               "gru_bwd_persistent", "dW": "gru_dw_"}


# the fused conv + BN kernels (paddle_tpu/ops/pallas/fused_conv.py) at the
# ResNet-50 bottleneck chain of benchmarks/conv_kernel_ab.py:195-200,
# batch 128: (label, images, C, c, side); each stage runs its 1x1 convs
# C->c and c->C and its 3x3 c->c
CONV_CHAIN = [("bneck1", 128, 256, 64, 56), ("bneck2", 128, 512, 128, 28),
              ("bneck3", 128, 1024, 256, 14), ("bneck4", 128, 2048, 512, 7)]
# the kernel table's rows: stage 1's first 1x1 (256->64) and its 3x3
CONV_MAIN_CASE = "bneck1"
# the sweep beyond the chain: (label, images, H, W, C, N) for the 3x3 (the
# 1x1 takes M = images*H*W rows of C): M 2*7*7 = 98 (below one 128-row
# tile), tiles crossing image boundaries (3x9x10), 1x1 images (every
# off-centre tap masked), C 3, C 64 and an odd C
CONV_COVERAGE_CASES = [("m98", 2, 7, 7, 64, 48), ("cross", 3, 9, 10, 3, 130),
                       ("img1x1", 5, 1, 1, 65, 16),
                       ("odd", 4, 6, 5, 37, 200)]
# (affine, relu, stats): bare, stats only, ReLU without the affine, the
# affine alone, the full prologue and epilogue, the prologue without stats
CONV_VARIANTS = [(False, False, False), (False, False, True),
                 (False, True, True), (True, False, True),
                 (True, True, True), (True, True, False)]
# the kernels' two operand types: float32 (three TF32 passes on the tensor
# cores) and bfloat16, as the reference runs them
CONV_DTYPES = ("f32", "bf16")
# fused conv kernel vs its plain twin on the card. float32: the same
# products summed in another order (K' up to 4608 terms; an H100 run of
# this kernel: <= 2.3e-6 * max|plain| on the outputs, <= 8e-7 of the sum
# of |terms| on the statistics). bfloat16: both round float32 sums of the
# same products, taken in another order, so each output element lies
# within one bf16 ulp (at the larger of the two) plus this fraction of
# its sum of |terms|; statistics as in float32. A wrong tap, mask or
# prologue gives O(1e-1) or more.
CONV_OUT_RTOL = 1e-5
CONV_STATS_RTOL = 1e-5
# the ResNet-50 bottleneck chain, fused kernels vs composed cuDNN + the
# port's batch_norm, float32 and bfloat16: L blocks per stage
CONV_CHAIN_BLOCKS = 8
# bfloat16, after L blocks, fused vs composed: the two arms are not
# twins. The fused arm takes each batch_norm's statistics from the
# float32 accumulator, the composed arm from its bf16-rounded conv
# output (the variance then differs by ~1e-4 at M 6272, ~1/sqrt(M)), so
# about 1% of the activations round to the other bf16 neighbour in one
# arm and not the other, and the two arms' rounding noise is largely
# independent: an H100 run read the fused-composed gap at 1.009 times
# the composed arm's own distance from its float32 chain (stage 3), a
# CPU run of the plain twins 0.945-1.20 (M 6272 to 72). Two equally noisy
# roundings of one chain whose noise is at most uncorrelated sit at most
# sqrt(2) times one's noise apart; a wrong tap or statistic moves the
# gap by O(1). The kernels' correctness in bf16 is held against their
# exact twin by phase 11's rule.
CHAIN_BF16_ARMS_FACTOR = 2.0 ** 0.5
# fused vs composed: the same function in another summation order. After
# one block the two agree to float rounding, amplified by the three
# batch_norms' renormalization: max |diff| <= 1e-4 * max|composed|. After
# L blocks a few ReLU inputs within rounding of 0 may have flipped: the
# 2-norm of the difference stays <= 1e-3 of the output's. A wrong tap,
# statistic or coefficient moves either by O(1).
CHAIN_ONE_BLOCK_RTOL = 1e-4
CHAIN_NORM_RTOL = 1e-3

# the ghost-BN bottleneck megakernel (paddle_tpu/ops/pallas/
# block_megakernel.py) at the stages of benchmarks/block_megakernel_ab.py
# :133-137, batch 128: (label, images, Cin, Cm, side), tiles of :81, L
# blocks of :30; bfloat16 (the benchmark's dtype) and float32
MEGA_STAGES = [("stage2", 128, 512, 128, 28), ("stage3", 128, 1024, 256, 14),
               ("stage4", 128, 2048, 512, 7)]
MEGA_TILES = (1, 2, 4)
MEGA_BLOCKS = 8
MEGA_DTYPES = ("bf16", "f32")
# the kernel table's rows: stage 2 at the micro's tile 2, bfloat16
MEGA_MAIN_CASE = ("stage2", 2, "bf16")
# the sweep beyond the stages: (label, images, side, Cin, Cm, tile): the
# CPU tests' 6x6 shape at tile 1 and 2, a 1x1 image (every off-centre tap
# masked), 3x3 images, Cm 64 (which the reference's 128-lane rule cannot
# build), and groups of 200 rows (not a multiple of the 128-row tile)
# with an uneven Cm
MEGA_COVERAGE_CASES = [("cpu6x6t1", 4, 6, 256, 128, 1),
                       ("cpu6x6t2", 4, 6, 256, 128, 2),
                       ("img1x1", 8, 1, 64, 64, 4),
                       ("img3x3", 8, 3, 128, 64, 2),
                       ("cm64", 16, 14, 256, 64, 1),
                       ("g200", 4, 10, 96, 40, 2)]
# megakernel vs its plain twin (and vs the composed arms), float32: the
# same products summed in another order and renormalized by three ghost
# BNs; after one block max |diff| <= 1e-4 * max|twin| (an H100 run of
# this script: <= 1.72e-6, 7.8e-6 at 4-row groups), after L blocks the
# 2-norm of the difference <= 1e-3 of the output's
# (CHAIN_ONE_BLOCK_RTOL, CHAIN_NORM_RTOL). bfloat16, one block: both round the taps, h2 and y
# at the same points, but a value the two summation orders put on either
# side of a rounding boundary rounds one ulp apart, and the output's own
# rounding adds one more: 2 ulps of max|twin| (2 * 2^-7 * max). A wrong
# tap, mask or statistic moves either by O(1e-1) or more.
MEGA_BF16_RTOL = 2 * 2.0 ** -7
# bfloat16, after L blocks: each block's ghost BNs renormalize the
# one-ulp flips of the blocks before, so the kernel-vs-twin gap grows
# with depth, the more the smaller the group (an H100 run of this
# script: 1.611e-2 of the 2-norm at stage 4, tile 1, 49-row groups).
# Both are roundings of one float32 chain, so the kernel must sit closer
# to the twin than the twin sits to that chain (the same bfloat16 inputs
# and weights through the twin in float32): gap <= this factor times
# the twin's own rounding noise (H100 runs: gaps 0.63-0.81 of it; the
# two agree on most roundings, so they sit closer than two independent
# roundings would).
MEGA_BF16_NOISE_FACTOR = 1.0
# ghost BN with tile = N is full-batch BN: the kernel at batch 4 and
# stage-2 widths (tile 4, float32) against cuDNN + the port's batch_norm
MEGA_BATCH_BN_CASE = (4, 512, 128, 28)

# MNIST conv (models/mnist.py build_train(net="conv"), Adam lr 1e-3) at
# batch 64, 5 steps, card against the port's CPU path
MNIST_BATCH, MNIST_STEPS = 64, 5
# card vs CPU, float32: cuDNN and the CPU's convolutions sum in another
# order (~1e-6 relative). Losses within rtol 1e-4. Step-1 gradients are
# held per element (rtol 1e-4, atol 1e-5 * max|g|) against a CPU step
# whose ReLUs take the card's masks, which takes out the flips of ReLU
# inputs within rounding of 0 (each flips one unit's whole gradient for
# one image), and by 2-norm (TRAIN_GRAD_NORM_RTOL) against the free CPU
# step.
MNIST_LOSS_RTOL = 1e-4

# ResNet-50 as bench.py:221-226 runs it (BASELINE config 2): 1000 classes,
# 3x224x224, Momentum 0.9 at lr 0.1, batch 128 (bench.py:81), fp32 with
# TF32 off; 5 steps from seeded weights
RESNET_CFG = dict(class_dim=1000, depth=50, image_shape=(3, 224, 224),
                  lr=0.1)
RESNET_BATCH, RESNET_STEPS = 128, 5
# then 2 steps of the same program at batch 4 on the card and on the
# port's CPU path. Any two runs that round differently flip the ReLU
# inputs that lie within rounding of 0, and each flip moves the
# gradients upstream of it (an H100 run of this script: card vs free CPU
# step-1 gradients up to 3.5e-2 apart by 2-norm). So the step-1
# gradients are held by 2-norm (TRAIN_GRAD_NORM_RTOL) against a CPU step
# whose ReLUs take the card's masks; what the flips carry into the second
# step (its loss, every batch_norm's running statistics, the free CPU
# step's gradients) is held at RESNET_NOISE_FACTOR times how far the CPU
# arm moves from parameters one ulp away.
RESNET_CHECK_BATCH, RESNET_CHECK_STEPS = 4, 2
RESNET_NOISE_FACTOR = 10.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of fn() in ms (CUDA events around `iters` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the float32 products of the flash kernels on the tensor cores: three
# TF32 passes (3xTF32)
ATTN_PATH_RATE = TF32_FLOPS_PER_S / 3


def attention_bound(b, h, sq, sk, d, pairs, bias_numel,
                    rate=ATTN_PATH_RATE):
    """Least time for the forward on this card: bytes (q, k, v, bias read
    once; O, lse written once) over HBM rate vs the (q, k) pairs this
    data leaves in (see live_pairs) times 4*D flops, at `rate` FLOP/s
    (3xTF32 on the tensor cores by default; FP32_FLOPS_PER_S for the FMA
    units)."""
    nbytes = 4.0 * (2 * b * h * sq * d + 2 * b * h * sk * d + bias_numel
                    + b * h * sq)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4.0 * d * pairs / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def live_pairs(bias, b, h, sq, sk, causal):
    """(q, k) pairs the bias and causal mask leave in (masked pairs
    carry -1e9 or less: exp gives 0)."""
    import torch
    from paddle_tpu_torch.ops.kernels.flash_attention import _bias_4d
    live = torch.ones(1, 1, sq, sk, dtype=torch.bool, device="cuda")
    if bias is not None:
        live = live & (_bias_4d(bias) > -1e8)
    if causal:
        live = live & torch.ones(sq, sk, dtype=torch.bool,
                                 device="cuda").tril()
    return int(live.expand(b, h, sq, sk).sum().item())


def _fwd_err(got, want):
    """Largest |got - want| over (O, lse), and whether both are within
    allclose(rtol=KERNEL_RTOL, atol=KERNEL_ATOL)."""
    import torch
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    ok = all(torch.allclose(g, w, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
             for g, w in zip(got, want))
    return err, ok


def check_attention(card):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        NEG_INF, flash_attention_fwd, flash_attention_fwd_plain)
    b, h, d = 1, 8, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for label, s, live in ATTN_CASES:
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                   for _ in range(3))
        bias = torch.zeros(b, 1, 1, s, device="cuda")
        bias[..., live:] = -1e9
        err, ok = _fwd_err(flash_attention_fwd(q, k, v, bias, causal=True),
                           flash_attention_fwd_plain(q, k, v, bias,
                                                     causal=True))
        if not ok:
            raise SystemExit(f"flash_attention_fwd disagrees with its plain "
                             f"version at {label}: max abs err {err:.3e}")
        causal_mask = torch.full((s, s), NEG_INF, device="cuda").triu(1)
        lib_mask = (bias + causal_mask).contiguous()
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, bias, causal=True))
        plain_ms = cuda_ms(lambda: flash_attention_fwd_plain(
            q, k, v, bias, causal=True))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask))
        pairs = live_pairs(bias, b, h, s, s, True)
        bound_ms, bound_by = attention_bound(b, h, s, s, d, pairs,
                                             bias.numel())
        fma_ms, fma_by = attention_bound(b, h, s, s, d, pairs, bias.numel(),
                                         FP32_FLOPS_PER_S)
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, fma_bound_ms=fma_ms,
                           fma_bound_by=fma_by)
        print(f"[{card}] flash_attention_fwd B={b} H={h} S={s} D={d} "
              f"live={live} causal: max_abs_err={err:.3e} kernel_ms="
              f"{ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
              f"3xTF32) fma_bound_ms={fma_ms:.4f} ({fma_by})", flush=True)
    # the rest of what the wrapper accepts, for correctness only: every
    # head dim, Sq != Sk, a full and a head-broadcast bias, no bias
    coverage_err = 0.0
    for b, h, sq, sk, d, bias_shape, causal in COVERAGE_CASES:
        q = torch.randn(b, h, sq, d, device="cuda", generator=gen)
        k, v = (torch.randn(b, h, sk, d, device="cuda", generator=gen)
                for _ in range(2))
        bias = None if bias_shape is None else torch.randn(
            bias_shape, device="cuda", generator=gen)
        err, ok = _fwd_err(
            flash_attention_fwd(q, k, v, bias, causal=causal),
            flash_attention_fwd_plain(q, k, v, bias, causal=causal))
        if not ok:
            raise SystemExit(f"flash_attention_fwd disagrees with its plain "
                             f"version at B={b} H={h} Sq={sq} Sk={sk} D={d} "
                             f"bias={bias_shape} causal={causal}: {err:.3e}")
        coverage_err = max(coverage_err, err)
        print(f"flash_attention_fwd B={b} H={h} Sq={sq} Sk={sk} D={d} "
              f"bias={bias_shape} causal={causal}: max_abs_err={err:.3e}",
              flush=True)
    return rows, coverage_err


def attention_bwd_bound(b, h, sq, sk, d, pairs, bias_numel, n_out,
                        flops_per_pair, rate=ATTN_PATH_RATE):
    """Least time for one backward kernel on this card: bytes (q, k, v,
    dO, the bias, lse and delta read once; `n_out` [.., S, D] gradients
    written once) over HBM rate vs the (q, k) pairs this data leaves in
    times `flops_per_pair` (6*D for dq, 8*D for dk/dv) at `rate` FLOP/s
    (as attention_bound)."""
    nbytes = 4.0 * (2 * b * h * sq * d + 2 * b * h * sk * d + bias_numel
                    + 2 * b * h * sq + n_out * b * h * sk * d)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops_per_pair * pairs / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max_err(got, want):
    """Largest |got - want| over paired tensors, and whether every pair
    is within allclose(rtol=1e-4, atol=1e-4 * max|want|)."""
    import torch
    err, ok = 0.0, True
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        err = max(err, (g - w).abs().max().item())
        ok = ok and torch.allclose(
            g, w, rtol=KERNEL_RTOL,
            atol=KERNEL_ATOL * max(w.abs().max().item(), 1e-30))
    return err, ok


def check_attention_bwd(card):
    """The forward, dq and dk/dv kernels against their plain twins on
    the card at the training shapes (key-row mask and dense decoder
    bias), timed there; the backward kernels also over
    BWD_COVERAGE_CASES."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, s, d = TRAIN_ATTN
    rows = {}
    for label in ("keyrow", "dense"):
        q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                       for _ in range(4))
        if label == "keyrow":
            bias = torch.zeros(b, 1, 1, s, device="cuda")
        else:
            bias = torch.full((s, s), -1e9, device="cuda").triu(1)
            bias = bias.expand(b, 1, s, s).contiguous()
        pairs = live_pairs(bias, b, h, s, s, False)
        o, lse = fa.flash_attention_fwd(q, k, v, bias)
        err, ok = _fwd_err((o, lse), fa.flash_attention_fwd_plain(
            q, k, v, bias))
        if not ok:
            raise SystemExit(f"flash_attention_fwd disagrees with its plain "
                             f"version at B={b} H={h} S={s} D={d} {label} "
                             f"bias: max abs err {err:.3e}")
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, bias), iters=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, bias), iters=5)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias), iters=10)
        bound_ms, bound_by = attention_bound(b, h, s, s, d, pairs,
                                             bias.numel())
        fma_ms, fma_by = attention_bound(b, h, s, s, d, pairs, bias.numel(),
                                         FP32_FLOPS_PER_S)
        rows[("flash_attention_fwd", label)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            fma_bound_ms=fma_ms, fma_bound_by=fma_by)
        print(f"[{card}] flash_attention_fwd B={b} H={h} S={s} D={d} "
              f"{label} bias {tuple(bias.shape)}: max_abs_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
              f"3xTF32) fma_bound_ms={fma_ms:.4f} ({fma_by}; {pairs} live "
              f"pairs)", flush=True)
        delta = fa._delta(o, do).contiguous()
        args = (q, k, v, bias, do, lse, delta)
        dq_k, _ = fa.flash_attention_bwd_dq(*args)
        dq_p, _ = fa.flash_attention_bwd_dq_plain(*args)
        dkv_k = fa.flash_attention_bwd_dkv(*args)
        dkv_p = fa.flash_attention_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        lq, lk, lv = (t.clone().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias)
        for kname, got, want, plain_fn, kernel_fn, wrt, n_out, fpp in (
                ("flash_attention_bwd_dq", [dq_k], [dq_p],
                 fa.flash_attention_bwd_dq_plain,
                 fa.flash_attention_bwd_dq, (lq,), 1, 6 * d),
                ("flash_attention_bwd_dkv", list(dkv_k), list(dkv_p),
                 fa.flash_attention_bwd_dkv_plain,
                 fa.flash_attention_bwd_dkv, (lk, lv), 2, 8 * d)):
            err, ok = _max_err(got, want)
            if not ok:
                raise SystemExit(f"{kname} disagrees with its plain version "
                                 f"at B={b} H={h} S={s} D={d} {label} "
                                 f"bias: max abs err {err:.3e}")
            ms = cuda_ms(lambda: kernel_fn(*args), iters=10)
            plain_ms = cuda_ms(lambda: plain_fn(*args), iters=5)
            # PyTorch's attention backward computes dq, dk and dv in one
            # call, whichever it is asked for: the row's library time is
            # that whole call (see the backward total below)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                lib_out, wrt, do, retain_graph=True), iters=10)
            bound_ms, bound_by = attention_bwd_bound(
                b, h, s, s, d, pairs, bias.numel(), n_out, fpp)
            fma_ms, fma_by = attention_bwd_bound(
                b, h, s, s, d, pairs, bias.numel(), n_out, fpp,
                FP32_FLOPS_PER_S)
            rows[(kname, label)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                fma_bound_ms=fma_ms, fma_bound_by=fma_by)
            print(f"[{card}] {kname} B={b} H={h} S={s} D={d} {label} bias "
                  f"{tuple(bias.shape)}: max_abs_err={err:.3e} kernel_ms="
                  f"{ms:.4f} plain_ms={plain_ms:.4f} library_ms="
                  f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
                  f"3xTF32) fma_bound_ms={fma_ms:.4f} ({fma_by}; {pairs} "
                  f"live pairs)", flush=True)
        # the flash backward as a whole (both kernels; delta is a torch
        # reduction either way) against the one library call that computes
        # dq, dk and dv together
        total_ms = (rows[("flash_attention_bwd_dq", label)]["ms"]
                    + rows[("flash_attention_bwd_dkv", label)]["ms"])
        total_lib_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (lq, lk, lv), do, retain_graph=True), iters=10)
        rows[("flash_attention_bwd_dkv", label)].update(
            backward_total_ms=total_ms, backward_library_ms=total_lib_ms)
        print(f"[{card}] flash backward total B={b} H={h} S={s} D={d} "
              f"{label} bias: dq + dk/dv kernel_ms={total_ms:.4f} vs "
              f"library_ms={total_lib_ms:.4f} (one call for dq, dk, dv; "
              f"{total_ms / total_lib_ms:.2f}x)", flush=True)
        del lib_out, lq, lk, lv
    coverage_err = 0.0
    for b, h, sq, sk, d, bias_shape, causal, bias_grad in BWD_COVERAGE_CASES:
        q, do = (torch.randn(b, h, sq, d, device="cuda", generator=gen)
                 for _ in range(2))
        k, v = (torch.randn(b, h, sk, d, device="cuda", generator=gen)
                for _ in range(2))
        bias = None if bias_shape is None else torch.randn(
            bias_shape, device="cuda", generator=gen)
        o, lse = fa.flash_attention_fwd(q, k, v, bias, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, bias, o, lse, do, causal,
                                     None, bias_grad)
        want = fa.flash_attention_bwd_plain(q, k, v, bias, o, lse, do,
                                            causal, None, bias_grad)
        err, ok = _max_err(got, want)
        if not ok or (got[3] is None) != (want[3] is None):
            raise SystemExit(
                f"flash_attention_bwd disagrees with its plain version at "
                f"B={b} H={h} Sq={sq} Sk={sk} D={d} bias={bias_shape} "
                f"causal={causal} bias_grad={bias_grad}: {err:.3e}")
        coverage_err = max(coverage_err, err)
        print(f"flash_attention_bwd B={b} H={h} Sq={sq} Sk={sk} D={d} "
              f"bias={bias_shape} causal={causal} bias_grad={bias_grad}: "
              f"max_abs_err={err:.3e}", flush=True)
    return rows, coverage_err


def lm_lengths(seed=0):
    """The ragged lengths bench.py's varlen LSTM-LM feed draws: ids first,
    then LSTM_BATCH lengths in [T/2, T], from RandomState(seed)."""
    b, t = LSTM_BATCH, LSTM_T
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, LSTM_CFG["vocab_size"], (b, t, 1)).astype(np.int64)
    lens = rng.randint(t // 2, t + 1, (b,)).astype(np.int32)
    return ids, lens


def lstm_bound(t, b, h, lengths_sum, backward):
    """Least time for one fused-LSTM call on this card: 2*L*H*4H FLOP
    forward, 3x that backward (recompute, dh_prev, dW), L the sum of the
    lengths, over the fp32 rate; vs the bytes of its inputs read once and
    outputs written once over HBM rate."""
    fwd = 2.0 * lengths_sum * h * 4 * h
    bwd = 3.0 * fwd
    seq, state, x, w = t * b * h, b * h, t * b * 4 * h, h * 4 * h + 4 * h
    if backward:
        # in: x, w, b, h0, c0, lengths, h_all, c_all, dh_all, dc_all,
        # dh_last, dc_last; out: dx, dw, db, dh0, dc0
        nbytes, flops = 4.0 * (2 * x + 2 * w + 6 * state + b + 4 * seq), bwd
    else:
        # in: x, w, b, h0, c0, lengths; out: h_all, c_all, h_last, c_last
        nbytes, flops = 4.0 * (x + w + 4 * state + b + 2 * seq), fwd
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _lstm_inputs(gen, t, b, h, lens, state, cotangents):
    """Random fused-LSTM inputs on the card: x ~ 0.5 N(0,1), w ~ U(+-1/
    sqrt(H)); h0/c0 zero unless `state`; dh_all random, and dc_all,
    dh_last, dc_last random with `cotangents`, else None (the LM's
    Hidden-only cotangent)."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=DEVICE, generator=gen) * scale
    x = rnd(t, b, 4 * h, scale=0.5)
    w = (torch.rand(h, 4 * h, device=DEVICE, generator=gen) * 2 - 1) \
        / h ** 0.5
    bias = rnd(4 * h, scale=0.1)
    h0 = rnd(b, h, scale=0.5) if state else torch.zeros(b, h, device=DEVICE)
    c0 = rnd(b, h, scale=0.5) if state else torch.zeros(b, h, device=DEVICE)
    lengths = torch.as_tensor(np.asarray(lens, np.int32), device=DEVICE)
    dh_all = rnd(t, b, h)
    more = (rnd(t, b, h), rnd(b, h), rnd(b, h)) if cotangents else \
        (None, None, None)
    return (x, w, bias, h0, c0, lengths), (dh_all,) + more


def _lstm_errs(inputs, cts):
    """Kernel vs plain twin, forward and backward: (forward err, backward
    err, ok, forward outputs, {backward output: (max |err|, max |plain|)})."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_lstm as fl
    fwd_k = fl.fused_lstm_fwd(*inputs)
    fwd_p = fl.fused_lstm_fwd_plain(*inputs)
    bwd_k = fl.fused_lstm_bwd(*inputs, *fwd_k[:2], *cts)
    bwd_p = fl.fused_lstm_bwd_plain(*inputs, *fwd_p[:2], *cts)
    torch.cuda.synchronize()
    ferr, fok = _max_err(fwd_k, fwd_p)
    berr, bok = _max_err(bwd_k, bwd_p)
    per_grad = {n: ((k - p).abs().max().item(), p.abs().max().item())
                for n, k, p in zip(("dx", "dw", "db", "dh0", "dc0"), bwd_k,
                                   bwd_p)}
    return ferr, berr, fok and bok, fwd_k, per_grad


def lstm_library(inputs, cts):
    """The yardstick: torch.nn.LSTM (cuDNN) on the packed sequence, with
    W_ih the permutation of the identity that reorders the gates i, c_hat,
    f, o into PyTorch's i, f, g, o (so it also runs a 4H x 4H input
    product the kernel does not), W_hh and b_ih the reordered w and b,
    b_hh 0. Returns (forward fn, backward fn, max |h_all - kernel's|)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence
    from paddle_tpu_torch.ops.kernels.fused_lstm import fused_lstm_fwd
    x, w, bias, h0, c0, lengths = inputs
    t, b, g = x.shape
    h = g // 4
    order = torch.cat([torch.arange(0, h), torch.arange(2 * h, 3 * h),
                       torch.arange(h, 2 * h), torch.arange(3 * h, 4 * h)]
                      ).to(DEVICE)
    lstm = torch.nn.LSTM(g, h).to(DEVICE)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(g, device=DEVICE)[order])
        lstm.weight_hh_l0.copy_(w.t()[order])
        lstm.bias_ih_l0.copy_(bias[order])
        lstm.bias_hh_l0.zero_()
    xl = x.clone().requires_grad_(True)
    lens_cpu = lengths.cpu().long()

    def fwd():
        packed = pack_padded_sequence(xl, lens_cpu, enforce_sorted=False)
        out, _ = lstm(packed, (h0[None], c0[None]))
        return pad_packed_sequence(out, total_length=t)[0]

    out = fwd()
    err = (out - fused_lstm_fwd(*inputs)[0]).abs().max().item()
    wrt = (xl,) + tuple(lstm.parameters())

    def bwd():
        return torch.autograd.grad(out, wrt, cts[0], retain_graph=True)
    return fwd, bwd, err


def check_lstm(card):
    """The fused-LSTM forward and backward kernels against their plain
    twins on the card at the LM's shape (T64 B64 H512, the bench.py
    ragged lengths and full lengths), timed there with the cuDNN
    yardstick and the bound; then over LSTM_COVERAGE_CASES."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_lstm as fl
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    t, b, h = LSTM_T, LSTM_BATCH, LSTM_CFG["hid_dim"]
    rows = {}
    for label in ("ragged", "full"):
        lens = lm_lengths()[1] if label == "ragged" else np.full(b, t)
        inputs, cts = _lstm_inputs(gen, t, b, h, lens, False, False)
        ferr, berr, ok, outs, per_grad = _lstm_errs(inputs, cts)
        if not ok:
            raise SystemExit(f"fused LSTM kernels disagree with their plain "
                             f"twins at T={t} B={b} H={h} {label}: forward "
                             f"{ferr:.3e}, backward {berr:.3e}")
        print("fused_lstm_bwd vs plain, max |err| (max |plain|): " + ", ".join(
            f"{n} {e:.3e} ({m:.3e})" for n, (e, m) in per_grad.items()),
            flush=True)
        lib_fwd, lib_bwd, lib_err = lstm_library(inputs, cts)
        if lib_err > LSTM_LIBRARY_ATOL:
            raise SystemExit(f"the cuDNN yardstick computes another function"
                             f": max |h_all diff| {lib_err:.3e}")
        l_sum = int(np.sum(lens))
        fwd_args = inputs
        bwd_args = inputs + tuple(outs[:2]) + cts
        times = {
            "fused_lstm_fwd": (
                cuda_ms(lambda: fl.fused_lstm_fwd(*fwd_args), iters=10),
                cuda_ms(lambda: fl.fused_lstm_fwd_plain(*fwd_args), iters=5),
                cuda_ms(lib_fwd, iters=10), ferr, False),
            "fused_lstm_bwd": (
                cuda_ms(lambda: fl.fused_lstm_bwd(*bwd_args), iters=10),
                cuda_ms(lambda: fl.fused_lstm_bwd_plain(*bwd_args), iters=5),
                cuda_ms(lib_bwd, iters=10), berr, True)}
        for name, (ms, plain_ms, library_ms, err, bwd) in times.items():
            bound_ms, bound_by = lstm_bound(t, b, h, l_sum, bwd)
            rows[(name, label)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            print(f"[{card}] {name} T={t} B={b} H={h} {label} lengths (sum "
                  f"{l_sum}): max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
        print(f"cuDNN yardstick vs kernel h_all: max_abs_err={lib_err:.3e}",
              flush=True)
    coverage_err = {"fused_lstm_fwd": 0.0, "fused_lstm_bwd": 0.0}
    for t, b, h, lens, state, cotangents in LSTM_COVERAGE_CASES:
        inputs, cts = _lstm_inputs(gen, t, b, h, lens, state, cotangents)
        ferr, berr, ok, _, _ = _lstm_errs(inputs, cts)
        if not ok:
            raise SystemExit(f"fused LSTM kernels disagree with their plain "
                             f"twins at T={t} B={b} H={h} lengths={lens} "
                             f"h0/c0={state} last-state cotangents="
                             f"{cotangents}: {ferr:.3e} / {berr:.3e}")
        coverage_err["fused_lstm_fwd"] = max(coverage_err["fused_lstm_fwd"],
                                             ferr)
        coverage_err["fused_lstm_bwd"] = max(coverage_err["fused_lstm_bwd"],
                                             berr)
        print(f"fused_lstm T={t} B={b} H={h} lengths={list(lens)} h0/c0="
              f"{state} cotangents={cotangents}: max_abs_err forward "
              f"{ferr:.3e}, backward {berr:.3e}", flush=True)
    return rows, coverage_err


def gru_lengths(seed=0):
    """The book model's feed as phase 6 draws it from RandomState(seed):
    source ids, target ids, label ids [GRU_BATCH, GRU_T, 1] (ids in
    [1, dict)), then source and target lengths in [GRU_MIN_LEN, GRU_T]."""
    b, t, v = GRU_BATCH, GRU_T, GRU_NMT_CFG["dict_size"]
    rng = np.random.RandomState(seed)
    ids = [rng.randint(1, v, (b, t, 1)).astype(np.int64) for _ in range(3)]
    src_lens = rng.randint(GRU_MIN_LEN, t + 1, (b,)).astype(np.int32)
    trg_lens = rng.randint(GRU_MIN_LEN, t + 1, (b,)).astype(np.int32)
    return ids, src_lens, trg_lens


def gru_bound(t, b, h, lengths_sum, backward):
    """Least time for one fused-GRU call on this card: 2*L*H*3H FLOP
    forward; 2x that backward, which reads the forward's saved gates and
    so recomputes nothing (d_rh = dc W_c^T, [du, dr] W_ur^T, dW_ur, dW_c:
    2*L*H*6H), L the sum of the lengths, over the fp32 rate; vs the bytes
    of the function's inputs read once and outputs written once over HBM
    rate."""
    fwd = 2.0 * lengths_sum * h * 3 * h
    seq, state, g3, w = t * b * h, b * h, t * b * 3 * h, h * 3 * h
    if backward:
        # in: gates, w, h0, lengths, h_all, dh_all, dh_last;
        # out: dx, dw, dh0
        nbytes, flops = 4.0 * (2 * g3 + 2 * w + 3 * state + b + 2 * seq), \
            2.0 * fwd
    else:
        # in: x, w, h0, lengths; out: h_all, h_last
        nbytes, flops = 4.0 * (g3 + w + 2 * state + b + seq), fwd
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _gru_inputs(gen, t, b, h, lens, state, last_cotangent):
    """Random fused-GRU inputs on the card: x ~ 0.5 N(0,1), w ~ U(+-1/
    sqrt(H)); h0 zero unless `state`; dh_all random, dh_last random with
    `last_cotangent`, else None (the book model's Hidden-only
    cotangent)."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=DEVICE, generator=gen) * scale
    x = rnd(t, b, 3 * h, scale=0.5)
    w = (torch.rand(h, 3 * h, device=DEVICE, generator=gen) * 2 - 1) \
        / h ** 0.5
    h0 = rnd(b, h, scale=0.5) if state else torch.zeros(b, h, device=DEVICE)
    lengths = torch.as_tensor(np.asarray(lens, np.int32), device=DEVICE)
    return (x, w, h0, lengths), (rnd(t, b, h),
                                 rnd(b, h) if last_cotangent else None)


def _gru_errs(inputs, cts):
    """Kernel vs plain twin, forward and backward: (forward max |err|,
    backward max |err|, ok, kernel forward outputs, {backward output:
    (max |err|, max |plain|)}). The forward is held at GRU_FWD_ATOL
    absolute (h_all, h_last, gates); the backward per output at rtol
    KERNEL_RTOL, atol KERNEL_ATOL * max|plain|. Each backward reads the
    kernel forward's h_all and gates."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_gru as fg
    fwd_k = fg.fused_gru_fwd(*inputs)
    fwd_p = fg.fused_gru_fwd_plain(*inputs)
    saved = (fwd_k[0], fwd_k[2])
    bwd_k = fg.fused_gru_bwd(*inputs[1:], *saved, *cts)
    bwd_p = fg.fused_gru_bwd_plain(*inputs[1:], *saved, *cts)
    torch.cuda.synchronize()
    ferr = max((k - p).abs().max().item() for k, p in zip(fwd_k, fwd_p))
    berr, bok = _max_err(bwd_k, bwd_p)
    per_grad = {n: ((k - p).abs().max().item(), p.abs().max().item())
                for n, k, p in zip(("dx", "dw", "dh0"), bwd_k, bwd_p)}
    return ferr, berr, ferr <= GRU_FWD_ATOL and bok, fwd_k, per_grad


def gru_yardstick(inputs, cts):
    """torch.nn.GRU (cuDNN) at the kernel's shape, as a same-FLOP
    yardstick only: no PyTorch call computes the kernel's function,
    because torch.nn.GRU applies the reset gate after the recurrent
    product (r * (W_hn h + b_hn)), where the reference's GRU multiplies
    (r * h) by W_c. Input size 1, so that its recurrent products (2 H 3H
    FLOP a row and step, as the kernel's) carry the work, on the packed
    sequence with the kernel's lengths and h0. Returns (forward fn,
    backward fn)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence
    x, w, h0, lengths = inputs
    t, b, g = x.shape
    h = g // 3
    gru = torch.nn.GRU(1, h).to(DEVICE)
    xl = torch.zeros(t, b, 1, device=DEVICE).normal_().requires_grad_(True)
    lens_cpu = lengths.cpu().long().clamp(min=1)

    def fwd():
        packed = pack_padded_sequence(xl, lens_cpu, enforce_sorted=False)
        out, _ = gru(packed, h0[None])
        return pad_packed_sequence(out, total_length=t)[0]

    out = fwd()
    wrt = (xl,) + tuple(gru.parameters())

    def bwd():
        return torch.autograd.grad(out, wrt, cts[0], retain_graph=True)
    return fwd, bwd


def gru_device_ms(fn, iters=5):
    """Device ms per call of each fused-GRU kernel that fn launches (keys
    of GRU_KERNELS), from one torch.profiler pass over `iters` calls after
    a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {part: sum(ms for name, ms, _ in device_kernels(prof)
                      if frag in name) / iters
            for part, frag in GRU_KERNELS.items()}


def check_gru(card):
    """The fused-GRU forward and backward kernels against their plain
    twins on the card at the book model's shape (T80 B64 H512, the phase-6
    source lengths, and full lengths), each run twice (bitwise equal),
    timed there beside the per-step kernels' times, the nn.GRU
    yardstick, the bound, the barrier floor (the same grid through the
    same barriers with no products) and the backward's recurrence and dW
    reduction apart; then over GRU_COVERAGE_CASES."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_gru as fg
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    t, b, h = GRU_T, GRU_BATCH, GRU_NMT_CFG["hid_dim"]
    rows = {}
    for label in ("ragged", "full"):
        lens = gru_lengths()[1] if label == "ragged" else np.full(b, t)
        inputs, cts = _gru_inputs(gen, t, b, h, lens, False, False)
        ferr, berr, ok, outs, per_grad = _gru_errs(inputs, cts)
        print("fused_gru vs plain, forward max |err| " + f"{ferr:.3e}; "
              "backward max |err| (max |plain|): " + ", ".join(
                  f"{n} {e:.3e} ({m:.3e})" for n, (e, m) in per_grad.items()),
              flush=True)
        if not ok:
            raise SystemExit(f"fused GRU kernels disagree with their plain "
                             f"twins at T={t} B={b} H={h} {label}: forward "
                             f"{ferr:.3e}, backward {berr:.3e}")
        bwd_args = inputs[1:] + (outs[0], outs[2]) + cts
        reruns = [fg.fused_gru_fwd(*inputs) + fg.fused_gru_bwd(*bwd_args)
                  for _ in range(2)]
        if not all(torch.equal(x, y) for x, y in zip(*reruns)):
            raise SystemExit(f"fused GRU kernels: a rerun at T={t} B={b} "
                             f"H={h} {label} is not bitwise equal")
        yard_fwd, yard_bwd = gru_yardstick(inputs, cts)
        l_sum = int(np.sum(lens))
        times = {
            "fused_gru_fwd": (
                cuda_ms(lambda: fg.fused_gru_fwd(*inputs), iters=10),
                cuda_ms(lambda: fg.fused_gru_fwd_plain(*inputs), iters=5),
                cuda_ms(yard_fwd, iters=10), ferr, False),
            "fused_gru_bwd": (
                cuda_ms(lambda: fg.fused_gru_bwd(*bwd_args), iters=10),
                cuda_ms(lambda: fg.fused_gru_bwd_plain(*bwd_args), iters=5),
                cuda_ms(yard_bwd, iters=10), berr, True)}
        parts = gru_device_ms(lambda: fg.fused_gru_bwd(*bwd_args))
        for name, (ms, plain_ms, yard_ms, err, bwd) in times.items():
            bound_ms, bound_by = gru_bound(t, b, h, l_sum, bwd)
            plan = fg.barrier_floor(t, b, h, bwd, DEVICE)
            floor_ms = cuda_ms(
                lambda: fg.barrier_floor(t, b, h, bwd, DEVICE), iters=10)
            rows[(name, label)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                yardstick_ms=yard_ms, bound_ms=bound_ms, bound_by=bound_by,
                barrier_floor_ms=floor_ms,
                plan=plan, **({"recurrence_device_ms":
                               parts["backward recurrence"],
                               "dw_device_ms": parts["dW"]} if bwd else {}))
            print(f"[{card}] {name} T={t} B={b} H={h} {label} lengths (sum "
                  f"{l_sum}): max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                  f"(per-step kernels: {GRU_PER_STEP_MS[(name, label)]}) "
                  f"plain_ms={plain_ms:.4f} nn.GRU yardstick_ms="
                  f"{yard_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"barrier_floor_ms={floor_ms:.4f} ({plan['barriers']} "
                  "barriers)" + (f" recurrence_device_ms="
                                 f"{parts['backward recurrence']:.4f} "
                                 f"dw_device_ms={parts['dW']:.4f}"
                                 if bwd else ""), flush=True)
            print(f"  plan: {plan}", flush=True)
    coverage_err = {"fused_gru_fwd": 0.0, "fused_gru_bwd": 0.0}
    for t, b, h, lens, state, last in GRU_COVERAGE_CASES:
        inputs, cts = _gru_inputs(gen, t, b, h, lens, state, last)
        ferr, berr, ok, outs, _ = _gru_errs(inputs, cts)
        zero = [i for i, n in enumerate(lens) if n == 0]
        if zero and not torch.equal(outs[1][zero], inputs[2][zero]):
            raise SystemExit(f"fused_gru_fwd: h_last of a zero-length row "
                             f"is not its h0 at T={t} B={b} H={h}")
        if not ok:
            raise SystemExit(f"fused GRU kernels disagree with their plain "
                             f"twins at T={t} B={b} H={h} lengths={lens} "
                             f"h0={state} h_last cotangent={last}: "
                             f"{ferr:.3e} / {berr:.3e}")
        coverage_err["fused_gru_fwd"] = max(coverage_err["fused_gru_fwd"],
                                            ferr)
        coverage_err["fused_gru_bwd"] = max(coverage_err["fused_gru_bwd"],
                                            berr)
        print(f"fused_gru T={t} B={b} H={h} lengths={list(lens)[:8]}... "
              f"h0={state} h_last cotangent={last}: max_abs_err forward "
              f"{ferr:.3e}, backward {berr:.3e}", flush=True)
    return rows, coverage_err


def conv_bound(m, k_rows, c, n, dtype, rate):
    """Least time of one fused conv on this card: bytes (x [M, C], w
    [K', N] in dtype, the stats [2, N] float32, each read or written once,
    out [M, N] in dtype written once) over HBM rate vs 2*M*K'*N operations
    at `rate` FLOP/s."""
    size = 2 if dtype == "bf16" else 4
    t_bytes = ((m * c + m * n + k_rows * n) * size + 2 * n * 4) \
        / HBM_BYTES_PER_S
    t_ops = 2.0 * m * k_rows * n / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def conv_path_rate(dtype):
    """The FLOP/s of the kernels' products on the tensor cores: bfloat16
    in one pass; float32 as three TF32 passes (3xTF32)."""
    return BF16_FLOPS_PER_S if dtype == "bf16" else TF32_FLOPS_PER_S / 3


def _conv_case(gen, kind, m, c, n, variant, dtype):
    """Inputs of one fused-conv call: x [M, C], w [K', N] (scaled to keep
    outputs O(1)) in dtype, and a, b [C] float32 when the variant has the
    affine."""
    import torch
    affine = variant[0]
    k_rows = c if kind == "1x1" else 9 * c
    dt = _torch_dtype(dtype)
    x = torch.randn(m, c, device=DEVICE, generator=gen).to(dt)
    w = (torch.randn(k_rows, n, device=DEVICE, generator=gen)
         / k_rows ** 0.5).to(dt)
    a = b = None
    if affine:
        a = torch.rand(c, device=DEVICE, generator=gen) + 0.5
        b = torch.randn(c, device=DEVICE, generator=gen) * 0.5
    return x, w, a, b


def bf16_ulp(v):
    """The spacing of bfloat16 values at |v| (0 at 0), float32."""
    import torch
    mant, exp = torch.frexp(v.float())
    return torch.where(mant == 0, torch.zeros_like(mant),
                       torch.ldexp(torch.ones_like(mant), exp - 8))


def _conv_errs(kind, args, img, variant):
    """(worst absolute output error, output error against the limit's
    scale, statistics error over their sum of |terms|, ok) of one kernel
    call against its plain twin. float32: outputs over max(|plain|, 1).
    bfloat16: per element (|kernel - plain| - one bf16 ulp at the larger
    of the two) over that element's sum of |terms|, since both round
    float32 sums of the same products, taken in another order."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_conv as fc
    x, w, a, b = args
    _, relu, stats = variant
    act = fc._prologue(x, a, b, relu)   # as the twin rounds it, float32
    if kind == "1x1":
        got = fc.conv1x1_bn_act(x, w, a, b, relu, stats)
        want = fc.conv1x1_bn_act_plain(x, w, a, b, relu, stats)
        ref32 = act @ w.float()
    else:
        got = fc.conv3x3_bn_act(x, w, *img, a, b, relu, stats)
        want = fc.conv3x3_bn_act_plain(x, w, *img, a, b, relu, stats)
        ref32 = fc.conv3x3_bn_act_plain(act, w.float(), *img,
                                        stats=False)[0]
    torch.cuda.synchronize()
    if got[0].dtype != x.dtype:
        return float("inf"), float("inf"), float("inf"), False
    diff = (got[0].float() - want[0].float()).abs()
    abs_err = float(diff.max())
    if x.dtype == torch.float32:
        out_err = abs_err / max(float(want[0].abs().max()), 1.0)
    else:
        if kind == "1x1":
            terms = act.abs() @ w.float().abs()
        else:
            terms = fc.conv3x3_bn_act_plain(act.abs(), w.float().abs(),
                                            *img, stats=False)[0]
        over = diff - bf16_ulp(torch.maximum(got[0].float().abs(),
                                             want[0].float().abs()))
        out_err = float((over / terms.clamp_min(1e-30)).max())
    ok = out_err <= CONV_OUT_RTOL
    stats_err = 0.0
    if stats:
        terms = torch.stack([ref32.abs().sum(0), (ref32 * ref32).sum(0)])
        stats_err = float((got[1] - want[1]).abs().max()) / float(
            terms.max())
        ok = ok and stats_err <= CONV_STATS_RTOL
    elif got[1] is not None:
        ok = False
    return abs_err, out_err, stats_err, ok


def conv_device_ms(fn, iters=5):
    """Device ms per call of each kernel that fn launches (the weight
    pack, the main kernel, the statistics reduction), from one
    torch.profiler pass over `iters` calls after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, ms, _ in device_kernels(prof):
        short = next((k for k in ("pack_w_kernel", "fused_conv_tc_kernel",
                                  "stats_reduce_kernel") if k in name),
                     name[:48])
        out[short] = out.get(short, 0.0) + ms / iters
    return out


def check_fused_conv(card):
    """The fused conv + BN kernels against their plain twins on the card,
    in float32 (3xTF32) and bfloat16: at the eight 1x1 and four 3x3
    shapes of the ResNet-50 bottleneck chain (batch 128) and
    CONV_COVERAGE_CASES, each over CONV_VARIANTS; timed at every chain
    shape in the bare variant (kernel, plain, the one PyTorch call
    computing the same function in the same dtype: torch.matmul for 1x1,
    F.conv2d on the channels_last view with padding 1 for 3x3) and in the
    full variant (kernel), with the bound on the kernels' own rate (the
    tensor cores) and on the FMA rate of the earlier SIMT kernel."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import fused_conv as fc
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    cases = []
    for label, imgs, big, small, side in CONV_CHAIN:
        m = imgs * side * side
        cases += [("1x1", f"{label} {big}->{small}", m, big, small, None),
                  ("1x1", f"{label} {small}->{big}", m, small, big, None),
                  ("3x3", f"{label} {small}->{small}", m, small, small,
                   (imgs, side, side))]
    for label, imgs, h, w_, c, n in CONV_COVERAGE_CASES:
        cases += [("1x1", f"{label} {c}->{n}", imgs * h * w_, c, n, None),
                  ("3x3", f"{label} {c}->{n} @{h}x{w_}", imgs * h * w_, c,
                   n, (imgs, h, w_))]
    # per kernel and dtype: worst absolute output error, output error
    # against the limit's scale, relative statistics error
    rows = {}
    worst = {(name, dtype): [0.0, 0.0, 0.0]
             for name in ("fused_conv1x1", "fused_conv3x3")
             for dtype in CONV_DTYPES}
    for dtype in CONV_DTYPES:
        dt = _torch_dtype(dtype)
        for kind, label, m, c, n, img in cases:
            name = "fused_conv1x1" if kind == "1x1" else "fused_conv3x3"
            hw = None if img is None else img[1:]
            for variant in CONV_VARIANTS:
                args = _conv_case(gen, kind, m, c, n, variant, dtype)
                errs = _conv_errs(kind, args, hw, variant)
                key = (name, dtype)
                worst[key] = [max(w, e) for w, e in zip(worst[key], errs)]
                _, out_err, stats_err, ok = errs
                if not ok:
                    raise SystemExit(
                        f"{name} {dtype} disagrees with its plain twin at "
                        f"{label} (M {m}) affine/relu/stats {variant}: "
                        f"outputs {out_err:.3e}, statistics "
                        f"{stats_err:.3e} of sum |terms| (limits "
                        f"{CONV_OUT_RTOL:.0e}, {CONV_STATS_RTOL:.0e})")
            if not label.startswith("bneck"):
                print(f"{name} {dtype} {label} (M {m}): all "
                      f"{len(CONV_VARIANTS)} variants equal the plain twin",
                      flush=True)
                continue
            x, w, _, _ = _conv_case(gen, kind, m, c, n, (False,) * 3, dtype)
            xa, wa, a, b = _conv_case(gen, kind, m, c, n, (True,) * 3,
                                      dtype)
            if kind == "1x1":
                def kern():
                    return fc.conv1x1_bn_act(x, w, stats=False)

                def full():
                    return fc.conv1x1_bn_act(xa, wa, a, b, True, True)

                def plain():
                    return fc.conv1x1_bn_act_plain(x, w, stats=False)

                def library():
                    return torch.matmul(x, w)
                k_rows = c
            else:
                w_oihw = w.reshape(3, 3, c, n).permute(3, 2, 0, 1) \
                    .contiguous(memory_format=torch.channels_last)
                x_nhwc = x.reshape(img[0], img[1], img[2], c).permute(
                    0, 3, 1, 2)

                def kern():
                    return fc.conv3x3_bn_act(x, w, *hw, stats=False)

                def full():
                    return fc.conv3x3_bn_act(xa, wa, *hw, a, b, True, True)

                def plain():
                    return fc.conv3x3_bn_act_plain(x, w, *hw, stats=False)

                def library():
                    return F.conv2d(x_nhwc, w_oihw, padding=1)
                k_rows = 9 * c
            lib_out = library()
            if kind == "3x3":
                lib_out = lib_out.permute(0, 2, 3, 1).reshape(m, n)
            ref = plain()[0].float()
            lib_err = float((lib_out.float() - ref).abs().max())
            # the yardstick rounds its output to dtype too
            lib_tol = CONV_OUT_RTOL * max(float(ref.abs().max()), 1) + (
                float(bf16_ulp(ref.abs().max())) if dt == torch.bfloat16
                else 0.0)
            if lib_err > lib_tol:
                raise SystemExit(f"the {dtype} yardstick of {label} does "
                                 f"not compute the kernel's function: "
                                 f"{lib_err:.3e}")
            bound_ms, bound_by = conv_bound(m, k_rows, c, n, dtype,
                                            conv_path_rate(dtype))
            fma_ms, fma_by = conv_bound(m, k_rows, c, n, dtype,
                                        FP32_FLOPS_PER_S)
            row = dict(ms=cuda_ms(kern, iters=10),
                       full_ms=cuda_ms(full, iters=10),
                       plain_ms=cuda_ms(plain, iters=5),
                       library_ms=cuda_ms(library, iters=10),
                       bound_ms=bound_ms, bound_by=bound_by,
                       fma_bound_ms=fma_ms, fma_bound_by=fma_by,
                       device_ms=conv_device_ms(kern),
                       full_device_ms=conv_device_ms(full),
                       dtype=dtype, m=m, c=c, n=n)
            rows[(name, f"{label} {dtype}")] = row
            print(f"[{card}] {name} {dtype} {label} (M {m}): kernel_ms="
                  f"{row['ms']:.4f} (with affine+ReLU+stats "
                  f"{row['full_ms']:.4f}) plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} bound_ms="
                  f"{bound_ms:.4f} ({bound_by} on the tensor cores; kernel "
                  f"at {100 * bound_ms / row['ms']:.1f}% of it; FMA-rate "
                  f"bound {fma_ms:.4f}, {fma_by}); device ms per kernel "
                  + ", ".join(f"{k} {v:.4f}" for k, v in
                              row["device_ms"].items())
                  + "; full " + ", ".join(
                      f"{k} {v:.4f}" for k, v in
                      row["full_device_ms"].items()), flush=True)
    print(f"fused conv kernels vs plain twins over {len(cases)} shapes x "
          f"{len(CONV_VARIANTS)} variants x {len(CONV_DTYPES)} dtypes: worst "
          "outputs (absolute, against the limit's scale) / statistics "
          "(relative to sum |terms|) "
          + ", ".join(f"{n} {d} {a:.3e}, {o:.3e} / {st:.3e}"
                      for (n, d), (a, o, st) in worst.items()), flush=True)
    return rows, worst


def seeded_weights(startup, seed):
    """numpy values for every variable a startup program initializes
    (KV caches aside), drawn from `seed` with the distribution its init
    op names."""
    rng = np.random.RandomState(seed)
    out = {}
    for op in startup.desc.global_block.ops:
        name = op.output("Out")[0]
        if name.startswith("kv_cache."):
            continue
        shape = op.attrs["shape"]
        if op.type == "uniform_random":
            out[name] = rng.uniform(op.attrs["min"], op.attrs["max"],
                                    shape).astype(np.float32)
        elif op.type == "gaussian_random":
            out[name] = rng.normal(op.attrs["mean"], op.attrs["std"],
                                   shape).astype(np.float32)
        elif op.type == "fill_constant":
            out[name] = np.full(shape, op.attrs["value"], np.float32)
        else:
            raise SystemExit(f"unexpected startup op {op.type}")
    return out


def serve(engine_model, prompts):
    from paddle_tpu_torch.serving.generation import GenerationConfig
    eng = engine_model.serve(
        config=GenerationConfig(max_new_tokens=MAX_NEW_TOKENS)).start()
    try:
        futs = [eng.submit(p) for p in prompts]
        results = [f.result(timeout=900) for f in futs]
    finally:
        eng.stop(timeout=900)
    for i, r in enumerate(results):
        if r.finish_reason not in ("eos", "max_tokens", "length"):
            raise SystemExit(f"request {i} ended {r.finish_reason!r}: "
                             f"{eng.last_error!r}")
    return results


def cpu_logits(cpu_model, prefix):
    """The CPU model's next-token logits after `prefix` (full program)."""
    from paddle_tpu_torch.serving.generation import bucket_for
    spec = cpu_model.spec
    bucket = bucket_for(len(prefix), spec.prompt_buckets)
    ids = np.zeros((spec.slots, bucket, 1), np.int64)
    ids[0, :len(prefix), 0] = prefix
    lengths = np.ones(spec.slots, np.int64)
    lengths[0] = len(prefix)
    lm = cpu_model.programs["full"][bucket]
    logits = cpu_model.run(lm, {"token_ids": ids, "lengths": lengths},
                           ["lm_head.tmp_1"])[0]
    return logits[0, len(prefix) - 1]


def compare_streams(prompts, gpu_res, cpu_res, cpu_model):
    for i, (p, g, c) in enumerate(zip(prompts, gpu_res, cpu_res)):
        if g.tokens == c.tokens:
            if g.finish_reason != c.finish_reason:
                raise SystemExit(f"request {i}: same tokens, finish "
                                 f"{g.finish_reason} vs {c.finish_reason}")
            continue
        j = next((t for t, (a, b) in enumerate(zip(g.tokens, c.tokens))
                  if a != b), min(len(g.tokens), len(c.tokens)))
        if j >= min(len(g.tokens), len(c.tokens)):
            raise SystemExit(f"request {i}: streams of different length "
                             f"agree up to {j}")
        logits = cpu_logits(cpu_model, list(p) + c.tokens[:j])
        top2 = np.argsort(logits)[::-1][:2]
        margin = float(logits[top2[0]] - logits[top2[1]])
        print(f"request {i}: GPU and CPU streams part at token {j} "
              f"(GPU {g.tokens[j]}, CPU {c.tokens[j]}); CPU top-2 "
              f"{top2.tolist()} margin {margin:.3e}", flush=True)
        if g.tokens[j] not in top2.tolist() or margin >= TIE_MARGIN:
            raise SystemExit(f"request {i}: divergence at token {j} is "
                             f"not a near tie (margin {margin:.3e} >= "
                             f"{TIE_MARGIN})")


def time_serving(model, card):
    """Prefill ms per prompt bucket and decode tokens/s per cache bucket
    (host clock; each call returns host tokens, so it ends synchronized)."""
    rng = np.random.RandomState(2)
    spec = model.spec
    out = {"prefill_ms": {}, "decode_tokens_per_s": {}}
    for bucket in spec.prompt_buckets:
        prompt = rng.randint(1, spec.vocab_size, bucket).tolist()
        model.run_prefill(prompt, 0)
        t0 = time.perf_counter()
        for _ in range(5):
            model.run_prefill(prompt, 0)
        out["prefill_ms"][bucket] = (time.perf_counter() - t0) / 5 * 1e3
    tokens = rng.randint(1, spec.vocab_size, spec.slots).astype(np.int64)
    for bucket in spec.cache_buckets:
        positions = np.full(spec.slots, bucket - 1, np.int64)
        model.run_decode(tokens, positions, bucket)
        t0 = time.perf_counter()
        for _ in range(10):
            model.run_decode(tokens, positions, bucket)
        step_s = (time.perf_counter() - t0) / 10
        out["decode_tokens_per_s"][bucket] = spec.slots / step_s
    for bucket, ms in out["prefill_ms"].items():
        print(f"[{card}] prefill bucket {bucket}: {ms:.3f} ms", flush=True)
    for bucket, tps in out["decode_tokens_per_s"].items():
        print(f"[{card}] decode cache bucket {bucket}, {spec.slots} slots: "
              f"{tps:.1f} tokens/s", flush=True)
    return out


def _stamp_naive(main):
    """use_flash=False on every attention op and on the fwd_op copy each
    __vjp__ took at append_backward time."""
    for op in main.desc.global_block.ops:
        if op.type == "scaled_dot_product_attention":
            op.attrs["use_flash"] = False
        elif op.type == "__vjp__" and \
                op.attrs["fwd_op"]["type"] == "scaled_dot_product_attention":
            op.attrs["fwd_op"]["attrs"]["use_flash"] = False
    main.desc._bump_version()


def train_arm(main, startup, loss, weights, feed, params, card, label):
    """TRAIN_STEPS Adam steps from `weights` in a fresh scope; the first
    also fetches every parameter's gradient and the sign of every ReLU
    input. Each step's time is a host clock around Executor.run, which
    ends synchronized (it returns the fetches as numpy)."""
    import torch
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    exe, scope = Executor(), Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, weights)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    relu_in = [op.input("X")[0] for op in main.desc.global_block.ops
               if op.type == "relu"]
    losses, step_ms, peaks, grads, signs = [], [], [], None, None
    for step in range(TRAIN_STEPS):
        fetch = [loss.name] + ([p + "@GRAD" for p in params] + relu_in
                               if step == 0 else [])
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated())
        losses.append(float(out[0].reshape(-1)[0]))
        if step == 0:
            grads = dict(zip(params, out[1:1 + len(params)]))
            signs = {n: x > 0 for n, x in zip(relu_in,
                                               out[1 + len(params):])}
        if not np.isfinite(losses[-1]):
            raise SystemExit(f"{label} arm: loss {losses[-1]} at step {step}")
        print(f"[{card}] train {label} step {step}: loss {losses[-1]:.6f} "
              f"{step_ms[-1]:.1f} ms peak {peaks[-1] / 2**30:.2f} GiB",
              flush=True)
    return dict(losses=losses, step_ms=step_ms, peak_bytes=max(peaks),
                grads=grads, relu_signs=signs)


def pinned_relu_grads(main, startup, loss, weights, feed, params, signs,
                      device=None):
    """One step from `weights` on `device` whose ReLUs pass exactly where
    `signs` (ReLU input name -> bool array) says, in the forward and in
    its __vjp__ replay alike; returns every parameter's gradient."""
    import torch
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    from paddle_tpu_torch.core.registry import OpRegistry
    device = DEVICE if device is None else device
    masks = {n: torch.from_numpy(m).to(device) for n, m in signs.items()}

    def pinned_relu(ctx):
        x = ctx.input("X")
        ctx.set_output("Out", torch.where(masks[ctx.op.input("X")[0]], x,
                                          torch.zeros_like(x)))

    relu = OpRegistry.get("relu")
    free_relu = relu.compute
    exe, scope = Executor(device), Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, weights)
    relu.compute = pinned_relu
    try:
        out = exe.run(main, feed=feed, scope=scope,
                      fetch_list=[loss.name] + [p + "@GRAD" for p in params])
    finally:
        relu.compute = free_relu
    return dict(zip(params, out[1:]))


def qk_projection_params(main):
    """The weights of the fc ops that feed an attention's Q or K slot."""
    ops = main.desc.global_block.ops
    producer = {n: op for op in ops if op.type != "__vjp__"
                for n in op.output_names()}
    out = set()
    for op in ops:
        if op.type != "scaled_dot_product_attention":
            continue
        for slot in ("Q", "K"):
            src = producer[op.input(slot)[0]]
            while src.type != "mul":
                src = producer[src.input("X")[0]]
            out.add(src.input("Y")[0])
    return out


def hold_step1_grads(main, startup, loss, weights, feed, params, flash,
                     card):
    """The witness for the flash arm's step-1 gradients: the naive route
    again (`main` stamped naive), its ReLUs pinned to the flash arm's
    masks, held per element for every parameter (see
    TRAIN_GRAD_NOISE_FACTOR); and once more from weights nudged by one
    ulp, for how far rounding alone moves each gradient. Returns the
    worst 2-norm |diff|/|g| and, for the Q/K projection weights whose
    atol the nudge set, (max |diff|, nudge) / max|g| and their ratio."""
    pinned = pinned_relu_grads(main, startup, loss, weights, feed, params,
                               flash["relu_signs"])
    rng = np.random.RandomState(1)
    nudged_w = dict(weights)
    for p in params:
        w = weights[p]
        away = np.where(rng.rand(*w.shape) < 0.5, -np.inf, np.inf)
        nudged_w[p] = np.nextafter(w, away.astype(np.float32))
    nudged = pinned_relu_grads(main, startup, loss, nudged_w, feed, params,
                               flash["relu_signs"])
    qk = qk_projection_params(main)
    rel, by_noise, lines, fails = {}, {}, {}, []
    for p in params:
        g, r = flash["grads"][p], pinned[p]
        scale = max(float(np.abs(r).max()), 1e-30)
        noise = float(np.abs(r - nudged[p]).max())
        diff = float(np.abs(g - r).max())
        rel[p] = float(np.linalg.norm(g - r)) / max(
            float(np.linalg.norm(r)), 1e-30)
        atol = TRAIN_GRAD_ATOL_FRAC * scale
        if p in qk:
            atol = max(atol, TRAIN_GRAD_NOISE_FACTOR * noise)
        if atol > TRAIN_GRAD_ATOL_FRAC * scale:
            by_noise[p] = (diff / scale, noise / scale, diff / noise)
        lines[p] = (f"  {p}@GRAD: max |diff| {diff / scale:.3e} * max|g|, "
                    f"one-ulp nudge {noise / scale:.3e} * max|g|, "
                    f"|diff|/|g| {rel[p]:.3e}")
        if not np.allclose(g, r, rtol=TRAIN_GRAD_RTOL, atol=atol):
            fails.append(p)
        if p in by_noise or p in fails:
            print(lines.pop(p), flush=True)
    for p in sorted(lines, key=rel.get, reverse=True)[:5]:
        print(lines[p], flush=True)
    if fails:
        raise SystemExit(f"flash vs naive with the flash ReLU masks: "
                         f"step-1 gradients of {fails} differ per element")
    worst = max(rel.values())
    print(f"[{card}] flash vs naive with the flash arm's ReLU masks: "
          f"step-1 gradients of all {len(params)} parameters equal per "
          f"element; |diff|/|g| (2-norms) up to {worst:.3e}; "
          f"{len(params) - len(by_noise)} held at rtol {TRAIN_GRAD_RTOL}, "
          f"atol {TRAIN_GRAD_ATOL_FRAC} * max|g|; {len(by_noise)} of the "
          f"{len(qk)} Q/K projection weights at atol "
          f"{TRAIN_GRAD_NOISE_FACTOR} x their one-ulp nudge (max |diff| / "
          f"nudge: {max([v[2] for v in by_noise.values()] or [0]):.2f})",
          flush=True)
    return worst, by_noise


def device_kernels(prof):
    """(name, device ms, launches) of each device kernel a
    torch.profiler run recorded."""
    import torch
    rows = []
    for e in prof.key_averages():
        # device_time_total is the newer name of cuda_time_total
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if getattr(e, "device_type", None) == \
                torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((e.key, us / 1e3, e.count))
    return rows


def profile_step(main, startup, loss, weights, feed, card, label="flash",
                 groups=None):
    """One more step of `main` (the `label` route) under torch.profiler
    (after a warm-up step), for where its device time goes: the kernels
    by total device time, and the device-busy share of the step's wall
    time, and the device ms and launches of each of `groups` ({part:
    fragment of its kernels' names}); then the forward alone (see
    below)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    exe, scope = Executor(DEVICE), Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, weights)
    exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_kernels(prof)
    busy_ms = sum(r[1] for r in rows)
    print(f"[{card}] profiled {label} step: {wall_ms:.1f} ms wall, "
          f"{busy_ms:.1f} ms of device kernels "
          f"({100 * busy_ms / wall_ms:.1f}% busy, overlap not removed)",
          flush=True)
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {ms:9.2f} ms {n:5d}x  {key[:90]}", flush=True)
    # the flash kernels by name: the forward, dq and dk/dv main kernels,
    # and the pack kernels all three launch ahead (one name for the three;
    # a call packs 1 rows + 1 cols in the forward, 2 rows + 1 cols in dq,
    # 2 rows + 2 cols in dk/dv)
    flash = [(k, ms, n) for k, ms, n in rows
             if "flash" in k or "pack_rows" in k or "pack_cols" in k]
    for key, ms, n in sorted(flash, key=lambda r: -r[1]):
        print(f"  flash: {ms:9.3f} ms {n:5d}x  {key[:90]}", flush=True)
    grouped = {part: dict(ms=sum(ms for k, ms, n in rows if frag in k),
                          count=sum(n for k, ms, n in rows if frag in k))
               for part, frag in (groups or {}).items()}
    if grouped:
        g_ms = sum(g["ms"] for g in grouped.values())
        print(f"[{card}] {label} kernels of the profiled step: " + ", ".join(
            f"{part} {g['ms']:.3f} ms ({g['count']}x)"
            for part, g in grouped.items()) + f"; {g_ms:.3f} ms of "
            f"{busy_ms:.1f} ms device, {wall_ms:.1f} ms wall "
            f"({100 * busy_ms / wall_ms:.1f}% busy)", flush=True)
    dq_ms = sum(ms for k, ms, n in flash if "flash_bwd_dq" in k)
    if dq_ms:
        print(f"[{card}] dq main kernel: {dq_ms:.3f} ms of the {label} "
              "step", flush=True)
    # the forward alone: the ops before append_backward's seed. Each
    # __vjp__ replays its forward op, so a step runs this much twice.
    blk = main.desc.global_block
    ops = blk.ops
    seed = [loss.name + "@GRAD"]
    blk.ops = ops[:next(i for i, op in enumerate(ops)
                        if op.output("Out") == seed)]
    main.desc._bump_version()
    try:
        exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        t0 = time.perf_counter()
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        fwd_ms = (time.perf_counter() - t0) / 3 * 1e3
    finally:
        blk.ops = ops
        main.desc._bump_version()
    print(f"[{card}] forward alone ({label} route): {fwd_ms:.1f} ms — what "
          f"the __vjp__ replays add to each step", flush=True)
    return dict(wall_ms=wall_ms, device_ms=busy_ms, forward_ms=fwd_ms,
                top_kernels=[dict(name=k[:120], ms=ms, count=n) for k, ms, n
                             in sorted(rows, key=lambda r: -r[1])[:12]],
                flash_kernels=[dict(name=k[:120], ms=ms, count=n)
                               for k, ms, n in flash], dq_device_ms=dq_ms,
                kernel_groups=grouped)


def train(card):
    """Phase 4: the NMT train step at Transformer-base width, flash route
    (as built) against the naive route on the same card."""
    import torch
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    with framework.isolated_name_scope():
        main, startup, f = transformer.build_train(**TRAIN_CFG)
    weights = seeded_weights(startup, seed=0)
    params = [p.name for p in main.all_parameters()]
    n_params = sum(weights[p].size for p in params)
    ln, vocab = TRAIN_CFG["max_len"], TRAIN_CFG["trg_vocab"]
    rng = np.random.RandomState(0)
    feed = {n: rng.randint(1, vocab, (TRAIN_BATCH, ln, 1)).astype(np.int64)
            for n in ("src_ids", "trg_ids", "trg_labels")}
    feed["pos_ids"] = np.arange(ln).astype(np.int64)
    print(f"train program built: {time.perf_counter() - t0:.2f} s, "
          f"{len(main.desc.global_block.ops)} ops, {n_params} parameters",
          flush=True)

    kernels.reset_launch_counts()
    flash = train_arm(main, startup, f["loss"], weights, feed, params,
                      card, "flash")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for name in NMT_TRAINING_KERNELS:
        if launches[name] == 0:
            raise SystemExit(f"kernel {name} was not launched on the "
                             "training path")
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    print(f"[{card}] training kernel launches {launches} "
          f"({per_step} per step)", flush=True)
    profiled = profile_step(main, startup, f["loss"], weights, feed, card)

    _stamp_naive(main)
    naive = train_arm(main, startup, f["loss"], weights, feed, params,
                      card, "naive")
    np.testing.assert_allclose(flash["losses"], naive["losses"],
                               rtol=TRAIN_LOSS_RTOL,
                               err_msg="flash vs naive losses")
    rel = {p: float(np.linalg.norm(flash["grads"][p] - naive["grads"][p]))
           / max(float(np.linalg.norm(naive["grads"][p])), 1e-30)
           for p in params}
    flips = [int((flash["relu_signs"][n] != naive["relu_signs"][n]).sum())
             for n in flash["relu_signs"]]
    worst = max(rel.values())
    n_relu = next(iter(flash["relu_signs"].values())).size
    print(f"[{card}] flash vs naive: losses {flash['losses']} vs "
          f"{naive['losses']}; step-1 gradients |diff|/|g| (2-norms) "
          f"{min(rel.values()):.3e} to {worst:.3e}; ReLU inputs of "
          f"another sign per FFN (encoder, then decoder): {flips} of "
          f"{n_relu} each", flush=True)
    for p in sorted(rel, key=rel.get, reverse=True)[:3] + \
            sorted(rel, key=rel.get)[:3]:
        print(f"  {p}@GRAD: |diff|/|g| {rel[p]:.3e}", flush=True)
    for p in params:
        if not rel[p] <= TRAIN_GRAD_NORM_RTOL:
            raise SystemExit(f"flash vs naive {p}@GRAD: |diff|/|g| "
                             f"{rel[p]:.3e} > {TRAIN_GRAD_NORM_RTOL}")
    worst_pinned, by_noise = hold_step1_grads(
        main, startup, f["loss"], weights, feed, params, flash, card)
    summary = {"card": card, "config": dict(TRAIN_CFG, batch=TRAIN_BATCH),
               "parameters": n_params, "steps": TRAIN_STEPS,
               "launches_per_step": per_step,
               "grad_norm_rel_diff_max": worst, "relu_sign_flips": flips,
               "pinned_relu_grad_norm_rel_diff_max": worst_pinned,
               "grads_held_by_nudge": {p: dict(zip(
                   ("max_diff_frac", "nudge_frac", "ratio"), v))
                   for p, v in by_noise.items()},
               "profiled_step": profiled}
    for label, arm in (("flash", flash), ("naive", naive)):
        summary[label] = {k: arm[k] for k in ("losses", "step_ms",
                                              "peak_bytes")}
    return summary, launches


def _stamp_pallas(main, op_type, value):
    """__pallas__=value on every `op_type` op and on the fwd_op copy each
    __vjp__ took at append_backward time (a stamp that misses the copies
    leaves the backward on the other route)."""
    for op in main.desc.global_block.ops:
        if op.type == op_type:
            op.attrs["__pallas__"] = value
        elif op.type == "__vjp__" and op.attrs["fwd_op"]["type"] == op_type:
            op.attrs["fwd_op"]["attrs"]["__pallas__"] = value
    main.desc._bump_version()


def steps_arm(main, startup, loss, weights, feed, params, card, label,
              steps, device=None, extra=()):
    """`steps` optimizer steps from `weights` in a fresh scope on `device`
    (DEVICE when None); the first also fetches every parameter's gradient
    (its grad var) and the vars named in `extra`. Each step's time is a
    host clock around Executor.run, which ends synchronized (it returns
    the fetches as numpy). Returns the arm's numbers, its executor and its
    scope."""
    import torch
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    device = DEVICE if device is None else device
    on_card = torch.device(device).type == "cuda"
    exe, scope = Executor(device), Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, weights)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms, peaks, grads, firsts = [], [], [], None, None
    for step in range(steps):
        fetch = [loss.name] + ([p + "@GRAD" for p in params] + list(extra)
                               if step == 0 else [])
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() if on_card else 0)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        if step == 0:
            grads = dict(zip(params, out[1:1 + len(params)]))
            firsts = dict(zip(extra, out[1 + len(params):]))
        if not np.isfinite(losses[-1]):
            raise SystemExit(f"{label} arm: loss {losses[-1]} at step "
                             f"{step}")
        print(f"[{card}] {label} step {step}: loss {losses[-1]:.6f}"
              f" {step_ms[-1]:.1f} ms" + (f" peak {peaks[-1] / 2**30:.3f} "
                                         "GiB" if on_card else ""),
              flush=True)
    return dict(losses=losses, step_ms=step_ms, peak_bytes=max(peaks),
                grads=grads, first_step=firsts), exe, scope


@contextlib.contextmanager
def knob(name, value):
    """Environment flag `name` set to `value` inside the block: both
    executors stamp the kernel-dispatch knobs onto the program before a
    run, over the stamps its ops carry (paddle_tpu_torch/core/dispatch.py)."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def hold_routes(fused, scan, params, card, what):
    """Kernel vs scan route of one model: losses within RNN_LOSS_RTOL and
    every parameter's step-1 gradient per element within RNN_GRAD_RTOL,
    atol RNN_GRAD_ATOL_FRAC * max|g|. Returns (max relative loss
    difference, worst max |diff| / max|g| over the parameters)."""
    loss_rel = float(np.max(np.abs(np.subtract(fused["losses"],
                                               scan["losses"]))
                            / np.abs(scan["losses"])))
    print(f"[{card}] {what} kernel vs scan: losses {fused['losses']} vs "
          f"{scan['losses']} (max rel diff {loss_rel:.3e})", flush=True)
    if not loss_rel <= RNN_LOSS_RTOL:
        raise SystemExit(f"{what} kernel vs scan losses differ by "
                         f"{loss_rel:.3e} > {RNN_LOSS_RTOL}")
    worst, fails = {}, []
    for p in params:
        g, r = fused["grads"][p], scan["grads"][p]
        scale = max(float(np.abs(r).max()), 1e-30)
        worst[p] = float(np.abs(g - r).max()) / scale
        if not np.allclose(g, r, rtol=RNN_GRAD_RTOL,
                           atol=RNN_GRAD_ATOL_FRAC * scale):
            fails.append(p)
    for p in sorted(worst, key=worst.get, reverse=True):
        print(f"  {p}@GRAD: max |diff| {worst[p]:.3e} * max|g|", flush=True)
    if fails:
        raise SystemExit(f"{what} kernel vs scan: step-1 gradients of "
                         f"{fails} differ per element")
    print(f"[{card}] {what} kernel vs scan: step-1 gradients of all "
          f"{len(params)} parameters equal per element (rtol "
          f"{RNN_GRAD_RTOL}, atol {RNN_GRAD_ATOL_FRAC} * max|g|; worst "
          f"max |diff| {max(worst.values()):.3e} * max|g|)", flush=True)
    return loss_rel, max(worst.values())


def train_lstm(card):
    """Phase 5: the stacked-LSTM LM train step at the bench.py:668
    configuration (vocabulary 10000, emb 256, hidden 512, 2 layers, SGD
    lr 1.0, B64 x T64, the bench's ragged lengths), kernel route (as
    built: every lstm op takes the fused-LSTM kernels) against the scan
    route (__pallas__="0" on every lstm op and fwd_op copy) on the same
    card from the same numpy-seeded weights."""
    import torch
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core.lod import RaggedPair
    from paddle_tpu_torch.models import lstm_lm
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    with framework.isolated_name_scope():
        main, startup, f = lstm_lm.build_train(**LSTM_CFG)
    weights = seeded_weights(startup, seed=0)
    params = [p.name for p in main.all_parameters()]
    n_params = sum(weights[p].size for p in params)
    ids, lens = lm_lengths()
    feed = {"words": RaggedPair(ids, lens), "targets": RaggedPair(ids, lens)}
    print(f"LSTM LM program built: {time.perf_counter() - t0:.2f} s, "
          f"{len(main.desc.global_block.ops)} ops, {n_params} parameters, "
          f"{int(lens.sum())} of {ids.shape[0] * ids.shape[1]} tokens live",
          flush=True)

    kernels.reset_launch_counts()
    fused, _, _ = steps_arm(main, startup, f["loss"], weights, feed, params,
                            card, "LSTM LM kernel", LSTM_STEPS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    per_step = {n: c / LSTM_STEPS for n, c in launches.items()}
    print(f"[{card}] LSTM LM kernel launches {launches} ({per_step} per "
          f"step)", flush=True)
    for name in ("fused_lstm_fwd", "fused_lstm_bwd"):
        if launches[name] == 0:
            raise SystemExit(f"kernel {name} was not launched on the LSTM "
                             "training path")
    # per step: each lstm op's forward and its __vjp__ replay, and one
    # backward per op
    want = {"fused_lstm_fwd": 2 * LSTM_CFG["num_layers"] * LSTM_STEPS,
            "fused_lstm_bwd": LSTM_CFG["num_layers"] * LSTM_STEPS}
    if any(launches[n] != c for n, c in want.items()):
        raise SystemExit(f"LSTM launches {launches}, expected {want}")
    profiled = profile_step(main, startup, f["loss"], weights, feed, card,
                            "LSTM kernel")

    _stamp_pallas(main, "lstm", "0")
    kernels.reset_launch_counts()
    with knob("PADDLE_TPU_PALLAS_LSTM", "0"):
        scan, _, _ = steps_arm(main, startup, f["loss"], weights, feed,
                               params, card, "LSTM LM scan", LSTM_STEPS)
    if kernels.launch_counts()["fused_lstm_fwd"]:
        raise SystemExit("the scan route launched the fused-LSTM kernel")
    loss_rel, worst = hold_routes(fused, scan, params, card, "LSTM LM")
    summary = {"card": card, "config": dict(LSTM_CFG, batch=LSTM_BATCH,
                                            t=LSTM_T),
               "parameters": n_params, "live_tokens": int(lens.sum()),
               "steps": LSTM_STEPS, "launches_per_step": per_step,
               "loss_rel_diff_max": loss_rel,
               "grad_max_diff_frac": worst,
               "profiled_step": profiled}
    for label, arm in (("kernel", fused), ("scan", scan)):
        summary[label] = {k: arm[k] for k in ("losses", "step_ms",
                                              "peak_bytes")}
    return summary, launches


def build_gru_nmt():
    """The book chapter's program (tests/test_book.py:166-184) with the
    port's layers at GRU_NMT_CFG: (main, startup, logits, loss)."""
    from paddle_tpu_torch import framework, layers, optimizer
    v, emb, hid = (GRU_NMT_CFG[k] for k in ("dict_size", "emb_dim",
                                             "hid_dim"))
    main, startup = framework.Program(), framework.Program()
    with framework.isolated_name_scope(), \
            framework.program_guard(main, startup):
        src = layers.data("src", [1], dtype="int64", lod_level=1)
        trg = layers.data("trg", [1], dtype="int64", lod_level=1)
        lbl = layers.data("lbl", [1], dtype="int64", lod_level=1)
        enc = layers.dynamic_gru(layers.fc(layers.embedding(
            src, size=[v, emb]), size=3 * hid), size=hid)
        dec = layers.dynamic_gru(layers.fc(layers.embedding(
            trg, size=[v, emb]), size=3 * hid), size=hid)
        ctx = layers.scaled_dot_product_attention(dec, enc, enc)
        logits = layers.fc(layers.concat([dec, ctx], axis=-1), size=v)
        tok_loss = layers.softmax_with_cross_entropy(logits, lbl)
        loss = layers.mean(layers.sequence_pool(tok_loss, "average"))
        optimizer.AdamOptimizer(
            learning_rate=GRU_NMT_CFG["lr"]).minimize(loss)
    return main, startup, logits, loss


def reload_inference(main, logits, exe, scope, feed, card):
    """Phase 7: save the trained `main` (in `scope`) as an inference model,
    fetch the logits of one more run of `main` (its forward reads the
    saved weights, before its own Adam update), load the model into a
    fresh Executor and scope on the card and run it on the same source
    and target; the logits must be equal bit for bit. Launch counts are
    set to 0 just before the reloaded run and read just after."""
    import tempfile
    import torch
    from paddle_tpu_torch import Executor, Scope, io, scope_guard
    from paddle_tpu_torch.ops import kernels
    with tempfile.TemporaryDirectory(prefix="gru_nmt_model_") as d:
        with scope_guard(scope):
            io.save_inference_model(d, ["src", "trg"], [logits], exe,
                                    main_program=main)
        files = sorted(os.listdir(d))
        (want,) = exe.run(main, feed=feed, fetch_list=[logits.name],
                          scope=scope)
        with scope_guard(Scope()):
            fresh = Executor(DEVICE)
            prog, feeds, fetches = io.load_inference_model(d, fresh)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            (got,) = fresh.run(prog, feed={k: feed[k] for k in feeds},
                               fetch_list=fetches)
            run_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
    n_ops = len(prog.desc.global_block.ops)
    if got.lod != want.lod or got.data.shape != want.data.shape:
        raise SystemExit(f"reloaded model: logits of shape {got.data.shape}"
                         f" lod {got.lod[0][:4]}..., trained program "
                         f"{want.data.shape} {want.lod[0][:4]}...")
    if not np.all(np.isfinite(got.data)):
        raise SystemExit("reloaded model: non-finite logits")
    diff = float(np.abs(got.data - want.data).max())
    if not np.array_equal(got.data, want.data):
        raise SystemExit(f"reloaded model's logits differ from the trained "
                         f"program's: max |diff| {diff:.3e}")
    if launches["fused_gru_fwd"] != 2 or launches["fused_gru_bwd"]:
        raise SystemExit(f"reloaded model launched {launches}; expected 2 "
                         "fused_gru_fwd (encoder, decoder) and no backward")
    print(f"[{card}] inference model ({', '.join(files)}; {n_ops} ops, "
          f"feeds {feeds}) reloaded on the card: logits "
          f"{tuple(got.data.shape)} equal the trained program's bit for bit"
          f"; reloaded run {run_ms:.1f} ms, launches {launches}", flush=True)
    return dict(files=files, ops=n_ops, logits_shape=list(got.data.shape),
                bitwise_equal=True, run_ms=run_ms,
                launches={k: v for k, v in launches.items() if v})


def train_gru_nmt(card):
    """Phases 6 and 7: the book's GRU encoder-decoder at its published
    width, kernel route (as built) against the scan route (__pallas__="0"
    on every gru op and fwd_op copy) on the same card from the same
    numpy-seeded weights; then the kernel-route model reloaded as an
    inference model."""
    import torch
    from paddle_tpu_torch.core.lod import RaggedPair
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    main, startup, logits, loss = build_gru_nmt()
    weights = seeded_weights(startup, seed=0)
    params = [p.name for p in main.all_parameters()]
    n_params = sum(weights[p].size for p in params)
    (src, trg, lbl), src_lens, trg_lens = gru_lengths()
    feed = {"src": RaggedPair(src, src_lens), "trg": RaggedPair(trg, trg_lens),
            "lbl": RaggedPair(lbl, trg_lens)}
    print(f"GRU NMT program built: {time.perf_counter() - t0:.2f} s, "
          f"{len(main.desc.global_block.ops)} ops, {n_params} parameters, "
          f"{int(src_lens.sum())} source and {int(trg_lens.sum())} target "
          f"tokens live of {GRU_BATCH * GRU_T} each", flush=True)

    kernels.reset_launch_counts()
    fused, exe, scope = steps_arm(main, startup, loss, weights, feed,
                                  params, card, "GRU NMT kernel", GRU_STEPS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    per_step = {n: c / GRU_STEPS for n, c in launches.items()}
    print(f"[{card}] GRU NMT kernel launches {launches} ({per_step} per "
          f"step)", flush=True)
    # per step: each gru op's forward and its __vjp__ replay, and one
    # backward per op
    want = {"fused_gru_fwd": 4 * GRU_STEPS, "fused_gru_bwd": 2 * GRU_STEPS}
    if any(launches[n] != c for n, c in want.items()):
        raise SystemExit(f"GRU launches {launches}, expected {want}")
    inference = reload_inference(main, logits, exe, scope, feed, card)
    del exe, scope
    profiled = profile_step(main, startup, loss, weights, feed, card,
                            "GRU kernel", groups=GRU_KERNELS)

    _stamp_pallas(main, "gru", "0")
    kernels.reset_launch_counts()
    with knob("PADDLE_TPU_PALLAS_GRU", "0"):
        scan, _, _ = steps_arm(main, startup, loss, weights, feed, params,
                               card, "GRU NMT scan", GRU_STEPS)
    if kernels.launch_counts()["fused_gru_fwd"]:
        raise SystemExit("the scan route launched the fused-GRU kernel")
    loss_rel, worst = hold_routes(fused, scan, params, card, "GRU NMT")
    summary = {"card": card, "config": dict(GRU_NMT_CFG, batch=GRU_BATCH,
                                            t=GRU_T),
               "parameters": n_params,
               "live_tokens": {"source": int(src_lens.sum()),
                               "target": int(trg_lens.sum())},
               "steps": GRU_STEPS, "launches_per_step": per_step,
               "loss_rel_diff_max": loss_rel,
               "grad_max_diff_frac": worst,
               "profiled_step": profiled, "inference_reload": inference}
    for label, arm in (("kernel", fused), ("scan", scan)):
        summary[label] = {k: arm[k] for k in ("losses", "step_ms",
                                              "peak_bytes")}
    return summary, launches


def relu_inputs(main):
    return [op.input("X")[0] for op in main.desc.global_block.ops
            if op.type == "relu"]


def _norm_gap(got, want):
    """|got - want| / |want| (2-norms)."""
    return float(np.linalg.norm(np.subtract(got, want))) / max(
        float(np.linalg.norm(want)), 1e-30)


def train_mnist(card):
    """Phase 8: MNIST conv (models.mnist.build_train(net="conv"), Adam lr
    1e-3) at batch 64 for MNIST_STEPS steps from seeded weights on the
    card, launch counts set to 0 just before and read just after; then
    the same steps on the port's CPU path. Losses within MNIST_LOSS_RTOL;
    the card's step-1 gradients per element against a CPU step whose
    ReLUs take the card's masks, and by 2-norm against the free CPU
    step."""
    import torch
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import mnist
    from paddle_tpu_torch.ops import kernels
    with framework.isolated_name_scope():
        main, startup, f = mnist.build_train(net="conv")
    weights = seeded_weights(startup, seed=0)
    params = [p.name for p in main.all_parameters()]
    rng = np.random.RandomState(2)
    feed = {"img": rng.rand(MNIST_BATCH, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (MNIST_BATCH, 1)).astype(np.int64)}
    relu_in = relu_inputs(main)
    kernels.reset_launch_counts()
    gpu, _, _ = steps_arm(main, startup, f["loss"], weights, feed, params,
                          card, "MNIST conv card", MNIST_STEPS,
                          device=DEVICE, extra=relu_in)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if any(launches.values()):
        raise SystemExit(f"the MNIST path launched {launches}; no op of "
                         "either package dispatches a kernel there")
    cpu, _, _ = steps_arm(main, startup, f["loss"], weights, feed, params,
                          card, "MNIST conv CPU", MNIST_STEPS, device="cpu")
    loss_rel = float(np.max(np.abs(np.subtract(gpu["losses"],
                                               cpu["losses"]))
                            / np.abs(cpu["losses"])))
    if not loss_rel <= MNIST_LOSS_RTOL:
        raise SystemExit(f"MNIST card vs CPU losses differ by {loss_rel:.3e}"
                         f": {gpu['losses']} vs {cpu['losses']}")
    signs = {n: v > 0 for n, v in gpu["first_step"].items()}
    pinned = pinned_relu_grads(main, startup, f["loss"], weights, feed,
                               params, signs, device="cpu")
    worst, norm_gap, fails = 0.0, 0.0, []
    for p in params:
        g, r = gpu["grads"][p], pinned[p]
        scale = max(float(np.abs(r).max()), 1e-30)
        worst = max(worst, float(np.abs(g - r).max()) / scale)
        norm_gap = max(norm_gap, _norm_gap(g, cpu["grads"][p]))
        if not np.allclose(g, r, rtol=TRAIN_GRAD_RTOL,
                           atol=TRAIN_GRAD_ATOL_FRAC * scale):
            fails.append(p)
    if fails or not norm_gap <= TRAIN_GRAD_NORM_RTOL:
        raise SystemExit(f"MNIST card vs CPU step-1 gradients: {fails} "
                         f"differ per element (worst {worst:.3e} * max|g|),"
                         f" 2-norm gap to the free CPU step {norm_gap:.3e}")
    print(f"[{card}] MNIST conv card vs CPU: losses {gpu['losses']} vs "
          f"{cpu['losses']} (max rel diff {loss_rel:.3e}); step-1 "
          f"gradients of all {len(params)} parameters equal per element to "
          f"the CPU step with the card's ReLU masks (worst {worst:.3e} * "
          f"max|g|), 2-norm gap to the free CPU step {norm_gap:.3e}",
          flush=True)
    return {"card": card, "config": {"net": "conv", "lr": 1e-3,
                                     "batch": MNIST_BATCH},
            "steps": MNIST_STEPS, "losses": gpu["losses"],
            "cpu_losses": cpu["losses"], "step_ms": gpu["step_ms"],
            "peak_bytes": gpu["peak_bytes"], "loss_rel_diff_max": loss_rel,
            "grad_max_diff_frac_pinned": worst,
            "grad_norm_gap_free": norm_gap}, launches


def _bn_stats(main, scope):
    """numpy values of every batch_norm's running mean and variance."""
    names = [n for op in main.desc.global_block.ops
             if op.type == "batch_norm"
             for n in op.input("Mean") + op.input("Variance")]
    return {n: scope.get(n).detach().cpu().numpy() for n in names}


def _nudged(weights, names):
    """`weights` with every entry of `names` one ulp away (up or down at
    random, a fixed draw)."""
    rng = np.random.RandomState(1)
    out = dict(weights)
    for n in names:
        away = np.where(rng.rand(*weights[n].shape) < 0.5, -np.inf, np.inf)
        out[n] = np.nextafter(weights[n], away.astype(np.float32))
    return out


def check_resnet_small_batch(main, startup, loss, weights, feed, params,
                             card):
    """RESNET_CHECK_STEPS steps of the ResNet-50 program at batch
    RESNET_CHECK_BATCH on the card and on the port's CPU path, once more
    on the CPU from parameters one ulp away, and one CPU step whose ReLUs
    take the card's step-1 masks. The first losses within 1e-4; every
    parameter's step-1 gradient within TRAIN_GRAD_NORM_RTOL (2-norm) of
    the pinned CPU step's; the later losses, the free CPU step's
    gradients and every batch_norm's running statistics after the steps
    within RESNET_NOISE_FACTOR times how far the nudge moved the CPU arm
    (ReLU inputs within rounding of 0 flip between any two runs that
    round differently, and lr 0.1 on 4 images carries each flip into
    the next step). Returns the gaps and limits."""
    relu_in = relu_inputs(main)
    arms = {}
    for label, device, w, extra in (
            ("card", DEVICE, weights, relu_in),
            ("cpu", "cpu", weights, relu_in),
            ("cpu_nudged", "cpu", _nudged(weights, params), ())):
        arm, _, scope = steps_arm(main, startup, loss, w, feed, params, card,
                                  f"ResNet-50 batch {RESNET_CHECK_BATCH} "
                                  f"{label}", RESNET_CHECK_STEPS,
                                  device=device, extra=extra)
        arm["stats"] = _bn_stats(main, scope)
        arms[label] = arm
    gpu, cpu, nudged = arms["card"], arms["cpu"], arms["cpu_nudged"]
    signs = {n: v > 0 for n, v in gpu.pop("first_step").items()}
    flips = sum(int(np.sum((v > 0) != signs[n]))
                for n, v in cpu.pop("first_step").items())
    pinned = pinned_relu_grads(main, startup, loss, weights, feed, params,
                               signs, device="cpu")
    out, fails = {}, []

    def hold(what, gap, noise, base):
        limit = max(base, RESNET_NOISE_FACTOR * noise)
        out[what] = {"gap": gap, "nudge": noise, "limit": limit}
        if not gap <= limit:
            fails.append(f"{what}: {gap:.3e} > {limit:.3e}")

    loss_scale = np.maximum(np.abs(cpu["losses"]), 1e-30)
    rel = np.abs(np.subtract(gpu["losses"], cpu["losses"])) / loss_scale
    rel_nudge = np.abs(np.subtract(nudged["losses"], cpu["losses"])) \
        / loss_scale
    hold("first loss", float(rel[0]), 0.0, 1e-4)
    hold("later losses", float(np.max(rel[1:])), float(np.max(rel_nudge[1:])),
         1e-5)
    pinned_gap = {p: _norm_gap(gpu["grads"][p], pinned[p]) for p in params}
    for p in params:
        hold(f"pinned grad {p}", pinned_gap[p], 0.0, TRAIN_GRAD_NORM_RTOL)
        hold(f"free grad {p}", _norm_gap(gpu["grads"][p], cpu["grads"][p]),
             _norm_gap(nudged["grads"][p], cpu["grads"][p]),
             TRAIN_GRAD_NORM_RTOL)
    for n, r in cpu["stats"].items():
        scale = max(float(np.abs(r).max()), 1e-30)
        hold(f"stat {n}", float(np.abs(gpu["stats"][n] - r).max()) / scale,
             float(np.abs(nudged["stats"][n] - r).max()) / scale, 1e-5)

    def worst(prefix):
        keys = [k for k in out if k.startswith(prefix)]
        return max(out[k]["gap"] for k in keys), max(out[k]["nudge"]
                                                     for k in keys)
    summary = {"losses": {k: a["losses"] for k, a in arms.items()},
               "first_loss_rel_gap": float(rel[0]),
               "pinned_grad_gap_max": worst("pinned grad ")[0],
               "free_grad_gap_max": worst("free grad ")[0],
               "free_grad_nudge_max": worst("free grad ")[1],
               "stat_gap_max": worst("stat ")[0],
               "stat_nudge_max": worst("stat ")[1],
               "later_losses": out["later losses"],
               "relu_sign_flips": flips}
    print(f"[{card}] ResNet-50 batch {RESNET_CHECK_BATCH} card vs CPU: "
          f"losses {gpu['losses']} vs {cpu['losses']} (nudged CPU "
          f"{nudged['losses']}); {flips} ReLU inputs of another sign in "
          f"step 1; step-1 gradients vs the CPU step with the card's ReLU "
          f"masks: 2-norm gap <= {summary['pinned_grad_gap_max']:.3e} "
          f"(limit {TRAIN_GRAD_NORM_RTOL}); vs the free CPU step <= "
          f"{summary['free_grad_gap_max']:.3e} (the nudge: "
          f"{summary['free_grad_nudge_max']:.3e}); running statistics "
          f"<= {summary['stat_gap_max']:.3e} * max (the nudge: "
          f"{summary['stat_nudge_max']:.3e})", flush=True)
    if fails:
        raise SystemExit("ResNet-50 card vs CPU: " + "; ".join(fails[:8]))
    return summary


def train_resnet(card):
    """Phase 9: ResNet-50 as bench.py:221-226 trains it (RESNET_CFG,
    batch RESNET_BATCH, fp32, TF32 off) for RESNET_STEPS steps from seeded
    weights through Executor.run, launch counts set to 0 just before and
    read just after (no op dispatches a kernel on this path: every count
    must stay 0); a profiled step; then the small-batch card-vs-CPU
    check."""
    import torch
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    # the earlier phases' blocks go back to the card: this step keeps
    # every value of its forward and backward (~52 GiB at batch 128)
    torch.cuda.empty_cache()
    with framework.isolated_name_scope():
        main, startup, f = resnet.build_train(**RESNET_CFG)
    weights = seeded_weights(startup, seed=0)
    params = [p.name for p in main.all_parameters()]
    n_params = sum(weights[p].size for p in params)
    rng = np.random.RandomState(3)
    img = rng.rand(RESNET_BATCH, *RESNET_CFG["image_shape"]).astype(
        np.float32)
    label = rng.randint(0, RESNET_CFG["class_dim"],
                        (RESNET_BATCH, 1)).astype(np.int64)
    feed = {"img": img, "label": label}
    print(f"ResNet-50 program built: {time.perf_counter() - t0:.2f} s, "
          f"{len(main.desc.global_block.ops)} ops, {n_params} parameters",
          flush=True)
    kernels.reset_launch_counts()
    arm, exe, scope = steps_arm(main, startup, f["loss"], weights, feed,
                                params, card, f"ResNet-50 batch "
                                f"{RESNET_BATCH}", RESNET_STEPS,
                                device=DEVICE)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if any(launches.values()):
        raise SystemExit(f"the ResNet-50 path launched {launches}; no op of "
                         "either package dispatches a kernel there")
    del exe, scope
    profiled = profile_step(main, startup, f["loss"], weights, feed, card,
                            "ResNet-50")
    small = check_resnet_small_batch(
        main, startup, f["loss"], weights,
        {k: v[:RESNET_CHECK_BATCH] for k, v in feed.items()}, params, card)
    steady = arm["step_ms"][1:]
    print(f"[{card}] ResNet-50 batch {RESNET_BATCH}: step ms {arm['step_ms']}"
          f" (steady median {float(np.median(steady)):.1f}, "
          f"{RESNET_BATCH * 1e3 / float(np.median(steady)):.1f} images/s), "
          f"peak {arm['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    return {"card": card, "config": dict(RESNET_CFG, batch=RESNET_BATCH,
                                         momentum=0.9),
            "parameters": n_params, "steps": RESNET_STEPS,
            "losses": arm["losses"], "step_ms": arm["step_ms"],
            "peak_bytes": arm["peak_bytes"],
            "images_per_s": RESNET_BATCH * 1e3 / float(np.median(steady)),
            "profiled_step": profiled, "small_batch_check": small}, launches


def _chain_params(gen, big, small, blocks):
    """Per block: NCHW weights (w1 [c,C,1,1], w2 [c,c,3,3], w3 [C,c,1,1],
    randn / sqrt(fan in)), their NHWC-flat forms for the kernels, and the
    three batch_norms' scale 1 and bias 0, as conv_kernel_ab.py draws
    them."""
    import torch
    from paddle_tpu_torch.ops.kernels.fused_conv import pack_w3x3
    out = []
    for _ in range(blocks):
        w1 = torch.randn(small, big, 1, 1, device=DEVICE,
                         generator=gen) / big ** 0.5
        w2 = torch.randn(small, small, 3, 3, device=DEVICE,
                         generator=gen) / (9 * small) ** 0.5
        w3 = torch.randn(big, small, 1, 1, device=DEVICE,
                         generator=gen) / small ** 0.5
        bns = [torch.ones(c, device=DEVICE) if i % 2 == 0 else
               torch.zeros(c, device=DEVICE)
               for i, c in enumerate((small, small, small, small, big,
                                      big))]
        flat = (w1.reshape(small, big).t().contiguous(),
                pack_w3x3(w2).contiguous(),
                w3.reshape(big, small).t().contiguous())
        out.append(((w1, w2, w3), flat, bns))
    return out


def composed_chain(x, params):
    """The bottleneck blocks in NCHW: cuDNN F.conv2d in x's dtype, then
    the port's batch_norm op in float32 (train mode: full-batch
    single-pass statistics, the affine), ReLU, the residual join in
    float32, and a cast back to x's dtype after each activation, as
    block_megakernel_ab.py:39-58 does (no casts in float32)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.core.ir import OpDesc
    from paddle_tpu_torch.core.registry import run_op
    bn_op = OpDesc(type="batch_norm",
                   inputs={"X": ["x"], "Scale": ["s"], "Bias": ["b"],
                           "Mean": ["m"], "Variance": ["v"]},
                   outputs={"Y": ["y"], "MeanOut": ["m"],
                            "VarianceOut": ["v"], "SavedMean": ["sm"],
                            "SavedVariance": ["sv"]},
                   attrs={"momentum": 0.9, "epsilon": 1e-5,
                          "is_test": False, "data_layout": "NCHW"})

    def bn(t, scale, bias):
        zeros = torch.zeros_like(scale)
        return run_op(bn_op, {"x": t, "s": scale, "b": bias, "m": zeros,
                              "v": zeros})["y"]

    dt = x.dtype
    for (w1, w2, w3), _, bns in params:
        t = torch.relu(bn(F.conv2d(x, w1).float(), bns[0], bns[1])).to(dt)
        t = torch.relu(bn(F.conv2d(t, w2, padding=1).float(), bns[2],
                          bns[3])).to(dt)
        x = torch.relu(bn(F.conv2d(t, w3).float(), bns[4], bns[5])
                       + x.float()).to(dt)
    return x


def fused_chain(x, params, side, plain=False):
    """The same blocks on NHWC-flat rows through the fused kernels (their
    plain twins with `plain`), as conv_kernel_ab.py
    pallas_bottleneck_chain runs them: the statistics ride each conv's
    epilogue, each batch_norm's affine and ReLU the next conv's prologue,
    and only the residual join is a separate pass, in float32 with a cast
    back to x's dtype (conv_kernel_ab.py:140-142; no casts in float32)."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_conv as fc
    conv1x1_bn_act = fc.conv1x1_bn_act_plain if plain else fc.conv1x1_bn_act
    conv3x3_bn_act = fc.conv3x3_bn_act_plain if plain else fc.conv3x3_bn_act
    m = x.shape[0]

    def coefs(st, scale, bias):
        mean = st[0] / m
        var = st[1] / m - mean * mean
        a = scale * torch.rsqrt(var + 1e-5)
        return a, bias - mean * a

    for _, (w1, w2, w3), bns in params:
        t1, st1 = conv1x1_bn_act(x, w1, stats=True)
        a1, b1 = coefs(st1, bns[0], bns[1])
        t2, st2 = conv3x3_bn_act(t1, w2, side, side, a=a1, b=b1, relu=True,
                                 stats=True)
        a2, b2 = coefs(st2, bns[2], bns[3])
        t3, st3 = conv1x1_bn_act(t2, w3, a=a2, b=b2, relu=True, stats=True)
        a3, b3 = coefs(st3, bns[4], bns[5])
        x = torch.relu(t3.float() * a3[None, :] + b3[None, :]
                       + x.float()).to(x.dtype)
    return x


def _chain_cast(params, dt):
    """`_chain_params` blocks with both weight forms in dt (the
    batch_norms' rows stay float32)."""
    return [(tuple(w.to(dt) for w in ws),
             tuple(w.to(dt).contiguous() for w in flat), bns)
            for ws, flat, bns in params]


def conv_chain(card):
    """Phase 10: the ResNet-50 bottleneck chain of conv_kernel_ab.py at
    each CONV_CHAIN stage (batch 128), CONV_CHAIN_BLOCKS blocks, in
    float32 and in bfloat16, as two arms on the same input and weights:
    composed (cuDNN + the port's batch_norm, NCHW; in bfloat16 cast as
    composed_chain casts) and fused (the conv kernels, NHWC-flat). float32:
    held together after one block (CHAIN_ONE_BLOCK_RTOL of max) and after
    all (CHAIN_NORM_RTOL of the 2-norm). bfloat16: after one block within
    MEGA_BF16_RTOL of max; after all, phase 11's rule (_norm_limit): the
    2-norm gap within MEGA_BF16_NOISE_FACTOR times the composed bfloat16
    arm's own distance from the same chain run composed in float32. A
    rerun of the fused arm must be bitwise equal. Each arm timed per
    block. Launch counts are set to 0 before each dtype's first stage and
    read after its last check; both kernels must launch in both dtypes.
    bfloat16 after all blocks: phase 11's rule (_norm_limit) with the
    kernels' exact twin: the fused arm's 2-norm gap from the same chain
    through the plain twins (which round where the kernels round) within
    MEGA_BF16_NOISE_FACTOR times the twins' own distance from that chain
    in float32; and the gap from the composed arm within
    CHAIN_BF16_ARMS_FACTOR times the composed arm's own distance from its
    float32 chain."""
    import torch
    from paddle_tpu_torch.ops import kernels
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    rows = {dtype: {} for dtype in CONV_DTYPES}
    launches, by_dtype = {}, {}
    for dtype in CONV_DTYPES:
        dt = _torch_dtype(dtype)
        kernels.reset_launch_counts()
        timed = []
        for label, imgs, big, small, side in CONV_CHAIN:
            m = imgs * side * side
            params = _chain_cast(
                _chain_params(gen, big, small, CONV_CHAIN_BLOCKS), dt)
            x = torch.randn(imgs, big, side, side, device=DEVICE,
                            generator=gen).to(dt)
            x_flat = x.permute(0, 2, 3, 1).reshape(m, big).contiguous()

            def flat(t):
                return t.permute(0, 2, 3, 1).reshape(m, big)

            one = _gaps(fused_chain(x_flat, params[:1], side),
                        flat(composed_chain(x, params[:1])))[1]
            want = flat(composed_chain(x, params))
            got = fused_chain(x_flat, params, side)
            rerun_equal = torch.equal(got, fused_chain(x_flat, params, side))
            every = _gaps(got, want)[2]
            twin_gap = twin_limit = None
            if dtype == "f32":
                one_limit, all_limit = CHAIN_ONE_BLOCK_RTOL, CHAIN_NORM_RTOL
            else:
                one_limit = MEGA_BF16_RTOL
                composed_noise = _gaps(want, flat(composed_chain(
                    x.float(), _chain_cast(params, torch.float32))))[2]
                all_limit = CHAIN_BF16_ARMS_FACTOR * composed_noise
                twin = fused_chain(x_flat, params, side, plain=True)
                twin_gap = _gaps(got, twin)[2]
                twin_limit = _norm_limit(dtype, twin, fused_chain(
                    x_flat.float(), _chain_cast(params, torch.float32), side,
                    plain=True))
                print(f"conv chain {label} bf16 after {CONV_CHAIN_BLOCKS} "
                      f"blocks: kernels vs twins 2-norm gap {twin_gap:.3e} "
                      f"(limit {twin_limit:.3e}); fused vs composed "
                      f"{every:.3e} = {every / composed_noise:.3f} x the "
                      f"composed arm's own distance from float32 (limit "
                      f"{CHAIN_BF16_ARMS_FACTOR:.3f} x)", flush=True)
                del twin
            if not (one <= one_limit and every <= all_limit
                    and rerun_equal and (twin_gap is None
                                         or twin_gap <= twin_limit)):
                raise SystemExit(
                    f"conv chain {label} {dtype}: fused vs composed after 1 "
                    f"block max |diff| {one:.3e} * max (limit "
                    f"{one_limit:.3e}), after {CONV_CHAIN_BLOCKS} 2-norm gap "
                    f"{every:.3e} (limit {all_limit:.3e}); kernels vs twins "
                    f"{twin_gap} (limit {twin_limit}); rerun bitwise equal "
                    f"{rerun_equal}")
            del want, got
            timed.append((label, m, big, small, side, params, x, x_flat,
                          (one, every, all_limit, twin_gap, twin_limit)))
        torch.cuda.synchronize()
        by_dtype[dtype] = kernels.launch_counts()
        for name in ("fused_conv1x1", "fused_conv3x3"):
            if by_dtype[dtype][name] == 0:
                raise SystemExit(f"kernel {name} was not launched on the "
                                 f"{dtype} conv chain")
        for name, n in by_dtype[dtype].items():
            launches[name] = launches.get(name, 0) + n
        for label, m, big, small, side, params, x, x_flat, gaps in timed:
            comp = cuda_ms(lambda: composed_chain(x, params), iters=5) \
                / CONV_CHAIN_BLOCKS
            fused = cuda_ms(lambda: fused_chain(x_flat, params, side),
                            iters=5) / CONV_CHAIN_BLOCKS
            flops = 2.0 * m * (2 * big * small + 9 * small * small)
            rows[dtype][label] = dict(
                m=m, big_c=big, small_c=small, side=side,
                blocks=CONV_CHAIN_BLOCKS, composed_ms_per_block=comp,
                fused_ms_per_block=fused, flop_per_block=flops,
                one_block_max_diff_frac=gaps[0],
                all_blocks_norm_gap=gaps[1],
                all_blocks_norm_limit=gaps[2],
                all_blocks_twin_norm_gap=gaps[3],
                all_blocks_twin_norm_limit=gaps[4], rerun_bitwise_equal=True)
            print(f"[{card}] conv chain {dtype} {label} (M {m}, "
                  f"{big}->{small}->{big} @ {side}x{side}, "
                  f"{CONV_CHAIN_BLOCKS} blocks): composed {comp:.3f} "
                  f"ms/block ({flops / comp / 1e9:.1f} TFLOP/s), fused "
                  f"{fused:.3f} ms/block ({flops / fused / 1e9:.1f} "
                  f"TFLOP/s), fused {comp / fused:.2f}x; fused vs composed "
                  f"after 1 block max |diff| {gaps[0]:.3e} * max, after "
                  f"{CONV_CHAIN_BLOCKS} 2-norm gap {gaps[1]:.3e} (limit "
                  f"{gaps[2]:.3e}); rerun bitwise equal", flush=True)
            del params, x, x_flat
        del timed
        print(f"[{card}] conv chain {dtype} kernel launches "
              f"{by_dtype[dtype]}", flush=True)
    return {"card": card, "stages": rows["f32"],
            "bf16_stages": rows["bf16"],
            "launches_by_dtype": {d: {k: by_dtype[d][k] for k in
                                      ("fused_conv1x1", "fused_conv3x3")}
                                  for d in CONV_DTYPES}}, launches


def megakernel_bound(n, hw, cin, cm, dtype):
    """Least time of one bottleneck block on this card: bytes (x read and
    y written once, the weights in the data type, the three BNs' [2, C]
    float32 rows read once) over HBM rate vs 2*N*H*W*Cm*(2*Cin + 9*Cm)
    FLOP over the type's peak (bfloat16 tensor cores, float32 FMA)."""
    size = 2 if dtype == "bf16" else 4
    t_bytes = ((2 * n * hw * cin + 2 * cin * cm + 9 * cm * cm) * size
               + 2 * (2 * cm + cin) * 4) / HBM_BYTES_PER_S
    rate = BF16_FLOPS_PER_S if dtype == "bf16" else FP32_FLOPS_PER_S
    t_ops = 2.0 * n * hw * cm * (2 * cin + 9 * cm) / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _torch_dtype(dtype):
    import torch
    return torch.bfloat16 if dtype == "bf16" else torch.float32


def _mega_inputs(gen, n, side, cin, cm, blocks, random_bn):
    """float32 x [N, side*side, Cin] (randn * 0.5) and `blocks` blocks of
    (w1 [Cin, Cm], w3 [9, Cm, Cm], w2 [Cm, Cin]) drawn randn / sqrt(fan
    in) as block_megakernel_ab.py:86-96 draws them, with the three BNs
    [2, C]: (1, 0) rows as the benchmark's, or gamma in [0.5, 1.5) and
    beta 0.1 * randn."""
    import torch
    x = torch.randn(n, side * side, cin, device=DEVICE, generator=gen) * 0.5
    params = []
    for _ in range(blocks):
        ws = (torch.randn(cin, cm, device=DEVICE, generator=gen) / cin ** 0.5,
              torch.randn(9, cm, cm, device=DEVICE, generator=gen)
              / (9 * cm) ** 0.5,
              torch.randn(cm, cin, device=DEVICE, generator=gen) / cm ** 0.5)
        bns = []
        for c in (cm, cm, cin):
            if random_bn:
                bns.append(torch.stack([
                    torch.rand(c, device=DEVICE, generator=gen) + 0.5,
                    torch.randn(c, device=DEVICE, generator=gen) * 0.1]))
            else:
                bns.append(torch.stack([torch.ones(c, device=DEVICE),
                                        torch.zeros(c, device=DEVICE)]))
        params.append((ws, bns))
    return x, params


def _cast(params, dtype):
    """The weights of `params` in dtype (the BN rows stay float32)."""
    dt = _torch_dtype(dtype)
    return [(tuple(w.to(dt) for w in ws), bns) for ws, bns in params]


def _gaps(got, want):
    """(max |got - want|, that over max|want|, the 2-norm of got - want
    over want's), in float32."""
    import torch
    d = got.float() - want.float()
    return (float(d.abs().max()), float(d.abs().max())
            / float(want.float().abs().max()),
            float(torch.linalg.vector_norm(d))
            / float(torch.linalg.vector_norm(want.float())))


def _norm_limit(dtype, twin, float32_chain):
    """The 2-norm gap a kernel chain may keep from its twin's output
    `twin` after MEGA_BLOCKS blocks: CHAIN_NORM_RTOL in float32; in
    bfloat16 MEGA_BF16_NOISE_FACTOR times the twin's own distance from
    `float32_chain`, the same chain run by the twin in float32."""
    if dtype == "f32":
        return CHAIN_NORM_RTOL
    return MEGA_BF16_NOISE_FACTOR * _gaps(twin, float32_chain)[2]


def check_megakernel(card):
    """Phase 2's rows of the megakernel: bottleneck_block (variant full)
    and roll_micro_block (every variant) against their plain twins on the
    card, in both dtypes, with random BN rows, over MEGA_STAGES x
    MEGA_TILES and MEGA_COVERAGE_CASES (the variants at the coverage
    shapes and at stage 2 tile 2). Returns the worst absolute error of
    each kernel."""
    import torch
    from paddle_tpu_torch.ops.kernels import block_megakernel as bm
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    cases = [(f"{label} t{tile}", n, side, cin, cm, tile)
             for label, n, cin, cm, side in MEGA_STAGES
             for tile in MEGA_TILES] + list(MEGA_COVERAGE_CASES)
    worst = {"block_megakernel": 0.0, "megakernel_roll_micro": 0.0}
    for label, n, side, cin, cm, tile in cases:
        x32, params = _mega_inputs(gen, n, side, cin, cm, 1, True)
        variants = bm.VARIANTS if not label.startswith("stage") or \
            label == "stage2 t2" else ()
        errs = {}
        for dtype in MEGA_DTYPES:
            (ws, bns), = _cast(params, dtype)
            x = x32.to(_torch_dtype(dtype))
            limit = MEGA_BF16_RTOL if dtype == "bf16" else \
                CHAIN_ONE_BLOCK_RTOL
            runs = [("block_megakernel", "full",
                     bm.bottleneck_block(x, *ws, *bns, side, side, tile),
                     bm.bottleneck_block_plain(x, *ws, *bns, side, side,
                                               tile))]
            flat = x.reshape(-1, cin)
            for variant in variants:
                runs.append(("megakernel_roll_micro", variant,
                             bm.roll_micro_block(flat, *ws, *bns, variant,
                                                 side, tile),
                             bm.roll_micro_block_plain(flat, *ws, *bns,
                                                       variant, side, tile)))
            torch.cuda.synchronize()
            for name, variant, got, want in runs:
                if got.dtype != x.dtype or got.shape != want.shape:
                    raise SystemExit(f"{name} {variant} {label} {dtype}: "
                                     f"returned {got.dtype} "
                                     f"{tuple(got.shape)}")
                abs_err, rel, _ = _gaps(got, want)
                worst[name] = max(worst[name], abs_err)
                errs[dtype] = max(errs.get(dtype, 0.0), rel)
                if not rel <= limit:
                    raise SystemExit(
                        f"{name} {variant} disagrees with its plain twin at "
                        f"{label} (N {n}, {side}x{side}, Cin {cin}, Cm {cm}, "
                        f"tile {tile}) in {dtype}: max |diff| {rel:.3e} * "
                        f"max|twin| > {limit:.1e}")
        print(f"[{card}] megakernel {label} (N {n}, {side}x{side}, {cin}->"
              f"{cm}, tile {tile}): full"
              + (f" and {len(variants)} variants" if variants else "")
              + " equal the plain twins, worst max |diff| "
              + ", ".join(f"{dt} {e:.3e}" for dt, e in errs.items())
              + " * max|twin|", flush=True)
    return worst


def _mega_nchw(params):
    """composed_chain's parameters for the same blocks: the NCHW/OIHW
    views of the weights as block_megakernel_ab.py:98-103 takes them
    (pack_w3x3 must undo the 3x3 view exactly) and the BN rows."""
    import torch
    from paddle_tpu_torch.ops.kernels.fused_conv import pack_w3x3
    out = []
    for (w1, w3, w2), bns in params:
        cin, cm = w1.shape
        w3n = w3.reshape(3, 3, cm, cm).permute(3, 2, 0, 1).contiguous()
        if not torch.equal(pack_w3x3(w3n), w3.reshape(9 * cm, cm)):
            raise SystemExit("pack_w3x3 does not undo the OIHW view of w3")
        out.append(((w1.t().reshape(cm, cin, 1, 1).contiguous(), w3n,
                     w2.t().reshape(cin, cm, 1, 1).contiguous()), None,
                    [bns[0][0], bns[0][1], bns[1][0], bns[1][1], bns[2][0],
                     bns[2][1]]))
    return out


def _nchw(x, side):
    return x.reshape(x.shape[0], side, side, -1).permute(0, 3, 1, 2) \
        .contiguous()


def mega_chain(x, params, side, tile, plain=False):
    """The blocks through bottleneck_block (or its plain twin)."""
    from paddle_tpu_torch.ops.kernels import block_megakernel as bm
    fn = bm.bottleneck_block_plain if plain else bm.bottleneck_block
    for ws, bns in params:
        x = fn(x, *ws, *bns, side, side, tile)
    return x


def profile_chain(card, fn, blocks, label):
    """One more call of fn (after a warm-up) under torch.profiler: each
    device kernel's time and launches per block, and their sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((dict(name=key[:120], ms=ms / blocks, count=n / blocks)
                   for key, ms, n in device_kernels(prof)),
                  key=lambda r: -r["ms"])
    total = sum(r["ms"] for r in rows)
    print(f"[{card}] profiled {label}: {total:.4f} ms of device kernels a "
          "block", flush=True)
    for r in rows:
        print(f"  {r['ms']:9.4f} ms {r['count']:5.1f}x  {r['name'][:90]}",
              flush=True)
    return dict(device_ms_per_block=total, kernels=rows)


def megakernel_chain(card):
    """Phase 11: benchmarks/block_megakernel_ab.py's arms on
    MEGA_BLOCKS stacked identity bottlenecks at each MEGA_STAGES stage
    (batch 128), in each dtype, on the same seeded input and weights:
    batch-BN (composed_chain: cuDNN in the dtype, the port's full-batch
    batch_norm in float32), ghost composed (the plain twin on the card)
    and the megakernel, at tiles MEGA_TILES. The megakernel is held
    against the twin after 1 block and after all, and its rerun must be
    bitwise equal; at MEGA_BATCH_BN_CASE (tile = N, float32) it is held
    against the batch-BN arm. Launch counts are set to 0 before the
    first check and read after the last; then each arm is timed per
    block."""
    import torch
    from paddle_tpu_torch.ops import kernels
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    kernels.reset_launch_counts()
    stages = []
    for label, n, cin, cm, side in MEGA_STAGES:
        x32, params32 = _mega_inputs(gen, n, side, cin, cm, MEGA_BLOCKS,
                                     False)
        for dtype in MEGA_DTYPES:
            x = x32.to(_torch_dtype(dtype))
            params = _cast(params32, dtype)
            one_rtol = MEGA_BF16_RTOL if dtype == "bf16" else \
                CHAIN_ONE_BLOCK_RTOL
            checks = {}
            for tile in MEGA_TILES:
                one = _gaps(mega_chain(x, params[:1], side, tile),
                            mega_chain(x, params[:1], side, tile, True))
                got = mega_chain(x, params, side, tile)
                rerun = mega_chain(x, params, side, tile)
                twin = mega_chain(x, params, side, tile, True)
                every = _gaps(got, twin)
                all_rtol = _norm_limit(dtype, twin, mega_chain(
                    x.float(), _cast(params, "f32"), side, tile, True))
                bitwise = bool(torch.equal(got, rerun))
                if not (one[1] <= one_rtol and every[2] <= all_rtol
                        and bitwise):
                    raise SystemExit(
                        f"megakernel chain {label} {dtype} tile {tile}: "
                        f"after 1 block max |diff| {one[1]:.3e} * max "
                        f"(limit {one_rtol:.1e}), after {MEGA_BLOCKS} "
                        f"2-norm gap {every[2]:.3e} (limit {all_rtol:.3e}),"
                        f" rerun bitwise equal: {bitwise}")
                checks[tile] = dict(one_block_max_diff_frac=one[1],
                                    all_blocks_norm_gap=every[2],
                                    all_blocks_norm_limit=all_rtol,
                                    bitwise_rerun=bitwise)
            stages.append((label, n, cin, cm, side, dtype, x, params,
                           checks))
    # ghost BN at tile = N is full-batch BN: the kernel against cuDNN +
    # the port's batch_norm
    n, cin, cm, side = MEGA_BATCH_BN_CASE
    x4, params4 = _mega_inputs(gen, n, side, cin, cm, MEGA_BLOCKS, False)
    nchw4 = _mega_nchw(params4)
    batch_bn = {}
    for depth in (1, MEGA_BLOCKS):
        want = composed_chain(_nchw(x4, side), nchw4[:depth]).permute(
            0, 2, 3, 1).reshape(x4.shape)
        batch_bn[depth] = _gaps(mega_chain(x4, params4[:depth], side, n),
                                want)
    if not (batch_bn[1][1] <= CHAIN_ONE_BLOCK_RTOL
            and batch_bn[MEGA_BLOCKS][2] <= CHAIN_NORM_RTOL):
        raise SystemExit(f"megakernel at tile = N = {n} vs full-batch BN: "
                         f"after 1 block max |diff| {batch_bn[1][1]:.3e} * "
                         f"max, after {MEGA_BLOCKS} 2-norm gap "
                         f"{batch_bn[MEGA_BLOCKS][2]:.3e}")
    print(f"[{card}] megakernel tile = N = {n} (Cin {cin}, Cm {cm}, {side}x"
          f"{side}, float32) vs cuDNN + batch_norm: after 1 block max |diff|"
          f" {batch_bn[1][1]:.3e} * max, after {MEGA_BLOCKS} 2-norm gap "
          f"{batch_bn[MEGA_BLOCKS][2]:.3e}", flush=True)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches["block_megakernel"] == 0:
        raise SystemExit("kernel block_megakernel was not launched on the "
                         "megakernel chain")
    rows = {}
    for label, n, cin, cm, side, dtype, x, params, checks in stages:
        nchw = _mega_nchw(params)
        xn = _nchw(x, side)
        bound_ms, bound_by = megakernel_bound(n, side * side, cin, cm, dtype)
        row = dict(images=n, cin=cin, cm=cm, side=side, blocks=MEGA_BLOCKS,
                   bound_ms=bound_ms, bound_by=bound_by,
                   batch_bn_ms=cuda_ms(lambda: composed_chain(xn, nchw),
                                       iters=3, warmup=1) / MEGA_BLOCKS,
                   tiles={})
        for tile in MEGA_TILES:
            mega = cuda_ms(lambda: mega_chain(x, params, side, tile),
                           iters=3, warmup=1) / MEGA_BLOCKS
            ghost = cuda_ms(lambda: mega_chain(x, params, side, tile, True),
                            iters=3, warmup=1) / MEGA_BLOCKS
            row["tiles"][tile] = dict(mega_ms=mega, ghost_ms=ghost,
                                      **checks[tile])
            print(f"[{card}] megakernel chain {label} {dtype} tile {tile} "
                  f"(N {n}, {cin}->{cm}->{cin} @ {side}x{side}, "
                  f"{MEGA_BLOCKS} blocks): megakernel {mega:.4f} ms/block, "
                  f"ghost composed {ghost:.4f}, batch-BN "
                  f"{row['batch_bn_ms']:.4f}, bound {bound_ms:.4f} "
                  f"({bound_by}; kernel at {100 * bound_ms / mega:.1f}% of "
                  f"it); vs twin after 1 block "
                  f"{checks[tile]['one_block_max_diff_frac']:.3e} * max, "
                  f"after {MEGA_BLOCKS} 2-norm gap "
                  f"{checks[tile]['all_blocks_norm_gap']:.3e} (limit "
                  f"{checks[tile]['all_blocks_norm_limit']:.3e}), rerun "
                  f"bitwise equal", flush=True)
        if (label, dtype) == (MEGA_MAIN_CASE[0], MEGA_MAIN_CASE[2]):
            tile = MEGA_MAIN_CASE[1]
            row["profiled"] = profile_chain(
                card, lambda: mega_chain(x, params, side, tile), MEGA_BLOCKS,
                f"megakernel chain {label} {dtype} tile {tile}")
        rows.setdefault(label, {})[dtype] = row
        del nchw, xn
    del stages
    print(f"[{card}] megakernel chain kernel launches {launches}",
          flush=True)
    return {"card": card, "stages": rows,
            "batch_bn_check": {"images": n, "tile": n,
                               "one_block_max_diff_frac": batch_bn[1][1],
                               "all_blocks_norm_gap":
                                   batch_bn[MEGA_BLOCKS][2]}}, launches


def micro_chain(x, params, variant, side, tile, plain=False):
    """The blocks of one micro variant through roll_micro_block (or its
    plain twin), on x [N*side*side, Cin]."""
    from paddle_tpu_torch.ops.kernels import block_megakernel as bm
    fn = bm.roll_micro_block_plain if plain else bm.roll_micro_block
    for ws, bns in params:
        x = fn(x, *ws, *bns, variant, side, tile)
    return x


def roll_micro(card):
    """Phase 12: benchmarks/megakernel_roll_micro.py at its shapes (stage
    2, batch 128, tile 2, bfloat16, (1, 0) BN rows, MEGA_BLOCKS blocks):
    each variant held against its own plain twin after 1 block and after
    all, then timed per block (kernel and twin). The gaps split the cost:
    full - noroll is the shifts and masks, full - nobn the statistics.
    Launch counts are set to 0 before the first check and read after the
    last."""
    import torch
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.block_megakernel import VARIANTS
    label, n, cin, cm, side = MEGA_STAGES[0]
    tile, dtype = 2, "bf16"
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    x32, params32 = _mega_inputs(gen, n, side, cin, cm, MEGA_BLOCKS, False)
    x = x32.to(_torch_dtype(dtype)).reshape(n * side * side, cin)
    params = _cast(params32, dtype)
    kernels.reset_launch_counts()
    checks = {}
    for variant in VARIANTS:
        one = _gaps(micro_chain(x, params[:1], variant, side, tile),
                    micro_chain(x, params[:1], variant, side, tile, True))
        twin = micro_chain(x, params, variant, side, tile, True)
        every = _gaps(micro_chain(x, params, variant, side, tile), twin)
        limit = _norm_limit(dtype, twin, micro_chain(
            x.float(), _cast(params, "f32"), variant, side, tile, True))
        if not (one[1] <= MEGA_BF16_RTOL and every[2] <= limit):
            raise SystemExit(f"roll micro {variant}: after 1 block max "
                             f"|diff| {one[1]:.3e} * max (limit "
                             f"{MEGA_BF16_RTOL:.1e}), after {MEGA_BLOCKS} "
                             f"2-norm gap {every[2]:.3e} (limit "
                             f"{limit:.3e})")
        checks[variant] = (one, every, limit)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches["megakernel_roll_micro"] == 0:
        raise SystemExit("kernel megakernel_roll_micro was not launched on "
                         "the roll micro")
    bound_ms, bound_by = megakernel_bound(n, side * side, cin, cm, dtype)
    rows = {}
    for variant in VARIANTS:
        ms = cuda_ms(lambda: micro_chain(x, params, variant, side, tile),
                     iters=3, warmup=1) / MEGA_BLOCKS
        plain_ms = cuda_ms(lambda: micro_chain(x, params, variant, side,
                                               tile, True),
                           iters=3, warmup=1) / MEGA_BLOCKS
        one, every, limit = checks[variant]
        rows[variant] = dict(ms=ms, plain_ms=plain_ms,
                             one_block_max_diff_frac=one[1],
                             one_block_max_abs_err=one[0],
                             all_blocks_norm_gap=every[2],
                             all_blocks_norm_limit=limit)
        print(f"[{card}] roll micro {variant} ({label}, N {n}, {cin}->{cm} "
              f"@ {side}x{side}, tile {tile}, {dtype}, {MEGA_BLOCKS} "
              f"blocks): kernel {ms:.4f} ms/block, plain {plain_ms:.4f}; "
              f"vs twin after 1 block {one[1]:.3e} * max, after "
              f"{MEGA_BLOCKS} 2-norm gap {every[2]:.3e} (limit {limit:.3e})",
              flush=True)
    gaps = {"shifts_and_masks_ms": rows["full"]["ms"] - rows["noroll"]["ms"],
            "statistics_ms": rows["full"]["ms"] - rows["nobn"]["ms"],
            "full_minus_strided_ms": rows["full"]["ms"]
            - rows["strided"]["ms"]}
    print(f"[{card}] roll micro: full - noroll (shifts and masks) "
          f"{gaps['shifts_and_masks_ms']:.4f} ms/block, full - nobn "
          f"(statistics) {gaps['statistics_ms']:.4f}, full - strided "
          f"{gaps['full_minus_strided_ms']:.4f}; bound {bound_ms:.4f} "
          f"({bound_by}); launches {launches}", flush=True)
    return {"card": card, "stage": label, "images": n, "cin": cin, "cm": cm,
            "side": side, "tile": tile, "dtype": dtype,
            "blocks": MEGA_BLOCKS, "bound_ms": bound_ms,
            "bound_by": bound_by, "variants": rows, **gaps}, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "paddle_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: paddle_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch import load_param_arrays
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.serving.generation import (GenerationModel,
                                                     GenerationSpec)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the conv parity checks (phases 8-10) compare cuDNN's convolutions
    # with other summation orders: a deterministic algorithm, picked
    # without timing, gives the same sums on every run
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    # -- 1. card and build ---------------------------------------------------
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(built)})", flush=True)
    for src, info in built.items():
        for line in (info["log"] or "").splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    # -- 2. kernels against their plain versions ---------------------------
    attn, coverage_err = check_attention(card)
    attn_bwd, bwd_coverage_err = check_attention_bwd(card)
    lstm_rows, lstm_coverage_err = check_lstm(card)
    gru_rows, gru_coverage_err = check_gru(card)
    conv_rows, conv_coverage_err = check_fused_conv(card)
    mega_coverage_err = check_megakernel(card)

    # -- 3. serve at Transformer-base width --------------------------------
    spec = GenerationSpec(**SERVE_SPEC)
    t0 = time.perf_counter()
    gpu = GenerationModel.build(spec)
    weights = seeded_weights(gpu.programs["startup"], seed=0)
    load_param_arrays(gpu, weights)
    cpu = GenerationModel(gpu.programs, spec, device="cpu")
    load_param_arrays(cpu, weights)
    print(f"models built: {time.perf_counter() - t0:.2f} s "
          f"({sum(w.size for w in weights.values())} parameters)",
          flush=True)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, spec.vocab_size, n).tolist()
               for n in PROMPT_LENS]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gpu_res = serve(gpu, prompts)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    n_tokens = sum(len(r.tokens) for r in gpu_res)
    print(f"[{card}] served {len(prompts)} requests, {n_tokens} tokens in "
          f"{serve_s:.3f} s on the card; kernel launches {launches}",
          flush=True)
    for name in SERVING_KERNELS:
        if launches[name] == 0:
            raise SystemExit(f"kernel {name} was not launched on the "
                             "serving path")
    t0 = time.perf_counter()
    cpu_res = serve(cpu, prompts)
    print(f"CPU reference served in {time.perf_counter() - t0:.3f} s",
          flush=True)
    for i, r in enumerate(gpu_res):
        print(f"request {i}: prompt {PROMPT_LENS[i]}, {len(r.tokens)} "
              f"tokens, {r.finish_reason}", flush=True)
    compare_streams(prompts, gpu_res, cpu_res, cpu)
    timing = time_serving(gpu, card)
    del gpu, cpu

    # -- 4. train at Transformer-base width ----------------------------------
    training, train_launches = train(card)

    # -- 5. train the stacked-LSTM LM ----------------------------------------
    lstm_training, lstm_launches = train_lstm(card)

    # -- 6, 7. train the book's GRU encoder-decoder; reload it -------------
    gru_training, gru_launches = train_gru_nmt(card)

    # -- 8. train MNIST conv on the card and on the CPU ----------------------
    mnist_training, mnist_launches = train_mnist(card)

    # -- 9. train ResNet-50 ----------------------------------------------------
    resnet_training, resnet_launches = train_resnet(card)

    # -- 10. the bottleneck chain: fused conv kernels vs composed --------------
    chain, chain_launches = conv_chain(card)

    # -- 11. the megakernel chain: batch-BN vs ghost composed vs the kernel --
    mega, mega_launches = megakernel_chain(card)

    # -- 12. the roll micro: the megakernel's four variants ------------------
    micro, micro_launches = roll_micro(card)

    # -- 13. result lines ------------------------------------------------------
    main_case = attn[MAIN_CASE]
    train_shapes = {name: {label: r for (n, label), r in
                           list(attn_bwd.items()) + list(lstm_rows.items())
                           + list(gru_rows.items())
                           + list(conv_rows.items()) if n == name}
                    for name in launches}
    by_path = {name: {"serving": launches[name],
                      "training": train_launches[name],
                      "lstm_training": lstm_launches[name],
                      "gru_nmt_training": gru_launches[name],
                      "mnist_training": mnist_launches[name],
                      "resnet_training": resnet_launches[name],
                      "conv_chain": chain_launches[name],
                      "megakernel_chain": mega_launches[name],
                      "roll_micro": micro_launches[name]}
               for name in launches}
    # the megakernel launches on its two paths only, each on its own
    for name, path in (("block_megakernel", "megakernel_chain"),
                       ("megakernel_roll_micro", "roll_micro")):
        stray = {p: k for p, k in by_path[name].items()
                 if k and p != path}
        if stray:
            raise SystemExit(f"kernel {name} launched off its path: {stray}")
    rows = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:61",
        "max_abs_err": max([coverage_err]
                           + [r["max_abs_err"] for r in attn.values()]
                           + [r["max_abs_err"] for r in
                              train_shapes["flash_attention_fwd"].values()]),
        **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "fma_bound_ms",
                                     "fma_bound_by")}}]
    # the flash rows' bound_ms at the 3xTF32 rate of the tensor cores,
    # where all three kernels run their products, fma_bound_ms at the FMA
    # rate of the earlier kernels; the dk/dv row carries the backward total
    # (dq + dk/dv) and the one library call that computes all three
    # gradients
    for name, line in (("flash_attention_bwd_dq", 213),
                       ("flash_attention_bwd_dkv", 265)):
        case = attn_bwd[(name, BWD_MAIN_CASE)]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "max_abs_err": max([bwd_coverage_err]
                               + [r["max_abs_err"] for r in
                                  train_shapes[name].values()]),
            **{k: case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "fma_bound_ms",
                                    "fma_bound_by", "backward_total_ms",
                                    "backward_library_ms") if k in case}})
    for name, line in (("fused_lstm_fwd", 35), ("fused_lstm_bwd", 66)):
        case = lstm_rows[(name, LSTM_MAIN_CASE)]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_lstm.cu",
            "replaces": f"paddle_tpu/ops/pallas/fused_lstm.py:{line}",
            "max_abs_err": max([lstm_coverage_err[name]]
                               + [r["max_abs_err"] for r in
                                  train_shapes[name].values()]),
            **{k: case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}})
    # no PyTorch call computes the GRU's function (torch.nn.GRU resets
    # after the recurrent product): library_ms is null, and the nn.GRU
    # same-FLOP yardstick rides beside it
    for name, line in (("fused_gru_fwd", 44), ("fused_gru_bwd", 63)):
        case = gru_rows[(name, GRU_MAIN_CASE)]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_gru.cu",
            "replaces": f"paddle_tpu/ops/pallas/fused_gru.py:{line}",
            "max_abs_err": max([gru_coverage_err[name]]
                               + [r["max_abs_err"] for r in
                                  train_shapes[name].values()]),
            **{k: case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "yardstick_ms",
                                    "barrier_floor_ms", "plan",
                                    "recurrence_device_ms", "dw_device_ms")
               if k in case}})
    # the fused conv kernels at stage 1 of the chain, float32 (3xTF32),
    # with the bfloat16 kernel's numbers beside them; ms, plain_ms and
    # library_ms in the bare variant (no affine, ReLU or statistics: the
    # function one PyTorch call computes), full_ms with all three;
    # bound_ms on the tensor cores' rate, fma_bound_ms on the FMA rate of
    # the earlier SIMT kernel
    timed_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "full_ms", "fma_bound_ms", "fma_bound_by", "device_ms",
                  "full_device_ms")
    for name, line, label in (
            ("fused_conv1x1", 44, f"{CONV_MAIN_CASE} 256->64"),
            ("fused_conv3x3", 128, f"{CONV_MAIN_CASE} 64->64")):
        case = conv_rows[(name, f"{label} f32")]
        bf16 = conv_rows[(name, f"{label} bf16")]
        errs = {d: conv_coverage_err[(name, d)] for d in CONV_DTYPES}
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_conv.cu",
            "replaces": f"paddle_tpu/ops/pallas/fused_conv.py:{line}",
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": errs["f32"][1],
            "max_stats_err": max(e[2] for e in errs.values()),
            "shape": f"{label} f32",
            **{k: case[k] for k in timed_keys},
            "bf16": {"max_abs_err": errs["bf16"][0],
                     "max_out_err": errs["bf16"][1],
                     "max_stats_err": errs["bf16"][2],
                     **{k: bf16[k] for k in timed_keys}}})
    # the megakernel at MEGA_MAIN_CASE, per block of phase 11's chain; no
    # PyTorch call computes a ghost-BN bottleneck, so library_ms is null,
    # and the batch-BN arm (cuDNN + batch_norm, another function) rides
    # beside it as a yardstick, as the ghost composed arm does as plain_ms
    label, tile, dtype = MEGA_MAIN_CASE
    stage = mega["stages"][label][dtype]
    rows.append({
        "name": "block_megakernel", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/block_megakernel.cu",
        "replaces": "paddle_tpu/ops/pallas/block_megakernel.py:60",
        "max_abs_err": mega_coverage_err["block_megakernel"],
        "shape": f"{label} tile {tile} {dtype}",
        "ms": stage["tiles"][tile]["mega_ms"],
        "plain_ms": stage["tiles"][tile]["ghost_ms"],
        "bound_ms": stage["bound_ms"], "bound_by": stage["bound_by"],
        "library_ms": None, "yardstick_ms": stage["batch_bn_ms"]})
    # the micro's full variant, and every variant's times beside it
    rows.append({
        "name": "megakernel_roll_micro", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/block_megakernel.cu",
        "replaces": "benchmarks/megakernel_roll_micro.py:40",
        "max_abs_err": max([mega_coverage_err["megakernel_roll_micro"]]
                           + [r["one_block_max_abs_err"]
                              for r in micro["variants"].values()]),
        "shape": f"{micro['stage']} tile {micro['tile']} {micro['dtype']}",
        "ms": micro["variants"]["full"]["ms"],
        "plain_ms": micro["variants"]["full"]["plain_ms"],
        "bound_ms": micro["bound_ms"], "bound_by": micro["bound_by"],
        "library_ms": None,
        "variant_ms": {v: r["ms"] for v, r in micro["variants"].items()},
        "variant_plain_ms": {v: r["plain_ms"]
                             for v, r in micro["variants"].items()}})
    for row in rows:
        row["launches"] = sum(by_path[row["name"]].values())
        row["launches_by_path"] = by_path[row["name"]]
        row["training_shapes"] = train_shapes[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"serving": {
        "card": card, "requests": len(prompts), "tokens": n_tokens,
        "serve_s": serve_s, **timing}}))
    print(json.dumps({"training": training}))
    print(json.dumps({"lstm_training": lstm_training}))
    print(json.dumps({"gru_nmt_training": gru_training}))
    print(json.dumps({"mnist_training": mnist_training}))
    print(json.dumps({"resnet_training": resnet_training}))
    print(json.dumps({"conv_chain": chain}))
    print(json.dumps({"megakernel_chain": mega}))
    print(json.dumps({"roll_micro": micro}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
