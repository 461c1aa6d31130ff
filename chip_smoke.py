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
     zero-length rows (the rows of a nested_sequence_flatten among
     them: 16 of 64 of length 0), initial states and last-state
     cotangents for the fused LSTM and the fused GRU; of the ResNet-50 bottleneck shapes,
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
     persistent fused-LSTM kernels at the 3xTF32 rate too; for the
     persistent fused-LSTM and fused-GRU kernels, a bitwise rerun, the
     barrier floor (the same grid through the same barriers with no
     products) and the backward's recurrence and dW reduction apart).
Phases 3-9 and 13 run the port's default executor, the compiled one
(paddle_tpu_torch/core/executor.py: a plan per compile key, each forward
op run once under autograd for its __vjp__ op, a CUDA graph per key from
its second run on), and print how many of its keys were captured; the
launch counts include what every graph replay launches.
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
     PADDLE_TPU_PALLAS_LSTM=0 (the scan route: the rewrite pipeline
     stamps the knob over an op's stamp when it is "1" or "force").
     Losses and
     every parameter's step-1 gradient must agree per element; a
     profiled step gives the fused-LSTM kernels' device ms (forward,
     backward recurrence, dW) beside the step's. One forward and one
     backward launch an lstm op a step.
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
     (forward, backward recurrence, dW) beside the step's. One forward and
     one backward launch a gru op a step.
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
     against the batch-BN arm; timed per block against its bound (in
     float32 at the 3xTF32 rate, the FMA-rate bound beside it) and the
     design's own byte floor; a profiled block names each of its kernels
     (pack, GEMM1, coef, 3x3, h2, GEMM3 statistics, GEMM3 final); the
     megakernel must launch there.
 12. the roll micro of benchmarks/megakernel_roll_micro.py: stage 2,
     tile 2, bfloat16, 8 blocks of each variant (full, strided, nobn,
     noroll) held against its twin and timed; full - noroll is the cost
     of the shifts and masks, full - nobn that of the statistics.
 13. the Trainer (paddle_tpu_torch.trainer), at full width: phase 5's
     LSTM LM fed as sample tuples through Trainer(feed_order=...) and
     DataFeeder, 8 batches with prefetch 2 and lazy costs (log_every 4),
     and without prefetch, each bit for bit equal to the same batches
     through Executor.run by hand (a warm-up arm, then TRAINER_ROUNDS
     interleaved rounds of the three, each timed as wall time a batch);
     then a run stopped after 4 batches with a checkpoint and resumed
     from it in a fresh scope and executor (Trainer.start(resume=True)),
     bit for bit equal to the uninterrupted run (parameters and the step
     counter). DeepFM as bench.py:593-611 runs it (batch 2048, 39 fields,
     1e5 features, embed 8, fc 400x3, Adam lr 1e-3) over 16 seeded
     batches at steps_per_dispatch 1 (a warm-up arm, then
     TRAINER_ROUNDS interleaved rounds), 4, and 1 with prefetch 2: every
     arm bit for bit equal (parameters and costs);
     the first step against the port's CPU path by phase 8's rule; step
     ms, examples/s and peak memory a arm; a profiled prefetch run says
     how much of the feed uploads overlaps kernels. Launch counts are set
     to 0 just before and read just after: the fused-LSTM kernels launch
     there (2 forward and 2 backward a LM step), nothing else.
 14. the eager executor (Executor(compiled=False)) beside the compiled
     one, each pair from the same weights on the same card: serving
     (phase 3's model and requests; token streams equal), NMT at 2+2
     layers (phase 4's width otherwise), the LSTM LM, GRU NMT, DeepFM
     through the Trainer and ResNet-50 at batch 128, each held bit for
     bit (losses or costs, every parameter, the step counter; a
     parameter set into the scope between two replays; the LM also with
     donate_state=False). Per arm:
     ms a step (CVE_WARM untimed steps first: the compiled key's warm-up
     and capture), busy share of CVE_PROFILED profiled steps, peak
     memory, launches a step; the flash, LSTM and GRU forward launches a
     compiled step must be half the eager step's, their backward
     launches equal.
 15. bf16 AMP (paddle_tpu_torch/amp.py, bench.py's default precision):
     the bf16 entry points of the three flash kernels against their bf16
     twins at phase 2's serving case (S1024, causal) and phase 4's
     training shapes (key-row mask and dense), by ROADMAP B1's rule,
     timed beside the twins, F.scaled_dot_product_attention in bf16 and
     their bf16 bounds; phase 4's NMT under amp_guard(), 5 steps, with
     flash (only the bf16 flash kernels launch: 18 of each a step) and
     with use_flash=False stamped, each held against phase 4's float32
     flash arm (see AMP_NMT_FACTOR); ResNet-50 at batch 128 under
     amp_guard(), 5 steps, compiled against eager bit for bit as phase 14
     holds them, its step-1 loss against phase 14's float32 arm (see
     AMP_RESNET_LOSS_RTOL), no kernel launched; per arm ms a step, busy
     share of profiled steps and peak memory, float32 beside AMP.
 16. RNNs under AMP (bench.py's default precision): phase 5's LSTM LM,
     a stacked_lstm_net classifier at its published defaults over phase
     5's feed, phase 6's GRU NMT and that NMT with bias-free gru ops (its
     x stays bf16), 5 compiled steps each under amp_guard() beside the
     float32 arm: exactly the fused-RNN launches of RNN_AMP_LAUNCHES (the
     bf16 LSTM kernels only, 2+2 a LM step; the NMT's float32 GRU
     kernels; the bias-free NMT's bf16 GRU kernels), the compiled key
     captured as a CUDA graph, the step-1 loss within RNN_AMP_LOSS_RTOL
     of the float32 arm's, every step-1 gradient held against the same
     step through the fused-RNN twins (AMP_TWIN_FACTOR, as phase 15
     holds flash); ms a step, busy share and peak memory of both arms.
     Phase 2 holds the bf16 arms of the fused LSTM and GRU kernels
     against their twins (the programs' AMP mixes at the LM's and the
     book model's shapes, and a subset of the coverage cases), timed
     beside the twins, torch.nn.LSTM / nn.GRU in bf16 and their bounds.
 17. the dense optimizers: phase 5's LSTM LM in float32 minimized by
     Adagrad, Adamax, DecayedAdagrad, Adadelta, RMSProp, Ftrl and
     LarsMomentum, each on one of the seven learning-rate schedules
     (set_lr_in_scope), and ModelAverage over SGD, 2 compiled steps each,
     every parameter and accumulator after a step held against the
     float64 update from the fetched gradients (OPT_RTOL); ModelAverage's
     apply and restore once.
 18. the sequence programs (SEQ_CFG): the book's sentiment program
     (sequence_conv with relu, max pool, dynamic_lstm,
     sequence_last_step; IMDB vocabulary 5149, emb 128, hidden 512,
     batch 128 of lengths in [32, 256]) and the hierarchical LSTM of
     tests/test_nested_lod.py at the same widths (32 documents of 1-8
     sentences of 4-64 tokens through DataFeeder at lod_level 2: the
     inner LSTM runs over the flatten's length-0 rows). Each: the kernel
     route in float32, its fused-LSTM launches exactly 1 + 1 and 2 + 2 a
     compiled step, the key captured, a profiled step; step 1 against
     the port's CPU path by phase 8's rule, its ReLUs and max pools
     pinned to the card's (the sentiment on its first SEQ_CPU_ROWS
     rows); the compiled arm against the eager one bit for bit over two
     alternating feeds (phase 14's rule); 5 steps under amp_guard() by
     phase 16's rule (the bf16 LSTM kernels only); the kernel route
     against the scan route by phase 5's rule.
 19. control flow (ops/control_flow_ops.py), float32, compiled: the
     book's machine-translation program (a dynamic_lstm encoder, a
     DynamicRNN decoder: fc([word, state], tanh) -> fc(softmax) a step;
     dictionary 30000, embedding and hidden 512, phase 6's B64 feed of
     lengths in [10, 80]) and the book's dyn_rnn_lstm classifier (the
     LSTM written out in a DynamicRNN step; phase 18's sentiment widths
     and feed). Each: exactly 1 + 1 (MT) and 0 (dyn_rnn_lstm) fused-LSTM
     launches a compiled step, the key captured, a profiled step; step 1
     against the port's CPU path on its first CF_CPU_ROWS rows by phase
     8's rule; the compiled arm against the eager one bit for bit over
     two alternating feeds (phase 14's rule); for the MT program the
     kernel route against the scan route by phase 5's rule and the
     DynamicRNN decoder's share of the device time. Then the WhileGrad
     programs of tests/test_while_grad_dynamic.py: _build's applied
     gradient against 2 (s - target) n, one compile key per trip-count
     bucket, each captured and replayed; the dynamic While in a
     DynamicRNN against central differences of its host replica; a cond
     program and the forward-only unbounded While compiled but named in
     uncaptured_ops (an IfElse beside them captured); each compiled
     against eager bit for bit.
 20. the rewrite pipeline (paddle_tpu_torch/analysis/), on by default
     in every phase above: (a) phase 4's NMT 6+6 built with the composed
     attention chain (matmul, +mask, softmax, matmul) against the fused
     build of the same weights, 5 compiled steps each, float32 and under
     amp_guard(): the pipeline outlines exactly 18 sites, each step
     launches exactly 18 of each flash kernel (the bf16 ones under AMP)
     and nothing else, the key is captured, and losses and parameters
     are bit for bit the fused build's; (b) the composed NMT at 2+2 with
     PADDLE_TPU_OPTIMIZE=0 (cuBLAS matmuls and the softmax op, no
     kernel) against the pipeline on: ms a step, busy share, peak, the
     losses by phase 4's flash-vs-naive rule; (d) the gate's cost on the
     host-bound paths: DeepFM through the Trainer at K = 1 and serving
     decode at cache bucket 1024, PADDLE_TPU_VERIFY=0
     PADDLE_TPU_OPTIMIZE=0 against the defaults in rounds taken in turns
     (costs, parameters and tokens equal), and the gate's check and the
     rewrite cache's lookup timed alone on this host. (c) For every path
     of every phase: its pipeline runs (actions per pass, seconds at the
     miss),
     the largest static memory plan beside the card's peak allocation,
     and the cost model's FLOPs a step of its largest key (phase 20's
     arms also at their step time).
 21. slice 20: (a) control flow under AMP: phase 19's MT and
     dyn_rnn_lstm at phase 19's width under amp_guard(), compiled
     against eager bit for bit, the MT's bf16 fused-LSTM kernels exactly
     1 + 1 a compiled step (A4C_LAUNCHES), the step-1 loss against phase
     19's float32 arm by phase 16's rule, every loop carry's dtype at
     every pass printed (one dtype each); (b) the image models bench.py
     runs (SE-ResNeXt at batch 12, cut from 152 layers to 50 to hold the
     script's time, GoogLeNet without its auxiliary
     heads and AlexNet with lrn at batch 128, 3x224x224), float32 and
     AMP, each compiled against eager bit for bit with ms a step, busy
     share and peak memory beside the static memory plan, no hand kernel
     launched (cuDNN convolutions); fuse_se outlines no gate of
     SE-ResNeXt's training program and 16 of its inference program,
     whose predictions with the pipeline on and off are held (SE_F32_ATOL
     and the AMP rule) and timed; (c) four chapters of the Fluid book on
     the port's dataset readers, card losses against the port's CPU run
     (BOOK_FIRST_RTOL, BOOK_LATER_RTOL), and each chapter's save / load
     round trip on the card bit for bit.
 22. slice 21, on a fresh metrics registry with the flight recorder's
     bundles in a scratch directory: (a) the book's last two chapters
     (label_semantic_roles with its linear-chain CRF, recommender_system
     with cos_sim) as phase 21 (c) runs the first four, SRL's
     crf_decoding tags equal to the CPU's on the card's emissions, its
     fused-LSTM kernels exactly 1 + 1 a compiled step, and SRL once more
     at the Fluid book's widths, timed; (b) ModelHost serving bench.py's
     frozen ResNet-50 (1000 classes, one 3x224x224 image a request,
     buckets 1-256): every delivered row bit for bit a direct run of its
     padded bucket, one compiled key and one CUDA graph a bucket,
     images/s, latency, batch fill and busy share under closed-loop
     clients, a hot swap under them with zero client errors and its
     blackout, admission at 2x the calibrated rate (the shed ledger, the
     admitted p99 bound); (c) a two-model GenerationHost at phase 3's
     width: streams equal a direct engine's, flash launches a prefill,
     a generation.step fault tripping the breaker with the completed
     tokens kept, a swap keeping an in-flight stream, save / load, idle
     TTFT, the decode arm at 2x with decode tokens/s and the MFU gauge
     against the card's peak; (d) the registry's serving families.
 23. JSON lines of the kernels, serving, the three earlier trainings,
     MNIST, ResNet-50, the conv chain, the megakernel chain, the roll
     micro, the Trainer, phase 14 (`compiled`), phase 15 (`amp`), phase
     16 (`rnn_amp`), phase 17 (`optimizers`), phase 18
     (`sequence_models`), phase 19 (`control_flow`), phase 20
     (`rewrite`), phase 21 (`slice20`) and phase 22 (`slice21`), then,
     last, the JSON result line.

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
def nested_rows(t, docs=16, slots=4):
    """Row lengths as RaggedNested.flatten makes them: `docs` documents of
    4, 3, 2, 3, ... sentences over `slots` sub-sequence slots each, every
    padding slot a length-0 row (16 of the 64 rows at the defaults), the
    live rows 1..t tokens long."""
    subs = [(4, 3, 2, 3)[d % 4] for d in range(docs)]
    return [1 + (5 * d + 3 * s) % t if s < subs[d] else 0
            for d in range(docs) for s in range(slots)]


NESTED_ROWS = nested_rows(16)
# fused-LSTM sweep: (T, B, H, lengths, nonzero h0/c0, nonzero dc_all and
# last-state cotangents): H 16/128, B=1, T=1, zero-length rows, an H and
# B off every tile edge; H 1024 and 2048, whose W strips do not fit in
# shared memory (the persistent kernels stream the rest from L2); the rows
# of a nested_sequence_flatten (NESTED_ROWS: 16 of 64 rows of length 0),
# at the hierarchical program's state (zero h0/c0, Hidden-only cotangent)
# and with every state and cotangent nonzero
LSTM_COVERAGE_CASES = [
    (8, 4, 16, [0, 3, 8, 1], True, True),
    (5, 3, 128, [5, 2, 4], True, True),
    (6, 2, 1024, [6, 3], True, True),
    (7, 1, 128, [7], False, True),
    (1, 5, 128, [1, 0, 1, 1, 0], True, True),
    (16, 40, 100, [i % 17 for i in range(40)], True, True),
    (5, 8, 2048, [5, 3, 0, 5, 1, 4, 5, 2], True, True),
    (16, 64, 512, NESTED_ROWS, False, False),
    (16, 64, 128, NESTED_ROWS, True, True),
]
# the times of the per-step kernels the persistent ones replaced (one
# launch a step forward, two backward; PERF.md rows 4-5, NVIDIA H100 80GB
# HBM3, 700.00 W), printed beside the persistent kernels' times and kept
# out of the kernels line, which holds only this run's numbers
LSTM_PER_STEP_MS = {("fused_lstm_fwd", "ragged"): "0.8701-0.8831",
                    ("fused_lstm_fwd", "full"): "0.8714-0.8841",
                    ("fused_lstm_bwd", "ragged"): "2.4845-2.5138",
                    ("fused_lstm_bwd", "full"): "2.4845-2.5138"}
# kernel name fragments of a fused-LSTM call in a profile
LSTM_KERNELS = {"forward": "lstm_fwd_persistent", "backward recurrence":
                "lstm_bwd_persistent", "dW": "lstm_dw_"}
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
# memory (the persistent kernels stream the rest from L2); the rows of a
# nested_sequence_flatten (NESTED_ROWS: 16 of 64 rows of length 0)
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
    (16, 64, 512, NESTED_ROWS, False, True),
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

# phase 2, the bf16 arms of the fused LSTM and GRU (the Pallas kernels on
# bf16 streams: float32 arithmetic, every stream rounded at store). Each
# kernel against its plain twin in the same dtypes, the backward fed the
# kernel's own forward outputs: every bf16 output within one bf16 ulp of
# the stored value plus 1e-5 of its sum of |terms| (fused_lstm.bf16_excess
# <= 1, fused_lstm.step_terms), every float32 one (dW, db, the gates, the
# NMT mix's streams) by _max_err as the float32 rows. The main cases are
# the programs' AMP mixes at the LM's and the book model's shapes: LSTM
# bf16 streams with float32 w, b and bf16 h0, c0 (phase 16's LM); GRU all
# streams bf16 with float32 w and bf16 h0 (the bias-free NMT); and the
# NMT's own mix, float32 streams with a bf16 h0, which runs the float32
# kernels. Then a subset of the coverage cases: a zero-length row, B = 1,
# H off a tile edge, H 2048 streamed from L2, and the rows of a
# nested_sequence_flatten (16 of 64 of length 0).
LSTM_BF16_CASES = [LSTM_COVERAGE_CASES[i] for i in (0, 3, 5, 6, 7, 8)]
GRU_BF16_CASES = [GRU_COVERAGE_CASES[i] for i in (0, 2, 6, 8, 9)]


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

# the Trainer phase: phase 5's LSTM LM (LSTM_CFG, B64 x T64, lengths in
# [32, 64] drawn as lm_lengths draws them, seeds 0-7) fed as sample
# tuples through Trainer(feed_order=...) and DataFeeder, 8 batches,
# prefetch 2, log_every 4; a checkpoint every 4 batches for the
# stop-and-resume arm
TRAINER_LM_BATCHES, TRAINER_LM_CKPT_EVERY = 8, 4
TRAINER_LM_PREFETCH, TRAINER_LM_LOG_EVERY = 2, 4
# the Trainer phase's timed arms run in this many interleaved rounds and
# report the median: host-clock times of one arm move 7-26% within a call
TRAINER_ROUNDS = 3
# DeepFM as bench.py:593-611 measures it (BASELINE config 5): 1e5
# features, 39 fields, embed 8, fc 400x3, Adam lr 1e-3, batch 2048; 16
# seeded dense batches drawn as the bench draws its feed
DEEPFM_CFG = dict(num_features=int(1e5), num_fields=39, embed_dim=8,
                  lr=1e-3)
DEEPFM_BATCH, DEEPFM_BATCHES, DEEPFM_K = 2048, 16, 4

# phase 14, the eager arm (Executor(compiled=False)) beside the compiled
# arm: each training arm runs CVE_STEPS steps, the first CVE_WARM of them
# the compiled key's warm-up and capture (untimed), then CVE_PROFILED
# steps under torch.profiler for the busy share. NMT runs at 2+2 layers
# (the script's time limit), everything else at its phase's width.
CVE_STEPS, CVE_WARM, CVE_PROFILED = 6, 2, 2
CVE_NMT_CFG = dict(TRAIN_CFG, n_layer=2)
# the kernels whose forward the eager arm's __vjp__ replays launch a
# second time: their forward launches a compiled step must be half the
# eager step's, their backward launches equal
CVE_HALVED = {"nmt": ("flash_attention_fwd", ("flash_attention_bwd_dq",
                                              "flash_attention_bwd_dkv")),
              "lstm_lm": ("fused_lstm_fwd", ("fused_lstm_bwd",)),
              "gru_nmt": ("fused_gru_fwd", ("fused_gru_bwd",)),
              "sentiment": ("fused_lstm_fwd", ("fused_lstm_bwd",)),
              "hierarchical": ("fused_lstm_fwd", ("fused_lstm_bwd",))}
# phase 15, bf16 AMP. The bf16 flash kernels against their bf16 twins at
# phase 2's serving case (S1024, causal, the key-row mask of ATTN_CASES)
# and phase 4's training shapes (key-row mask and dense decoder bias):
# (label, (B, H, S, D), bias kind, causal)
AMP_ATTN_CASES = [("S1024", (1, 8, 1024, 64), "serving", True),
                  ("keyrow", TRAIN_ATTN, "keyrow", False),
                  ("dense", TRAIN_ATTN, "dense", False)]
AMP_MAIN_CASES = {"flash_attention_fwd_bf16": "S1024",
                  "flash_attention_bwd_dq_bf16": "keyrow",
                  "flash_attention_bwd_dkv_bf16": "keyrow"}
# the bf16 entry points the AMP NMT step launches, 18 each a step (6
# encoder self-attentions, 6 decoder self- and 6 cross-attentions)
AMP_NMT_KERNELS = tuple(AMP_MAIN_CASES)
AMP_NMT_LAUNCHES_PER_STEP = 18
# the AMP arm with flash (a) against phase 4's float32 flash arm (c): its
# step-1 loss and every parameter's step-1 gradient may sit at most this
# many times as far from (c) as the AMP arm with the naive attention (b)
# does (distance: |loss difference|, 2-norm of the gradient difference).
# Both AMP arms round every mul and conv the same way; (b) also rounds
# the attention scores to bf16 before the softmax, (a) P and dS as the
# Pallas kernels do. Held for every parameter but the attentions' Q and
# K projection weights: their gradients pass through ds = p (dp - delta),
# a difference of nearly equal terms, and the flash algorithm takes delta
# = rowsum(dO * O) from the bf16 O (as the reference's Pallas backward
# does), the naive one from its own float32 softmax; (a)'s sit up to
# ~12x farther from float32 there (an H100 run of this script, deep
# decoder layers) with kernels that agree with their twins. Every parameter,
# those included, is held against (a'): the same AMP step with the three
# bf16 kernels swapped for their plain twins and the ReLUs pinned to
# (a)'s masks: (a) may sit at most AMP_TWIN_FACTOR times as far from (a')
# as (a') sits from (c). Where the bf16 rounding noise dominates a
# gradient (the Q/K projections, through delta), the kernel and the twin
# round P, and so O and delta, at other scales: two roundings whose
# noise is independent sit about sqrt(2) times one's noise apart (an H100
# run: up to 1.61 on the deepest decoder layer's cross-attention Q/K,
# 0.03-0.76 everywhere else). A wrong tile, mask or rounding moves a
# gradient by O(1), hundreds of times the AMP noise.
AMP_NMT_FACTOR = 2.0
AMP_TWIN_FACTOR = 2.0
# ResNet-50 under AMP (bench.py's default precision): its step-1 loss
# within this relative distance of the float32 arm's (phase 14's,
# same weights and feeds): bf16 convs and activations move a
# 1000-class cross entropy by well under 1%; a cast in the wrong place
# (a float32 conv, a bf16 statistic) moves it by more, or not at all
AMP_RESNET_LOSS_RTOL = 5e-2
# each AMP ResNet-50 arm: AMP_STEPS steps (phase 14's first CVE_WARM of
# them untimed), then CVE_PROFILED profiled steps for the busy share (the
# NMT arms take phase 4's TRAIN_STEPS)
AMP_STEPS = 5

# phase 16, the RNN programs under AMP: phase 5's LSTM LM, a
# stacked_lstm_net classifier at its published defaults (hidden 512, emb
# 512, 3 layers, the middle one reversed) over phase 5's vocabulary, feed
# and batch, phase 6's GRU NMT, and that NMT with both GRUs built as gru
# ops without their Bias input (the op's Bias is optional in both
# packages; dynamic_gru(bias_attr=False) still creates one there, so the
# bias-free program is built from the op): its x stays bf16 under AMP,
# where the NMT's float32 bias promotes it. Each runs RNN_AMP_STEPS
# compiled steps under amp_guard() beside its float32 arm (same weights
# and feed), from the same seed.
STACKED_CFG = dict(vocab_size=LSTM_CFG["vocab_size"], hid_dim=512,
                   emb_dim=512, stacked_num=3, class_dim=2, lr=1e-3)
RNN_AMP_STEPS = TRAIN_STEPS
# the fused-RNN launches a step under AMP, and nothing else of theirs: bf16
# LSTM kernels only (zero float32 LSTM launches), one forward and one
# backward a layer; the NMT's float32 GRU kernels (its streams are float32
# after the bias add); the bias-free NMT's bf16 GRU kernels
RNN_AMP_LAUNCHES = {
    "lstm_lm": {"fused_lstm_fwd_bf16": 2, "fused_lstm_bwd_bf16": 2},
    "stacked_lstm_net": {"fused_lstm_fwd_bf16": 3, "fused_lstm_bwd_bf16": 3},
    "gru_nmt": {"fused_gru_fwd": 2, "fused_gru_bwd": 2},
    "gru_nmt_nobias": {"fused_gru_fwd_bf16": 2, "fused_gru_bwd_bf16": 2}}
# each AMP arm's step-1 loss within this relative distance of its float32
# arm's: bf16 products and activations move a cross entropy by well under
# 1% at these widths (from seeded initial weights the LM's logits are
# near 0 and its loss, ~ln(10000) a token, may not move at all), a wrong
# cast or gate by O(1); and some step-1 gradient differs from the float32
# arm's (else nothing was rounded). Every step-1 gradient of the AMP arm
# is held against
# the same step with the fused-RNN kernels swapped for their plain twins
# (rnn_twins), at AMP_TWIN_FACTOR times that step's distance from the
# float32 arm, as phase 15 holds flash: kernel and twin sum in another
# order, so one may round a stored value on a rounding boundary to the
# other neighbour; a wrong mask, gate or rounding moves a gradient by O(1)
RNN_AMP_LOSS_RTOL = 2e-2

# phase 17, the dense optimizers: phase 5's LSTM LM in float32 minimized by
# each class for OPT_STEPS compiled steps, its learning rate one of the
# seven schedules (set_lr_in_scope before each step); ModelAverage over
# phase 5's SGD at lr 1.0 (its window closes at the second update). Every
# parameter and accumulator after a step is held against the same
# update computed in float64 on the host (the program's update ops, in
# order, over the fetched gradients and the state before the step),
# within OPT_RTOL of the element plus OPT_ATOL_FRAC of the tensor's
# largest value: float32 on the card against float64, a few roundings of
# the update's expression (LARS's norms sum a million squares); a wrong
# slot, attr or schedule moves an update by O(1) of itself.
OPT_STEPS = 2
OPT_RTOL, OPT_ATOL_FRAC = 1e-4, 1e-6
OPT_CLASSES = [
    ("AdagradOptimizer", {}, ("exponential_decay", (0.1, 1, 0.5))),
    ("AdamaxOptimizer", {}, ("noam_decay", (512, 4000, 100.0))),
    ("DecayedAdagradOptimizer", {}, ("inverse_time_decay", (0.1, 1, 0.5))),
    ("AdadeltaOptimizer", {}, ("polynomial_decay", (1.0, 4))),
    ("RMSPropOptimizer", {"momentum": 0.5},
     ("piecewise_decay", ([1], [0.01, 0.005]))),
    ("FtrlOptimizer", {"l1": 1e-4, "l2": 1e-4},
     ("natural_exp_decay", (0.1, 1, 0.5))),
    ("LarsMomentumOptimizer", {}, ("cosine_decay", (1.0, 1, 4))),
    ("ModelAverage", {"average_window_rate": 0.5, "min_average_window": 2,
                      "max_average_window": 3}, None)]

# DeepFM's three dispatch arms (K = 1, K = 4, K = 1 with prefetch 2) and a
# rerun of the K = 1 arm run the same ops in the same order on the same
# card: all must end bit for bit equal (parameters and costs).
# card vs the port's CPU path, first step of batch 0: the first loss
# within rtol 1e-4; step-1 gradients by phase 8's rule (per element
# against a CPU step whose ReLUs take the card's masks, rtol 1e-4, atol
# 1e-5 * max|g|; the free CPU step by 2-norm <= TRAIN_GRAD_NORM_RTOL)
DEEPFM_LOSS_RTOL = 1e-4

# phase 18, the sequence programs of slice 17 at full width. (a) The
# book's sentiment program (tests/test_book.py test_understand_sentiment:
# sequence_conv with relu -> max pool; fc -> dynamic_lstm ->
# sequence_last_step; concat -> fc -> softmax cross entropy; Adam 5e-3) at
# the IMDB vocabulary (paddle_tpu/dataset/imdb.py:15) and the widths of
# the Fluid book's stacked_lstm_net (emb 128, hidden 512), batch 128 of
# lengths uniform in [32, 256]. (b) The hierarchical LSTM of
# tests/test_nested_lod.py (the embedding of a 2-level LoD feed ->
# nested_sequence_flatten -> fc -> dynamic_lstm -> sequence_last_step ->
# nested_sequence_pack -> fc -> dynamic_lstm -> sequence_last_step -> fc
# -> softmax cross entropy; Adam 1e-2) at the same widths: 32 documents of
# 1-8 sentences of 4-64 tokens, through DataFeeder at lod_level 2 (its
# flatten hands the inner LSTM a length-0 row for every padding slot).
SEQ_CFG = dict(vocab=5149, emb=128, hid=512)
SEQ_LR = {"sentiment": 5e-3, "hierarchical": 1e-2}
SEQ_SENT_BATCH, SEQ_SENT_LENS = 128, (32, 256)
SEQ_DOCS, SEQ_SENTS, SEQ_TOKS = 32, (1, 8), (4, 64)
# the sentiment rows phase 18 holds the card against the port's CPU path on
SEQ_CPU_ROWS = 8
# fused-LSTM launches a compiled step: one forward and one backward an
# lstm op (float32 kernels, and under AMP the bf16 ones only)
SEQ_LSTM_OPS = {"sentiment": 1, "hierarchical": 2}

# Phase 19: control flow (ops/control_flow_ops.py), float32, the compiled
# executor. (a) The Fluid book's machine-translation train program (ch. 8:
# encoder embedding -> fc(4H, tanh) -> dynamic_lstm -> sequence_last_step;
# decoder a DynamicRNN over the target embedding, memory(init=encoder
# last), fc([word, pre_state], H, tanh) -> fc(V, softmax) a step;
# cross_entropy -> mean; Adam at phase 6's lr) at phase 6's width
# (dictionary 30000 both sides, embedding and hidden 512) and feed (B64,
# source and target lengths in [10, 80]). (b) The book's dyn_rnn_lstm
# sentiment classifier (ch. 6: embedding -> fc(H, tanh), a DynamicRNN step
# that writes the LSTM out: four gate_common fc pairs, sigmoid gates and
# a tanh cell, two memories; sequence_last_step -> fc(2, softmax), cross
# entropy -> mean; Adam) at phase 18's sentiment widths and feed. (c) The
# WhileGrad programs of tests/test_while_grad_dynamic.py: _build (:19)
# and the dynamic While inside a DynamicRNN (:264). (d) Routes that are
# not captured: the dynamic While in a cond branch (:322) and the
# forward-only unbounded While (:101), beside the IfElse of
# tests/test_dynamic_rnn.py:89, which is.
CF_MT_CFG = dict(vocab=GRU_NMT_CFG["dict_size"], emb=GRU_NMT_CFG["emb_dim"],
                 hid=GRU_NMT_CFG["hid_dim"], lr=GRU_NMT_CFG["lr"])
CF_SENT_CFG = dict(vocab=SEQ_CFG["vocab"], emb=SEQ_CFG["emb"],
                   hid=SEQ_CFG["hid"], lr=SEQ_LR["sentiment"])
# the rows of (a) and (b) held against the port's CPU path (the time axis
# cut to their longest row)
CF_CPU_ROWS = 4
# fused-LSTM launches a compiled step: (a) one lstm op forward and
# backward, (b) none (its LSTM is written out in the step)
CF_LSTM_OPS = {"mt": 1, "dyn_rnn_lstm": 0}
# steps of each compiled-vs-eager arm of (a) and (b): CVE_WARM untimed,
# then one that reads a parameter set from outside (phase 14's rule); no
# profiled steps (torch.profiler's events of an eager step of (b), ~10^5
# ops, take tens of seconds to sum)
CF_CVE_STEPS = 4
# (c): the analytic gradient 2 (s - target) n of _build, and the
# dynamic While in a DynamicRNN against central differences of its host
# replica (eps 1e-3), as tests/test_while_grad_dynamic.py holds them
CF_ANALYTIC_RTOL, CF_FD_RTOL = 1e-4, 1e-3

# phase 20, the rewrite pipeline (paddle_tpu_torch/analysis/): the
# composed NMT at phase 4's configuration outlines its 6 encoder
# self-attentions, 6 decoder self- and 6 cross-attentions onto the flash
# kernels: exactly REWRITE_SITES outlined sites and that many launches of
# each flash kernel a compiled step, float32 and under AMP
REWRITE_SITES = 18
# (b): the pipeline's own cost at phase 14's 2+2 depth, the composed
# build with PADDLE_TPU_OPTIMIZE=0 (cuBLAS matmuls and the softmax op)
# against the same build with the pipeline on (6 outlined sites)
REWRITE_2X2_SITES = 6
# (d): the gate on the host-bound paths, off (PADDLE_TPU_VERIFY=0,
# PADDLE_TPU_OPTIMIZE=0) and at the defaults, GATE_ROUNDS interleaved
# rounds of each; serving decodes GATE_DECODE_STEPS steps a round at the
# largest cache bucket
GATE_ROUNDS = 4
GATE_DECODE_STEPS = 20

# phase 21, slice 20. (a) Control flow under AMP: phase 19's MT and
# dyn_rnn_lstm programs at phase 19's width and feeds under amp_guard():
# compiled against eager bit for bit (phase 14's rule, CF_CVE_STEPS
# steps), the MT's bf16 fused-LSTM kernels exactly A4C_LAUNCHES a compiled
# step (no float32 LSTM launch), the step-1 loss within RNN_AMP_LOSS_RTOL
# of phase 19's float32 arm on the same weights and feed (phase 16's
# rule), and the dtype of every loop carry at every pass printed.
A4C_LAUNCHES = {"mt": {"fused_lstm_fwd_bf16": 1.0,
                       "fused_lstm_bwd_bf16": 1.0},
                "dyn_rnn_lstm": {}}
# (b) The image models bench.py runs that the port lacked, at bench.py's
# batch and shape (bench.py:534-575; 1000 classes, 3x224x224, Momentum
# 0.9): SE-ResNeXt (cardinality 32, lr 0.1) at batch 12 with its depth
# cut from bench.py's 152 layers (counts (3, 8, 36, 3)) to 50
# (SE_LAYER_COUNTS: a SE-ResNeXt-152 step walks 3018 forward ops on the
# host, 116 s of the script's phase 21 at full depth), GoogLeNet
# without its auxiliary heads (bench.py's protocol, lr 0.01) and AlexNet
# with lrn (lr 0.01) at batch 128. Each in float32 and under
# amp_guard(): IMAGE_STEPS steps of the eager and the compiled
# executor (phase 14's rule: bit for bit; CVE_WARM untimed, the rest
# timed, IMAGE_PROFILED profiled), no hand-kernel launch (the convs go to
# cuDNN, as the reference's go to XLA), ms a step, busy share and peak
# memory beside the largest static memory plan of the arm's keys. Their
# dropout keeps the compiled keys from a CUDA graph.
IMAGE_MODELS = {"se_resnext": 12, "googlenet": 128, "alexnet": 128}
SE_LAYER_COUNTS = (3, 4, 6, 3)
IMAGE_SHAPE, IMAGE_CLASSES = (3, 224, 224), 1000
IMAGE_STEPS, IMAGE_PROFILED = 4, 1
# SE-ResNeXt's inference program (its trained program pruned to the
# logits and cloned for_test, as io.save_inference_model freezes it;
# every batch_norm's running statistics set to the batch's own, as a
# trained network's would normalize it: calibrate_batch_norms) at batch
# 12 with the pipeline on (fuse_se outlines one se_block a block:
# SE_SITES) and off (the composed gates): the float32 logits within
# SE_F32_ATOL of the largest, or RESNET_NOISE_FACTOR times how far
# weights one ulp away move the composed logits where that is larger
# (se_block sums the pool in another order than pool2d's window, and 50
# gates and 155 batch_norms pass that on); under AMP the outlined logits
# no farther from the composed ones than the composed AMP logits sit
# from the float32 ones (2-norm); ms a batch of each, SE_TIMED runs after
# two untimed. fuse_se outlines no gate of the training program: its
# backward reads the intermediates.
SE_SITES = sum(SE_LAYER_COUNTS)
SE_F32_ATOL = 1e-4
SE_TIMED = 5
# (c) Four chapters of the Fluid book (tests/test_book.py:47, :69, :96,
# :122), each built as its chapter builds it, fed BOOK_BATCHES batches
# from the port's dataset readers through reader.batch (the synthetic
# corpora: DATA_HOME an empty directory) on the card and on the port's
# CPU path from the same seeded weights: the first loss within rtol 1e-4
# (phase 8's rule: cuDNN and cuBLAS sum in other orders than the CPU),
# the later ones within BOOK_LATER_RTOL of the CPU's (Adam's first steps
# move a weight whose gradient is within float noise of 0 by the
# learning rate either way); then the chapter's save/load round trip on
# the card, the reloaded model's output bit for bit the trained
# program's pruned forward on the same feed.
BOOK_BATCHES = 4
BOOK_FIRST_RTOL = 1e-4
BOOK_LATER_RTOL = {"fit_a_line": 1e-4, "recognize_digits": 1e-4,
                   "image_classification": 1e-3, "word2vec": 1e-4}

# phase 22, slice 21. (a) The book's last two chapters
# (tests/test_book.py:208 label_semantic_roles, :262 recommender_system)
# as phase 21 (c) runs the first four (BOOK_BATCHES batches, card vs CPU
# by BOOK_FIRST_RTOL and LAST_CHAPTERS_RTOL, the round trip bit for bit);
# SRL's crf_decoding tags on the card equal the CPU's crf_decoding of the
# card's emissions and transition exactly (integer tags); SRL's fused-LSTM
# launches exactly SRL_LAUNCHES a compiled step (its dynamic_lstm on the
# kernel, forward and backward). Then SRL once more at the Fluid book's
# widths (SRL_BOOK_CFG: word_dim 32, mark_dim 5, hidden 512, its single
# LSTM layer; the chapter's batch of 16), SRL_BOOK_STEPS steps timed.
LAST_CHAPTERS_RTOL = {"label_semantic_roles": 1e-4,
                      "recommender_system": 1e-4}
SRL_TEST_CFG = {"emb": 16, "mark_emb": 16, "hid": 32}
SRL_BOOK_CFG = {"emb": 32, "mark_emb": 5, "hid": 512}
SRL_MAXLEN, SRL_BATCH, SRL_BOOK_STEPS = 32, 16, 6
SRL_LAUNCHES = {"fused_lstm_fwd": 1, "fused_lstm_bwd": 1}
# (b) ModelHost serving bench.py:619's frozen ResNet-50 (1000 classes,
# test-mode batch norm, 3x224x224 float32, seeded weights; a second
# version from another seed), one image a request, batch buckets 1-256
# (bench.py's batch), RESNET_LATENCY_MS deadline: every delivered row of
# a burst drive (RESNET_BURSTS) bit for bit a direct Executor.run of the
# same padded bucket (tests/test_serving.py:29); one compiled key and one
# CUDA graph per bucket; closed-loop clients (RESNET_CLIENTS threads,
# RESNET_WINDOW requests in flight each) calibrate the capacity over
# RESNET_CAL_S and give images/s, p50/p99, batch fill and, profiled over
# RESNET_PROFILE_S, the busy share; a hot swap to the second version
# under those clients with zero client errors and its blackout (the
# largest gap between completions within 0.25 s of the swap); then
# admission (max_queue_rows RESNET_ADMIT_ROWS) at 2x the calibrated
# rate open loop for RESNET_ADMIT_S: every refused request in the shed
# ledger, every admitted one answered, admitted p99 within
# RESNET_P99_FACTOR times the queue's drain time (admitted rows + two
# buckets over the capacity).
SERVE_RESNET_CFG = {"class_dim": 1000, "depth": 50}
RESNET_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256]
RESNET_LATENCY_MS = 5.0
RESNET_BURSTS = [1, 2, 5, 16, 40, 100, 256, 300]
RESNET_IMAGES = 32
RESNET_CLIENTS, RESNET_WINDOW = 4, 128
RESNET_CAL_S, RESNET_PROFILE_S, RESNET_ADMIT_S = 4.0, 1.5, 4.0
RESNET_ADMIT_ROWS = 512
RESNET_P99_FACTOR = 2.0
# (c) A two-model GenerationHost at phase 3's width (SERVE_SPEC; the
# second model from seed 1), driven as benchmarks/serving_latency.py:351's
# decode arm drives it: the streams of phase 3's prompts, one request at
# a time, equal a direct GenerationEngine's of the same weights; flash
# forward launches exactly n_layer a prefill at a prompt bucket of
# PADDLE_TPU_FLASH_MIN_SEQ or more (phase 3's count); a generation.step
# fault after GEN_FAULT_AFTER steps trips a one-failure breaker and the
# request keeps its completed tokens (the solo stream's prefix); a swap
# keeps an in-flight request's stream; a save / load round trip streams
# the same tokens; idle TTFT per prompt bucket (max_new_tokens 1, median
# of GEN_TTFT_RUNS); closed-loop calibration (2 x slots clients,
# GEN_CAL_S) then open loop at 2x for GEN_DRIVE_S: goodput, decode
# tokens/s, latency and the MFU gauge against the card's peak.
GEN_FAULT_AFTER = 2
# the MFU gauges are read against the card's peak (observability/
# attribution.py's default, unless PADDLE_TPU_PEAK_FLOPS says otherwise)
PEAK_FLOPS = BF16_FLOPS_PER_S
PEAK_NOTE = ("989e12 FLOP/s, the dense bf16 peak of an NVIDIA H100 80GB "
             "HBM3 at 700 W")
GEN_TTFT_RUNS = 3
GEN_CAL_S, GEN_DRIVE_S = 3.0, 4.0
# (d) After (b) and (c), on the fresh registry the phase installs: the
# serving and token-serving families tests/test_metric_names.py expects
# (SERVING_FAMILIES; tests/test_torch_serving.py holds the same list) all
# published, and nothing else but the rest of serving's
# (OTHER_SERVING_FAMILIES) and the process-wide mirrors
# (PROCESS_FAMILIES).
SERVING_FAMILIES = frozenset({
    "paddle_tpu_serving_requests_total",
    "paddle_tpu_circuit_breaker_state",
    "paddle_tpu_mfu",
    "paddle_tpu_model_flops",
    "paddle_tpu_serving_swaps_total",
    "paddle_tpu_serving_shed_total",
    "paddle_tpu_serving_model_version",
    "paddle_tpu_serving_canary_requests_total",
    "paddle_tpu_decode_requests_total",
    "paddle_tpu_decode_tokens_total",
    "paddle_tpu_decode_steps_total",
    "paddle_tpu_decode_prefills_total",
    "paddle_tpu_decode_retired_total",
    "paddle_tpu_decode_shed_total",
    "paddle_tpu_decode_step_seconds",
    "paddle_tpu_decode_prefill_seconds",
    "paddle_tpu_decode_slots_active",
    "paddle_tpu_decode_slots_total",
    "paddle_tpu_decode_host_requests_total",
    "paddle_tpu_decode_host_swaps_total",
    "paddle_tpu_decode_host_models",
    "paddle_tpu_memory_peak_bytes",
})
OTHER_SERVING_FAMILIES = frozenset({
    "paddle_tpu_serving_rejected_total",
    "paddle_tpu_serving_timeouts_total",
    "paddle_tpu_serving_errors_total",
    "paddle_tpu_serving_batches_total",
    "paddle_tpu_serving_warmup_compiles_total",
    "paddle_tpu_serving_queue_depth_rows",
    "paddle_tpu_serving_batch_fill_ratio",
    "paddle_tpu_serving_batch_rows",
    "paddle_tpu_serving_latency_seconds",
    "paddle_tpu_serving_queue_wait_seconds",
    "paddle_tpu_circuit_breaker_opened_total",
    "paddle_tpu_circuit_breaker_shed_total",
})
PROCESS_FAMILIES = frozenset({
    "paddle_tpu_retry_calls_total", "paddle_tpu_retry_retries_total",
    "paddle_tpu_retry_failures_total",
    "paddle_tpu_flight_recorder_dumps_total",
})


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
# a masked score in bf16 (F.scaled_dot_product_attention's mask for the
# bf16 yardstick): -1e9 rounds to a bf16 value, exp of it is 0 all the same
NEG_INF_BF16 = -1e9


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


# the float32 products of the fused-LSTM kernels on the tensor cores:
# three TF32 passes (3xTF32)
LSTM_PATH_RATE = TF32_FLOPS_PER_S / 3


def lstm_bound(t, b, h, lengths_sum, backward, rate=LSTM_PATH_RATE,
               stream_bytes=4):
    """Least time for one fused-LSTM call on this card: 2*L*H*4H FLOP
    forward, 3x that backward (recompute, dh_prev, dW), L the sum of the
    lengths, at `rate` FLOP/s (3xTF32 on the tensor cores by default;
    FP32_FLOPS_PER_S for the FMA units; the bf16 arm's products are
    float32 too); vs the bytes of its inputs read once and outputs
    written once over HBM rate, the [T,B,.] streams at `stream_bytes` an
    element (2: the bf16 arm), the rest at 4."""
    fwd = 2.0 * lengths_sum * h * 4 * h
    bwd = 3.0 * fwd
    seq, state, x, w = t * b * h, b * h, t * b * 4 * h, h * 4 * h + 4 * h
    s = stream_bytes
    if backward:
        # in: x, w, b, h0, c0, lengths, h_all, c_all, dh_all, dc_all,
        # dh_last, dc_last; out: dx, dw, db, dh0, dc0
        nbytes, flops = s * (2 * x + 4 * seq) + 4.0 * (
            2 * w + 6 * state + b), bwd
    else:
        # in: x, w, b, h0, c0, lengths; out: h_all, c_all, h_last, c_last
        nbytes, flops = s * (x + 2 * seq) + 4.0 * (w + 4 * state + b), fwd
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / rate
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
    b_hh 0, in x's dtype (bf16: cuDNN's bf16 LSTM, which also rounds its
    state and products to bf16). Returns (forward fn, backward fn, max
    |h_all - kernel's|)."""
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
    lstm = lstm.to(x.dtype)
    xl = x.clone().requires_grad_(True)
    lens_cpu = lengths.cpu().long()
    h0, c0 = h0.to(x.dtype), c0.to(x.dtype)

    def fwd():
        packed = pack_padded_sequence(xl, lens_cpu, enforce_sorted=False)
        out, _ = lstm(packed, (h0[None], c0[None]))
        return pad_packed_sequence(out, total_length=t)[0]

    out = fwd()
    err = (out.float() - fused_lstm_fwd(*inputs)[0].float()).abs().max(
        ).item()
    wrt = (xl,) + tuple(lstm.parameters())

    def bwd():
        return torch.autograd.grad(out, wrt, cts[0], retain_graph=True)
    return fwd, bwd, err


def _rnn_holds(got, want, names, terms, rounded=()):
    """Each kernel output against its twin's: bf16 ones, and those named
    in `rounded` (rounded to bf16 and then widened), by the bf16 rule
    (terms[name], see fused_lstm.step_terms), float32 ones as _max_err
    holds them. Returns (max |err|, the worst bf16 excess, ok)."""
    from paddle_tpu_torch.ops.kernels import fused_lstm as fl
    import torch
    err, excess, ok = 0.0, 0.0, True
    for name, g, w in zip(names, got, want):
        if g is None and w is None:
            continue
        if g.dtype != w.dtype:
            raise SystemExit(f"{name}: the kernel gives {g.dtype}, the twin "
                             f"{w.dtype}")
        err = max(err, (g.float() - w.float()).abs().max().item())
        if g.dtype == torch.bfloat16 or name in rounded:
            r = fl.bf16_excess(g, w, terms[name])
            excess, ok = max(excess, r), ok and r <= 1.0
        else:
            ok = ok and _max_err([g], [w])[1]
    return err, excess, ok


def _lstm_bf16_case(gen, t, b, h, lens, state, cotangents):
    """LSTM inputs in the LM's AMP mix (bf16 x, h0, c0 and cotangents;
    float32 w and b) and the kernel-vs-twin holds: (forward (err, excess,
    ok), backward (err, excess, ok), inputs, cotangents, kernel forward)."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_lstm as fl
    inputs, cts = _lstm_inputs(gen, t, b, h, lens, state, cotangents)
    x, w, bias, h0, c0, lengths = inputs
    bf = torch.bfloat16
    inputs = (x.to(bf), w, bias, h0.to(bf), c0.to(bf), lengths)
    cts = tuple(None if c is None else c.to(bf) for c in cts)
    fwd_k = fl.fused_lstm_fwd(*inputs)
    fwd_p = fl.fused_lstm_fwd_plain(*inputs)
    bwd_k = fl.fused_lstm_bwd(*inputs, *fwd_k[:2], *cts)
    bwd_p = fl.fused_lstm_bwd_plain(*inputs, *fwd_k[:2], *cts)
    torch.cuda.synchronize()
    h_prev = torch.cat([inputs[3][None].float(), fwd_p[0][:-1].float()])
    fwd_terms = fl.step_terms(h_prev, w, inputs[0], bias)
    dh_all, dc_all = fl.fold_last(
        torch.zeros_like(fwd_k[0]) if cts[0] is None else cts[0],
        torch.zeros_like(fwd_k[1]) if cts[1] is None else cts[1],
        cts[2], cts[3], lengths)
    bwd_terms = fl.step_terms(bwd_p[0].float(), w.t(), dh_all, dc_all)
    fwd = _rnn_holds(fwd_k, fwd_p, ("h_all", "c_all", "h_last", "c_last"),
                     dict.fromkeys(("h_all", "c_all", "h_last", "c_last"),
                                   fwd_terms))
    bwd = _rnn_holds(bwd_k, bwd_p, ("dx", "dw", "db", "dh0", "dc0"),
                     dict.fromkeys(("dx", "dh0", "dc0"), bwd_terms))
    return fwd, bwd, inputs, cts, fwd_k


def check_lstm_bf16(card):
    """The bf16 arm of the fused-LSTM kernels (fused_lstm_{fwd,bwd}_bf16)
    against the twins in the LM's AMP mix at its shape (T64 B64 H512, the
    ragged lengths), timed beside the twins, torch.nn.LSTM in bf16 and the
    bound (the float32 products' rate, bf16 streams' bytes); then over
    LSTM_BF16_CASES. Returns (rows, {kernel: max |err|})."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_lstm as fl
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    t, b, h = LSTM_T, LSTM_BATCH, LSTM_CFG["hid_dim"]
    lens = lm_lengths()[1]
    fwd, bwd, inputs, cts, outs = _lstm_bf16_case(gen, t, b, h, lens, False,
                                                  False)
    if not (fwd[2] and bwd[2]):
        raise SystemExit(f"fused LSTM bf16 kernels disagree with their "
                         f"twins at T={t} B={b} H={h}: forward {fwd}, "
                         f"backward {bwd} (max |err|, bf16 excess, ok)")
    bwd_args = inputs + tuple(outs[:2]) + cts
    reruns = [fl.fused_lstm_fwd(*inputs) + fl.fused_lstm_bwd(*bwd_args)
              for _ in range(2)]
    if not all(torch.equal(x, y) for x, y in zip(*reruns)):
        raise SystemExit("fused LSTM bf16 kernels: a rerun is not bitwise "
                         "equal")
    lib_fwd, lib_bwd, lib_err = lstm_library(inputs, cts)
    l_sum = int(np.sum(lens))
    rows = {}
    for name, run, plain, lib_fn, hold, backward in (
            ("fused_lstm_fwd_bf16", lambda: fl.fused_lstm_fwd(*inputs),
             lambda: fl.fused_lstm_fwd_plain(*inputs), lib_fwd, fwd, False),
            ("fused_lstm_bwd_bf16", lambda: fl.fused_lstm_bwd(*bwd_args),
             lambda: fl.fused_lstm_bwd_plain(*bwd_args), lib_bwd, bwd,
             True)):
        ms = cuda_ms(run, iters=10)
        plain_ms = cuda_ms(plain, iters=5)
        library_ms = cuda_ms(lib_fn, iters=10)
        bound_ms, bound_by = lstm_bound(t, b, h, l_sum, backward,
                                        stream_bytes=2)
        rows[(name, "ragged")] = dict(
            max_abs_err=hold[0], allowance_ratio=hold[1], ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_max_abs_err=lib_err)
        print(f"[{card}] {name} T={t} B={b} H={h} ragged (sum {l_sum}): "
              f"max_abs_err={hold[0]:.3e} bf16 excess={hold[1]:.3f} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} nn.LSTM bf16 "
              f"library_ms={library_ms:.4f} (its h_all vs the kernel's: "
              f"{lib_err:.3e}) bound_ms={bound_ms:.4f} ({bound_by})",
              flush=True)
    parts = kernel_device_ms(lambda: fl.fused_lstm_bwd(*bwd_args),
                             LSTM_KERNELS)
    rows[("fused_lstm_bwd_bf16", "ragged")].update(
        recurrence_device_ms=parts["backward recurrence"],
        dw_device_ms=parts["dW"])
    print(f"  fused_lstm_bwd_bf16 device ms: {parts}", flush=True)
    errs = {"fused_lstm_fwd_bf16": fwd[0], "fused_lstm_bwd_bf16": bwd[0]}
    for t, b, h, lens, state, cotangents in LSTM_BF16_CASES:
        fwd, bwd, _, _, _ = _lstm_bf16_case(gen, t, b, h, lens, state,
                                            cotangents)
        print(f"fused_lstm bf16 T={t} B={b} H={h} lengths={list(lens)[:8]} "
              f"h0/c0={state} cotangents={cotangents}: forward max_abs_err "
              f"{fwd[0]:.3e} excess {fwd[1]:.3f}, backward {bwd[0]:.3e} "
              f"excess {bwd[1]:.3f}", flush=True)
        if not (fwd[2] and bwd[2]):
            raise SystemExit(f"fused LSTM bf16 kernels disagree with their "
                             f"twins at T={t} B={b} H={h} lengths={lens}")
        errs["fused_lstm_fwd_bf16"] = max(errs["fused_lstm_fwd_bf16"], fwd[0])
        errs["fused_lstm_bwd_bf16"] = max(errs["fused_lstm_bwd_bf16"], bwd[0])
    return rows, errs


def check_lstm(card):
    """The fused-LSTM forward and backward kernels against their plain
    twins on the card at the LM's shape (T64 B64 H512, the bench.py
    ragged lengths and full lengths), each run twice (bitwise equal),
    timed there beside the per-step kernels' times, the cuDNN yardstick,
    the bound (3xTF32, the FMA-rate bound beside it), the barrier floor
    (the same grid through the same barriers with no products) and the
    backward's recurrence and dW reduction apart; then over
    LSTM_COVERAGE_CASES."""
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
        bwd_args = inputs + tuple(outs[:2]) + cts
        reruns = [fl.fused_lstm_fwd(*inputs) + fl.fused_lstm_bwd(*bwd_args)
                  for _ in range(2)]
        if not all(torch.equal(x, y) for x, y in zip(*reruns)):
            raise SystemExit(f"fused LSTM kernels: a rerun at T={t} B={b} "
                             f"H={h} {label} is not bitwise equal")
        lib_fwd, lib_bwd, lib_err = lstm_library(inputs, cts)
        if lib_err > LSTM_LIBRARY_ATOL:
            raise SystemExit(f"the cuDNN yardstick computes another function"
                             f": max |h_all diff| {lib_err:.3e}")
        l_sum = int(np.sum(lens))
        fwd_args = inputs
        times = {
            "fused_lstm_fwd": (
                cuda_ms(lambda: fl.fused_lstm_fwd(*fwd_args), iters=10),
                cuda_ms(lambda: fl.fused_lstm_fwd_plain(*fwd_args), iters=5),
                cuda_ms(lib_fwd, iters=10), ferr, False),
            "fused_lstm_bwd": (
                cuda_ms(lambda: fl.fused_lstm_bwd(*bwd_args), iters=10),
                cuda_ms(lambda: fl.fused_lstm_bwd_plain(*bwd_args), iters=5),
                cuda_ms(lib_bwd, iters=10), berr, True)}
        parts = kernel_device_ms(lambda: fl.fused_lstm_bwd(*bwd_args),
                                 LSTM_KERNELS)
        for name, (ms, plain_ms, library_ms, err, bwd) in times.items():
            bound_ms, bound_by = lstm_bound(t, b, h, l_sum, bwd)
            fma_ms, fma_by = lstm_bound(t, b, h, l_sum, bwd,
                                        FP32_FLOPS_PER_S)
            plan = fl.barrier_floor(t, b, h, bwd, DEVICE)
            floor_ms = cuda_ms(
                lambda: fl.barrier_floor(t, b, h, bwd, DEVICE), iters=10)
            rows[(name, label)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                fma_bound_ms=fma_ms, fma_bound_by=fma_by,
                barrier_floor_ms=floor_ms, plan=plan,
                **({"recurrence_device_ms": parts["backward recurrence"],
                    "dw_device_ms": parts["dW"]} if bwd else {}))
            print(f"[{card}] {name} T={t} B={b} H={h} {label} lengths (sum "
                  f"{l_sum}): max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                  f"(per-step kernels: {LSTM_PER_STEP_MS[(name, label)]}) "
                  f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}, 3xTF32) "
                  f"fma_bound_ms={fma_ms:.4f} ({fma_by}) "
                  f"barrier_floor_ms={floor_ms:.4f} ({plan['barriers']} "
                  "barriers)" + (f" recurrence_device_ms="
                                 f"{parts['backward recurrence']:.4f} "
                                 f"dw_device_ms={parts['dW']:.4f}"
                                 if bwd else ""), flush=True)
            print(f"  plan: {plan}", flush=True)
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


def gru_bound(t, b, h, lengths_sum, backward, bf16=False):
    """Least time for one fused-GRU call on this card: 2*L*H*3H FLOP
    forward; 2x that backward, which reads the forward's saved gates and
    so recomputes nothing (d_rh = dc W_c^T, [du, dr] W_ur^T, dW_ur, dW_c:
    2*L*H*6H), L the sum of the lengths, over the fp32 rate; vs the bytes
    of the function's inputs read once and outputs written once over HBM
    rate. bf16: the [T,B,.] streams at 2 bytes, and the backward's
    function takes x in place of the gates, which it must recompute at
    the stored h_all (one forward's products more: 3x the forward)."""
    fwd = 2.0 * lengths_sum * h * 3 * h
    seq, state, g3, w = t * b * h, b * h, t * b * 3 * h, h * 3 * h
    s = 2 if bf16 else 4
    if backward:
        # in: gates (bf16: x), w, h0, lengths, h_all, dh_all, dh_last;
        # out: dx, dw, dh0
        nbytes = (s + 4) * g3 if not bf16 else 2 * s * g3
        nbytes, flops = nbytes + s * 2 * seq + 4.0 * (
            2 * w + 3 * state + b), (3.0 if bf16 else 2.0) * fwd
    else:
        # in: x, w, h0, lengths; out: h_all, h_last
        nbytes, flops = s * (g3 + seq) + 4.0 * (w + 2 * state + b), fwd
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
    sequence with the kernel's lengths and h0, in x's dtype. Returns
    (forward fn, backward fn)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence
    x, w, h0, lengths = inputs
    t, b, g = x.shape
    h = g // 3
    gru = torch.nn.GRU(1, h).to(DEVICE).to(x.dtype)
    xl = torch.zeros(t, b, 1, device=DEVICE, dtype=x.dtype).normal_(
        ).requires_grad_(True)
    lens_cpu = lengths.cpu().long().clamp(min=1)
    h0 = h0.to(x.dtype)

    def fwd():
        packed = pack_padded_sequence(xl, lens_cpu, enforce_sorted=False)
        out, _ = gru(packed, h0[None])
        return pad_packed_sequence(out, total_length=t)[0]

    out = fwd()
    wrt = (xl,) + tuple(gru.parameters())

    def bwd():
        return torch.autograd.grad(out, wrt, cts[0], retain_graph=True)
    return fwd, bwd


def kernel_device_ms(fn, groups, iters=5):
    """Device ms per call of each group of kernels that fn launches
    ({part: fragment of its kernels' names}, as GRU_KERNELS), from one
    torch.profiler pass over `iters` calls after a warm-up call."""
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
            for part, frag in groups.items()}


def _gru_bf16_case(gen, t, b, h, lens, state, last, mix):
    """GRU inputs in an AMP mix and the kernel-vs-twin holds. mix "bf16":
    every stream bf16 (x, cotangents), float32 w, bf16 h0 (the bias-free
    NMT); "nmt": float32 streams with a bf16 h0 (the book NMT under AMP,
    the float32 kernels). Returns (forward (err, excess, ok), backward
    (err, excess, ok), inputs, cotangents, kernel forward)."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_gru as fg
    from paddle_tpu_torch.ops.kernels import fused_lstm as fl
    inputs, cts = _gru_inputs(gen, t, b, h, lens, state, last)
    x, w, h0, lengths = inputs
    bf = torch.bfloat16
    sdt = bf if mix == "bf16" else torch.float32
    inputs = (x.to(sdt), w, h0.to(bf), lengths)
    cts = tuple(None if c is None else c.to(sdt) for c in cts)
    recompute = sdt == bf
    fwd_k = fg.fused_gru_fwd(*inputs)
    fwd_p = fg.fused_gru_fwd_plain(*inputs)
    saved = (None, inputs[0]) if recompute else (fwd_k[2], None)
    bwd_k = fg.fused_gru_bwd(w, inputs[2], lengths, fwd_k[0], saved[0],
                             *cts, x=saved[1])
    bwd_p = fg.fused_gru_bwd_plain(w, inputs[2], lengths, fwd_k[0],
                                   saved[0], *cts, x=saved[1])
    torch.cuda.synchronize()
    h_prev = torch.cat([inputs[2][None].float(), fwd_p[0][:-1].float()])
    fwd_terms = fl.step_terms(h_prev, w, inputs[0])
    dh_all, _ = fg.fold_last(cts[0], cts[1], lengths)
    bwd_terms = fl.step_terms(bwd_p[0].float(), w.t(), dh_all)
    fwd = _rnn_holds(fwd_k, fwd_p, ("h_all", "h_last", "gates"),
                     dict.fromkeys(("h_all", "h_last"), fwd_terms))
    if not recompute:   # the float32 forward, as phase 2's float32 rows
        fwd = fwd[:2] + (fwd[0] <= GRU_FWD_ATOL,)
    # a bf16 h0's dh0 is rounded to bf16 by both, and where a zero-length
    # row passes its float32 h_last cotangent straight to dh0 the sum is
    # float32, as the reference's (_fused_gru_bwd: bf16 + float32): it
    # stays a bf16-rounded value for the other rows
    bwd = _rnn_holds(bwd_k, bwd_p, ("dx", "dw", "dh0"),
                     dict.fromkeys(("dx", "dh0"), bwd_terms),
                     rounded=("dh0",) if inputs[2].dtype == bf else ())
    return fwd, bwd, inputs, cts, fwd_k


def check_gru_bf16(card):
    """The bf16 arm of the fused-GRU kernels (fused_gru_{fwd,bwd}_bf16,
    the backward recomputing the gates at the stored h_all) against the
    twins with every stream bf16 at the book model's shape (T80 B64 H512,
    the source lengths), timed beside the twins, torch.nn.GRU in bf16 (a
    same-FLOP yardstick, not the function) and the bound; the book NMT's
    own AMP mix (float32 streams, bf16 h0: the float32 kernels) at that
    shape; then both mixes over GRU_BF16_CASES. Returns (rows, {kernel:
    max |err|})."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_gru as fg
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    t, b, h = GRU_T, GRU_BATCH, GRU_NMT_CFG["hid_dim"]
    lens = gru_lengths()[1]
    errs = {"fused_gru_fwd_bf16": 0.0, "fused_gru_bwd_bf16": 0.0,
            "fused_gru_fwd": 0.0, "fused_gru_bwd": 0.0}
    rows = {}
    for mix in ("bf16", "nmt"):
        fwd, bwd, inputs, cts, outs = _gru_bf16_case(gen, t, b, h, lens,
                                                     False, False, mix)
        print(f"fused_gru {mix} mix T={t} B={b} H={h} ragged: forward "
              f"max_abs_err {fwd[0]:.3e} excess {fwd[1]:.3f}, backward "
              f"{bwd[0]:.3e} excess {bwd[1]:.3f}", flush=True)
        if not (fwd[2] and bwd[2]):
            raise SystemExit(f"fused GRU kernels disagree with their twins "
                             f"in the {mix} mix at T={t} B={b} H={h}")
        suffix = "_bf16" if mix == "bf16" else ""
        errs["fused_gru_fwd" + suffix] = fwd[0]
        errs["fused_gru_bwd" + suffix] = bwd[0]
        if mix != "bf16":
            continue
        bwd_args = (inputs[1], inputs[2], inputs[3], outs[0], None) + cts
        reruns = [fg.fused_gru_fwd(*inputs)
                  + fg.fused_gru_bwd(*bwd_args, x=inputs[0])
                  for _ in range(2)]
        if not all(torch.equal(x, y) for x, y in zip(*reruns)):
            raise SystemExit("fused GRU bf16 kernels: a rerun is not "
                             "bitwise equal")
        yard_fwd, yard_bwd = gru_yardstick(inputs, cts)
        l_sum = int(np.sum(lens))
        for name, run, plain, yard, hold, backward in (
                ("fused_gru_fwd_bf16", lambda: fg.fused_gru_fwd(*inputs),
                 lambda: fg.fused_gru_fwd_plain(*inputs), yard_fwd, fwd,
                 False),
                ("fused_gru_bwd_bf16",
                 lambda: fg.fused_gru_bwd(*bwd_args, x=inputs[0]),
                 lambda: fg.fused_gru_bwd_plain(*bwd_args, x=inputs[0]),
                 yard_bwd, bwd, True)):
            ms = cuda_ms(run, iters=10)
            plain_ms = cuda_ms(plain, iters=5)
            yard_ms = cuda_ms(yard, iters=10)
            bound_ms, bound_by = gru_bound(t, b, h, l_sum, backward, True)
            rows[(name, "ragged")] = dict(
                max_abs_err=hold[0], allowance_ratio=hold[1], ms=ms,
                plain_ms=plain_ms, library_ms=None, yardstick_ms=yard_ms,
                bound_ms=bound_ms, bound_by=bound_by)
            print(f"[{card}] {name} T={t} B={b} H={h} ragged (sum {l_sum}): "
                  f"max_abs_err={hold[0]:.3e} bf16 excess={hold[1]:.3f} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} nn.GRU bf16 "
                  f"yardstick_ms={yard_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by})", flush=True)
        parts = kernel_device_ms(
            lambda: fg.fused_gru_bwd(*bwd_args, x=inputs[0]),
            dict(GRU_KERNELS, recompute="gru_gates_"))
        rows[("fused_gru_bwd_bf16", "ragged")].update(
            recompute_device_ms=parts["recompute"],
            recurrence_device_ms=parts["backward recurrence"],
            dw_device_ms=parts["dW"])
        print(f"  fused_gru_bwd_bf16 device ms: {parts}", flush=True)
    for t, b, h, lens, state, last in GRU_BF16_CASES:
        for mix in ("bf16", "nmt"):
            fwd, bwd, _, _, _ = _gru_bf16_case(gen, t, b, h, lens, state,
                                               last, mix)
            print(f"fused_gru {mix} mix T={t} B={b} H={h} lengths="
                  f"{list(lens)[:8]} h0={state} h_last cotangent={last}: "
                  f"forward {fwd[0]:.3e} excess {fwd[1]:.3f}, backward "
                  f"{bwd[0]:.3e} excess {bwd[1]:.3f}", flush=True)
            if not (fwd[2] and bwd[2]):
                raise SystemExit(f"fused GRU kernels disagree with their "
                                 f"twins in the {mix} mix at T={t} B={b} "
                                 f"H={h} lengths={lens}")
            suffix = "_bf16" if mix == "bf16" else ""
            for kind, hold in (("fwd", fwd), ("bwd", bwd)):
                key = f"fused_gru_{kind}{suffix}"
                errs[key] = max(errs[key], hold[0])
    return rows, errs


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
        parts = kernel_device_ms(lambda: fg.fused_gru_bwd(*bwd_args),
                                 GRU_KERNELS)
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
    (host clock; each call returns host tokens, so it ends synchronized),
    each after two untimed calls (a compiled key's warm-up and capture)."""
    rng = np.random.RandomState(2)
    spec = model.spec
    out = {"prefill_ms": {}, "decode_tokens_per_s": {}}
    for bucket in spec.prompt_buckets:
        prompt = rng.randint(1, spec.vocab_size, bucket).tolist()
        for _ in range(2):
            model.run_prefill(prompt, 0)
        t0 = time.perf_counter()
        for _ in range(5):
            model.run_prefill(prompt, 0)
        out["prefill_ms"][bucket] = (time.perf_counter() - t0) / 5 * 1e3
    tokens = rng.randint(1, spec.vocab_size, spec.slots).astype(np.int64)
    for bucket in spec.cache_buckets:
        positions = np.full(spec.slots, bucket - 1, np.int64)
        for _ in range(2):
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


def _stamp_naive(main, naive=True):
    """use_flash=False (with naive=False: the attr taken away, the op's
    auto policy back in charge) on every attention op and on the fwd_op
    copy each __vjp__ took at append_backward time."""
    for op in main.desc.global_block.ops:
        if op.type == "scaled_dot_product_attention":
            attrs = op.attrs
        elif op.type == "__vjp__" and \
                op.attrs["fwd_op"]["type"] == "scaled_dot_product_attention":
            attrs = op.attrs["fwd_op"]["attrs"]
        else:
            continue
        if naive:
            attrs["use_flash"] = False
        else:
            attrs.pop("use_flash", None)
    main.desc._bump_version()


@contextlib.contextmanager
def flash_twins():
    """The bf16 flash kernels' wrappers swapped for their plain twins
    while inside (on CUDA tensors too; no launch is counted)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    saved = (fa.flash_attention_fwd_bf16, fa.flash_attention_bwd_dq_bf16,
             fa.flash_attention_bwd_dkv_bf16)
    fa.flash_attention_fwd_bf16 = fa.flash_attention_fwd_plain
    fa.flash_attention_bwd_dq_bf16 = fa.flash_attention_bwd_dq_plain
    fa.flash_attention_bwd_dkv_bf16 = fa.flash_attention_bwd_dkv_plain
    try:
        yield
    finally:
        (fa.flash_attention_fwd_bf16, fa.flash_attention_bwd_dq_bf16,
         fa.flash_attention_bwd_dkv_bf16) = saved


def host_dense(value, feed):
    """A fetched value as the dense array the program computed: a ragged
    fetch (a LoDTensor of its valid rows) padded back to the time steps
    of the feed's ragged values, zero past each row's length."""
    if not hasattr(value, "lod"):
        return value
    t = max(v.data.shape[1] for v in feed.values() if hasattr(v, "lengths"))
    return value.to_padded(max_len=t)[0]


def train_arm(main, startup, loss, weights, feed, params, card, label,
              profiled=0):
    """TRAIN_STEPS Adam steps from `weights` in a fresh scope; the first
    also fetches every parameter's gradient and the sign of every ReLU
    input. Each step's time is a host clock around Executor.run, which
    ends synchronized (it returns the fetches as numpy). With `profiled`,
    the kernels' launch counts are read after those steps, and that many
    more steps run under torch.profiler for the device-busy share."""
    import torch
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    from paddle_tpu_torch.ops import kernels
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
            signs = {n: host_dense(x, feed) > 0 for n, x in
                     zip(relu_in, out[1 + len(params):])}
        if not np.isfinite(losses[-1]):
            raise SystemExit(f"{label} arm: loss {losses[-1]} at step {step}")
        print(f"[{card}] train {label} step {step}: loss {losses[-1]:.6f} "
              f"{step_ms[-1]:.1f} ms peak {peaks[-1] / 2**30:.2f} GiB",
              flush=True)
    print(f"[{card}] train {label}: {capture_note(exe)}", flush=True)
    out = dict(losses=losses, step_ms=step_ms, peak_bytes=max(peaks),
               grads=grads, relu_signs=signs,
               captured=sum(c.captured for c in exe._cache.values()))
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        out["launches"] = kernels.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profiled):
                exe.run(main, feed=feed, fetch_list=[loss.name],
                        scope=scope)
            wall_ms = (time.perf_counter() - t0) * 1e3
        out["busy"] = sum(ms for _, ms, _ in device_kernels(prof)) / wall_ms
    return out


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


def capture_note(exe):
    """How `exe`'s compiled keys ran on the card: the keys, how many were
    captured as a CUDA graph, and the op types (registered
    capturable=False) that kept any from one."""
    keys = list(exe._cache.values())
    blockers = sorted({t for c in keys for t in c.uncaptured_ops})
    replayed = sorted({t for c in keys for t in c.replayed})
    return (f"{len(keys)} compiled keys, {sum(c.captured for c in keys)} "
            f"captured" + (f"; not capturable: {blockers} (the startup "
                           "program's random init)" if blockers else "")
            + (f"; __vjp__ replays of {replayed}" if replayed else ""))


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
    # the compiled key's first run is its warm-up, the second captures it:
    # the profiled run replays the graph
    for _ in range(2):
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
          f"({100 * busy_ms / wall_ms:.1f}% busy, overlap not removed); "
          f"captured {exe.last_compiled.captured}", flush=True)
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
    # the forward alone: the ops before append_backward's seed (the eager
    # arm's __vjp__ replays run this much a second time a step)
    blk = main.desc.global_block
    ops = blk.ops
    seed = [loss.name + "@GRAD"]
    blk.ops = ops[:next(i for i, op in enumerate(ops)
                        if op.output("Out") == seed)]
    main.desc._bump_version()
    try:
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        t0 = time.perf_counter()
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        fwd_ms = (time.perf_counter() - t0) / 3 * 1e3
    finally:
        blk.ops = ops
        main.desc._bump_version()
    print(f"[{card}] forward alone ({label} route, compiled): {fwd_ms:.1f} "
          "ms — what the eager arm's __vjp__ replays add to each step",
          flush=True)
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
    return summary, launches, flash


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
    if on_card:
        print(f"[{card}] {label}: {capture_note(exe)}", flush=True)
    return dict(losses=losses, step_ms=step_ms, peak_bytes=max(peaks),
                grads=grads, first_step=firsts), exe, scope


@contextlib.contextmanager
def knob(name, value):
    """Environment flag `name` set to `value` inside the block: both
    executors read the knobs at every run (the rewrite pipeline stamps
    the kernel-dispatch knobs onto the program it runs, over the stamps
    its ops carry: paddle_tpu_torch/analysis/rewrite.py KernelDispatch)."""
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
    # per step: one forward and one backward per lstm op (the compiled
    # step runs each forward op once; its __vjp__ op reads that record)
    want = {"fused_lstm_fwd": LSTM_CFG["num_layers"] * LSTM_STEPS,
            "fused_lstm_bwd": LSTM_CFG["num_layers"] * LSTM_STEPS}
    if any(launches[n] != c for n, c in want.items()):
        raise SystemExit(f"LSTM launches {launches}, expected {want}")
    profiled = profile_step(main, startup, f["loss"], weights, feed, card,
                            "LSTM kernel", groups=LSTM_KERNELS)

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


def gru_without_bias(x, size):
    """A gru op with no Bias input (the op takes it as optional, as the
    reference's gru_op.cc does): weight [size, 3 size] and the ragged
    hidden states, built as dynamic_gru builds them."""
    from paddle_tpu_torch.layer_helper import LayerHelper
    helper = LayerHelper("dynamic_gru")
    w = helper.create_parameter(helper.param_attr, shape=[size, 3 * size],
                                dtype="float32")
    hidden = helper.create_tmp_variable("float32", lod_level=1,
                                        shape=[-1, size])
    last_h = helper.create_tmp_variable("float32", shape=[-1, size])
    helper.append_op(type="gru", inputs={"Input": x, "Weight": w},
                     outputs={"Hidden": hidden, "LastH": last_h},
                     attrs={"is_reverse": False,
                            "gate_activation": "sigmoid",
                            "activation": "tanh"})
    return hidden


def build_gru_nmt(bias=True):
    """The book chapter's program (tests/test_book.py:166-184) with the
    port's layers at GRU_NMT_CFG, each GRU without its Bias input unless
    `bias` (gru_without_bias): (main, startup, logits, loss)."""
    from paddle_tpu_torch import framework, layers, optimizer
    v, emb, hid = (GRU_NMT_CFG[k] for k in ("dict_size", "emb_dim",
                                             "hid_dim"))
    gru = layers.dynamic_gru if bias else gru_without_bias
    main, startup = framework.Program(), framework.Program()
    with framework.isolated_name_scope(), \
            framework.program_guard(main, startup):
        src = layers.data("src", [1], dtype="int64", lod_level=1)
        trg = layers.data("trg", [1], dtype="int64", lod_level=1)
        lbl = layers.data("lbl", [1], dtype="int64", lod_level=1)
        enc = gru(layers.fc(layers.embedding(src, size=[v, emb]),
                            size=3 * hid), size=hid)
        dec = gru(layers.fc(layers.embedding(trg, size=[v, emb]),
                            size=3 * hid), size=hid)
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
          f"; reloaded run {run_ms:.1f} ms, launches {launches}; "
          f"{capture_note(fresh)} (one run: its warm-up)", flush=True)
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
    # per step: one forward and one backward per gru op (the compiled
    # step runs each forward op once; its __vjp__ op reads that record)
    want = {"fused_gru_fwd": 2 * GRU_STEPS, "fused_gru_bwd": 2 * GRU_STEPS}
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


def megakernel_bound(n, hw, cin, cm, dtype, rate=None):
    """Least time of one bottleneck block on this card: bytes (x read and
    y written once, the weights in the data type, the three BNs' [2, C]
    float32 rows read once) over HBM rate vs 2*N*H*W*Cm*(2*Cin + 9*Cm)
    FLOP at `rate`, by default the rate of the kernel's products on the
    tensor cores (conv_path_rate: bfloat16 in one pass, float32 as
    3xTF32); FP32_FLOPS_PER_S gives the FMA-rate bound of the earlier
    SIMT kernel."""
    size = 2 if dtype == "bf16" else 4
    t_bytes = ((2 * n * hw * cin + 2 * cin * cm + 9 * cm * cm) * size
               + 2 * (2 * cm + cin) * 4) / HBM_BYTES_PER_S
    rate = conv_path_rate(dtype) if rate is None else rate
    t_ops = 2.0 * n * hw * cm * (2 * cin + 9 * cm) / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def megakernel_design_ms(n, hw, cin, cm, dtype):
    """The megakernel design's own floor on device-memory traffic, over
    HBM rate (ms): x read twice (GEMM1, GEMM3's final pass), acc1 and
    acc2 [M, Cm] float32 each written and read once (by the 3x3, by the
    pass that activates acc2), h2 [M, Cm] in the dtype written once and
    read by GEMM3's two passes, y written once (acc3 never leaves the
    chip; the 3x3's halo rows and the rows each column tile reads again
    are taken as L2 hits)."""
    size = 2 if dtype == "bf16" else 4
    m = n * hw
    nbytes = 3 * m * cin * size + 4 * m * cm * 4 + 3 * m * cm * size
    return nbytes / HBM_BYTES_PER_S * 1e3


def mega_role(name):
    """The role of one of the megakernel's device kernels, from its name
    in a torch.profiler trace: pack (the weights), GEMM1, coef (a BN's
    coefficients), 3x3, h2 (GEMM3's activated operand), GEMM3 statistics,
    GEMM3 final; block_gemm_kernel<E, float A, vec, promote, epilogue>
    is the 3x3 when its A is float32 (acc1), else GEMM1 for epilogue 0
    (acc stored) and GEMM3's passes for 1 (statistics) and 2 (y)."""
    for role, frag in (("pack", "pack_w_kernel"), ("coef", "coef_kernel"),
                       ("h2", "act_kernel")):
        if frag in name:
            return role
    if "block_gemm_kernel<" not in name:
        return "other"
    args = [a.strip() for a in
            name.split("block_gemm_kernel<", 1)[1].split(">", 1)[0]
            .split(",")]
    if args[1] == "true":
        return "3x3"
    return {"0": "GEMM1", "1": "GEMM3 statistics",
            "2": "GEMM3 final"}.get(args[4], "other")


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


def profile_chain(card, fn, blocks, label, role=None):
    """One more call of fn (after a warm-up) under torch.profiler: each
    device kernel's time and launches per block, and their sum; `role`
    (a function of the kernel's name) labels each line and sums the
    time by role."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((dict(name=key[:120], ms=ms / blocks, count=n / blocks,
                        **({"role": role(key)} if role else {}))
                   for key, ms, n in device_kernels(prof)),
                  key=lambda r: -r["ms"])
    total = sum(r["ms"] for r in rows)
    print(f"[{card}] profiled {label}: {total:.4f} ms of device kernels a "
          "block", flush=True)
    for r in rows:
        tag = f"[{r['role']}] " if role else ""
        print(f"  {r['ms']:9.4f} ms {r['count']:5.1f}x  {tag}"
              f"{r['name'][:90]}", flush=True)
    out = dict(device_ms_per_block=total, kernels=rows)
    if role:
        by_role = {}
        for r in rows:
            by_role[r["role"]] = by_role.get(r["role"], 0.0) + r["ms"]
        print(f"[{card}] profiled {label} by kernel: "
              + ", ".join(f"{k} {v:.4f}" for k, v in by_role.items())
              + " ms a block", flush=True)
        out["by_role"] = by_role
    return out


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
        fma_ms, fma_by = megakernel_bound(n, side * side, cin, cm, dtype,
                                          FP32_FLOPS_PER_S)
        design_ms = megakernel_design_ms(n, side * side, cin, cm, dtype)
        row = dict(images=n, cin=cin, cm=cm, side=side, blocks=MEGA_BLOCKS,
                   bound_ms=bound_ms, bound_by=bound_by,
                   fma_bound_ms=fma_ms, fma_bound_by=fma_by,
                   design_bytes_ms=design_ms,
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
                  f"it; FMA-rate bound {fma_ms:.4f}, {fma_by}; the "
                  f"design's byte floor {design_ms:.4f}); vs twin after 1 "
                  f"block "
                  f"{checks[tile]['one_block_max_diff_frac']:.3e} * max, "
                  f"after {MEGA_BLOCKS} 2-norm gap "
                  f"{checks[tile]['all_blocks_norm_gap']:.3e} (limit "
                  f"{checks[tile]['all_blocks_norm_limit']:.3e}), rerun "
                  f"bitwise equal", flush=True)
        if (label, dtype) == (MEGA_MAIN_CASE[0], MEGA_MAIN_CASE[2]):
            tile = MEGA_MAIN_CASE[1]
            row["profiled"] = profile_chain(
                card, lambda: mega_chain(x, params, side, tile), MEGA_BLOCKS,
                f"megakernel chain {label} {dtype} tile {tile}", mega_role)
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
    design_ms = megakernel_design_ms(n, side * side, cin, cm, dtype)
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
          f"({bound_by}; the design's byte floor {design_ms:.4f}); "
          f"launches {launches}", flush=True)
    return {"card": card, "stage": label, "images": n, "cin": cin, "cm": cm,
            "side": side, "tile": tile, "dtype": dtype,
            "blocks": MEGA_BLOCKS, "bound_ms": bound_ms,
            "bound_by": bound_by, "design_bytes_ms": design_ms,
            "variants": rows, **gaps}, launches


def lm_trainer_batches():
    """TRAINER_LM_BATCHES batches of phase 5's LM feed as sample tuples
    (words, targets): batch i takes lm_lengths(seed=i)'s ids cut to its
    lengths."""
    out = []
    for i in range(TRAINER_LM_BATCHES):
        ids, lens = lm_lengths(seed=i)
        out.append([(ids[b, :n], ids[b, :n]) for b, n in enumerate(lens)])
    return out


def params_of(main, scope):
    """Every parameter of `main` in `scope`, as numpy arrays."""
    return {p.name: scope.get(p.name).cpu().numpy()
            for p in main.all_parameters()}


def bitwise_gaps(got, want):
    """Names whose arrays are not bit for bit equal."""
    return sorted(n for n in want
                  if got[n].dtype != want[n].dtype
                  or got[n].shape != want[n].shape
                  or got[n].tobytes() != want[n].tobytes())


def trainer_arm(main, startup, loss, weights, batches, card, label,
                checkpoint_dir=None, checkpoint_every=None, resume=False,
                compiled=True, profile_from=None, **train_kw):
    """Trainer.train over `batches` in a fresh scope and executor on the
    card, from `weights` or, with `resume`, from the newest checkpoint in
    `checkpoint_dir` (Trainer.start(resume=True)); with
    `checkpoint_every`, a checkpoint there every that many batches.
    Returns the EndIteration costs, the host-clock times (the card
    synchronized at the end), the peak memory, the parameters, the step
    counter and the trainer. `compiled=False` gives the Trainer the eager
    executor; with `profile_from`, torch.profiler records from that
    batch's BeginIteration to the end (the busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    from paddle_tpu_torch.core.executor import STEP_VAR
    from paddle_tpu_torch.executor import scope_guard
    from paddle_tpu_torch.trainer import (BeginIteration, CheckpointConfig,
                                          EndIteration, Trainer)
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = CheckpointConfig(str(checkpoint_dir),
                                every_n_batches=checkpoint_every,
                                on_error="raise")
    scope = Scope()
    with scope_guard(scope):
        t = Trainer(loss, main_program=main, startup_program=startup,
                    executor=Executor(DEVICE, compiled=compiled),
                    checkpoint_config=ckpt,
                    feed_order=train_kw.pop("feed_order", None))
        t.start(resume=resume)
        if not resume:
            load_param_arrays(scope, weights)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events, begins = [], []
        prof = None if profile_from is None else profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        def handler(e):
            if isinstance(e, BeginIteration):
                if len(begins) == profile_from:
                    prof.start()
                begins.append(time.perf_counter())
            elif isinstance(e, EndIteration):
                events.append(e)
        t0 = time.perf_counter()
        t.train(1, lambda: iter(batches), event_handler=handler,
                **train_kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy = None
        if prof is not None:
            prof.stop()
            profiled_ms = (time.perf_counter() - begins[profile_from]) * 1e3
            busy = sum(ms for _, ms, _ in device_kernels(prof)) / profiled_ms
        costs = [e.cost for e in events]
    if not np.all(np.isfinite(costs)):
        raise SystemExit(f"{label}: costs {costs}")
    step_ms = wall_ms / len(batches)
    print(f"[{card}] {label}: {len(batches)} batches in {len(events)} "
          f"dispatches, {wall_ms:.1f} ms ({step_ms:.2f} ms a batch, "
          f"host clock); peak {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB; costs {[round(c, 6) for c in costs]}; "
          f"{capture_note(t.exe)}", flush=True)
    return dict(costs=costs, wall_ms=wall_ms, step_ms=step_ms,
                dispatch_ms=[(b - a) * 1e3 for a, b in zip(begins,
                                                          begins[1:])],
                peak_bytes=torch.cuda.max_memory_allocated(),
                params=params_of(main, scope),
                step_var=int(scope.find(STEP_VAR)), trainer=t, busy=busy)


def hand_lm_arm(main, startup, loss, weights, batches, card, label):
    """The same batches as the Trainer arm, through DataFeeder and
    Executor.run by hand, in a fresh scope on the card. Each step fetches
    its loss, so each ends synchronized."""
    import torch
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    from paddle_tpu_torch.core.executor import STEP_VAR
    from paddle_tpu_torch.data_feeder import DataFeeder
    feeder = DataFeeder([main.global_block().var("words"),
                         main.global_block().var("targets")])
    exe, scope = Executor(DEVICE), Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, weights)
    torch.cuda.synchronize()
    losses, step_ms = [], []
    start = time.perf_counter()
    for batch in batches:
        t0 = time.perf_counter()
        out = exe.run(main, feed=feeder.feed(batch), fetch_list=[loss],
                      scope=scope)
        losses.append(float(out[0].reshape(-1)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    print(f"[{card}] {label}: {len(batches)} steps, {wall_ms:.1f} ms "
          f"({wall_ms / len(batches):.2f} ms a batch, host clock); steps "
          f"{[round(m, 1) for m in step_ms]} ms; losses "
          f"{[round(x, 6) for x in losses]}", flush=True)
    return dict(losses=losses, step_ms=wall_ms / len(batches),
                steps_ms=step_ms, params=params_of(main, scope),
                step_var=int(scope.find(STEP_VAR)))


def trainer_lstm(card):
    """Phase 13a: phase 5's LSTM LM through Trainer.train (sample tuples,
    feed_order, DataFeeder, prefetch, lazy costs) and without prefetch,
    against the same batches by hand, in TRAINER_ROUNDS interleaved
    rounds; then a run stopped after TRAINER_LM_CKPT_EVERY batches and
    resumed from its checkpoint in a fresh scope and executor.
    Everything bit for bit."""
    import shutil
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import lstm_lm
    with framework.isolated_name_scope():
        main, startup, f = lstm_lm.build_train(**LSTM_CFG)
    loss = f["loss"]
    weights = seeded_weights(startup, seed=0)
    batches = lm_trainer_batches()
    feed_kw = dict(feed_order=["words", "targets"],
                   prefetch=TRAINER_LM_PREFETCH,
                   log_every=TRAINER_LM_LOG_EVERY)
    # a hand arm first takes the card's warm-up and is the arm every
    # other is held against; then TRAINER_ROUNDS rounds of the Trainer,
    # the Trainer without prefetch and the hand loop, each timed as wall
    # time over the batches with the card synchronized at the end
    warm = hand_lm_arm(main, startup, loss, weights, batches, card,
                       "LSTM LM by hand (warm-up)")
    rounds = {"trainer": [], "no_prefetch": [], "hand": []}
    for r in range(1, TRAINER_ROUNDS + 1):
        rounds["trainer"].append(trainer_arm(
            main, startup, loss, weights, batches, card,
            f"LSTM LM Trainer, round {r}", **feed_kw))
        rounds["no_prefetch"].append(trainer_arm(
            main, startup, loss, weights, batches, card,
            f"LSTM LM Trainer, no prefetch, round {r}",
            feed_order=feed_kw["feed_order"]))
        hand = hand_lm_arm(main, startup, loss, weights, batches, card,
                           f"LSTM LM by hand, round {r}")
        hand["costs"] = hand["losses"]
        rounds["hand"].append(hand)
    for label, arms in rounds.items():
        for arm in arms:
            off = bitwise_gaps(arm["params"], warm["params"])
            if arm["costs"] != warm["losses"] or off \
                    or arm["step_var"] != warm["step_var"]:
                raise SystemExit(
                    f"LSTM LM {label} vs by hand: costs {arm['costs']} vs "
                    f"{warm['losses']}; parameters {off} differ; step "
                    f"counters {arm['step_var']} vs {warm['step_var']}")
    step_ms = {label: [a["step_ms"] for a in arms]
               for label, arms in rounds.items()}
    median_ms = {label: float(np.median(v)) for label, v in step_ms.items()}
    tr = rounds["trainer"][0]
    print(f"[{card}] LSTM LM Trainer (prefetch {TRAINER_LM_PREFETCH} and "
          f"none) vs by hand: {len(batches)} losses and all "
          f"{len(tr['params'])} parameters bit for bit equal, step counter "
          f"{tr['step_var']}; ms a batch (wall / {len(batches)}, synchronized"
          f" at the end), median of {TRAINER_ROUNDS} rounds: Trainer "
          f"{median_ms['trainer']:.2f}, no prefetch "
          f"{median_ms['no_prefetch']:.2f}, by hand {median_ms['hand']:.2f}"
          f"; rounds {step_ms}", flush=True)

    ckpt = ROOT / "build" / "trainer_checkpoints"
    shutil.rmtree(ckpt, ignore_errors=True)
    cut = TRAINER_LM_CKPT_EVERY
    first = trainer_arm(main, startup, loss, weights, batches[:cut], card,
                        "LSTM LM Trainer, first half", checkpoint_dir=ckpt,
                        checkpoint_every=cut, **feed_kw)
    saved = sorted(os.listdir(ckpt))
    if saved != [f"checkpoint_{cut}"]:
        raise SystemExit(f"checkpoint directory holds {saved}")
    resumed = trainer_arm(main, startup, loss, None, batches[cut:], card,
                          "LSTM LM Trainer, resumed", checkpoint_dir=ckpt,
                          checkpoint_every=cut, resume=True, **feed_kw)
    shutil.rmtree(ckpt, ignore_errors=True)
    if resumed["trainer"].step != len(batches):
        raise SystemExit(f"resumed trainer at step "
                         f"{resumed['trainer'].step}")
    off = bitwise_gaps(resumed["params"], tr["params"])
    if off or resumed["step_var"] != tr["step_var"] \
            or first["costs"] + resumed["costs"] != tr["costs"]:
        raise SystemExit(f"LSTM LM resumed vs uninterrupted: parameters "
                         f"{off} differ; step counters {resumed['step_var']}"
                         f" vs {tr['step_var']}; costs {first['costs']} + "
                         f"{resumed['costs']} vs {tr['costs']}")
    print(f"[{card}] LSTM LM stopped at batch {cut}, resumed from "
          f"checkpoint_{cut} in a fresh scope and executor: costs, all "
          f"parameters and the step counter ({resumed['step_var']}) bit for "
          "bit equal to the uninterrupted run", flush=True)
    return {"config": dict(LSTM_CFG, batch=LSTM_BATCH, t=LSTM_T),
            "batches": len(batches), "prefetch": TRAINER_LM_PREFETCH,
            "log_every": TRAINER_LM_LOG_EVERY, "costs": tr["costs"],
            "step_ms": median_ms, "step_ms_rounds": step_ms,
            "trainer_dispatch_ms": tr["dispatch_ms"],
            "hand_warmup_step_ms": warm["step_ms"],
            "checkpointed_step_ms": [first["step_ms"], resumed["step_ms"]],
            "peak_bytes": tr["peak_bytes"], "bitwise_hand": True,
            "bitwise_resume": True, "step_var": tr["step_var"]}


def deepfm_batches():
    """DEEPFM_BATCHES dense batches drawn as bench.py:600-605 draws its
    feed, one after another from RandomState(0)."""
    rng = np.random.RandomState(0)
    n, fields = DEEPFM_CFG["num_features"], DEEPFM_CFG["num_fields"]
    return [{"feat_ids": rng.randint(0, n, (DEEPFM_BATCH, fields, 1)
                                     ).astype(np.int64),
             "feat_vals": rng.rand(DEEPFM_BATCH, fields).astype(np.float32),
             "label": rng.randint(0, 2, (DEEPFM_BATCH, 1)
                                  ).astype(np.float32)}
            for _ in range(DEEPFM_BATCHES)]


def upload_overlap(prof):
    """(host-to-device copy ms, of which ms overlapped a kernel) over a
    torch.profiler run: each copy's interval against the union of the
    kernels' intervals."""
    import torch
    copies, kernels = [], []
    for e in prof.events():
        if getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "Memcpy HtoD" in e.name:
            copies.append(span)
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.append(span)
    total = sum(b - a for a, b in copies)
    covered = 0.0
    for a, b in copies:
        cut = sorted((max(a, ka), min(b, kb)) for ka, kb in kernels
                     if ka < b and kb > a)
        end = a
        for lo, hi in cut:
            lo = max(lo, end)
            if hi > lo:
                covered += hi - lo
                end = hi
    return total / 1e3, covered / 1e3


def trainer_deepfm(card):
    """Phase 13b: DeepFM at bench.py:593-611 through Trainer.train at
    steps_per_dispatch 1, 4, and 1 with prefetch 2, in TRAINER_ROUNDS
    interleaved rounds after a warm-up arm, all bit for bit equal; then
    the first step on the card against the port's CPU path; then a
    profiled prefetch run for whether the feed uploads overlap the
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import deepfm
    with framework.isolated_name_scope():
        main, startup, f = deepfm.build_train(**DEEPFM_CFG)
    loss = f["loss"]
    weights = seeded_weights(startup, seed=0)
    params = [p.name for p in main.all_parameters()]
    batches = deepfm_batches()
    # a K = 1 arm first takes the card's warm-up and is the arm every
    # other is held against; then TRAINER_ROUNDS interleaved rounds of
    # K = 1 (its reruns), K = 4 and K = 1 with prefetch
    labels = {"k1": {}, "k4": dict(steps_per_dispatch=DEEPFM_K),
              "k1_prefetch": dict(prefetch=2)}
    base = trainer_arm(main, startup, loss, weights, batches, card,
                       "DeepFM Trainer k1 (warm-up)")
    want_costs = {"k1": base["costs"], "k1_prefetch": base["costs"],
                  "k4": base["costs"][DEEPFM_K - 1::DEEPFM_K]}
    arms = {label: [] for label in labels}
    for r in range(1, TRAINER_ROUNDS + 1):
        for label, kw in labels.items():
            arm = trainer_arm(main, startup, loss, weights, batches, card,
                              f"DeepFM Trainer {label}, round {r}", **kw)
            off = bitwise_gaps(arm["params"], base["params"])
            if off or arm["costs"] != want_costs[label]:
                raise SystemExit(f"DeepFM {label} round {r} vs k1: "
                                 f"parameters {off} differ, costs "
                                 f"{arm['costs']} vs {want_costs[label]}")
            arms[label].append(arm)
    step_ms = {label: [a["step_ms"] for a in v] for label, v in arms.items()}
    median_ms = {label: float(np.median(v)) for label, v in step_ms.items()}
    print(f"[{card}] DeepFM: {TRAINER_ROUNDS} rounds of K=1, K={DEEPFM_K} "
          "and the prefetch arm end bit for bit at the first K=1 arm's "
          f"parameters and costs; ms a batch, median of the rounds {median_ms}"
          f"; rounds {step_ms}", flush=True)

    # card vs CPU, first step of batch 0
    relu_in = relu_inputs(main)
    feed = batches[0]
    gpu, _, _ = steps_arm(main, startup, loss, weights, feed, params, card,
                          "DeepFM card", 1, device=DEVICE, extra=relu_in)
    cpu, _, _ = steps_arm(main, startup, loss, weights, feed, params, card,
                          "DeepFM CPU", 1, device="cpu")
    loss_rel = abs(gpu["losses"][0] - cpu["losses"][0]) / abs(
        cpu["losses"][0])
    if not loss_rel <= DEEPFM_LOSS_RTOL:
        raise SystemExit(f"DeepFM card vs CPU first loss: {gpu['losses']} "
                         f"vs {cpu['losses']}")
    if gpu["losses"][0] != base["costs"][0]:
        raise SystemExit(f"DeepFM by hand vs Trainer first loss: "
                         f"{gpu['losses'][0]} vs {base['costs'][0]}")
    signs = {n: v > 0 for n, v in gpu["first_step"].items()}
    pinned = pinned_relu_grads(main, startup, loss, weights, feed, params,
                               signs, device="cpu")
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
        raise SystemExit(f"DeepFM card vs CPU step-1 gradients: {fails} "
                         f"differ per element (worst {worst:.3e} * max|g|),"
                         f" 2-norm gap to the free CPU step {norm_gap:.3e}")
    print(f"[{card}] DeepFM card vs CPU: first loss {gpu['losses'][0]:.7f} "
          f"vs {cpu['losses'][0]:.7f} (rel diff {loss_rel:.3e}); step-1 "
          f"gradients of all {len(params)} parameters equal per element to "
          f"the CPU step with the card's ReLU masks (worst {worst:.3e} * "
          f"max|g|), 2-norm gap to the free CPU step {norm_gap:.3e}",
          flush=True)

    # the prefetcher's uploads: do they overlap the kernels?
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer_arm(main, startup, loss, weights, batches[:6], card,
                    "DeepFM Trainer k1_prefetch (profiled)", prefetch=2)
    htod_ms, overlapped_ms = upload_overlap(prof)
    busy_ms = sum(ms for _, ms, _ in device_kernels(prof))
    print(f"[{card}] DeepFM prefetch uploads: {htod_ms:.3f} ms of "
          f"host-to-device copies in 6 batches, {overlapped_ms:.3f} ms of "
          f"them beside a running kernel; {busy_ms:.3f} ms of device "
          "kernels and copies in those batches", flush=True)
    examples = {label: DEEPFM_BATCH / (ms / 1e3)
                for label, ms in median_ms.items()}
    return {"config": dict(DEEPFM_CFG, layers=[400, 400, 400],
                           batch=DEEPFM_BATCH),
            "batches": DEEPFM_BATCHES, "bitwise_arms": True,
            "step_ms": median_ms, "step_ms_rounds": step_ms,
            "warmup_step_ms": base["step_ms"],
            "examples_per_s": examples,
            "peak_bytes": {k: max(a["peak_bytes"] for a in v)
                           for k, v in arms.items()},
            "costs": base["costs"], "cpu_first_loss": cpu["losses"][0],
            "first_loss_rel_diff": loss_rel,
            "grad_max_diff_frac_pinned": worst,
            "grad_norm_gap_free": norm_gap,
            "htod_ms": htod_ms, "htod_overlapped_ms": overlapped_ms,
            "profiled_device_ms": busy_ms, "profiled_batches": 6}


def train_trainer(card):
    """Phase 13: the Trainer at full width (trainer_lstm,
    trainer_deepfm), launch counts set to 0 just before and read just
    after; the fused-LSTM kernels must launch there."""
    import torch
    from paddle_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    lm = trainer_lstm(card)
    dfm = trainer_deepfm(card)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"[{card}] Trainer phase kernel launches {launches}", flush=True)
    # 2 forward and 2 backward a step (two lstm ops; the compiled step
    # runs each forward op once); the LM runs 8 warm-up steps by hand, TRAINER_ROUNDS
    # rounds of 8 Trainer, 8 Trainer without prefetch and 8 hand steps,
    # and 4 + 4 checkpointed steps
    lm_steps = TRAINER_LM_BATCHES * (2 + 3 * TRAINER_ROUNDS)
    want = {"fused_lstm_fwd": LSTM_CFG["num_layers"] * lm_steps,
            "fused_lstm_bwd": LSTM_CFG["num_layers"] * lm_steps}
    if any(launches[n] != c for n, c in want.items()):
        raise SystemExit(f"Trainer phase launches {launches}, expected "
                         f"{want} and 0 elsewhere")
    stray = {n: c for n, c in launches.items() if c and n not in want}
    if stray:
        raise SystemExit(f"the Trainer phase launched {stray}")
    return {"card": card, "lstm_lm": lm, "deepfm": dfm}, launches


def cve_arm(main, startup, loss, weights, feeds, card, label, compiled,
            donate=True, steps=CVE_STEPS, profiled=CVE_PROFILED):
    """Phase 14's arm of one training path: CVE_STEPS + CVE_PROFILED
    steps over `feeds` (step i takes feeds[i % len(feeds)]) from `weights`
    in a fresh scope on the card, through Executor(compiled=compiled,
    donate_state=donate). Steps after the first CVE_WARM are timed (host
    clock around Executor.run, which ends synchronized) and their kernel
    launches counted; the last `profiled` (CVE_PROFILED) run under
    torch.profiler (none: no busy share).
    Before step CVE_WARM + 1 (a replay, on the compiled arm) the last
    parameter is set into the scope from outside, halved: the replay must
    read it. Returns the losses, ms a step (median), busy share, peak
    memory, launches a step, the parameters and the step counter."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    from paddle_tpu_torch.core.executor import STEP_VAR
    from paddle_tpu_torch.ops import kernels
    exe = Executor(DEVICE, compiled=compiled, donate_state=donate)
    scope = Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, weights)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    last = main.all_parameters()[-1].name

    def step(i):
        out = exe.run(main, feed=feeds[i % len(feeds)],
                      fetch_list=[loss.name], scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))

    for i in range(steps):
        if i == CVE_WARM:
            kernels.reset_launch_counts()
        if i == CVE_WARM + 1:
            scope.set(last, scope.get(last) * 0.5)
        t0 = time.perf_counter()
        step(i)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    timed = steps - CVE_WARM
    launches = {n: c / timed for n, c in kernels.launch_counts().items()
                if c}
    busy = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps, steps + profiled):
                step(i)
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(ms for _, ms, _ in device_kernels(prof)) / wall_ms
    if not np.all(np.isfinite(losses)):
        raise SystemExit(f"{label}: losses {losses}")
    out = dict(losses=losses, step_ms=float(np.median(step_ms[CVE_WARM:])),
               steps_ms=step_ms, busy=busy,
               peak_bytes=torch.cuda.max_memory_allocated(),
               launches_per_step=launches, params=params_of(main, scope),
               step_var=int(scope.find(STEP_VAR)),
               captured=bool(compiled and exe.last_compiled.captured),
               note=capture_note(exe) if compiled else "eager")
    print(f"[{card}] {label}: {out['step_ms']:.2f} ms a step (median of "
          f"{timed}; steps {[round(m, 1) for m in step_ms]}), "
          + (f"{100 * busy:.1f}% busy over {profiled} profiled steps, "
             if profiled else "") + f"peak "
          f"{out['peak_bytes'] / 2**30:.3f} GiB, launches a step {launches};"
          f" {out['note']}", flush=True)
    return out


def cve_hold(what, eager, compiled, card, halved=None):
    """The two arms of `what` bit for bit: losses (or costs), every
    parameter, the step counter; and, for the paths in CVE_HALVED, the
    replayed kernel's forward launches a compiled step at half the eager
    step's and its backward launches equal."""
    key = "losses" if "losses" in eager else "costs"
    off = bitwise_gaps(compiled["params"], eager["params"])
    if compiled[key] != eager[key] or off or \
            compiled["step_var"] != eager["step_var"]:
        raise SystemExit(f"{what} compiled vs eager: {key} {compiled[key]}"
                         f" vs {eager[key]}; parameters {off} differ; step "
                         f"counters {compiled['step_var']} vs "
                         f"{eager['step_var']}")
    if halved:
        fwd, bwds = halved
        e, c = eager["launches_per_step"], compiled["launches_per_step"]
        if not (e.get(fwd) and c.get(fwd) * 2 == e[fwd]) or \
                any(c.get(b) != e.get(b) or not e.get(b) for b in bwds):
            raise SystemExit(f"{what} launches a step, compiled {c} vs "
                             f"eager {e}: expected {fwd} at half, {bwds} "
                             "equal")
    print(f"[{card}] {what}: compiled arm bit for bit equal to the eager "
          f"arm ({len(eager[key])} {key}, {len(eager['params'])} "
          f"parameters, step counter {eager['step_var']})"
          + (f"; {halved[0]} {compiled['launches_per_step'][halved[0]]:g} "
             f"a step vs {eager['launches_per_step'][halved[0]]:g}"
             if halved else ""), flush=True)
    return {label: {k: arm[k] for k in ("step_ms", "busy", "peak_bytes",
                                         "launches_per_step", "captured",
                                         "note", "losses", "costs")
                    if k in arm}
            for label, arm in (("eager", eager), ("compiled", compiled))}


def cve_training_pair(what, main, startup, loss, weights, feeds, card,
                      no_donate=False, steps=CVE_STEPS,
                      profiled=CVE_PROFILED):
    """The eager and the compiled arm of `what` (and, with `no_donate`, a
    compiled arm with donate_state=False, held against the eager arm the
    same way), each in a fresh executor and scope."""
    import gc
    import torch
    arms = {}
    for label, compiled, donate in (("eager", False, True),
                                    ("compiled", True, True),
                                    ("compiled, donate_state=False", True,
                                     False))[:3 if no_donate else 2]:
        arms[label] = cve_arm(main, startup, loss, weights, feeds, card,
                              f"{what} {label}", compiled, donate, steps,
                              profiled)
        gc.collect()
        torch.cuda.empty_cache()
    if no_donate:
        cve_hold(f"{what} (donate_state=False)", arms["eager"],
                 arms["compiled, donate_state=False"], card,
                 CVE_HALVED.get(what))
    return cve_hold(what, arms["eager"], arms["compiled"], card,
                    CVE_HALVED.get(what))


def cve_serving(card):
    """Phase 14, serving: phase 3's model and requests through a compiled
    and an eager executor (same weights); token streams must be equal.
    Per arm: the requests' wall time, prefill ms and decode tokens/s per
    bucket (time_serving), the busy share of 10 decode steps at the
    largest cache bucket, peak memory, launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import Executor, load_param_arrays
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving.generation import (GenerationModel,
                                                     GenerationSpec)
    spec = GenerationSpec(**SERVE_SPEC)
    compiled = GenerationModel.build(spec)
    weights = seeded_weights(compiled.programs["startup"], seed=0)
    eager = GenerationModel(compiled.programs, spec)
    eager.executor = Executor(eager.device, compiled=False)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, spec.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    arms, streams = {}, {}
    for label, model in (("eager", eager), ("compiled", compiled)):
        load_param_arrays(model, weights)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = serve(model, prompts)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {n: c for n, c in kernels.launch_counts().items() if c}
        streams[label] = [(r.tokens, r.finish_reason) for r in res]
        timing = time_serving(model, card)
        bucket = spec.cache_buckets[-1]
        tokens = rng.randint(1, spec.vocab_size, spec.slots).astype(np.int64)
        positions = np.full(spec.slots, bucket - 1, np.int64)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                model.run_decode(tokens, positions, bucket)
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(ms for _, ms, _ in device_kernels(prof)) / wall_ms
        arms[label] = dict(
            serve_s=serve_s, decode_step_ms=wall_ms / 10, busy=busy,
            peak_bytes=torch.cuda.max_memory_allocated(), launches=launches,
            note=capture_note(model.executor) if label == "compiled"
            else "eager", **timing)
        print(f"[{card}] serving {label}: {len(prompts)} requests in "
              f"{serve_s:.3f} s, launches {launches}; 10 decode steps at "
              f"cache bucket {bucket}: {wall_ms / 10:.3f} ms a step, "
              f"{100 * busy:.1f}% busy; peak "
              f"{arms[label]['peak_bytes'] / 2**30:.3f} GiB; "
              f"{arms[label]['note']}", flush=True)
    if streams["compiled"] != streams["eager"]:
        raise SystemExit(f"serving compiled vs eager: token streams differ"
                         f": {streams['compiled']} vs {streams['eager']}")
    if arms["compiled"]["launches"] != arms["eager"]["launches"]:
        raise SystemExit(f"serving launches compiled "
                         f"{arms['compiled']['launches']} vs eager "
                         f"{arms['eager']['launches']}")
    print(f"[{card}] serving: compiled token streams equal the eager "
          f"arm's ({sum(len(t) for t, _ in streams['eager'])} tokens)",
          flush=True)
    return arms


def cve_deepfm(card):
    """Phase 14, DeepFM through the Trainer (phase 13's configuration and
    batches, K = 1): the eager arm, then the compiled arm, each profiled
    from its third batch on; costs, parameters and the step counter bit
    for bit."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import deepfm
    with framework.isolated_name_scope():
        main, startup, f = deepfm.build_train(**DEEPFM_CFG)
    weights = seeded_weights(startup, seed=0)
    batches = deepfm_batches()
    arms = {}
    for label, compiled in (("eager", False), ("compiled", True)):
        arm = trainer_arm(main, startup, f["loss"], weights, batches, card,
                          f"DeepFM Trainer {label}", compiled=compiled,
                          profile_from=CVE_WARM)
        arm["launches_per_step"] = {}
        arm["note"] = capture_note(arm["trainer"].exe) if compiled \
            else "eager"
        arm["captured"] = bool(compiled and
                               arm["trainer"].exe.last_compiled.captured)
        print(f"[{card}] DeepFM {label}: {100 * arm['busy']:.1f}% busy from "
              f"batch {CVE_WARM + 1} on", flush=True)
        arms[label] = arm
    return cve_hold("deepfm", arms["eager"], arms["compiled"], card)


def compiled_vs_eager(card):
    """Phase 14: the eager arm beside the compiled arm on serving, NMT
    (2+2 layers), the LSTM LM, GRU NMT, DeepFM through the Trainer and
    ResNet-50, each pair bit for bit; launch counts are set to 0 by each
    arm and read after it."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core.lod import RaggedPair
    from paddle_tpu_torch.models import lstm_lm, resnet, transformer
    out = {"card": card, "steps": CVE_STEPS, "warm_steps": CVE_WARM,
           "profiled_steps": CVE_PROFILED}
    out["serving"] = cve_serving(card)

    with framework.isolated_name_scope():
        main, startup, f = transformer.build_train(**CVE_NMT_CFG)
    rng = np.random.RandomState(0)
    ln, vocab = CVE_NMT_CFG["max_len"], CVE_NMT_CFG["trg_vocab"]
    feeds = []
    for _ in range(2):
        feed = {n: rng.randint(1, vocab, (TRAIN_BATCH, ln, 1))
                .astype(np.int64)
                for n in ("src_ids", "trg_ids", "trg_labels")}
        feed["pos_ids"] = np.arange(ln).astype(np.int64)
        feeds.append(feed)
    out["nmt"] = cve_training_pair("nmt", main, startup, f["loss"],
                                   seeded_weights(startup, seed=0), feeds,
                                   card)

    with framework.isolated_name_scope():
        main, startup, f = lstm_lm.build_train(**LSTM_CFG)
    feeds = []
    for seed in range(2):
        ids, lens = lm_lengths(seed)
        feeds.append({"words": RaggedPair(ids, lens),
                      "targets": RaggedPair(ids, lens)})
    out["lstm_lm"] = cve_training_pair("lstm_lm", main, startup, f["loss"],
                                       seeded_weights(startup, seed=0),
                                       feeds, card, no_donate=True)

    main, startup, _, loss = build_gru_nmt()
    feeds = []
    for seed in range(2):
        (src, trg, lbl), src_lens, trg_lens = gru_lengths(seed)
        feeds.append({"src": RaggedPair(src, src_lens),
                      "trg": RaggedPair(trg, trg_lens),
                      "lbl": RaggedPair(lbl, trg_lens)})
    out["gru_nmt"] = cve_training_pair("gru_nmt", main, startup, loss,
                                       seeded_weights(startup, seed=0),
                                       feeds, card)

    out["deepfm"] = cve_deepfm(card)

    with framework.isolated_name_scope():
        main, startup, f = resnet.build_train(**RESNET_CFG)
    rng = np.random.RandomState(3)
    feeds = [{"img": rng.rand(RESNET_BATCH, *RESNET_CFG["image_shape"])
              .astype(np.float32),
              "label": rng.randint(0, RESNET_CFG["class_dim"],
                                   (RESNET_BATCH, 1)).astype(np.int64)}
             for _ in range(2)]
    out["resnet50"] = cve_training_pair("resnet50", main, startup,
                                        f["loss"],
                                        seeded_weights(startup, seed=0),
                                        feeds, card)
    return out


def attention_bound_bf16(b, h, sq, sk, d, pairs, bias_numel, kind):
    """Least time for one bf16 flash kernel on this card: the bytes it
    must move (bf16 q, k, v, and dO for the backward, read once; the
    float32 bias, lse and delta read or written once; its bf16 outputs
    written once) over HBM rate vs the live (q, k) pairs times its FLOP a
    pair (the float32 rows' counts: 4*D forward, 6*D dq, 8*D dk/dv) at
    the dense bf16 rate."""
    bhq, bhk, rows = b * h * sq * d, b * h * sk * d, b * h * sq
    nbytes, fpp = {
        "fwd": (2 * (2 * bhq + 2 * bhk) + 4 * (bias_numel + rows), 4 * d),
        "dq": (2 * (3 * bhq + 2 * bhk) + 4 * (bias_numel + 2 * rows), 6 * d),
        "dkv": (2 * (2 * bhq + 4 * bhk) + 4 * (bias_numel + 2 * rows),
                8 * d)}[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = fpp * pairs / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _bf16_gap(got, want, limit):
    """(max |got - want|, the largest ratio of |got - want| to its
    allowance: one bf16 ulp at the larger of the two plus `limit`)."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    g, w = got.double(), want.double()
    err = (g - w).abs()
    allow = fa.bf16_spacing(torch.maximum(g.abs(), w.abs())) + limit
    return (float(err.max()),
            float((err / allow.clamp_min(1e-300)).max()))


def check_attention_bf16(card):
    """Phase 15's kernel holds: the three bf16 flash kernels against their
    bf16 twins (ops/kernels/flash_attention.py) at AMP_ATTN_CASES, by
    ROADMAP B1's rule (one bf16 ulp of the output plus 1e-5 of its sum of
    |terms|) with bf16_limits' operand-rounding term (one ulp of each p
    or ds a product takes in bf16 times its partner, 1.5 for O's p: the
    kernel computes them in another order than its twin, and the forward
    rounds p at another scale), timed beside the twin and
    F.scaled_dot_product_attention in bf16 (for the backward kernels,
    its whole backward)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    rows = {}
    for label, (b, h, s, d), kind, causal in AMP_ATTN_CASES:
        q, k, v, do = (torch.randn(b, h, s, d, device=DEVICE, generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        if kind == "dense":
            bias = torch.full((s, s), -1e9, device=DEVICE).triu(1)
            bias = bias.expand(b, 1, s, s).contiguous()
        else:
            bias = torch.zeros(b, 1, 1, s, device=DEVICE)
            if kind == "serving":   # phase 2's live key rows
                bias[..., {c[0]: c[2] for c in ATTN_CASES}[label]:] = -1e9
        o_t, lse_t = fa.flash_attention_fwd_plain(q, k, v, bias, causal)
        delta = fa._delta(o_t, do).contiguous()
        args = (q, k, v, bias, do, lse_t, delta)
        lim = fa.bf16_limits(*args, causal)
        got = {"flash_attention_fwd_bf16": (
                   fa.flash_attention_fwd_bf16(q, k, v, bias, causal)[0], o_t,
                   lim["o"]),
               "flash_attention_bwd_dq_bf16": (
                   fa.flash_attention_bwd_dq_bf16(*args, causal)[0],
                   fa.flash_attention_bwd_dq_plain(*args, causal)[0],
                   lim["dq"])}
        dk, dv = fa.flash_attention_bwd_dkv_bf16(*args, causal)
        dk_t, dv_t = fa.flash_attention_bwd_dkv_plain(*args, causal)
        torch.cuda.synchronize()
        errs = {n: _bf16_gap(*t) for n, t in got.items()}
        gk, gv = _bf16_gap(dk, dk_t, lim["dk"]), _bf16_gap(dv, dv_t,
                                                           lim["dv"])
        errs["flash_attention_bwd_dkv_bf16"] = (max(gk[0], gv[0]),
                                                max(gk[1], gv[1]))
        del got, dk, dv, dk_t, dv_t, lim
        for name, (err, ratio) in errs.items():
            if not ratio <= 1.0:
                raise SystemExit(f"{name} disagrees with its bf16 twin at "
                                 f"{label}: max abs err {err:.3e}, "
                                 f"{ratio:.3f} of its allowance")
        pairs = live_pairs(bias, b, h, s, s, causal)
        mask = bias.to(torch.bfloat16)
        if causal:
            mask = mask + torch.full((s, s), NEG_INF_BF16, device=DEVICE,
                                     dtype=torch.bfloat16).triu(1)
        lq, lk, lv = (t.clone().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv,
                                                 attn_mask=mask)
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (lq, lk, lv), do, retain_graph=True), iters=10)
        lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters=10)
        for name, kernel_fn, plain_fn, kind_ in (
                ("flash_attention_fwd_bf16",
                 lambda: fa.flash_attention_fwd_bf16(q, k, v, bias, causal),
                 lambda: fa.flash_attention_fwd_plain(q, k, v, bias, causal),
                 "fwd"),
                ("flash_attention_bwd_dq_bf16",
                 lambda: fa.flash_attention_bwd_dq_bf16(*args, causal),
                 lambda: fa.flash_attention_bwd_dq_plain(*args, causal),
                 "dq"),
                ("flash_attention_bwd_dkv_bf16",
                 lambda: fa.flash_attention_bwd_dkv_bf16(*args, causal),
                 lambda: fa.flash_attention_bwd_dkv_plain(*args, causal),
                 "dkv")):
            bound_ms, bound_by = attention_bound_bf16(
                b, h, s, s, d, pairs, bias.numel(), kind_)
            row = dict(max_abs_err=errs[name][0],
                       allowance_ratio=errs[name][1],
                       ms=cuda_ms(kernel_fn, iters=10),
                       plain_ms=cuda_ms(plain_fn, iters=3),
                       library_ms=lib_fwd_ms if kind_ == "fwd"
                       else lib_bwd_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            rows[(name, label)] = row
            print(f"[{card}] {name} B={b} H={h} S={s} D={d} {label} "
                  f"causal={causal}: max_abs_err={row['max_abs_err']:.3e} "
                  f"({row['allowance_ratio']:.3f} of B1's allowance) "
                  f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f}"
                  f" library_ms={row['library_ms']:.4f} (bf16 "
                  f"{'forward' if kind_ == 'fwd' else 'whole backward'}) "
                  f"bound_ms={bound_ms:.4f} ({bound_by}, dense bf16; "
                  f"{pairs} live pairs)", flush=True)
        del lib_out, lq, lk, lv, q, k, v, do, bias, o_t, lse_t, delta, args
        torch.cuda.empty_cache()
    return rows


def _median_ms(step_ms):
    """The median of the steps after the first two (a key's first run and
    its capture)."""
    return float(np.median(step_ms[2:]))


def train_amp(card, flash32, f32_profiled, resnet32):
    """Phase 15: the bf16 flash kernels against their twins, then NMT at
    phase 4's configuration and ResNet-50 at phase 9's under amp_guard()
    (bench.py's default precision), each beside its float32 arm from the
    earlier phases (phase 4's flash arm `flash32` and its profiled step
    `f32_profiled`; phase 14's ResNet-50 pair `resnet32`). Returns the
    phase's summary, its kernel rows and the NMT flash arm's launches."""
    import gc
    import torch
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.models import resnet, transformer
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    rows = check_attention_bf16(card)
    holds_s = time.perf_counter() - t0

    # NMT: (a) AMP + flash, (b) AMP + naive attention, (c) phase 4's
    # float32 flash arm, from the same weights on the same feed
    with framework.isolated_name_scope():
        main, startup, f = transformer.build_train(**TRAIN_CFG)
    weights = seeded_weights(startup, seed=0)
    params = [p.name for p in main.all_parameters()]
    ln, vocab = TRAIN_CFG["max_len"], TRAIN_CFG["trg_vocab"]
    rng = np.random.RandomState(0)
    feed = {n: rng.randint(1, vocab, (TRAIN_BATCH, ln, 1)).astype(np.int64)
            for n in ("src_ids", "trg_ids", "trg_labels")}
    feed["pos_ids"] = np.arange(ln).astype(np.int64)
    arms = {}
    with amp.amp_guard():
        kernels.reset_launch_counts()
        arms["amp_flash"] = train_arm(main, startup, f["loss"], weights,
                                      feed, params, card, "NMT AMP flash",
                                      profiled=CVE_PROFILED)
        launches = arms["amp_flash"]["launches"]
        want = {n: AMP_NMT_LAUNCHES_PER_STEP * TRAIN_STEPS
                for n in AMP_NMT_KERNELS}
        got = {n: c for n, c in launches.items() if c}
        if got != want:
            raise SystemExit(f"NMT AMP flash launched {got}, expected "
                             f"{want} ({AMP_NMT_LAUNCHES_PER_STEP} of each "
                             f"bf16 flash kernel a step, nothing else)")
        _stamp_naive(main)
        kernels.reset_launch_counts()
        arms["amp_naive"] = train_arm(main, startup, f["loss"], weights,
                                      feed, params, card, "NMT AMP naive",
                                      profiled=CVE_PROFILED)
        if any(arms["amp_naive"]["launches"].values()):
            raise SystemExit(f"NMT AMP naive launched "
                             f"{arms['amp_naive']['launches']}")
        _stamp_naive(main, False)
        with flash_twins():
            twin = pinned_relu_grads(main, startup, f["loss"], weights,
                                     feed, params,
                                     arms["amp_flash"]["relu_signs"])
    a, b, c = arms["amp_flash"], arms["amp_naive"], flash32
    for label, arm in arms.items():
        if not np.all(np.isfinite(arm["losses"])):
            raise SystemExit(f"NMT {label}: losses {arm['losses']}")

    def gap(x, y):
        return float(np.linalg.norm(x - y))

    qk = {p + "@GRAD" for p in qk_projection_params(main)}
    dists = {"loss step 1": (abs(a["losses"][0] - c["losses"][0]),
                             abs(b["losses"][0] - c["losses"][0]))}
    for p in params:
        dists[p + "@GRAD"] = (gap(a["grads"][p], c["grads"][p]),
                              gap(b["grads"][p], c["grads"][p]))
    ratios = {q: da / max(db, 1e-30) for q, (da, db) in dists.items()}
    twin_ratios = {p + "@GRAD": gap(a["grads"][p], twin[p]) / max(
        gap(twin[p], c["grads"][p]), 1e-30) for p in params}
    print(f"[{card}] NMT AMP vs float32 (phase 4's flash arm), step 1: "
          f"|flash - f32| / |naive - f32| (2-norms; factor "
          f"{AMP_NMT_FACTOR}, Q/K projections * reported only), then "
          f"|flash - twins| / |twins - f32| (factor {AMP_TWIN_FACTOR}):",
          flush=True)
    items = list(ratios.items())
    for i in range(0, len(items), 3):
        print("  " + "; ".join(
            f"{q}{'*' if q in qk else ''} {r:.3f} / "
            f"{twin_ratios.get(q, 0.0):.3f}" for q, r in items[i:i + 3]),
            flush=True)
    fails = {q: r for q, r in ratios.items()
             if q not in qk and not r <= AMP_NMT_FACTOR}
    fails.update({q + " (twins)": r for q, r in twin_ratios.items()
                  if not r <= AMP_TWIN_FACTOR})
    if fails:
        raise SystemExit(f"NMT AMP flash: {fails} over their factors "
                         f"({AMP_NMT_FACTOR} against the naive arm, "
                         f"{AMP_TWIN_FACTOR} against the twins)")
    held = [r for q, r in ratios.items() if q not in qk]
    print(f"[{card}] NMT AMP: losses flash {a['losses']}, naive "
          f"{b['losses']}, float32 {c['losses']}; against the naive arm up "
          f"to {max(held):.3f} (loss {ratios['loss step 1']:.3f}; Q/K "
          f"projections up to {max(ratios[q] for q in qk):.3f}, not held); "
          f"against the twins up to {max(twin_ratios.values()):.3f}",
          flush=True)
    nmt = {"config": dict(TRAIN_CFG, batch=TRAIN_BATCH), "steps": TRAIN_STEPS,
           "launches_per_step": {n: launches[n] / TRAIN_STEPS
                                 for n in AMP_NMT_KERNELS},
           "factor": AMP_NMT_FACTOR, "ratio_max": max(held),
           "qk_ratio_max": max(ratios[q] for q in qk), "ratios": ratios,
           "twin_factor": AMP_TWIN_FACTOR,
           "twin_ratio_max": max(twin_ratios.values()),
           "twin_ratios": twin_ratios,
           "f32_flash": {"losses": c["losses"],
                         "step_ms": _median_ms(c["step_ms"]),
                         "busy": f32_profiled["device_ms"]
                         / f32_profiled["wall_ms"],
                         "peak_bytes": c["peak_bytes"]}}
    for label, arm in arms.items():
        nmt[label] = {"losses": arm["losses"],
                      "step_ms": _median_ms(arm["step_ms"]),
                      "busy": arm["busy"], "peak_bytes": arm["peak_bytes"]}
    del arms, a, b, twin, main, startup, weights
    gc.collect()
    torch.cuda.empty_cache()

    # ResNet-50: compiled against eager under AMP, as phase 14 holds them
    with framework.isolated_name_scope():
        main, startup, f = resnet.build_train(**RESNET_CFG)
    rng = np.random.RandomState(3)
    feeds = [{"img": rng.rand(RESNET_BATCH, *RESNET_CFG["image_shape"])
              .astype(np.float32),
              "label": rng.randint(0, RESNET_CFG["class_dim"],
                                   (RESNET_BATCH, 1)).astype(np.int64)}
             for _ in range(2)]
    with amp.amp_guard():
        pair = cve_training_pair("resnet50 AMP", main, startup, f["loss"],
                                 seeded_weights(startup, seed=0), feeds,
                                 card, steps=AMP_STEPS)
    for label, arm in pair.items():
        if arm["launches_per_step"]:
            raise SystemExit(f"ResNet-50 AMP {label} launched "
                             f"{arm['launches_per_step']}; no op dispatches "
                             "a kernel there")
    amp_loss = pair["compiled"]["losses"][0]
    f32_loss = resnet32["compiled"]["losses"][0]
    rel = abs(amp_loss - f32_loss) / abs(f32_loss)
    print(f"[{card}] ResNet-50 AMP step-1 loss {amp_loss:.6f} vs float32 "
          f"{f32_loss:.6f}: relative distance {rel:.3e} (limit "
          f"{AMP_RESNET_LOSS_RTOL})", flush=True)
    if not rel <= AMP_RESNET_LOSS_RTOL:
        raise SystemExit(f"ResNet-50 AMP step-1 loss {rel:.3e} from the "
                         f"float32 arm's, over {AMP_RESNET_LOSS_RTOL}")
    for label in ("eager", "compiled"):
        print(f"[{card}] ResNet-50 {label}: float32 "
              f"{resnet32[label]['step_ms']:.2f} ms a step, "
              f"{100 * resnet32[label]['busy']:.1f}% busy, peak "
              f"{resnet32[label]['peak_bytes'] / 2**30:.2f} GiB; AMP "
              f"{pair[label]['step_ms']:.2f} ms, "
              f"{100 * pair[label]['busy']:.1f}% busy, peak "
              f"{pair[label]['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    for label in ("f32_flash", "amp_flash", "amp_naive"):
        arm = nmt[label]
        print(f"[{card}] NMT {label}: {arm['step_ms']:.2f} ms a step, "
              f"{100 * arm['busy']:.1f}% busy, peak "
              f"{arm['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    resnet_out = {"config": dict(RESNET_CFG, batch=RESNET_BATCH),
                  "steps": AMP_STEPS, "loss_rel_to_f32": rel,
                  "amp": pair,
                  "f32": {k: {x: resnet32[k][x] for x in
                              ("step_ms", "busy", "peak_bytes", "losses")}
                          for k in ("eager", "compiled")}}
    summary = {"card": card, "kernel_holds_s": holds_s,
               "kernels": {f"{n} {label}": r for (n, label), r in
                           rows.items()},
               "nmt": nmt, "resnet50": resnet_out,
               "phase_s": time.perf_counter() - t0}
    return summary, rows, launches


@contextlib.contextmanager
def rnn_twins():
    """The fused-LSTM and fused-GRU wrappers (float32 and bf16 arms alike)
    swapped for their plain twins while inside (on CUDA tensors too; no
    launch is counted)."""
    from paddle_tpu_torch.ops.kernels import fused_gru as fg
    from paddle_tpu_torch.ops.kernels import fused_lstm as fl
    swaps = [(fl, "fused_lstm_fwd", fl.fused_lstm_fwd_plain),
             (fl, "fused_lstm_bwd", fl.fused_lstm_bwd_plain),
             (fg, "fused_gru_fwd", fg.fused_gru_fwd_plain),
             (fg, "fused_gru_bwd", fg.fused_gru_bwd_plain)]
    saved = [getattr(m, n) for m, n, _ in swaps]
    for m, n, twin in swaps:
        setattr(m, n, twin)
    try:
        yield
    finally:
        for (m, n, _), fn in zip(swaps, saved):
            setattr(m, n, fn)


def rnn_amp_program(name):
    """Phase 16's program `name` at full width and its feed: (main,
    startup, loss, feed)."""
    from paddle_tpu_torch import framework, layers, optimizer
    from paddle_tpu_torch.core.lod import RaggedPair
    from paddle_tpu_torch.models import lstm_lm
    if name.startswith("gru_nmt"):
        main, startup, _, loss = build_gru_nmt(bias=name == "gru_nmt")
        (src, trg, lbl), src_lens, trg_lens = gru_lengths()
        return main, startup, loss, {
            "src": RaggedPair(src, src_lens),
            "trg": RaggedPair(trg, trg_lens),
            "lbl": RaggedPair(lbl, trg_lens)}
    ids, lens = lm_lengths()
    words = RaggedPair(ids, lens)
    if name == "lstm_lm":
        with framework.isolated_name_scope():
            main, startup, f = lstm_lm.build_train(**LSTM_CFG)
        return main, startup, f["loss"], {"words": words,
                                          "targets": words}
    cfg = dict(STACKED_CFG)
    lr = cfg.pop("lr")
    main, startup = framework.Program(), framework.Program()
    with framework.isolated_name_scope(), \
            framework.program_guard(main, startup):
        data = layers.data("words", [1], dtype="int64", lod_level=1)
        label = layers.data("label", [1], dtype="int64")
        pred = lstm_lm.stacked_lstm_net(data, **cfg)
        loss = layers.mean(layers.cross_entropy(pred, label))
        optimizer.AdamOptimizer(learning_rate=lr).minimize(loss)
    label = np.random.RandomState(5).randint(
        0, cfg["class_dim"], (LSTM_BATCH, 1)).astype(np.int64)
    return main, startup, loss, {"words": words, "label": label}


def train_rnn_amp(card):
    """Phase 16: the RNN programs (RNN_AMP_LAUNCHES) at full width under
    amp_guard(), each beside its float32 arm and the same AMP step through
    the fused-RNN twins (rnn_twins): launches, step-1 loss and gradients
    held as RNN_AMP_LOSS_RTOL says, the compiled key captured as a CUDA
    graph (the wrappers' dtype conversions inside it), ms a step, busy
    share and peak memory of both arms. Returns the phase's summary and
    its launches (summed over the AMP arms)."""
    import gc
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    summary, total = {}, {}
    for name, want in RNN_AMP_LAUNCHES.items():
        main, startup, loss, feed = rnn_amp_program(name)
        weights = seeded_weights(startup, seed=0)
        params = [p.name for p in main.all_parameters()]
        arms = {}
        kernels.reset_launch_counts()
        arms["f32"] = train_arm(main, startup, loss, weights, feed, params,
                                card, f"{name} float32",
                                profiled=CVE_PROFILED)
        with amp.amp_guard():
            kernels.reset_launch_counts()
            arms["amp"] = train_arm(main, startup, loss, weights, feed,
                                    params, card, f"{name} AMP",
                                    profiled=CVE_PROFILED)
            with rnn_twins():
                twin = pinned_relu_grads(main, startup, loss, weights, feed,
                                         params, arms["amp"]["relu_signs"])
        a, c = arms["amp"], arms["f32"]
        launches = {n: k for n, k in a["launches"].items() if k}
        rnn = {n: k for n, k in launches.items()
               if n.startswith(("fused_lstm", "fused_gru"))}
        expect = {n: k * RNN_AMP_STEPS for n, k in want.items()}
        print(f"[{card}] {name} AMP launches {launches}", flush=True)
        if rnn != expect:
            raise SystemExit(f"{name} AMP launched {rnn} of the fused-RNN "
                             f"kernels, expected {expect}")
        if not a["captured"]:
            raise SystemExit(f"{name} AMP: no compiled key was captured as "
                             "a CUDA graph")
        for n, k in launches.items():
            total[n] = total.get(n, 0) + k
        rel = abs(a["losses"][0] - c["losses"][0]) / abs(c["losses"][0])
        if not rel <= RNN_AMP_LOSS_RTOL:
            raise SystemExit(f"{name} AMP step-1 loss {a['losses'][0]} vs "
                             f"float32 {c['losses'][0]}: relative distance "
                             f"{rel:.3e}, over {RNN_AMP_LOSS_RTOL}")

        def gap(x, y):
            return float(np.linalg.norm(np.asarray(x, np.float64)
                                        - np.asarray(y, np.float64)))
        if not any(gap(a["grads"][p], c["grads"][p]) for p in params):
            raise SystemExit(f"{name} AMP: every step-1 gradient equals the "
                             "float32 arm's; nothing was rounded")
        ratios = {p: gap(a["grads"][p], twin[p])
                  / max(gap(twin[p], c["grads"][p]), 1e-30) for p in params}
        worst = max(ratios, key=ratios.get)
        print(f"[{card}] {name} AMP: step-1 loss {a['losses'][0]:.6f} vs "
              f"float32 {c['losses'][0]:.6f} (relative {rel:.3e}); "
              f"|kernels - twins| / |twins - f32| up to "
              f"{ratios[worst]:.3f} ({worst}; factor {AMP_TWIN_FACTOR})",
              flush=True)
        fails = {p: r for p, r in ratios.items() if not r <= AMP_TWIN_FACTOR}
        if fails:
            raise SystemExit(f"{name} AMP gradients over {AMP_TWIN_FACTOR}x "
                             f"the twins' distance: {fails}")
        out = {"launches_per_step": {n: k / RNN_AMP_STEPS
                                     for n, k in launches.items()},
               "loss_rel_to_f32": rel, "twin_ratio_max": ratios[worst],
               "twin_ratio_argmax": worst, "captured": a["captured"]}
        for label, arm in arms.items():
            out[label] = {"losses": arm["losses"],
                          "step_ms": _median_ms(arm["step_ms"]),
                          "busy": arm["busy"],
                          "peak_bytes": arm["peak_bytes"]}
            print(f"[{card}] {name} {label}: {out[label]['step_ms']:.2f} ms "
                  f"a step, {100 * arm['busy']:.1f}% busy, peak "
                  f"{arm['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        summary[name] = out
        del arms, a, c, twin, main, startup, weights
        gc.collect()
        torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t0
    return summary, total


# the ops that update a program's state after its backward
UPDATE_OPS = ("sgd", "momentum", "adam", "adagrad", "adamax", "adadelta",
              "rmsprop", "decayed_adagrad", "ftrl", "lars_momentum",
              "average_accumulates")


def _update_ops(main):
    """The ops of `main` that update state after the backward, in program
    order: each optimizer's update op, Adamax's beta1_pow scale (in
    place) and ModelAverage's average_accumulates."""
    return [op for op in main.desc.global_block.ops
            if op.type in UPDATE_OPS or op.type == "scale"
            and op.input("X") == op.output("Out")]


def float64_updates(ops, state, grads):
    """`ops` run on the host in float64 over the state before a step and
    its fetched gradients ({name: numpy}): the state after it."""
    import torch
    from paddle_tpu_torch.core.registry import ExecutionContext, OpRegistry
    env = {n: torch.from_numpy(np.asarray(v)).to(
        torch.float64 if np.asarray(v).dtype.kind == "f" else None)
        for n, v in list(state.items()) + list(grads.items())}
    for op in ops:
        ctx = ExecutionContext(op, env, {"device": "cpu"})
        OpRegistry.get(op.type).compute(ctx)
        env.update(ctx.outputs)
    return {n: env[n].numpy() for n in state}


def train_optimizers(card):
    """Phase 17: OPT_CLASSES on phase 5's LSTM LM in float32, OPT_STEPS
    compiled steps each, every state update held against float64_updates;
    then ModelAverage's apply (the averages, from the accumulators) and
    restore (the parameters back bit for bit). Returns the phase's
    summary."""
    import torch
    from paddle_tpu_torch import (Executor, Scope, framework, layers,
                                  learning_rate_decay, optimizer,
                                  scope_guard)
    from paddle_tpu_torch.core.lod import RaggedPair
    from paddle_tpu_torch.models import lstm_lm
    t0 = time.perf_counter()
    ids, lens = lm_lengths()
    feed = {"words": RaggedPair(ids, lens), "targets": RaggedPair(ids, lens)}
    cfg = {k: v for k, v in LSTM_CFG.items() if k != "lr"}
    summary = {}
    for name, kwargs, schedule in OPT_CLASSES:
        main, startup = framework.Program(), framework.Program()
        with framework.isolated_name_scope(), \
                framework.program_guard(main, startup):
            w = layers.data("words", [1], dtype="int64", lod_level=1)
            tg = layers.data("targets", [1], dtype="int64", lod_level=1)
            loss, _ = lstm_lm.language_model(w, tg, **cfg)
            if name == "ModelAverage":
                _, params_grads = optimizer.SGDOptimizer(
                    learning_rate=1.0).minimize(loss)
                opt = optimizer.ModelAverage(params_grads, **kwargs)
            else:
                lr = getattr(learning_rate_decay, schedule[0])(*schedule[1])
                opt = getattr(optimizer, name)(learning_rate=lr, **kwargs)
                opt.minimize(loss)
        ops = _update_ops(main)
        names = sorted({n for op in ops for n in op.output_names()})
        reads = sorted(set(names) | {n for op in ops
                                     for n in op.input_names()
                                     if not n.endswith("@GRAD")})
        params = [p.name for p in main.all_parameters()]
        exe, scope = Executor(), Scope()
        exe.run(startup, scope=scope)
        weights = seeded_weights(startup, seed=0)
        for p in params:   # the accumulators keep their startup values
            scope.set(p, torch.from_numpy(weights[p]).to(
                scope.get(p).device))
        worst, losses = 0.0, []
        for step in range(OPT_STEPS):
            opt.set_lr_in_scope(step, scope)
            before = {n: scope.get(n).cpu().numpy().copy()
                      for n in reads}
            out = exe.run(main, feed=feed, scope=scope,
                          fetch_list=[loss.name]
                          + [p + "@GRAD" for p in params])
            losses.append(float(out[0].reshape(-1)[0]))
            want = float64_updates(ops, before, {
                p + "@GRAD": g for p, g in zip(params, out[1:])})
            for n in names:
                got = scope.get(n).cpu().numpy().astype(np.float64)
                ref = np.asarray(want[n], np.float64)
                limit = OPT_RTOL * np.abs(ref) + OPT_ATOL_FRAC * max(
                    float(np.abs(ref).max()), 1e-30)
                excess = float((np.abs(got - ref) / limit).max())
                worst = max(worst, excess)
                if not excess <= 1.0:
                    raise SystemExit(f"{name} step {step}: {n} is "
                                     f"{excess:.2f}x its allowance from the "
                                     "float64 update")
        out = {"losses": losses, "allowance_ratio_max": worst,
               "updated_vars": len(names),
               "update_ops": sorted({op.type for op in ops}),
               "schedule": schedule[0] if schedule else None}
        if name == "ModelAverage":
            trained = {p: scope.get(p).cpu().numpy().copy() for p in params}
            acc = opt._accumulators
            with scope_guard(scope):
                with opt.apply(exe):
                    gap = 0.0
                    for p in params:
                        s = sum(scope.get(acc[k][p].name).cpu().numpy()
                                .astype(np.float64)
                                for k in ("sum_1", "sum_2", "sum_3"))
                        n = sum(int(scope.get(acc[k][p].name).cpu()[0])
                                for k in ("num_accumulates",
                                          "old_num_accumulates"))
                        avg = scope.get(p).cpu().numpy()
                        gap = max(gap, float(np.abs(avg - s / n).max()
                                             / max(np.abs(s / n).max(),
                                                   1e-30)))
                for p in params:
                    if not np.array_equal(scope.get(p).cpu().numpy(),
                                          trained[p]):
                        raise SystemExit(f"ModelAverage restore: {p} is "
                                         "not its trained value")
            if not gap <= OPT_RTOL:
                raise SystemExit(f"ModelAverage apply: the averages sit "
                                 f"{gap:.3e} from the accumulators' mean")
            out["apply_rel_gap"] = gap
        note = (f"; apply/restore, averages within "
                f"{out['apply_rel_gap']:.2e}" if name == "ModelAverage"
                else "")
        print(f"[{card}] {name}: losses {losses}, {len(names)} state vars "
              f"of {out['update_ops']} held against float64 (worst "
              f"{worst:.3f} of the allowance){note}", flush=True)
        summary[name] = out
        del exe, scope
        torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t0
    return summary


def build_sequence_program(name):
    """Phase 18's program `name` at full width (SEQ_CFG): (main, startup,
    loss, the data vars)."""
    from paddle_tpu_torch import framework, layers, optimizer
    v, emb, hid = SEQ_CFG["vocab"], SEQ_CFG["emb"], SEQ_CFG["hid"]
    main, startup = framework.Program(), framework.Program()
    with framework.isolated_name_scope(), \
            framework.program_guard(main, startup):
        label = layers.data("label", [1], dtype="int64")
        if name == "sentiment":
            words = layers.data("words", [1], dtype="int64", lod_level=1)
            e = layers.embedding(words, size=[v, emb])
            conv = layers.sequence_conv(e, num_filters=hid, filter_size=3,
                                        act="relu")
            pooled = layers.sequence_pool(conv, pool_type="max")
            h, _ = layers.dynamic_lstm(layers.fc(e, size=4 * hid),
                                       size=4 * hid)
            feat = layers.concat([pooled, layers.sequence_last_step(h)],
                                 axis=-1)
            data = words
        else:
            docs = layers.data("docs", [1], dtype="int64", lod_level=2)
            toks = layers.nested_sequence_flatten(
                layers.embedding(docs, size=[v, emb]))
            h, _ = layers.dynamic_lstm(layers.fc(toks, size=4 * hid),
                                       size=4 * hid)
            sents = layers.nested_sequence_pack(
                layers.sequence_last_step(h), docs)
            h2, _ = layers.dynamic_lstm(layers.fc(sents, size=4 * hid),
                                        size=4 * hid)
            feat = layers.sequence_last_step(h2)
            data = docs
        logits = layers.fc(feat, size=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        optimizer.AdamOptimizer(learning_rate=SEQ_LR[name]).minimize(loss)
    return main, startup, loss, (data, label)


def sequence_feeds(name, data_vars):
    """Phase 18's two feeds of `name`, drawn from RandomState(0) and (1),
    and the first one's live tokens and rows: the sentiment batch as a
    RaggedPair (ids past a row's length are 0, as a LoDTensor pads them),
    the documents through DataFeeder at lod_level 2 (its buckets: tokens
    to a multiple of 16, sentence slots to a multiple of 4)."""
    from paddle_tpu_torch import DataFeeder
    from paddle_tpu_torch.core.lod import RaggedPair
    vocab = SEQ_CFG["vocab"]
    feeds = []
    for seed in range(2):
        rng = np.random.RandomState(seed)
        if name == "sentiment":
            b, (lo, hi) = SEQ_SENT_BATCH, SEQ_SENT_LENS
            ids = rng.randint(1, vocab, (b, hi, 1)).astype(np.int64)
            lens = rng.randint(lo, hi + 1, (b,)).astype(np.int32)
            ids[np.arange(hi)[None, :] >= lens[:, None]] = 0
            feeds.append({"words": RaggedPair(ids, lens),
                          "label": rng.randint(0, 2, (b, 1))
                          .astype(np.int64)})
            continue
        batch = []
        for _ in range(SEQ_DOCS):
            doc = [rng.randint(1, vocab, rng.randint(SEQ_TOKS[0],
                                                     SEQ_TOKS[1] + 1))
                   .tolist() for _ in range(rng.randint(SEQ_SENTS[0],
                                                        SEQ_SENTS[1] + 1))]
            batch.append((doc, [rng.randint(0, 2)]))
        feeds.append(DataFeeder(list(data_vars)).feed(batch))
    first = feeds[0]["words" if name == "sentiment" else "docs"]
    if name == "sentiment":
        info = dict(rows=SEQ_SENT_BATCH, live_tokens=int(first.lengths.sum()),
                    shape=list(first.data.shape))
    else:
        rows = first.tok_lengths * (np.arange(first.data.shape[1])[None, :]
                                    < first.sub_lengths[:, None])
        info = dict(rows=int(rows.size), zero_rows=int((rows == 0).sum()),
                    live_tokens=int(rows.sum()),
                    shape=list(first.data.shape))
    return feeds, info


def pinned_grads(main, startup, loss, weights, feed, params, signs, picks,
                 device):
    """pinned_relu_grads, with every max sequence_pool over a var in
    `picks` (name -> float [n, t, c] weights: 1/k on the k positions that
    attain the card's maximum, 0 elsewhere) taking the card's picks too:
    a near tie that rounding breaks the other way on `device` would move
    a gradient by O(1) of one example's share."""
    import torch
    from paddle_tpu_torch.core.registry import OpRegistry
    pool = OpRegistry.get("sequence_pool")
    free_pool = pool.compute
    weights_of = {n: torch.from_numpy(w).to(device) for n, w in picks.items()}

    def pinned_pool(ctx):
        name = ctx.op.input("X")[0]
        if ctx.attr("pooltype", "").upper() != "MAX" or name not in picks:
            return free_pool(ctx)
        ctx.set_output("Out", (ctx.input("X").data * weights_of[name]).sum(1))

    pool.compute = pinned_pool
    try:
        return pinned_relu_grads(main, startup, loss, weights, feed, params,
                                 signs, device=device)
    finally:
        pool.compute = free_pool


def max_pool_picks(main, values, feed):
    """For each max sequence_pool of `main` whose input was fetched in
    `values` (a LoDTensor) from a step on `feed`, the card's picks as
    pinned_grads takes them."""
    out = {}
    for op in main.desc.global_block.ops:
        name = op.input("X")[0] if op.type == "sequence_pool" else None
        if name in values and op.attrs.get("pooltype", "").upper() == "MAX":
            x = host_dense(values[name], feed)
            lens = np.asarray([len(r) for r in values[name].sequences()])
            valid = np.arange(x.shape[1])[None, :, None] < lens[:, None, None]
            x = np.where(valid, x, -np.inf)
            hit = x == x.max(axis=1, keepdims=True)
            out[name] = (hit / hit.sum(axis=1, keepdims=True)).astype(
                np.float32)
    return out


def card_vs_cpu_feed(name, feed):
    """The feed phase 18 holds the card against the port's CPU path on:
    the hierarchical batch whole; the sentiment batch's first
    SEQ_CPU_ROWS rows (the host's T256 scan takes ~28 s a step at batch
    128, as phase 9 cuts ResNet-50 to batch 4 for its CPU arm)."""
    from paddle_tpu_torch.core.lod import RaggedPair
    if name != "sentiment":
        return feed
    n = SEQ_CPU_ROWS
    return {"words": RaggedPair(feed["words"].data[:n],
                                feed["words"].lengths[:n]),
            "label": feed["label"][:n]}


def hold_card_vs_cpu(what, main, startup, loss, weights, feed, params,
                     card):
    """Phase 8's rule on one step of `feed`: the card's loss against the
    port's CPU path within MNIST_LOSS_RTOL; the card's gradients per
    element against a CPU step whose ReLUs and max pools take the card's
    masks and picks, at rtol TRAIN_GRAD_RTOL and atol the larger of
    TRAIN_GRAD_ATOL_FRAC * max|g| and TRAIN_GRAD_NOISE_FACTOR times how
    far that CPU step moves from weights one ulp away (phase 4's noise
    floor: the biases under the LSTM sum its dgates over every token of
    a T256 recurrence, and the two routes' roundings reach ~1e-5 * max|g|
    there); and by 2-norm against the free CPU step
    (TRAIN_GRAD_NORM_RTOL)."""
    t0 = time.perf_counter()
    relu_in = relu_inputs(main)
    pools = [op.input("X")[0] for op in main.desc.global_block.ops
             if op.type == "sequence_pool"
             and op.attrs.get("pooltype", "").upper() == "MAX"]
    gpu, _, _ = steps_arm(main, startup, loss, weights, feed, params, card,
                          f"{what} card", 1, extra=relu_in + pools)
    firsts = gpu["first_step"]
    signs = {n: host_dense(firsts[n], feed) > 0 for n in relu_in}
    picks = max_pool_picks(main, {n: firsts[n] for n in pools}, feed)
    cpu, _, _ = steps_arm(main, startup, loss, weights, feed, params, card,
                          f"{what} CPU", 1, device="cpu")

    def pinned_at(w):
        if signs or picks:
            return pinned_grads(main, startup, loss, w, feed, params, signs,
                                picks, "cpu")
        return steps_arm(main, startup, loss, w, feed, params, card,
                         f"{what} CPU", 1, device="cpu")[0]["grads"]

    pinned = cpu["grads"] if not (signs or picks) else pinned_at(weights)
    nudged = pinned_at(_nudged(weights, params))
    rel = abs(gpu["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
    worst, norm_gap, fails, by_noise = 0.0, 0.0, [], {}
    for p in params:
        g, r = gpu["grads"][p], pinned[p]
        scale = max(float(np.abs(r).max()), 1e-30)
        diff = float(np.abs(g - r).max())
        noise = float(np.abs(r - nudged[p]).max())
        atol = max(TRAIN_GRAD_ATOL_FRAC * scale,
                   TRAIN_GRAD_NOISE_FACTOR * noise)
        if atol > TRAIN_GRAD_ATOL_FRAC * scale:
            by_noise[p] = (diff / scale, noise / scale)
        worst = max(worst, diff / scale)
        norm_gap = max(norm_gap, _norm_gap(g, cpu["grads"][p]))
        if not np.allclose(g, r, rtol=TRAIN_GRAD_RTOL, atol=atol):
            fails.append(p)
        if p in fails or p in by_noise:
            print(f"  {p}@GRAD: max |diff| {diff / scale:.3e} * max|g|, "
                  f"one-ulp nudge {noise / scale:.3e} * max|g|", flush=True)
    print(f"[{card}] {what} card vs CPU, step 1: loss {gpu['losses'][0]:.7f}"
          f" vs {cpu['losses'][0]:.7f} (relative {rel:.3e}); gradients of "
          f"{len(params)} parameters against the pinned CPU step: worst "
          f"{worst:.3e} * max|g|, {len(by_noise)} held at the nudge's "
          f"noise floor; 2-norm gap to the free CPU step {norm_gap:.3e} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not rel <= MNIST_LOSS_RTOL or fails or \
            not norm_gap <= TRAIN_GRAD_NORM_RTOL:
        raise SystemExit(f"{what} card vs CPU: loss relative {rel:.3e}, "
                         f"{fails} differ per element, 2-norm gap "
                         f"{norm_gap:.3e}")
    return dict(loss_rel=rel, grad_max_diff_frac_pinned=worst,
                grad_norm_gap_free=norm_gap, cpu_loss=cpu["losses"][0],
                held_at_noise_floor=by_noise)


def train_sequence_models(card):
    """Phase 18: the sentiment program and the hierarchical LSTM at full
    width (SEQ_CFG). Per program: the kernel route in float32 (the fused
    LSTM launched exactly SEQ_LSTM_OPS forward and backward a compiled
    step, the key captured); step 1 against the port's CPU path by phase
    8's rule; the compiled arm against the eager one bit for bit over two
    alternating feeds (phase 14's rule); TRAIN_STEPS steps under
    amp_guard() by phase 16's rule (the bf16 LSTM kernels only); and the
    kernel route against the scan route by phase 5's rule. Returns the
    phase's summary and its launches (the float32 and AMP arms)."""
    import gc
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    summary, total = {"card": card, "config": dict(SEQ_CFG)}, {}
    for name, ops in SEQ_LSTM_OPS.items():
        t1 = time.perf_counter()
        main, startup, loss, data_vars = build_sequence_program(name)
        weights = seeded_weights(startup, seed=0)
        params = [p.name for p in main.all_parameters()]
        feeds, info = sequence_feeds(name, data_vars)
        feed = feeds[0]
        print(f"{name}: {len(main.desc.global_block.ops)} ops, "
              f"{sum(weights[p].size for p in params)} parameters, feed "
              f"{info}", flush=True)

        kernels.reset_launch_counts()
        f32 = train_arm(main, startup, loss, weights, feed, params, card,
                        f"{name} float32", profiled=CVE_PROFILED)
        launches = {n: k for n, k in f32["launches"].items() if k}
        want = {"fused_lstm_fwd": ops * TRAIN_STEPS,
                "fused_lstm_bwd": ops * TRAIN_STEPS}
        print(f"[{card}] {name} float32 launches {launches}", flush=True)
        if launches != want or not f32["captured"]:
            raise SystemExit(f"{name}: launches {launches}, expected {want}"
                             f"; captured {f32['captured']}")
        profiled = profile_step(main, startup, loss, weights, feed, card,
                                f"{name} float32", groups=LSTM_KERNELS)
        card_cpu = hold_card_vs_cpu(name, main, startup, loss, weights,
                                    card_vs_cpu_feed(name, feed), params,
                                    card)

        pair = cve_training_pair(name, main, startup, loss, weights, feeds,
                                 card)
        if not pair["compiled"]["captured"]:
            raise SystemExit(f"{name}: the compiled arm was not captured")

        with amp.amp_guard():
            kernels.reset_launch_counts()
            a = train_arm(main, startup, loss, weights, feed, params, card,
                          f"{name} AMP", profiled=CVE_PROFILED)
            with rnn_twins():
                twin = pinned_relu_grads(main, startup, loss, weights, feed,
                                         params, a["relu_signs"])
        amp_launches = {n: k for n, k in a["launches"].items() if k}
        want_amp = {"fused_lstm_fwd_bf16": ops * TRAIN_STEPS,
                    "fused_lstm_bwd_bf16": ops * TRAIN_STEPS}
        print(f"[{card}] {name} AMP launches {amp_launches}", flush=True)
        if amp_launches != want_amp or not a["captured"]:
            raise SystemExit(f"{name} AMP: launches {amp_launches}, "
                             f"expected {want_amp}; captured "
                             f"{a['captured']}")
        rel = abs(a["losses"][0] - f32["losses"][0]) / abs(f32["losses"][0])

        def gap(x, y):
            return float(np.linalg.norm(np.asarray(x, np.float64)
                                        - np.asarray(y, np.float64)))
        ratios = {p: gap(a["grads"][p], twin[p])
                  / max(gap(twin[p], f32["grads"][p]), 1e-30)
                  for p in params}
        worst = max(ratios, key=ratios.get)
        print(f"[{card}] {name} AMP: step-1 loss {a['losses'][0]:.6f} vs "
              f"float32 {f32['losses'][0]:.6f} (relative {rel:.3e}); "
              f"|kernels - twins| / |twins - f32| up to {ratios[worst]:.3f} "
              f"({worst}; factor {AMP_TWIN_FACTOR})", flush=True)
        if not rel <= RNN_AMP_LOSS_RTOL or \
                not any(gap(a["grads"][p], f32["grads"][p]) for p in params) \
                or ratios[worst] > AMP_TWIN_FACTOR:
            raise SystemExit(f"{name} AMP: loss relative {rel:.3e}; twin "
                             f"ratios over {AMP_TWIN_FACTOR}: "
                             f"{ {p: r for p, r in ratios.items() if r > AMP_TWIN_FACTOR} }")

        _stamp_pallas(main, "lstm", "0")
        kernels.reset_launch_counts()
        with knob("PADDLE_TPU_PALLAS_LSTM", "0"):
            scan, _, _ = steps_arm(main, startup, loss, weights, feed,
                                   params, card, f"{name} scan", TRAIN_STEPS)
        if any(k for n, k in kernels.launch_counts().items()
               if n.startswith("fused_lstm")):
            raise SystemExit(f"{name}: the scan route launched the fused "
                             "LSTM")
        loss_rel, grad_worst = hold_routes(f32, scan, params, card, name)

        for n, k in list(launches.items()) + list(amp_launches.items()):
            total[n] = total.get(n, 0) + k
        out = {"feed": info, "launches_per_step": {
                   "float32": {n: k / TRAIN_STEPS for n, k in
                               launches.items()},
                   "amp": {n: k / TRAIN_STEPS for n, k in
                           amp_launches.items()}},
               "card_vs_cpu": card_cpu, "compiled_vs_eager": pair,
               "profiled_step": profiled,
               "kernel_vs_scan": {"loss_rel_diff_max": loss_rel,
                                  "grad_max_diff_frac": grad_worst},
               "amp_loss_rel_to_f32": rel, "twin_ratio_max": ratios[worst],
               "twin_ratio_argmax": worst}
        for label, arm in (("f32", f32), ("amp", a), ("scan", scan)):
            out[label] = {"losses": arm["losses"],
                          "step_ms": _median_ms(arm["step_ms"]),
                          "peak_bytes": arm["peak_bytes"],
                          **({"busy": arm["busy"]} if "busy" in arm else {})}
            print(f"[{card}] {name} {label}: {out[label]['step_ms']:.2f} ms a"
                  f" step" + (f", {100 * arm['busy']:.1f}% busy"
                              if "busy" in arm else "")
                  + f", peak {arm['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        out["program_s"] = time.perf_counter() - t1
        summary[name] = out
        del f32, a, scan, twin, pair, profiled, main, startup, weights, feeds
        gc.collect()
        torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t0
    print(f"[{card}] phase 18: {summary['phase_s']:.1f} s", flush=True)
    return summary, total


def build_cf_program(name):
    """Phase 19's program `name` ("mt" or "dyn_rnn_lstm") at full width
    (CF_MT_CFG, CF_SENT_CFG): (main, startup, loss, the data vars)."""
    from paddle_tpu_torch import framework, layers, optimizer
    cf = layers.control_flow
    main, startup = framework.Program(), framework.Program()
    with framework.isolated_name_scope(), \
            framework.program_guard(main, startup):
        if name == "mt":
            v, emb, hid = (CF_MT_CFG[k] for k in ("vocab", "emb", "hid"))
            src = layers.data("src", [1], dtype="int64", lod_level=1)
            trg = layers.data("trg", [1], dtype="int64", lod_level=1)
            lbl = layers.data("lbl", [1], dtype="int64", lod_level=1)
            enc_in = layers.fc(layers.embedding(src, size=[v, emb]),
                               size=4 * hid, act="tanh")
            enc, _ = layers.dynamic_lstm(enc_in, size=4 * hid)
            enc_last = layers.sequence_last_step(enc)
            trg_emb = layers.embedding(trg, size=[v, emb])
            drnn = cf.DynamicRNN()
            with drnn.block():
                word = drnn.step_input(trg_emb)
                pre = drnn.memory(init=enc_last)
                state = layers.fc([word, pre], size=hid, act="tanh")
                drnn.update_memory(pre, state)
                drnn.output(layers.fc(state, size=v, act="softmax"))
            loss = layers.mean(layers.cross_entropy(drnn(), lbl))
            lr, data = CF_MT_CFG["lr"], (src, trg, lbl)
        else:
            v, emb, hid = (CF_SENT_CFG[k] for k in ("vocab", "emb", "hid"))
            words = layers.data("words", [1], dtype="int64", lod_level=1)
            label = layers.data("label", [1], dtype="int64")
            sentence = layers.fc(layers.embedding(words, size=[v, emb]),
                                 size=hid, act="tanh")
            rnn = cf.DynamicRNN()
            with rnn.block():
                word = rnn.step_input(sentence)
                prev_hidden = rnn.memory(value=0.0, shape=[hid])
                prev_cell = rnn.memory(value=0.0, shape=[hid])

                def gate_common(ipt, hidden):
                    return layers.fc(ipt, size=hid) + \
                        layers.fc(hidden, size=hid, bias_attr=False)

                forget_gate = layers.sigmoid(gate_common(word, prev_hidden))
                input_gate = layers.sigmoid(gate_common(word, prev_hidden))
                output_gate = layers.sigmoid(gate_common(word, prev_hidden))
                cell_gate = layers.sigmoid(gate_common(word, prev_hidden))
                cell = forget_gate * prev_cell + input_gate * cell_gate
                hidden = output_gate * layers.tanh(cell)
                rnn.update_memory(prev_cell, cell)
                rnn.update_memory(prev_hidden, hidden)
                rnn.output(hidden)
            prediction = layers.fc(layers.sequence_last_step(rnn()), size=2,
                                   act="softmax")
            loss = layers.mean(layers.cross_entropy(prediction, label))
            lr, data = CF_SENT_CFG["lr"], (words, label)
        optimizer.AdamOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, loss, data


def cf_feeds(name):
    """Phase 19's two feeds of `name` and the first one's live tokens: the
    MT batch as phase 6 draws it (gru_lengths, seeds 0 and 1), the
    sentiment batch as phase 18 draws it."""
    from paddle_tpu_torch.core.lod import RaggedPair
    if name == "dyn_rnn_lstm":
        feeds, info = sequence_feeds("sentiment", None)
        return feeds, info
    feeds = []
    for seed in range(2):
        (src, trg, lbl), src_lens, trg_lens = gru_lengths(seed)
        feeds.append({"src": RaggedPair(src, src_lens),
                      "trg": RaggedPair(trg, trg_lens),
                      "lbl": RaggedPair(lbl, trg_lens)})
    first = feeds[0]
    return feeds, dict(rows=GRU_BATCH, t=GRU_T,
                       live_tokens={"source": int(first["src"].lengths.sum()),
                                    "target": int(first["trg"].lengths.sum())})


def first_rows(feed, n):
    """The feed's first `n` rows, each ragged value's time axis cut to
    the longest of them (the CPU arm's feed; the card runs it too)."""
    from paddle_tpu_torch.core.lod import RaggedPair
    out = {}
    for k, v in feed.items():
        if isinstance(v, RaggedPair):
            t = int(np.max(v.lengths[:n]))
            out[k] = RaggedPair(v.data[:n, :t], v.lengths[:n])
        else:
            out[k] = v[:n]
    return out


def decoder_share(main, startup, loss, weights, feed, card):
    """The device time of the dynamic_rnn op (its forward and the
    backward its __vjp__ op pulls through the forward's record) as a
    share of one step's device time: a fresh executor's first run of the
    key (planned, not captured: a graph replay's kernels carry no host
    range) under torch.profiler, the op's two halves in record_function
    ranges (autograd's worker threads off for the run, so the backward's
    kernels launch inside its range)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    from paddle_tpu_torch.core.registry import OpRegistry
    from paddle_tpu_torch.ops import core_ops
    opdef = OpRegistry.get("dynamic_rnn")
    compute, grads = opdef.compute, core_ops.vjp_grads
    outs = {n for op in main.desc.global_block.ops
            if op.type == "dynamic_rnn" for n in op.output_names()}

    def ranged_compute(ctx):
        with record_function("cf::dynamic_rnn forward"):
            return compute(ctx)

    def ranged_grads(recorded, *args, **kw):
        if outs & set(recorded):
            with record_function("cf::dynamic_rnn backward"):
                return grads(recorded, *args, **kw)
        return grads(recorded, *args, **kw)

    exe, scope = Executor(DEVICE), Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, weights)
    torch.cuda.synchronize()
    opdef.compute, core_ops.vjp_grads = ranged_compute, ranged_grads
    try:
        with torch.autograd.set_multithreading_enabled(False), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
    finally:
        opdef.compute, core_ops.vjp_grads = compute, grads
    halves = {}
    for e in prof.key_averages():
        if e.key.startswith("cf::") and \
                getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            halves[e.key] = halves.get(e.key, 0.0) + us / 1e3
    total = sum(ms for k, ms, _ in device_kernels(prof)
                if not k.startswith("cf::"))
    share = sum(halves.values()) / total if total else 0.0
    print(f"[{card}] mt decoder (dynamic_rnn) device time: "
          + ", ".join(f"{k[4:]} {ms:.2f} ms" for k, ms in halves.items())
          + f" of {total:.2f} ms a step ({100 * share:.1f}%; an uncaptured "
          "run)", flush=True)
    if not halves or not 0.0 < share <= 1.0:
        raise SystemExit(f"mt decoder share: {halves} of {total} ms")
    return dict(share=share, device_ms=halves, step_device_ms=total)


def build_while_grad(name, lr):
    """tests/test_while_grad_dynamic.py's `name` on the port: "while_sum"
    (_build at :19, x0 0.3, target 2), "while_in_drnn" (:264, p0 0.25),
    "while_in_cond" (:322, x0 0.3) or "forward_only" (:101). Returns
    (main, startup, fetch vars, the parameter's name)."""
    from paddle_tpu_torch import framework, initializer, layers, optimizer
    cf = layers.control_flow
    main, startup = framework.Program(), framework.Program()

    def param(pname, v):
        return layers.create_parameter(
            shape=[1], dtype="float32", name=pname,
            default_initializer=initializer.ConstantInitializer(v))

    def walk(limit, step, t=None):
        if t is None:
            t = layers.fill_constant([1], "float32", 0.0)
            t.stop_gradient = False
        cond = cf.less_than_v(t, limit)
        w = cf.While(cond)
        with w.block():
            layers.assign(layers.elementwise_add(t, step), output=t)
            cf.less_than_v(t, limit, cond=cond)
        return t, w

    with framework.isolated_name_scope(), \
            framework.program_guard(main, startup):
        if name == "forward_only":
            i = layers.fill_constant([1], "float32", 0.0)
            lim = layers.data("lim", [1], dtype="float32")
            cond = cf.less_than_v(i, lim)
            w = cf.While(cond)
            with w.block():
                layers.increment(i, value=1.0, in_place=True)
                cf.less_than_v(i, lim, cond=cond)
            return main, startup, [i, w.steps], None
        if name == "while_sum":
            x = param("xparam", 0.3)
            s, w = walk(layers.data("thr", [1], dtype="float32"), x)
            loss = layers.reduce_sum(layers.square(layers.elementwise_sub(
                s, layers.fill_constant([1], "float32", 2.0))))
            fetch = [loss, w.steps]
        elif name == "while_in_drnn":
            p = param("p_drnn_nest", 0.25)
            xs = layers.data("x", [1], dtype="float32", lod_level=1)
            drnn = cf.DynamicRNN()
            with drnn.block():
                x_t = drnn.step_input(xs)
                prev = drnn.memory(shape=[1], value=0.0)
                t, _ = walk(layers.reshape(x_t, [1]), p)
                nxt = layers.elementwise_add(prev, layers.reshape(t, [1, 1]))
                drnn.update_memory(prev, nxt)
                drnn.output(nxt)
            drnn()
            loss = layers.reduce_sum(layers.square(drnn.last_memory()))
            fetch = [loss]
        else:
            x = param("xp_cond", 0.3)
            thr_out = layers.data("thr_out", [1], dtype="float32")
            thr_in = layers.data("thr_in", [1], dtype="float32")
            s = layers.fill_constant([1], "float32", 0.0)
            s.stop_gradient = False
            cond_o = cf.less_than_v(s, thr_out)
            w = cf.While(cond_o)
            with w.block():
                pred = cf.less_than_v(
                    s, layers.fill_constant([1], "float32", 0.6))
                inc = cf.cond_op(pred, lambda: walk(thr_in, x)[0],
                                 lambda: layers.scale(x, scale=2.0))
                layers.assign(layers.elementwise_add(s, inc), output=s)
                cf.less_than_v(s, thr_out, cond=cond_o)
            loss = layers.reduce_sum(layers.square(s))
            fetch = [loss, w.steps]
        optimizer.SGDOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, fetch, main.all_parameters()[0].name


def if_else_rows():
    """tests/test_dynamic_rnn.py:89 on the port: (main, startup, fetch)."""
    from paddle_tpu_torch import framework, layers
    cf = layers.control_flow
    main, startup = framework.Program(), framework.Program()
    with framework.isolated_name_scope(), \
            framework.program_guard(main, startup):
        x = layers.data("x", [1], dtype="float32")
        ie = cf.IfElse(layers.greater_than(
            x, layers.fill_constant([1], "float32", 0.0)))
        with ie.true_block():
            ie.output(ie.input(x) * 2.0)
        with ie.false_block():
            ie.output(ie.input(x) - 1.0)
        out = ie()
    return main, startup, [out]


def cf_arm(main, startup, fetch, feeds, compiled, param=None):
    """The runs of `feeds` through a fresh Executor(DEVICE,
    compiled=compiled) and scope: (each run's fetches, the parameter
    before and after each run, the executor)."""
    import torch
    from paddle_tpu_torch import Executor, Scope
    exe, scope = Executor(DEVICE, compiled=compiled), Scope()
    exe.run(startup, scope=scope)
    outs, params = [], []

    def value():
        return float(scope.get(param).reshape(-1)[0]) if param else None

    params.append(value())
    for feed in feeds:
        outs.append([np.asarray(getattr(v, "data", v)) for v in
                     exe.run(main, feed=feed, fetch_list=fetch, scope=scope)])
        params.append(value())
    torch.cuda.synchronize()
    return outs, params, exe


def cf_bitwise(what, compiled, eager, card):
    (c_outs, c_params, _), (e_outs, e_params, _) = compiled, eager
    same = len(c_outs) == len(e_outs) and c_params == e_params and all(
        c.dtype == e.dtype and np.array_equal(c, e)
        for cs, es in zip(c_outs, e_outs) for c, e in zip(cs, es))
    if not same:
        raise SystemExit(f"{what}: compiled {c_outs} {c_params} vs eager "
                         f"{e_outs} {e_params}")
    print(f"[{card}] {what}: compiled arm bit for bit equal to the eager "
          f"arm ({len(c_outs)} runs)", flush=True)


def cf_host_walk(x, limit):
    t, n = 0.0, 0
    while t < limit:
        t, n = t + x, n + 1
    return t, n


def cf_while_grads(card):
    """Phase 19 (c) and (d): the WhileGrad programs and the routes that
    are not captured, each compiled against eager bit for bit."""
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.ops import kernels
    out = {}
    kernels.reset_launch_counts()
    # (c) _build: the applied gradient of one step against 2 (s - t) n
    lr = 0.05
    main, startup, fetch, p = build_while_grad("while_sum", lr)
    feeds = [{"thr": np.asarray([1.0], np.float32)}]
    arms = {c: cf_arm(main, startup, fetch, feeds, c, p)
            for c in (True, False)}
    cf_bitwise("while_sum one step", arms[True], arms[False], card)
    (outs, params, _), want = arms[True], 2 * (1.2 - 2.0) * 4
    g = (params[0] - params[1]) / lr
    print(f"[{card}] while_sum: {int(outs[0][1])} passes, applied gradient "
          f"{g:.6f} vs analytic {want:.6f}", flush=True)
    if int(outs[0][1]) != 4 or not abs(g - want) <= CF_ANALYTIC_RTOL * \
            abs(want):
        raise SystemExit(f"while_sum: {outs} gradient {g} vs {want}")
    out["while_sum_grad"] = dict(applied=g, analytic=want)

    # (c) _build at lr 0: one miss per trip-count bucket, then replays
    main, startup, fetch, p = build_while_grad("while_sum", 0.0)
    trips = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 1.0)
    feeds = [{"thr": np.asarray([v], np.float32)} for v in trips]
    arms = {c: cf_arm(main, startup, fetch, feeds, c, p)
            for c in (True, False)}
    cf_bitwise("while_sum buckets", arms[True], arms[False], card)
    outs, _, exe = arms[True]
    keys = {k[6]: c for k, c in exe._cache.items()
            if k[0] == main.desc.uid}
    steps = [int(o[1]) for o in outs]
    losses = [float(o[0]) for o in outs]
    print(f"[{card}] while_sum buckets: passes {steps}, keys "
          f"{ {str(b): c.captured for b, c in keys.items()} } (captured), "
          f"cache {exe.cache_stats}", flush=True)
    if steps != [4, 4, 4, 7, 7, 7, 4] or \
            sorted(map(str, keys)) != ["(('while_0', 4),)",
                                       "(('while_0', 8),)"] or \
            not all(c.captured for c in keys.values()) or \
            exe.cache_stats != {"hits": 5, "misses": 3} or \
            not np.allclose(losses, [(0.3 * n - 2.0) ** 2 for n in steps],
                            rtol=1e-4):
        raise SystemExit(f"while_sum buckets: {steps} {losses} {keys} "
                         f"{exe.cache_stats}")
    out["while_sum_buckets"] = dict(passes=steps,
                                    cache_stats=dict(exe.cache_stats),
                                    captured=len(keys))

    # (c) the dynamic While inside a DynamicRNN: 3 steps, each against
    # central differences of the host replica
    lr, eps = 2e-4, 1e-3
    main, startup, fetch, p = build_while_grad("while_in_drnn", lr)
    rows = [np.asarray([[0.4], [0.9], [0.2]], np.float32)]
    feeds = [{"x": LoDTensor.from_sequences(rows)}] * 3
    arms = {c: cf_arm(main, startup, fetch, feeds, c, p)
            for c in (True, False)}
    cf_bitwise("while_in_drnn", arms[True], arms[False], card)
    _, params, exe = arms[True]

    def host(v):
        return sum(cf_host_walk(v, r)[0] for r in (0.4, 0.9, 0.2)) ** 2

    worst = 0.0
    for x0, x1 in zip(params, params[1:]):
        g, fd = (x0 - x1) / lr, (host(x0 + eps) - host(x0 - eps)) / (2 * eps)
        worst = max(worst, abs(g - fd) / abs(fd))
    captured = exe.last_compiled.captured
    print(f"[{card}] while_in_drnn: applied gradients against central "
          f"differences, worst relative {worst:.3e}; key captured "
          f"{captured}", flush=True)
    if not worst <= CF_FD_RTOL or not captured:
        raise SystemExit(f"while_in_drnn: {worst} captured {captured}")
    out["while_in_drnn"] = dict(fd_rel_worst=worst, params=params)

    # (d) cond and the forward-only While run compiled, not captured; the
    # IfElse is captured
    for name, feeds, want in (
            ("while_in_cond", [{"thr_out": np.asarray([1.5], np.float32),
                                "thr_in": np.asarray([1.0], np.float32)}]
             * 3, ("cond",)),
            ("forward_only", [{"lim": np.asarray([5.0], np.float32)}] * 3,
             ("while",)),
            ("if_else_rows", [{"x": np.asarray([[1.0], [-2.0], [3.0],
                                                [-4.0]], np.float32)}] * 3,
             ())):
        if name == "if_else_rows":
            (main, startup, fetch), p = if_else_rows(), None
        else:
            main, startup, fetch, p = build_while_grad(name, 0.001)
        arms = {c: cf_arm(main, startup, fetch, feeds, c, p)
                for c in (True, False)}
        cf_bitwise(name, arms[True], arms[False], card)
        compiled = arms[True][2].last_compiled
        print(f"[{card}] {name}: uncaptured_ops {compiled.uncaptured_ops}, "
              f"captured {compiled.captured}", flush=True)
        if compiled.uncaptured_ops != want or compiled.captured == bool(want):
            raise SystemExit(f"{name}: {compiled.uncaptured_ops} captured "
                             f"{compiled.captured}, expected {want}")
        out[name] = dict(uncaptured_ops=list(compiled.uncaptured_ops),
                         captured=compiled.captured,
                         outs=[[o.tolist() for o in run]
                               for run in arms[True][0]])
    stray = {n: k for n, k in kernels.launch_counts().items() if k}
    if stray:
        raise SystemExit(f"the WhileGrad programs launched {stray}")
    return out


def train_control_flow(card, sentiment):
    """Phase 19: (a) the book's MT program with its DynamicRNN decoder and
    (b) the dyn_rnn_lstm classifier at full width, each: TRAIN_STEPS
    compiled steps in float32 (exactly CF_LSTM_OPS fused-LSTM forward and
    backward launches a step, the key captured) with a profiled step;
    step 1 against the port's CPU path on its first CF_CPU_ROWS rows by
    phase 8's rule; the compiled arm against the eager one bit for bit
    over two alternating feeds (phase 14's rule); for (a) the kernel
    route against the scan route by phase 5's rule and the decoder's
    share of the device time. Then (c) and (d) (cf_while_grads).
    `sentiment` is phase 18's sentiment summary, whose float32 step (the
    fused-LSTM kernels) (b) is set beside. Returns the phase's summary
    and its launches."""
    import gc
    import torch
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    summary, total = {"card": card, "mt_config": dict(CF_MT_CFG),
                      "dyn_rnn_lstm_config": dict(CF_SENT_CFG)}, {}
    for name, ops in CF_LSTM_OPS.items():
        t1 = time.perf_counter()
        main, startup, loss, _ = build_cf_program(name)
        weights = seeded_weights(startup, seed=0)
        params = [p.name for p in main.all_parameters()]
        feeds, info = cf_feeds(name)
        feed = feeds[0]
        print(f"{name}: {len(main.desc.global_block.ops)} ops, "
              f"{sum(weights[p].size for p in params)} parameters, feed "
              f"{info}", flush=True)

        kernels.reset_launch_counts()
        f32 = train_arm(main, startup, loss, weights, feed, params, card,
                        f"{name} float32", profiled=CVE_PROFILED)
        launches = {n: k for n, k in f32["launches"].items() if k}
        want = {k: ops * TRAIN_STEPS for k in ("fused_lstm_fwd",
                                                "fused_lstm_bwd") if ops}
        print(f"[{card}] {name} float32 launches {launches}", flush=True)
        if launches != want or not f32["captured"]:
            raise SystemExit(f"{name}: launches {launches}, expected {want}"
                             f"; captured {f32['captured']}")
        # (b)'s busy share is train_arm's: its top kernels are the step's
        # small GEMMs and elementwise ops
        profiled = profile_step(main, startup, loss, weights, feed, card,
                                f"{name} float32", groups=LSTM_KERNELS) \
            if ops else None
        card_cpu = hold_card_vs_cpu(name, main, startup, loss, weights,
                                    first_rows(feed, CF_CPU_ROWS), params,
                                    card)
        pair = cve_training_pair(name, main, startup, loss, weights, feeds,
                                 card, steps=CF_CVE_STEPS, profiled=0)
        if not pair["compiled"]["captured"]:
            raise SystemExit(f"{name}: the compiled arm was not captured")
        out = {"feed": info, "launches_per_step": {
                   n: k / TRAIN_STEPS for n, k in launches.items()},
               "card_vs_cpu": card_cpu, "compiled_vs_eager": pair}
        if profiled:
            out["profiled_step"] = profiled
        arms = [("f32", f32)]
        if ops:
            out["decoder"] = decoder_share(main, startup, loss, weights,
                                           feed, card)
            _stamp_pallas(main, "lstm", "0")
            kernels.reset_launch_counts()
            with knob("PADDLE_TPU_PALLAS_LSTM", "0"):
                scan, _, _ = steps_arm(main, startup, loss, weights, feed,
                                       params, card, f"{name} scan",
                                       TRAIN_STEPS)
            if any(k for n, k in kernels.launch_counts().items() if k):
                raise SystemExit(f"{name}: the scan route launched "
                                 f"{kernels.launch_counts()}")
            loss_rel, grad_worst = hold_routes(f32, scan, params, card, name)
            out["kernel_vs_scan"] = {"loss_rel_diff_max": loss_rel,
                                     "grad_max_diff_frac": grad_worst}
            arms.append(("scan", scan))
        for label, arm in arms:
            out[label] = {"losses": arm["losses"],
                          "step_ms": _median_ms(arm["step_ms"]),
                          "peak_bytes": arm["peak_bytes"],
                          **({"busy": arm["busy"]} if "busy" in arm else {})}
            print(f"[{card}] {name} {label}: {out[label]['step_ms']:.2f} ms a"
                  f" step" + (f", {100 * arm['busy']:.1f}% busy"
                              if "busy" in arm else "")
                  + f", peak {arm['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        if not ops:
            fused_ms = sentiment["f32"]["step_ms"]
            out["sentiment_fused_lstm_step_ms"] = fused_ms
            print(f"[{card}] dyn_rnn_lstm {out['f32']['step_ms']:.2f} ms a "
                  f"step (the LSTM in a DynamicRNN step) vs phase 18's "
                  f"sentiment {fused_ms:.2f} ms (the fused-LSTM kernels)",
                  flush=True)
        for n, k in launches.items():
            total[n] = total.get(n, 0) + k
        out["program_s"] = time.perf_counter() - t1
        summary[name] = out
        del f32, arms, pair, profiled, main, startup, weights, feeds
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    summary["while_grad"] = cf_while_grads(card)
    summary["while_grad"]["program_s"] = time.perf_counter() - t1
    summary["phase_s"] = time.perf_counter() - t0
    print(f"[{card}] phase 19: {summary['phase_s']:.1f} s", flush=True)
    return summary, total


# -- phase 20: the rewrite pipeline ----------------------------------------
# (c): every compile-cache miss of every path the script drives, recorded
# as it happens: the rewrite pipeline's summary (rewrite_program, wrapped)
# and the memory plan and cost of the program that runs (Executor._reports,
# wrapped), under the path main() names
MISS_LOG: list = []
CURRENT_PATH = ["setup"]


def record_misses():
    """Wrap rewrite_program and Executor._reports so each miss lands in
    MISS_LOG under CURRENT_PATH (the wrappers return what they wrap)."""
    from paddle_tpu_torch.analysis import rewrite
    from paddle_tpu_torch.core.executor import Executor
    pipeline, reports = rewrite.rewrite_program, Executor._reports

    def logged_pipeline(*args, **kw):
        res = pipeline(*args, **kw)
        MISS_LOG.append({"path": CURRENT_PATH[0], "kind": "rewrite",
                         "seconds": res.seconds, "changed": res.changed,
                         "aborted": list(res.aborted),
                         "passes": res.summary()["passes"]})
        return res

    def logged_reports(self, source, program, feed_vals, stacked_feed):
        mem, cost = reports(self, source, program, feed_vals, stacked_feed)
        MISS_LOG.append({"path": CURRENT_PATH[0], "kind": "reports",
                         "program": source.uid,
                         "peak_bytes": mem.peak_bytes if mem else None,
                         "ideal_peak_bytes": mem.ideal_peak_bytes
                         if mem else None,
                         "flops": cost.flops if cost else None})
        return mem, cost

    rewrite.rewrite_program = logged_pipeline
    Executor._reports = logged_reports


def path_report(path, card):
    """One path's misses: the pipeline's runs (actions per pass summed,
    seconds), the largest static plan (arena and ideal peak) beside the
    card's peak allocation since the path's last reset, and the cost
    model's GFLOP a step of its largest key."""
    import torch
    rows = [r for r in MISS_LOG if r["path"] == path]
    runs = [r for r in rows if r["kind"] == "rewrite"]
    plans = [r for r in rows if r["kind"] == "reports"
             and r["peak_bytes"] is not None]
    passes: dict = {}
    for r in runs:
        for name, acts in r["passes"].items():
            for act, n in acts.items():
                key = f"{name}:{act}"
                passes[key] = passes.get(key, 0) + n
    top = max(plans, key=lambda r: r["peak_bytes"]) if plans else None
    flops = max((r["flops"] or 0 for r in plans), default=0)
    out = {"rewrites": len(runs),
           "pipeline_s": sum(r["seconds"] for r in runs),
           "pipeline_s_max": max((r["seconds"] for r in runs), default=0.0),
           "aborted": sorted({a for r in runs for a in r["aborted"]}),
           "actions": passes, "keys_planned": len(plans),
           "static_peak_bytes": top["peak_bytes"] if top else None,
           "static_ideal_peak_bytes": top["ideal_peak_bytes"] if top
           else None,
           "device_peak_bytes": torch.cuda.max_memory_allocated(),
           "gflop_per_step_max_key": flops / 1e9}
    print(f"[{card}] rewrite report, {path}: {out['rewrites']} pipeline "
          f"runs ({out['pipeline_s']:.2f} s, longest "
          f"{out['pipeline_s_max']:.2f} s; aborted {out['aborted']}), "
          f"{out['keys_planned']} keys planned; largest static plan "
          + (f"{top['peak_bytes'] / 2**30:.3f} GiB arena / "
             f"{top['ideal_peak_bytes'] / 2**30:.3f} GiB ideal"
             if top else "none")
          + f" beside the card's peak "
          f"{out['device_peak_bytes'] / 2**30:.3f} GiB; largest key "
          f"{out['gflop_per_step_max_key']:.1f} GFLOP a step; actions "
          f"{passes}", flush=True)
    return out


def rewrite_arm(main, startup, loss, weights, feed, card, label, steps,
                profiled=0):
    """`steps` steps of `main` from `weights` in a fresh scope and
    executor on the card, one fetch list (the loss): one compile key,
    warmed up by its first run and captured at its second. Returns the
    losses, the parameters after the steps, ms a step (median of the
    steps after the first two), the peak allocation, the launches a step
    (the counts' growth over the steps), the busy share of `profiled`
    more steps, and the key's analysis reports (rewrite summary, static
    peak, cost-model FLOPs a step and their rate at the median step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    from paddle_tpu_torch.ops import kernels
    exe, scope = Executor(DEVICE), Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, weights)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kernels.launch_counts()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
    torch.cuda.synchronize()
    launches = {n: (c - before[n]) / steps
                for n, c in kernels.launch_counts().items() if c - before[n]}
    peak = torch.cuda.max_memory_allocated()
    if not np.all(np.isfinite(losses)):
        raise SystemExit(f"{label}: losses {losses}")
    params = params_of(main, scope)
    busy = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profiled):
                exe.run(main, feed=feed, fetch_list=[loss.name],
                        scope=scope)
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(ms for _, ms, _ in device_kernels(prof)) / wall_ms
    compiled = exe.last_compiled
    ms = _median_ms(step_ms)
    res = compiled.rewrite
    arm = dict(
        losses=losses, step_ms=ms, steps_ms=step_ms, peak_bytes=peak,
        busy=busy, launches_per_step=launches, captured=compiled.captured,
        params=params,
        rewrite=None if res is None else {
            "changed": res.changed, "seconds": res.seconds,
            "aborted": res.aborted, "passes": res.summary()["passes"],
            "outlined": res.count("fuse_attention", "outline")},
        static_peak_bytes=compiled.memory.peak_bytes,
        static_ideal_peak_bytes=compiled.memory.ideal_peak_bytes,
        cost_flops=compiled.cost.flops,
        cost_tflops_per_s=compiled.cost.flops / (ms / 1e3) / 1e12,
        note=capture_note(exe))
    print(f"[{card}] {label}: losses {[round(x, 6) for x in losses]}; "
          f"{ms:.2f} ms a step (median of {steps - 2}; steps "
          f"{[round(m, 1) for m in step_ms]})"
          + (f", {100 * busy:.1f}% busy over {profiled} profiled steps"
             if busy is not None else "")
          + f"; launches a step {launches}; peak {peak / 2**30:.3f} GiB "
          f"(static plan {compiled.memory.peak_bytes / 2**30:.3f} GiB "
          f"arena, {compiled.memory.ideal_peak_bytes / 2**30:.3f} GiB "
          f"ideal); cost model {compiled.cost.flops / 1e12:.3f} TFLOP a "
          f"step = {arm['cost_tflops_per_s']:.1f} TFLOP/s at the median "
          f"step; rewrite {arm['rewrite']}; {arm['note']}", flush=True)
    return arm


def nmt_feed(cfg, seed=0):
    rng = np.random.RandomState(seed)
    ln, vocab = cfg["max_len"], cfg["trg_vocab"]
    feed = {n: rng.randint(1, vocab, (TRAIN_BATCH, ln, 1)).astype(np.int64)
            for n in ("src_ids", "trg_ids", "trg_labels")}
    feed["pos_ids"] = np.arange(ln).astype(np.int64)
    return feed


def hold_bitwise(what, got, want, card):
    """`got` against `want` bit for bit: the losses and every
    parameter."""
    off = bitwise_gaps(got["params"], want["params"])
    if got["losses"] != want["losses"] or off:
        raise SystemExit(f"{what}: losses {got['losses']} vs "
                         f"{want['losses']}; parameters {off[:8]} "
                         f"({len(off)}) differ")
    print(f"[{card}] {what}: bit for bit equal ({len(want['losses'])} "
          f"losses, {len(want['params'])} parameters)", flush=True)


def check_flash_launches(what, arm, names, per_step):
    """Exactly `per_step` launches of each of `names` a step and no other
    launch."""
    want = {n: float(per_step) for n in names}
    if arm["launches_per_step"] != want:
        raise SystemExit(f"{what}: launches a step "
                         f"{arm['launches_per_step']}, expected {want}")
    if not arm["captured"]:
        raise SystemExit(f"{what}: the compiled key was not captured "
                         f"({arm['note']})")


def composed_vs_fused(card):
    """Phase 20 (a): the composed NMT 6+6 at phase 4's configuration
    against the fused build of the same weights, float32 and under AMP:
    18 outlined sites, 18 launches of each flash kernel a step, the key
    captured, losses and parameters bit for bit."""
    import gc
    import torch
    from paddle_tpu_torch import amp, framework
    from paddle_tpu_torch.models import transformer
    builds = {}
    for impl in ("fused", "composed"):
        with framework.isolated_name_scope():
            builds[impl] = transformer.build_train(
                **TRAIN_CFG, attention_impl=impl)
    weights = seeded_weights(builds["fused"][1], seed=0)
    feed = nmt_feed(TRAIN_CFG)
    out = {}
    for precision, names in (("f32", NMT_TRAINING_KERNELS),
                             ("amp", AMP_NMT_KERNELS)):
        guard = amp.amp_guard() if precision == "amp" \
            else contextlib.nullcontext()
        arms = {}
        with guard:
            for impl, (main, startup, f) in builds.items():
                arms[impl] = rewrite_arm(
                    main, startup, f["loss"], weights, feed, card,
                    f"NMT 6+6 {impl} {precision}", TRAIN_STEPS)
                check_flash_launches(f"NMT 6+6 {impl} {precision}",
                                     arms[impl], names, REWRITE_SITES)
                gc.collect()
                torch.cuda.empty_cache()
        got = arms["composed"]["rewrite"]
        if got is None or got["outlined"] != REWRITE_SITES or \
                got["aborted"]:
            raise SystemExit(f"NMT 6+6 composed {precision}: rewrite {got}, "
                             f"expected {REWRITE_SITES} outlined sites")
        hold_bitwise(f"NMT 6+6 composed vs fused, {precision}",
                     arms["composed"], arms["fused"], card)
        for arm in arms.values():
            arm.pop("params")
        out[precision] = arms
    return out


def composed_2x2_cost(card):
    """Phase 20 (b): the composed NMT at phase 14's 2+2 depth with the
    pipeline off (PADDLE_TPU_OPTIMIZE=0: cuBLAS matmuls and the softmax
    op, no kernel) and on (6 outlined sites on the flash kernels): ms a
    step, busy share, peak; losses within phase 4's flash-vs-naive
    rule."""
    import gc
    import torch
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import transformer
    with framework.isolated_name_scope():
        main, startup, f = transformer.build_train(
            **CVE_NMT_CFG, attention_impl="composed")
    weights = seeded_weights(startup, seed=0)
    feed = nmt_feed(CVE_NMT_CFG)
    arms = {}
    for label, value in (("off", "0"), ("on", "1")):
        with knob("PADDLE_TPU_OPTIMIZE", value):
            arms[label] = rewrite_arm(
                main, startup, f["loss"], weights, feed, card,
                f"NMT 2+2 composed, pipeline {label}", CVE_STEPS,
                profiled=CVE_PROFILED)
        gc.collect()
        torch.cuda.empty_cache()
    if arms["off"]["launches_per_step"] or arms["off"]["rewrite"]:
        raise SystemExit(f"NMT 2+2 pipeline off: launches "
                         f"{arms['off']['launches_per_step']}, rewrite "
                         f"{arms['off']['rewrite']}")
    check_flash_launches("NMT 2+2 composed, pipeline on", arms["on"],
                         NMT_TRAINING_KERNELS, REWRITE_2X2_SITES)
    for arm in arms.values():
        arm.pop("params")
    np.testing.assert_allclose(arms["on"]["losses"], arms["off"]["losses"],
                               rtol=TRAIN_LOSS_RTOL,
                               err_msg="NMT 2+2 pipeline on vs off losses")
    return arms


def gate_cost(card):
    """Phase 20 (d): the host-bound paths with the gate and the pipeline
    off (PADDLE_TPU_VERIFY=0, PADDLE_TPU_OPTIMIZE=0) and at the defaults,
    GATE_ROUNDS rounds in turns (off, on, on, off, ...): DeepFM through
    the Trainer at K = 1 (phase 13's configuration and batches; ms a
    batch, the median of the dispatch intervals after the first
    CVE_WARM; costs and parameters bit for bit across the settings) and
    serving decode at the largest cache bucket (phase 3's model; ms a
    step over GATE_DECODE_STEPS steps after two untimed ones, which
    compile and capture the setting's key; the same tokens). Then what
    the defaults add to every run on this host: the gate's memoized
    check and the rewrite cache's lookup, timed alone on the decode
    program (timeit)."""
    import gc
    import timeit
    import torch
    from paddle_tpu_torch.analysis import verifier
    from paddle_tpu_torch import framework, load_param_arrays
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.serving.generation import (GenerationModel,
                                                     GenerationSpec)
    settings = (("off", "0"), ("defaults", "1"))
    with framework.isolated_name_scope():
        main, startup, f = deepfm.build_train(**DEEPFM_CFG)
    weights = seeded_weights(startup, seed=0)
    batches = deepfm_batches()
    dfm = {label: [] for label, _ in settings}
    ref = None
    turns = [settings[::1 - 2 * (r % 2)] for r in range(GATE_ROUNDS)]
    for turn in turns:
        for label, value in turn:
            with knob("PADDLE_TPU_VERIFY", value), \
                    knob("PADDLE_TPU_OPTIMIZE", value):
                arm = trainer_arm(main, startup, f["loss"], weights,
                                  batches, card, f"DeepFM gate {label}")
            dfm[label].append(float(np.median(arm["dispatch_ms"][
                CVE_WARM:])))
            arm.pop("trainer")
            ref = ref or arm
            if arm["costs"] != ref["costs"] or \
                    bitwise_gaps(arm["params"], ref["params"]):
                raise SystemExit(f"DeepFM gate {label}: costs or "
                                 "parameters differ from the first arm's")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    spec = GenerationSpec(**SERVE_SPEC)
    model = GenerationModel.build(spec)
    load_param_arrays(model, seeded_weights(model.programs["startup"],
                                            seed=0))
    bucket = spec.cache_buckets[-1]
    rng = np.random.RandomState(2)
    tokens = rng.randint(1, spec.vocab_size, spec.slots).astype(np.int64)
    positions = np.full(spec.slots, bucket - 1, np.int64)
    dec = {label: [] for label, _ in settings}
    toks = {}
    for turn in turns:
        for label, value in turn:
            with knob("PADDLE_TPU_VERIFY", value), \
                    knob("PADDLE_TPU_OPTIMIZE", value):
                for _ in range(2):
                    nxt = model.run_decode(tokens, positions, bucket)
                t0 = time.perf_counter()
                for _ in range(GATE_DECODE_STEPS):
                    model.run_decode(tokens, positions, bucket)
                dec[label].append((time.perf_counter() - t0)
                                  / GATE_DECODE_STEPS * 1e3)
            toks.setdefault(label, np.asarray(nxt).tolist())
    if toks["off"] != toks["defaults"]:
        raise SystemExit(f"decode gate: tokens {toks}")
    exe, lm = model.executor, model.programs["decode"][bucket]
    prog, feeds, fetch = lm.main.desc, lm.feed_names, [lm.fetch_name]
    n = 20000
    gate_us = timeit.timeit(
        lambda: verifier.verify_enabled() and verifier.executor_gate(
            prog, 0, fetch, feeds, exe.donate_state, True),
        number=n) / n * 1e6
    lookup_us = timeit.timeit(lambda: exe._rewritten(prog, feeds, fetch),
                              number=n) / n * 1e6
    del model, exe, lm
    gc.collect()
    torch.cuda.empty_cache()
    out = {"deepfm_ms_per_batch": dfm, "decode_ms_per_step": dec,
           "decode_bucket": bucket, "order": [[label for label, _ in t]
                                              for t in turns],
           "gate_us_per_run": gate_us, "rewrite_lookup_us_per_run":
           lookup_us}
    print(f"[{card}] gate cost on this host: the memoized gate "
          f"{gate_us:.2f} us and the rewrite cache's lookup "
          f"{lookup_us:.2f} us a run ({n} calls each)", flush=True)
    for what, by in (("DeepFM Trainer K=1, ms a batch", dfm),
                     (f"decode at cache bucket {bucket}, ms a step", dec)):
        off, on = np.median(by["off"]), np.median(by["defaults"])
        print(f"[{card}] gate cost, {what}: off {by['off']} defaults "
              f"{by['defaults']}; medians {off:.3f} vs {on:.3f} "
              f"({100 * (on / off - 1):+.1f}%)", flush=True)
    return out


def train_rewrite(card):
    """Phase 20: the rewrite pipeline and the gates on the card (a, b, d;
    (c) is every path's report, path_report). Launch counts are set to 0
    just before and read just after; returns the phase's summary and
    those counts."""
    import torch
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    summary = {"card": card}
    summary["composed_vs_fused"] = composed_vs_fused(card)
    t1 = time.perf_counter()
    summary["composed_2x2"] = composed_2x2_cost(card)
    t2 = time.perf_counter()
    summary["gate"] = gate_cost(card)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    summary["phase_s"] = time.perf_counter() - t0
    summary["part_s"] = {"a": t1 - t0, "b": t2 - t1,
                         "d": summary["phase_s"] - (t2 - t0)}
    print(f"[{card}] phase 20: {summary['phase_s']:.1f} s "
          f"({summary['part_s']}); launches {launches}", flush=True)
    return summary, launches


# -- phase 21: control flow under AMP, the image models, the book -------------

def loop_carries(main):
    """The names each loop op of `main` carries from pass to pass (a
    DynamicRNN's or StaticRNN's memories as its body reads them, a
    While's carried vars)."""
    out = []
    for blk in main.desc.blocks:
        for op in blk.ops:
            if op.type in ("dynamic_rnn", "static_rnn"):
                out += op.attrs["mem_pre_names"]
            elif op.type == "while":
                out += op.attrs["carried_names"]
    return out


def carry_dtypes(main, startup, weights, feed, fetch):
    """One eager step of `main` under AMP on the card with every loop
    carry's dtype recorded at every pass: {carry: sorted dtypes seen}."""
    import torch
    from paddle_tpu_torch import Executor, Scope, amp, load_param_arrays
    from paddle_tpu_torch.ops import control_flow_ops as cfo
    seen = {n: set() for n in loop_carries(main)}
    trace = cfo._trace_sub

    def recording(ctx, block_idx, env):
        for n, dts in seen.items():
            if isinstance(env.get(n), torch.Tensor):
                dts.add(str(env[n].dtype).replace("torch.", ""))
        return trace(ctx, block_idx, env)

    exe, scope = Executor(DEVICE, compiled=False), Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, weights)
    cfo._trace_sub = recording
    try:
        with amp.amp_guard():
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    finally:
        cfo._trace_sub = trace
    return {n: sorted(d) for n, d in seen.items()}


def a4c_on_card(card, control_flow=None):
    """Phase 21 (a): phase 19's programs under AMP (A4C_LAUNCHES);
    `control_flow` is phase 19's summary, whose float32 arms ran the same
    weights and first feed (None: one float32 step of each here).
    Returns the part's summary and launches."""
    import gc
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import kernels
    out, total = {}, {}
    for name, want in A4C_LAUNCHES.items():
        t1 = time.perf_counter()
        main, startup, loss, _ = build_cf_program(name)
        weights = seeded_weights(startup, seed=0)
        feeds, info = cf_feeds(name)
        with amp.amp_guard():
            pair = cve_training_pair(f"{name} AMP", main, startup, loss,
                                     weights, feeds, card,
                                     steps=CF_CVE_STEPS, profiled=0)
        for n, k in kernels.launch_counts().items():
            if k:
                total[n] = total.get(n, 0) + k
        c = pair["compiled"]
        launches = {n: k for n, k in c["launches_per_step"].items() if k}
        print(f"[{card}] {name} AMP compiled launches a step {launches}",
              flush=True)
        if launches != want or not c["captured"]:
            raise SystemExit(f"{name} AMP: launches a step {launches}, "
                             f"expected {want}; captured {c['captured']}")
        if control_flow:
            f32, source = control_flow[name]["f32"]["losses"][0], "phase 19"
        else:   # phase 21 run alone: one float32 step of its own
            f32 = steps_arm(main, startup, loss, weights, feeds[0], [],
                            card, f"{name} float32", 1)[0]["losses"][0]
            source = "one float32 step"
        rel = abs(c["losses"][0] - f32) / abs(f32)
        print(f"[{card}] {name} AMP step-1 loss {c['losses'][0]:.6f} vs "
              f"float32 {f32:.6f} ({source}; relative {rel:.3e}, limit "
              f"{RNN_AMP_LOSS_RTOL})", flush=True)
        if not rel <= RNN_AMP_LOSS_RTOL:
            raise SystemExit(f"{name} AMP step-1 loss {c['losses'][0]} vs "
                             f"float32 {f32}")
        carries = carry_dtypes(main, startup, weights, feeds[0],
                               [loss.name])
        print(f"[{card}] {name} AMP loop carries, dtype at every pass: "
              f"{carries}", flush=True)
        if any(len(d) != 1 for d in carries.values()):
            raise SystemExit(f"{name}: a carry changed dtype between "
                             f"passes: {carries}")
        out[name] = {"feed": info, "compiled_vs_eager": pair,
                     "launches_per_step": launches,
                     "loss_rel_to_f32": rel, "carry_dtypes": carries,
                     "program_s": time.perf_counter() - t1}
        del pair, main, startup, weights, feeds
        gc.collect()
        torch.cuda.empty_cache()
    return out, total


def build_image_model(name):
    """(main, startup, fetches) of phase 21 (b)'s model `name` at
    bench.py's configuration."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import alexnet, googlenet, resnet
    kw = dict(class_dim=IMAGE_CLASSES, image_shape=IMAGE_SHAPE)
    with framework.isolated_name_scope():
        if name == "se_resnext":
            return resnet.build_se_resnext_train(
                layers_counts=SE_LAYER_COUNTS, lr=0.1, **kw)
        if name == "googlenet":
            return googlenet.build_train(lr=0.01, with_aux=False, **kw)
        return alexnet.build_train(lr=0.01, **kw)


def static_plan(mark):
    """The largest static memory plan (arena, ideal) of the keys planned
    since MISS_LOG[mark], and the cost model's FLOPs a step of the
    largest of them."""
    plans = [r for r in MISS_LOG[mark:] if r["kind"] == "reports"
             and r["peak_bytes"] is not None]
    if not plans:
        return None, None, None
    top = max(plans, key=lambda r: r["peak_bytes"])
    return top["peak_bytes"], top["ideal_peak_bytes"], \
        max(r["flops"] or 0 for r in plans)


def calibrate_batch_norms(main, startup, weights, img, scope):
    """Set every batch_norm's running mean and variance in `scope` to the
    statistics of `img` in one training-mode forward of `main` (pruned to
    those statistics: no backward, no update) from `weights`, in a scope
    of its own: the inference program then normalizes as a trained
    network does. From
    the initial statistics (mean 0, variance 1) the seeded SE-ResNeXt-152
    grows its activations to ~1e4 and saturates its SE gates, and a 1e-7
    change at gate 20 flips gates until the logits part by 90%
    (measured on the CPU at 3x64x64)."""
    import torch
    from paddle_tpu_torch import Executor, Scope, io, load_param_arrays
    bns = [op for op in main.desc.global_block.ops
           if op.type == "batch_norm"]
    fetch = [n for op in bns for n in (op.output("SavedMean")[0],
                                       op.output("SavedVariance")[0])]
    exe, tmp = Executor(DEVICE), Scope()
    exe.run(startup, scope=tmp)
    load_param_arrays(tmp, weights)
    got = exe.run(io._prune(main, ["img"], fetch), feed={"img": img},
                  fetch_list=fetch, scope=tmp)
    stats = {}
    for i, op in enumerate(bns):
        inv = np.asarray(got[2 * i + 1], np.float64)   # rsqrt(var + eps)
        stats[op.input("Mean")[0]] = np.asarray(got[2 * i], np.float32)
        stats[op.input("Variance")[0]] = (
            1.0 / inv ** 2 - op.attrs.get("epsilon", 1e-5)).astype(np.float32)
    for name, value in stats.items():
        scope.set(name, torch.from_numpy(value).to(DEVICE))


def se_inference(card, main, startup, f, weights, img):
    """Phase 21 (b), SE-ResNeXt's gates: no gate outlined in the
    training program; the inference program (calibrated: see
    calibrate_batch_norms) with the pipeline on (exactly SE_SITES
    se_block ops run) and off, float32 and AMP, held as SE_F32_ATOL says;
    ms a batch of each."""
    import torch
    from paddle_tpu_torch import Executor, Scope, amp, io, load_param_arrays
    from paddle_tpu_torch.analysis import rewrite
    train = rewrite.rewrite_program(main, feed_names=["img", "label"],
                                    fetch_names=[f["loss"].name])
    if train.count("fuse_se") != 0:
        raise SystemExit("fuse_se outlined a gate of the training program")
    # the logits, before the softmax: from seeded weights the
    # probabilities saturate
    logits = next(op.input("X")[0] for op in main.desc.global_block.ops
                  if op.type == "softmax"
                  and op.output("Out") == [f["pred"].name])
    infer = io._prune(main, ["img"], [logits]).inference_optimize()
    params = [p.name for p in main.all_parameters()]
    scopes = {}
    for label, w in (("seeded", weights), ("nudged", _nudged(weights,
                                                             params))):
        scopes[label] = Scope()
        Executor(DEVICE).run(startup, scope=scopes[label])
        load_param_arrays(scopes[label], w)
        calibrate_batch_norms(main, startup, w, img, scopes[label])
    out, preds = {"train_outlined": 0}, {}
    for prec, on, label in (("f32", "0", "seeded"), ("f32", "1", "seeded"),
                            ("amp", "0", "seeded"), ("amp", "1", "seeded"),
                            ("f32", "0", "nudged")):
        with knob("PADDLE_TPU_OPTIMIZE", on), amp.amp_guard(prec == "amp"):
            exe = Executor(DEVICE)
            for _ in range(2):
                got = exe.run(infer, feed={"img": img}, fetch_list=[logits],
                              scope=scopes[label])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SE_TIMED):
                got = exe.run(infer, feed={"img": img}, fetch_list=[logits],
                              scope=scopes[label])
            ms = (time.perf_counter() - t0) / SE_TIMED * 1e3
        preds[(prec, on, label)] = np.asarray(got[0], np.float64)
        if label == "nudged":
            continue
        sites = [op.type for blk in exe.last_compiled.program.blocks
                 for op in blk.ops].count("se_block")
        want = SE_SITES if on == "1" else 0
        print(f"[{card}] SE-ResNeXt inference, batch {len(img)}, "
              f"{prec}, pipeline {'on' if on == '1' else 'off'}: "
              f"{sites} se_block ops, {ms:.2f} ms a batch", flush=True)
        if sites != want:
            raise SystemExit(f"SE-ResNeXt inference ran {sites} "
                             f"se_block ops, expected {want}")
        out[f"{prec}_{'on' if on == '1' else 'off'}_ms"] = ms
    off = preds[("f32", "0", "seeded")]
    f32_gap = float(np.abs(preds[("f32", "1", "seeded")] - off).max())
    noise = float(np.abs(preds[("f32", "0", "nudged")] - off).max())
    limit = max(SE_F32_ATOL * float(np.abs(off).max()),
                RESNET_NOISE_FACTOR * noise)
    amp_gap = float(np.linalg.norm(preds[("amp", "1", "seeded")]
                                   - preds[("amp", "0", "seeded")]))
    amp_dist = float(np.linalg.norm(preds[("amp", "0", "seeded")] - off))
    print(f"[{card}] SE-ResNeXt inference logits, outlined vs "
          f"composed: float32 max |diff| {f32_gap:.3e} of max "
          f"{np.abs(off).max():.3e} (limit {limit:.3e}; weights one ulp "
          f"away move the composed logits {noise:.3e}; "
          f"{'bit for bit' if f32_gap == 0 else 'other summation order'}"
          f"); AMP 2-norm {amp_gap:.3e} vs the composed AMP arm's "
          f"distance from float32 {amp_dist:.3e}", flush=True)
    if not f32_gap <= limit or not amp_gap <= amp_dist:
        raise SystemExit(f"SE-ResNeXt outlined vs composed: float32 "
                         f"{f32_gap} (limit {limit}), AMP {amp_gap} (limit "
                         f"{amp_dist})")
    out.update(sites=SE_SITES, f32_max_abs_diff=f32_gap,
               f32_nudge_max_abs_diff=noise, f32_limit=limit,
               amp_norm_diff=amp_gap, amp_norm_to_f32=amp_dist)
    return out


def image_models_on_card(card):
    """Phase 21 (b): IMAGE_MODELS at bench.py's batch and shape, float32
    and AMP, compiled against eager; SE-ResNeXt's gates
    (se_inference). Launch counts set to 0 just before each arm pair and
    read just after: no hand kernel launches here."""
    import gc
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import kernels
    out = {}
    for name, batch in IMAGE_MODELS.items():
        t1 = time.perf_counter()
        main, startup, f = build_image_model(name)
        weights = seeded_weights(startup, seed=0)
        params = [p.name for p in main.all_parameters()]
        rng = np.random.RandomState(4)
        feeds = [{"img": rng.rand(batch, *IMAGE_SHAPE).astype(np.float32),
                  "label": rng.randint(0, IMAGE_CLASSES, (batch, 1))
                  .astype(np.int64)} for _ in range(2)]
        res = {"batch": batch, "ops": len(main.desc.global_block.ops),
               "parameters": sum(weights[p].size for p in params),
               "build_s": time.perf_counter() - t1}
        print(f"[{card}] {name}: {res['ops']} ops, {res['parameters']} "
              f"parameters, batch {batch}, built on the host in "
              f"{res['build_s']:.2f} s", flush=True)
        for prec in ("f32", "amp"):
            mark = len(MISS_LOG)
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            with amp.amp_guard(prec == "amp"):
                pair = cve_training_pair(f"{name} {prec}", main, startup,
                                         f["loss"], weights, feeds, card,
                                         steps=IMAGE_STEPS,
                                         profiled=IMAGE_PROFILED)
            torch.cuda.synchronize()
            launched = {n: k for n, k in kernels.launch_counts().items()
                        if k}
            if launched:
                raise SystemExit(f"{name} {prec} launched {launched}; no "
                                 "op dispatches a hand kernel there")
            arena, ideal, flops = static_plan(mark)
            c = pair["compiled"]
            print(f"[{card}] {name} {prec}: compiled {c['step_ms']:.2f} ms "
                  f"a step ({batch * 1e3 / c['step_ms']:.1f} images/s; cost "
                  f"model {flops / 1e12:.3f} TFLOP a step, "
                  f"{flops / c['step_ms'] / 1e9:.1f} TFLOP/s), "
                  f"{100 * c['busy']:.1f}% busy, peak "
                  f"{c['peak_bytes'] / 2**30:.3f} GiB beside the static "
                  f"plan {arena / 2**30:.3f} GiB arena / "
                  f"{ideal / 2**30:.3f} GiB ideal; eager "
                  f"{pair['eager']['step_ms']:.2f} ms; no hand kernel ran "
                  "(convs on cuDNN, no op dispatches fused_conv)",
                  flush=True)
            res[prec] = {"compiled_vs_eager": pair,
                         "static_plan_bytes": arena,
                         "static_ideal_bytes": ideal,
                         "cost_model_flops": flops,
                         "images_per_s": batch * 1e3 / c["step_ms"]}
            gc.collect()
            torch.cuda.empty_cache()
        if name == "se_resnext":
            res["gates"] = se_inference(card, main, startup, f, weights,
                                        feeds[0]["img"])
        res["program_s"] = time.perf_counter() - t1
        out[name] = res
        del main, startup, weights, feeds
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _ragged_feed(seqs, max_len):
    """tests/test_book.py _ragged on the port: int64 [n, max_len, 1] rows
    and their lengths."""
    from paddle_tpu_torch.core.lod import LoDTensor, RaggedPair
    arrs = [np.asarray(q, np.int64).reshape(len(q), 1) for q in seqs]
    padded, lengths = LoDTensor.from_sequences(arrs).to_padded(
        max_len=max_len)
    return RaggedPair(padded, lengths)


def build_srl(cfg):
    """tests/test_book.py:208's SRL program at `cfg`'s widths (word and
    verb embeddings cfg["emb"], mark cfg["mark_emb"], one LSTM of
    cfg["hid"]): (main, startup, loss, batches(), feed names, target,
    probe feed, {"emission", "path"})."""
    from paddle_tpu_torch import (ParamAttr, dataset, framework, layers,
                                  optimizer, reader)
    word_dict, verb_dict, label_dict = dataset.conll05.get_dict()
    ln = len(label_dict)
    hid = cfg["hid"]
    main, startup = framework.Program(), framework.Program()
    with framework.isolated_name_scope(), \
            framework.program_guard(main, startup):
        word = layers.data("word", [1], dtype="int64", lod_level=1)
        verb = layers.data("verb", [1], dtype="int64", lod_level=1)
        mark = layers.data("mark", [1], dtype="int64", lod_level=1)
        tag = layers.data("target", [1], dtype="int64", lod_level=1)
        feat = layers.concat([
            layers.embedding(word, size=[len(word_dict), cfg["emb"]]),
            layers.embedding(verb, size=[len(verb_dict), cfg["emb"]]),
            layers.embedding(mark, size=[2, cfg["mark_emb"]])], axis=-1)
        h, _ = layers.dynamic_lstm(layers.fc(feat, size=4 * hid),
                                   size=4 * hid)
        emission = layers.fc(h, size=ln)
        loss = layers.mean(layers.linear_chain_crf(
            emission, tag, param_attr=ParamAttr(name="crfw")))
        optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
        path = layers.crf_decoding(emission, param_attr=ParamAttr(name="crfw"))

    def batches():
        for b in reader.batch(dataset.conll05.train(), SRL_BATCH)():
            yield {k: _ragged_feed([s[i] for s in b], SRL_MAXLEN)
                   for k, i in (("word", 0), ("verb", 6), ("mark", 7),
                                ("target", 8))}
    probe = next(batches())
    return main, startup, loss, batches, ["word", "verb", "mark"], path, \
        {k: probe[k] for k in ("word", "verb", "mark")}, \
        {"emission": emission, "path": path, "main": main}


def build_chapter(name):
    """Phase 21 (c)'s and 22 (a)'s chapter `name` on the port, as
    tests/test_book.py builds it: (main, startup, loss, batches(), feed
    names, target, probe feed, named vars a check reads)."""
    from paddle_tpu_torch import (ParamAttr, dataset, framework, layers,
                                  optimizer, reader)
    from paddle_tpu_torch.models import resnet
    if name == "label_semantic_roles":
        return build_srl(SRL_TEST_CFG)
    main, startup = framework.Program(), framework.Program()
    with framework.isolated_name_scope(), \
            framework.program_guard(main, startup):
        if name == "recommender_system":
            ml = dataset.movielens
            emb = 16
            uid = layers.data("uid", [1], dtype="int64")
            gender = layers.data("gender", [1], dtype="int64")
            age = layers.data("age", [1], dtype="int64")
            job = layers.data("job", [1], dtype="int64")
            mid = layers.data("mid", [1], dtype="int64")
            title = layers.data("title", [1], dtype="int64", lod_level=1)
            rating = layers.data("rating", [1])
            usr = layers.concat([
                layers.embedding(uid, size=[ml.max_user_id() + 1, emb]),
                layers.embedding(gender, size=[2, emb]),
                layers.embedding(age, size=[len(ml.age_table()), emb]),
                layers.embedding(job, size=[ml.max_job_id() + 1, emb]),
            ], axis=1)
            usr_feat = layers.fc(usr, size=32, act="tanh")
            mov = layers.concat([
                layers.embedding(mid, size=[ml.max_movie_id() + 1, emb]),
                layers.sequence_pool(layers.embedding(
                    title, size=[len(ml.get_movie_title_dict()), emb]),
                    pool_type="sum")], axis=1)
            mov_feat = layers.fc(mov, size=32, act="tanh")
            target = layers.scale(layers.cos_sim(usr_feat, mov_feat),
                                  scale=5.0)
            loss = layers.mean(layers.square_error_cost(target, rating))
            optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)

            def batches():
                for b in reader.batch(ml.train(), 32)():
                    f = {k: np.array([[s[i]] for s in b], np.int64)
                         for k, i in (("uid", 0), ("gender", 1), ("age", 2),
                                      ("job", 3), ("mid", 4))}
                    f["title"] = _ragged_feed([s[6] for s in b], 8)
                    f["rating"] = np.array([[s[7]] for s in b], np.float32)
                    yield f
            probe = {k: v for k, v in next(batches()).items()
                     if k != "rating"}
            return main, startup, loss, batches, list(probe), target, \
                probe, {}
        if name == "fit_a_line":
            x = layers.data("x", [13])
            y = layers.data("y", [1])
            target = layers.fc(x, size=1)
            loss = layers.mean(layers.square_error_cost(target, y))
            optimizer.SGDOptimizer(learning_rate=0.01).minimize(loss)

            def batches():
                for b in reader.batch(dataset.uci_housing.train(), 32)():
                    yield {"x": np.stack([s[0] for s in b]),
                           "y": np.stack([s[1] for s in b])}
            return main, startup, loss, batches, ["x"], target, \
                {"x": np.zeros((4, 13), np.float32)}, {}
        if name == "recognize_digits":
            img = layers.data("img", [784])
            label = layers.data("label", [1], dtype="int64")
            x = layers.reshape(img, [-1, 1, 28, 28])
            x = layers.conv2d(x, num_filters=8, filter_size=5, act="relu")
            x = layers.pool2d(x, pool_size=2, pool_stride=2)
            target = layers.fc(x, size=10)
            loss = layers.mean(layers.softmax_with_cross_entropy(target,
                                                                 label))
            layers.accuracy(layers.softmax(target), label)
            optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)

            def batches():
                for b in reader.batch(dataset.mnist.train(), 32)():
                    yield {"img": np.stack([s[0] for s in b]),
                           "label": np.array([[s[1]] for s in b],
                                             np.int64)}
            return main, startup, loss, batches, ["img"], target, \
                {"img": np.zeros((2, 784), np.float32)}, {}
        if name == "image_classification":
            img = layers.data("img", [3, 32, 32])
            label = layers.data("label", [1], dtype="int64")
            target = resnet.resnet_cifar10(img, class_dim=10, depth=20)
            loss = layers.mean(layers.softmax_with_cross_entropy(target,
                                                                 label))
            optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)

            def batches():
                for b in reader.batch(dataset.cifar.train10(), 16)():
                    yield {"img": np.stack([s[0].reshape(3, 32, 32)
                                            for s in b]),
                           "label": np.array([[s[1]] for s in b],
                                             np.int64)}
            return main, startup, loss, batches, ["img"], target, \
                {"img": np.zeros((2, 3, 32, 32), np.float32)}, {}
        n = dataset.imikolov.N
        dict_size = len(dataset.imikolov.build_dict())
        words = [layers.data(f"w{i}", [1], dtype="int64")
                 for i in range(n - 1)]
        nxt = layers.data("target", [1], dtype="int64")
        embs = [layers.embedding(w, size=[dict_size, 32],
                                 param_attr=ParamAttr(name="shared_emb"))
                for w in words]
        hidden = layers.fc(layers.concat(embs, axis=1), size=64, act="relu")
        target = layers.fc(hidden, size=dict_size)
        loss = layers.mean(layers.softmax_with_cross_entropy(target, nxt))
        optimizer.AdamOptimizer(learning_rate=5e-3).minimize(loss)

        def batches():
            for b in reader.batch(dataset.imikolov.train(), 64)():
                f = {f"w{i}": np.array([[s[i]] for s in b], np.int64)
                     for i in range(n - 1)}
                f["target"] = np.array([[s[n - 1]] for s in b], np.int64)
                yield f
        return main, startup, loss, batches, \
            [f"w{i}" for i in range(n - 1)], target, \
            {f"w{i}": np.zeros((2, 1), np.int64) for i in range(n - 1)}, {}


def launch_delta(before):
    """The kernel launches since `before` (a launch_counts() snapshot),
    those that moved only."""
    import torch
    from paddle_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    return {n: k - before.get(n, 0)
            for n, k in kernels.launch_counts().items()
            if k != before.get(n, 0)}


def _host_bytes(value):
    """A fetch as (bytes of its data, its LoD) for a bit-for-bit
    comparison (a ragged fetch is a LoDTensor)."""
    if hasattr(value, "lod"):
        return (np.asarray(value.data).tobytes(),
                [list(map(int, level)) for level in value.lod])
    return np.asarray(value).tobytes(), None


def chapter_on_card(card, name, later_rtol, tmp):
    """One chapter of phase 21 (c) or 22 (a): BOOK_BATCHES batches on the
    card and on the port's CPU path from the same seeded weights (the
    first loss within BOOK_FIRST_RTOL of the CPU's, the later ones within
    `later_rtol`), then the save / load round trip on the card bit for
    bit. Returns (summary, the card's executor, scope, batches, the
    chapter's named vars, the card arm's launch counts)."""
    import torch
    from paddle_tpu_torch import (Executor, Scope, io, load_param_arrays,
                                  scope_guard)
    from paddle_tpu_torch.ops import kernels
    t1 = time.perf_counter()
    main, startup, loss, batches, feed_names, target, probe, named = \
        build_chapter(name)
    weights = seeded_weights(startup, seed=0)
    feeds = [b for _, b in zip(range(BOOK_BATCHES), batches())]
    losses, ms = {}, {}
    for device in (DEVICE, "cpu"):
        exe, scope = Executor(device), Scope()
        exe.run(startup, scope=scope)
        load_param_arrays(scope, weights)
        if device == DEVICE:
            torch.cuda.synchronize()
            before = kernels.launch_counts()
        losses[device] = []
        step_ms = []
        for feed in feeds:
            t2 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss.name],
                            scope=scope)
            step_ms.append((time.perf_counter() - t2) * 1e3)
            losses[device].append(float(np.asarray(lv).reshape(-1)[0]))
        # after the key's first run and its capture
        ms[device] = _median_ms(step_ms)
        if device == DEVICE:
            launches = launch_delta(before)
            card_exe, card_scope = exe, scope
    card_l, cpu_l = (np.asarray(losses[d]) for d in (DEVICE, "cpu"))
    rel = np.abs(card_l - cpu_l) / np.abs(cpu_l)
    print(f"[{card}] book {name}: card losses "
          f"{[round(float(v), 6) for v in card_l]} vs CPU "
          f"{[round(float(v), 6) for v in cpu_l]} (relative "
          f"{rel.max():.3e}); {ms[DEVICE]:.2f} ms a batch on the card; "
          f"launches {launches}", flush=True)
    if not (np.all(np.isfinite(card_l)) and rel[0] <= BOOK_FIRST_RTOL
            and np.all(rel[1:] <= later_rtol)):
        raise SystemExit(f"book {name}: card {card_l} vs CPU {cpu_l}")
    d = os.path.join(tmp, name)
    with scope_guard(card_scope):
        io.save_inference_model(d, feed_names, [target], card_exe,
                                main_program=main)
        prog, names, fetches = io.load_inference_model(d, card_exe)
        got = card_exe.run(prog, feed=probe, fetch_list=fetches)
    forward = io._prune(main, feed_names, [target.name]) \
        .inference_optimize()
    want = card_exe.run(forward, feed=probe, fetch_list=[target.name],
                        scope=card_scope)
    if names != feed_names or _host_bytes(got[0]) != _host_bytes(want[0]):
        raise SystemExit(f"book {name}: the reloaded model's output "
                         "differs from the trained program's forward")
    shape = np.asarray(getattr(got[0], "data", got[0])).shape
    print(f"[{card}] book {name}: saved, reloaded, output {tuple(shape)} "
          "bit for bit the trained program's forward", flush=True)
    out = {"card_losses": losses[DEVICE], "cpu_losses": losses["cpu"],
           "max_rel_diff": float(rel.max()),
           "card_ms_per_batch": ms[DEVICE], "cpu_ms_per_batch": ms["cpu"],
           "program_s": time.perf_counter() - t1}
    return out, card_exe, card_scope, feeds, named, launches


@contextlib.contextmanager
def synthetic_corpora():
    """The dataset readers' synthetic corpora (DATA_HOME an empty
    directory, whatever a cache under HOME holds); yields a scratch
    directory."""
    import tempfile
    from paddle_tpu_torch import dataset
    saved_home = dataset.common.DATA_HOME
    with tempfile.TemporaryDirectory() as tmp:
        dataset.common.DATA_HOME = os.path.join(tmp, "data_home")
        try:
            yield tmp
        finally:
            dataset.common.DATA_HOME = saved_home


def book_on_card(card):
    """Phase 21 (c): the four chapters on the card against the port's CPU
    path (BOOK_FIRST_RTOL, BOOK_LATER_RTOL), then each chapter's save /
    load round trip on the card. Launch counts set to 0 just before and
    read just after: no hand kernel launches here."""
    out = {}
    with synthetic_corpora() as tmp:
        for name, rtol in BOOK_LATER_RTOL.items():
            out[name], *_, launched = chapter_on_card(card, name, rtol, tmp)
            if launched:
                raise SystemExit(f"book {name} launched {launched}; no "
                                 "op dispatches a hand kernel there")
    return out


def train_slice20(card, control_flow=None):
    """Phase 21: (a) control flow under AMP, (b) the image models, (c) the
    book's chapters; `control_flow` is phase 19's summary (None when the
    phase runs alone). Returns the phase's summary and its launches
    (those of (a); (b) and (c) launch none, each checked)."""
    t0 = time.perf_counter()
    summary = {"card": card}
    summary["control_flow_amp"], launches = a4c_on_card(card, control_flow)
    t1 = time.perf_counter()
    summary["image_models"] = image_models_on_card(card)
    t2 = time.perf_counter()
    summary["book"] = book_on_card(card)
    summary["phase_s"] = time.perf_counter() - t0
    summary["part_s"] = {"a": t1 - t0, "b": t2 - t1,
                         "c": summary["phase_s"] - (t2 - t0)}
    print(f"[{card}] phase 21: {summary['phase_s']:.1f} s "
          f"({summary['part_s']}); launches {launches}", flush=True)
    return summary, launches


# -- phase 22: the book's last chapters, ModelHost, GenerationHost -----------

def srl_tags_on_cpu(exe, scope, feed, named):
    """One more SRL step on the card fetching its crf_decoding path and
    emissions; the CPU's crf_decoding of those emissions with the card's
    transition (read after the step, as the program's crf_decoding reads
    it after the update). Returns (card path, CPU path) as LoDTensors."""
    import torch
    from paddle_tpu_torch.core.ir import OpDesc
    from paddle_tpu_torch.core.lod import LoDTensor, RaggedPair
    from paddle_tpu_torch.core.registry import run_op
    path, em = exe.run(named["main"], feed=feed,
                       fetch_list=[named["path"].name,
                                   named["emission"].name], scope=scope)
    padded, lengths = em.to_padded()
    op = OpDesc("crf_decoding", {"Emission": ["em"], "Transition": ["tr"]},
                {"ViterbiPath": ["path"]})
    out = run_op(op, {
        "em": RaggedPair(torch.from_numpy(padded),
                         torch.from_numpy(lengths.astype(np.int32))),
        "tr": scope.get("crfw").detach().cpu()},
        {"device": torch.device("cpu")})["path"]
    cpu = LoDTensor.from_padded(out.data.numpy(), out.lengths.numpy())
    return path, cpu


def srl_at_book_width(card):
    """Phase 22 (a): SRL at the Fluid book's widths (SRL_BOOK_CFG) on the
    card, SRL_BOOK_STEPS steps from seeded weights: finite losses, the
    fused LSTM exactly SRL_LAUNCHES a step, ms a step (median after two
    untimed)."""
    import torch
    from paddle_tpu_torch import Executor, Scope, load_param_arrays
    from paddle_tpu_torch.ops import kernels
    main, startup, loss, batches, *_ = build_srl(SRL_BOOK_CFG)
    weights = seeded_weights(startup, seed=0)
    exe, scope = Executor(DEVICE), Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, weights)
    feeds = [b for _, b in zip(range(SRL_BOOK_STEPS), batches())]
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    losses, step_ms = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss.name],
                        scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    launched = launch_delta(before)
    want = {n: k * len(feeds) for n, k in SRL_LAUNCHES.items()}
    live = int(sum(np.asarray(f["word"].lengths).sum() for f in feeds))
    out = {"config": SRL_BOOK_CFG, "batch": SRL_BATCH, "losses": losses,
           "step_ms": _median_ms(step_ms), "launches": launched,
           "tokens_per_s": live / (sum(step_ms[2:]) / 1e3)
           * (len(feeds) - 2) / len(feeds),
           "parameters": int(sum(w.size for n, w in weights.items()
                                 if n in {p.name for p in
                                          main.all_parameters()})),
           "note": capture_note(exe)}
    print(f"[{card}] SRL at the book's widths {SRL_BOOK_CFG}, batch "
          f"{SRL_BATCH}: losses {[round(v, 4) for v in losses]}, "
          f"{out['step_ms']:.2f} ms a step, launches {launched}; "
          f"{out['note']}", flush=True)
    if not np.all(np.isfinite(losses)) or launched != want:
        raise SystemExit(f"SRL at the book's widths: losses {losses}, "
                         f"launches {launched} (want {want})")
    return out


def last_chapters_on_card(card):
    """Phase 22 (a): label_semantic_roles and recommender_system as phase
    21 (c) runs the first four; SRL's launches a compiled step and its
    crf_decoding tags against the CPU's on the same emissions; then SRL
    at the book's widths."""
    out = {}
    with synthetic_corpora() as tmp:
        for name, rtol in LAST_CHAPTERS_RTOL.items():
            res, exe, scope, feeds, named, launched = chapter_on_card(
                card, name, rtol, tmp)
            want = {n: k * BOOK_BATCHES for n, k in SRL_LAUNCHES.items()} \
                if name == "label_semantic_roles" else {}
            if launched != want:
                raise SystemExit(f"book {name}: launches {launched}, want "
                                 f"{want} (SRL_LAUNCHES a compiled step)")
            res["launches"] = launched
            if named:
                card_path, cpu_path = srl_tags_on_cpu(exe, scope, feeds[-1],
                                                      named)
                equal = _host_bytes(card_path) == _host_bytes(cpu_path)
                print(f"[{card}] book {name}: crf_decoding tags of "
                      f"{len(card_path.data)} positions on the card "
                      f"{'equal' if equal else 'DIFFER FROM'} the CPU's "
                      "on the same emissions", flush=True)
                if not equal:
                    raise SystemExit(f"book {name}: crf_decoding tags "
                                     "differ from the CPU's")
                res["tags_equal"] = True
                res["tag_positions"] = int(len(card_path.data))
            out[name] = res
        out["srl_book_width"] = srl_at_book_width(card)
    return out


def frozen_resnet50(tmp, seed, version):
    """bench.py:619's frozen ResNet-50 (1000 classes, test-mode batch
    norm) from seeded weights, saved as an inference model with
    `version`; returns its directory."""
    from paddle_tpu_torch import (Executor, Scope, framework, io,
                                  load_param_arrays, scope_guard)
    from paddle_tpu_torch.models import resnet
    with framework.isolated_name_scope():
        main, startup, f = resnet.build_train(image_shape=IMAGE_SHAPE,
                                              **SERVE_RESNET_CFG)
    exe, scope = Executor(DEVICE), Scope()
    exe.run(startup, scope=scope)
    load_param_arrays(scope, seeded_weights(startup, seed))
    d = os.path.join(tmp, version)
    with scope_guard(scope):
        io.save_inference_model(d, ["img"], [f["pred"]], exe,
                                 main_program=main, model_version=version)
    return d


class ClosedLoop:
    """RESNET_CLIENTS threads, each keeping RESNET_WINDOW single-image
    requests in flight against `submit`; completion times, latencies and
    errors recorded."""

    def __init__(self, submit, images):
        import threading
        self.submit, self.images = submit, images
        self.done, self.lat, self.errors = [], [], []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i,),
                                          daemon=True)
                         for i in range(RESNET_CLIENTS)]

    def _run(self, i):
        from collections import deque
        q, k = deque(), i
        while not self._stop.is_set() or q:
            while not self._stop.is_set() and len(q) < RESNET_WINDOW:
                t = time.monotonic()
                try:
                    q.append((self.submit(
                        {"img": self.images[k % len(self.images)]}), t))
                except Exception as e:  # noqa: BLE001 — counted, asserted
                    with self._lock:
                        self.errors.append(e)
                k += 1
            if not q:
                continue
            fut, t = q.popleft()
            try:
                fut.result(timeout=120)
            except Exception as e:  # noqa: BLE001 — counted, asserted
                with self._lock:
                    self.errors.append(e)
                continue
            now = time.monotonic()
            with self._lock:
                self.done.append(now)
                self.lat.append(now - t)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=300)
        return False


def _pcts_ms(lat):
    if not lat:
        return {"p50": None, "p99": None}
    return {"p50": float(np.percentile(lat, 50) * 1e3),
            "p99": float(np.percentile(lat, 99) * 1e3)}


def _max_gap(times, lo, hi):
    ts = sorted(t for t in times if lo <= t <= hi)
    return max((b - a for a, b in zip(ts, ts[1:])), default=None)


def resnet_host_on_card(card, tmp):
    """Phase 22 (b): ModelHost serving the frozen ResNet-50."""
    import threading
    import torch
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving.batcher import QueueFullError
    from paddle_tpu_torch.resilience.health import CircuitOpenError
    t_phase = t0 = time.perf_counter()
    d1 = frozen_resnet50(tmp, 0, "r50_v1")
    d2 = frozen_resnet50(tmp, 1, "r50_v2")
    out = {"freeze_s": time.perf_counter() - t0}
    rng = np.random.RandomState(5)
    images = [rng.rand(1, *IMAGE_SHAPE).astype(np.float32)
              for _ in range(RESNET_IMAGES)]
    config = serving.BatchingConfig(
        max_batch_size=RESNET_BUCKETS[-1], batch_buckets=RESNET_BUCKETS,
        max_latency_ms=RESNET_LATENCY_MS, queue_capacity_rows=16384)
    t0 = time.perf_counter()
    host = serving.ModelHost(d1, config=config,
                             admission=serving.AdmissionConfig(
                                 max_queue_rows=RESNET_ADMIT_ROWS)).start()
    out["start_s"] = time.perf_counter() - t0
    try:
        v1 = host._current
        exe = v1.model.executor
        print(f"[{card}] ModelHost started ResNet-50 {v1.name} in "
              f"{out['start_s']:.2f} s: {len(RESNET_BUCKETS)} buckets "
              f"warmed, {v1.engine.warm_captures} captured by the worker; "
              f"{capture_note(exe)}", flush=True)

        # -- every delivered row against a direct run of its bucket ------
        recorded = []
        complete = v1.engine._complete

        def record(batch, fetches, t, cost=None):
            recorded.append((batch, fetches[0]))
            return complete(batch, fetches, t, cost)

        v1.engine._complete = record
        futures = []
        try:
            k = 0
            for n in RESNET_BURSTS:
                fs = [host.submit({"img": images[(k + j) % len(images)]})
                      for j in range(n)]
                k += n
                futures += fs
                for f in fs:
                    f.result(timeout=300)
        finally:
            del v1.engine._complete
        buckets_seen = sorted({b.bucket_rows for b, _ in recorded})
        for batch, fetched in recorded:
            (direct,) = v1.model.run_direct(batch.feed)
            if direct.tobytes() != fetched.tobytes():
                raise SystemExit(f"ResNet-50 serving: a batch of "
                                 f"{batch.rows} in bucket "
                                 f"{batch.bucket_rows} differs from a "
                                 "direct run of the same padded bucket")
            for req, (i0, i1) in zip(batch.requests, batch.slices):
                if req.future.result(timeout=0)[0].tobytes() != \
                        fetched[i0:i1].tobytes():
                    raise SystemExit("ResNet-50 serving: a request's rows "
                                     "differ from its batch's")
        keys = list(exe._cache.values())
        captured = sum(c.captured for c in keys)
        graphs = len(RESNET_BUCKETS) if DEVICE == "cuda" else 0
        if not (len(keys) == exe.cache_stats["misses"]
                == len(RESNET_BUCKETS)
                and captured == v1.engine.warm_captures == graphs):
            raise SystemExit(f"ResNet-50 serving: {len(keys)} keys, "
                             f"{exe.cache_stats}, {captured} captured, want "
                             f"one captured key per bucket")
        print(f"[{card}] ResNet-50 serving: {len(futures)} requests in "
              f"{len(recorded)} batches (buckets {buckets_seen}) bit for "
              "bit a direct run of the same padded bucket; one compiled "
              f"key and one CUDA graph per bucket ({len(keys)}; "
              f"{exe.cache_stats})", flush=True)
        out["bitwise"] = {"requests": len(futures),
                          "batches": len(recorded),
                          "buckets_seen": buckets_seen,
                          "keys": len(keys), "captured": captured,
                          "cache_stats": dict(exe.cache_stats)}

        # -- capacity, latency, fill and busy share ------------------------
        stats0 = v1.engine.stats()
        hist = v1.engine.metrics.latency_s
        n0 = hist.count
        with ClosedLoop(host.submit, images) as loop:
            time.sleep(0.5)
            t_a = time.monotonic()
            time.sleep(RESNET_CAL_S)
            t_b = time.monotonic()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t_p = time.perf_counter()
                time.sleep(RESNET_PROFILE_S)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t_p) * 1e3
        if loop.errors:
            raise SystemExit(f"ResNet-50 calibration: {loop.errors[:3]}")
        n_cal = sum(1 for t in loop.done if t_a <= t <= t_b)
        capacity = n_cal / (t_b - t_a)
        busy = sum(ms for _, ms, _ in device_kernels(prof)) / wall_ms
        stats1 = v1.engine.stats()
        served = list(hist._vals)[-(hist.count - n0):]
        batches = stats1["batches"] - stats0["batches"]
        rows = stats1["requests"] - stats0["requests"]
        fill = stats1["batch_fill_ratio"]
        out["closed_loop"] = {
            "images_per_s": capacity, "latency_ms": _pcts_ms(served),
            "client_latency_ms": _pcts_ms(loop.lat),
            "in_flight": RESNET_CLIENTS * RESNET_WINDOW,
            "rows_per_batch": rows / max(batches, 1),
            "batch_fill_p50": fill["p50"], "busy": busy,
            "mfu": stats1["mfu"], "model_flops": stats1["model_flops"]}
        print(f"[{card}] ResNet-50 serving, {RESNET_CLIENTS} x "
              f"{RESNET_WINDOW} in flight: {capacity:.1f} images/s, "
              f"latency {_pcts_ms(served)} ms (clients "
              f"{_pcts_ms(loop.lat)}), "
              f"{rows / max(batches, 1):.1f} rows a batch, fill p50 "
              f"{fill['p50']}, busy {100 * busy:.1f}% over "
              f"{wall_ms:.0f} ms profiled, MFU gauge {stats1['mfu']:.4f} "
              f"of {PEAK_NOTE}", flush=True)

        # -- hot swap under the same clients --------------------------------
        with ClosedLoop(host.submit, images) as loop:
            time.sleep(1.0)
            t_s0 = time.monotonic()
            report = host.swap(d2, canary_fraction=0.1)
            t_s1 = time.monotonic()
            time.sleep(1.0)
        blackout = _max_gap(loop.done, t_s0 - 0.25, t_s1 + 0.25)
        steady = _max_gap(loop.done, t_s0 - 1.0, t_s0 - 0.25)
        out["swap"] = {"report": report, "client_errors": len(loop.errors),
                       "completed": len(loop.done),
                       "swap_wall_s": t_s1 - t_s0,
                       "blackout_ms": blackout * 1e3 if blackout else None,
                       "steady_max_gap_ms": steady * 1e3 if steady
                       else None}
        print(f"[{card}] ResNet-50 hot swap r50_v1 -> r50_v2 under "
              f"{RESNET_CLIENTS} x {RESNET_WINDOW} clients: "
              f"{report['outcome']} in {t_s1 - t_s0:.2f} s "
              f"({report['durations_s']}), canary {report['canary']}, "
              f"{len(loop.errors)} client errors, blackout "
              f"{out['swap']['blackout_ms']} ms (steady largest gap "
              f"{out['swap']['steady_max_gap_ms']} ms)", flush=True)
        if report["outcome"] != "completed" or loop.errors or \
                host.current_version != "r50_v2":
            raise SystemExit(f"ResNet-50 hot swap: {report}, client "
                             f"errors {loop.errors[:3]}")
        v2 = host._current
        (served,) = host.predict({"img": images[0]}, timeout=300)
        (direct,) = v2.model.run_direct({"img": images[0]})
        if served.tobytes() != direct.tobytes():
            raise SystemExit("after the swap the host does not serve "
                             "r50_v2's weights")

        # -- admission at 2x the calibrated rate ------------------------------
        shed0 = sum(v2.engine.metrics.shed_by_reason().values())
        hist = v2.engine.metrics.latency_s
        n0 = hist.count
        offered, refused = 0, 0
        pending, lat, errors = [], [], []
        done = threading.Event()
        lock = threading.Lock()

        def collect():
            i = 0
            while not done.is_set() or i < len(pending):
                if i >= len(pending):
                    time.sleep(0.001)
                    continue
                fut, t = pending[i]
                i += 1
                try:
                    fut.result(timeout=300)
                except Exception as e:  # noqa: BLE001 — asserted
                    with lock:
                        errors.append(e)
                    continue
                with lock:
                    lat.append(time.monotonic() - t)

        collector = threading.Thread(target=collect, daemon=True)
        collector.start()
        period = 1.0 / (2.0 * capacity)
        t_a = time.monotonic()
        while time.monotonic() - t_a < RESNET_ADMIT_S:
            t = time.monotonic()
            try:
                pending.append((host.submit(
                    {"img": images[offered % len(images)]}), t))
            except (serving.ServiceOverloadedError, QueueFullError,
                    CircuitOpenError):
                refused += 1
            offered += 1
            wait = t_a + offered * period - time.monotonic()
            if wait > 0:
                time.sleep(wait)
        done.set()
        collector.join(timeout=600)
        elapsed = time.monotonic() - t_a
        shed = sum(v2.engine.metrics.shed_by_reason().values()) - shed0
        bound_s = RESNET_P99_FACTOR * (RESNET_ADMIT_ROWS
                                       + 2 * RESNET_BUCKETS[-1]) / capacity
        # the engine's own submit-to-delivery latencies of the admitted
        # requests (the client threads' clocks add their scheduling)
        served = list(hist._vals)[-(hist.count - n0):] \
            if hist.count > n0 else []
        p = _pcts_ms(served)
        out["admission"] = {
            "offered_rps": offered / elapsed, "offered": offered,
            "admitted": len(pending), "refused": refused,
            "shed_ledger": shed,
            "shed_by_reason": v2.engine.metrics.shed_by_reason(),
            "completed": len(lat), "errors": len(errors),
            "admitted_latency_ms": p,
            "client_latency_ms": _pcts_ms(lat),
            "p99_bound_ms": bound_s * 1e3,
            "goodput_rps": len(lat) / elapsed}
        print(f"[{card}] ResNet-50 admission at 2x ({offered / elapsed:.1f}"
              f" offered requests/s): {len(pending)} admitted, {refused} "
              f"refused ({shed} in the shed ledger: "
              f"{v2.engine.metrics.shed_by_reason()}), {len(errors)} "
              f"errors, admitted latency {p} ms (bound "
              f"{bound_s * 1e3:.0f} ms)", flush=True)
        if refused == 0 or shed != refused or errors or \
                len(lat) != len(pending) or len(served) != len(pending) \
                or p["p99"] > bound_s * 1e3:
            raise SystemExit(f"ResNet-50 admission: {out['admission']}")
    finally:
        host.stop(timeout=600)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def generation_host_on_card(card, tmp):
    """Phase 22 (c): the two-model GenerationHost at phase 3's width."""
    import threading
    import torch
    from paddle_tpu_torch import flags, load_param_arrays
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import FaultInjector
    from paddle_tpu_torch.resilience.health import (CircuitBreaker,
                                                    CircuitOpenError,
                                                    HealthMonitor)
    from paddle_tpu_torch.serving.admission import ServiceOverloadedError
    from paddle_tpu_torch.serving.batcher import QueueFullError
    from paddle_tpu_torch.serving.generation import (GenerationConfig,
                                                     GenerationHost,
                                                     GenerationModel,
                                                     GenerationSpec,
                                                     bucket_for)
    t0 = time.perf_counter()
    spec = GenerationSpec(**SERVE_SPEC)
    spec1 = GenerationSpec(**{**SERVE_SPEC, "seed": 1})
    slots = spec.slots
    cfg = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS,
                           queue_capacity=4 * slots, idle_wait_s=0.002)
    host = GenerationHost(config=cfg, default_budget=2 * slots)
    host.deploy("m0", spec)
    host.deploy("m1", spec1)
    w0 = seeded_weights(host._hosted["m0"].model.programs["startup"], 0)
    w1 = seeded_weights(host._hosted["m1"].model.programs["startup"], 1)
    load_param_arrays(host._hosted["m0"].model, w0)
    load_param_arrays(host._hosted["m1"].model, w1)
    direct = GenerationModel.build(spec)
    load_param_arrays(direct, w0)
    out = {"build_s": time.perf_counter() - t0}
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, spec.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    try:
        # -- streams against a direct engine; flash launches --------------
        min_seq = int(flags.get("PADDLE_TPU_FLASH_MIN_SEQ"))
        want_flash = spec.n_layer * sum(
            bucket_for(len(p), spec.prompt_buckets) >= min_seq
            for p in prompts)
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        hosted = [host.generate("m0", p, timeout=600) for p in prompts]
        launches = launch_delta(before)
        eng = direct.serve(config=cfg).start()
        try:
            solo = [eng.generate(p, timeout=600) for p in prompts]
        finally:
            eng.stop(timeout=600)
        same = [a.tokens == b.tokens and a.finish_reason == b.finish_reason
                for a, b in zip(hosted, solo)]
        print(f"[{card}] GenerationHost m0: {len(prompts)} prompts "
              f"{PROMPT_LENS}, streams equal a direct engine's: {same}; "
              f"launches {launches} (want flash_attention_fwd "
              f"{want_flash}: {spec.n_layer} a prefill at a bucket >= "
              f"{min_seq})", flush=True)
        flash = launches.pop("flash_attention_fwd", 0)
        if not all(same) or launches or flash != want_flash or \
                (DEVICE == "cuda" and flash == 0):
            raise SystemExit("GenerationHost: streams or flash launches")
        out["streams_equal"] = True
        out["flash_launches"] = want_flash

        # -- the breaker keeps completed tokens ------------------------------
        health = HealthMonitor(breaker=CircuitBreaker(
            failure_threshold=1, reset_timeout_s=3600))
        eng = direct.serve(config=cfg, health=health).start()
        try:
            with FaultInjector(seed=0) as fi:
                fi.on("generation.step", after=GEN_FAULT_AFTER)
                res = eng.submit(prompts[0]).result(timeout=600)
            state = eng.health.snapshot()["breaker"]["state"]
            try:
                eng.submit(prompts[1])
                shed = False
            except CircuitOpenError:
                shed = True
        finally:
            eng.stop(drain=False, timeout=600)
        kept = res.tokens == solo[0].tokens[:GEN_FAULT_AFTER + 1]
        print(f"[{card}] generation.step fault after {GEN_FAULT_AFTER} "
              f"steps: finish {res.finish_reason!r}, {len(res.tokens)} "
              f"tokens kept (the solo stream's prefix: {kept}), breaker "
              f"{state}, next submit shed: {shed}", flush=True)
        if res.finish_reason != "aborted" or not kept or state != "open" \
                or not shed:
            raise SystemExit("GenerationEngine breaker")

        # -- a swap keeps an in-flight request -----------------------------
        fut = host.submit("m0", prompts[5])
        report = host.swap("m0", GenerationSpec(**{**SERVE_SPEC,
                                                  "seed": 99}),
                           probe_prompts=([3, 4, 5],))
        inflight = fut.result(timeout=600)
        print(f"[{card}] GenerationHost swap of m0: {report['outcome']} "
              f"({report['phases']}); the in-flight request's stream "
              f"equals its solo stream: {inflight.tokens == solo[5].tokens}",
              flush=True)
        if report["outcome"] != "completed" or \
                inflight.tokens != solo[5].tokens:
            raise SystemExit(f"GenerationHost swap: {report}")
        out["swap"] = report

        # -- save / load --------------------------------------------------
        d = os.path.join(tmp, "generation")
        direct.save(d, model_version="g1")
        loaded = GenerationModel.load(d)
        eng = loaded.serve(config=cfg).start()
        try:
            again = [eng.generate(p, timeout=600) for p in prompts[:3]]
        finally:
            eng.stop(timeout=600)
        if [r.tokens for r in again] != [r.tokens for r in solo[:3]] or \
                loaded.version != "g1":
            raise SystemExit("GenerationModel save / load changed tokens")
        print(f"[{card}] GenerationModel.save / load: the loaded model "
              "streams the saved one's tokens bit for bit", flush=True)
        del loaded, eng

        # -- idle TTFT per prompt bucket -------------------------------------
        ttft = {}
        for b in spec.prompt_buckets:
            p = rng.randint(1, spec.vocab_size, b).tolist()
            runs = []
            for i in range(GEN_TTFT_RUNS + 2):
                t = time.perf_counter()
                host.generate("m1", p, max_new_tokens=1, timeout=600)
                runs.append((time.perf_counter() - t) * 1e3)
            ttft[b] = float(np.median(runs[2:]))
        out["ttft_ms"] = ttft
        print(f"[{card}] idle TTFT (submit to the first token) by prompt "
              f"bucket: {ttft} ms", flush=True)

        # -- the decode arm: calibration, then 2x open loop --------------
        models = ["m0", "m1"]
        prompt_len = max(1, spec.prompt_buckets[0] // 2)

        def one(i):
            return host.submit(models[i % 2],
                               rng.randint(1, spec.vocab_size,
                                           prompt_len).tolist())

        calib, stop, lock = [0], threading.Event(), threading.Lock()

        def client(i):
            while not stop.is_set():
                try:
                    one(i).result(timeout=600)
                except Exception:  # noqa: BLE001 — shed under load
                    continue
                with lock:
                    calib[0] += 1

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(2 * slots)]
        ta = time.monotonic()
        for t in threads:
            t.start()
        time.sleep(GEN_CAL_S)
        stop.set()
        for t in threads:
            t.join(timeout=600)
        capacity = calib[0] / (time.monotonic() - ta)
        period = 1.0 / max(2.0, 2.0 * capacity)
        done, shed, failed, lat, toks = [0], [0], [0], [], [0]
        waiters = []

        def wait_on(f, ts):
            try:
                r = f.result(timeout=600)
            except Exception:  # noqa: BLE001 — counted
                with lock:
                    failed[0] += 1
                return
            with lock:
                done[0] += 1
                lat.append(time.monotonic() - ts)
                toks[0] += len(r.tokens)

        ta = time.monotonic()
        i = 0
        while time.monotonic() - ta < GEN_DRIVE_S:
            ts = time.monotonic()
            try:
                f = one(i)
            except (ServiceOverloadedError, QueueFullError,
                    CircuitOpenError):
                shed[0] += 1
            else:
                w = threading.Thread(target=wait_on, args=(f, ts),
                                     daemon=True)
                w.start()
                waiters.append(w)
            i += 1
            wait = ts + period - time.monotonic()
            if wait > 0:
                time.sleep(wait)
        for w in waiters:
            w.join(timeout=600)
        elapsed = time.monotonic() - ta
        stats = host.stats()
        mfu = {n: stats["models"][n]["mfu"] for n in models}
        out["decode_arm"] = {
            "capacity_rps": capacity, "offered": i,
            "offered_rps": i / elapsed, "completed": done[0],
            "shed": shed[0], "failed": failed[0],
            "goodput_rps": done[0] / elapsed,
            "latency_ms": _pcts_ms(lat),
            "decode_tokens_per_s": toks[0] / elapsed,
            "shed_by_model": {n: stats["models"][n]["shed_by_reason"]
                              for n in models},
            "mfu": mfu, "peak_flops": PEAK_FLOPS,
            "compile_cache": stats.get("compile_cache")}
        print(f"[{card}] GenerationHost decode arm: capacity "
              f"{capacity:.2f} requests/s closed loop; at 2x "
              f"({i / elapsed:.2f}/s offered) {done[0]} completed, "
              f"{shed[0]} shed, {failed[0]} failed, latency "
              f"{_pcts_ms(lat)} ms, {toks[0] / elapsed:.1f} decode "
              f"tokens/s; MFU gauge {mfu} of {PEAK_NOTE}", flush=True)
        if failed[0] or done[0] == 0:
            raise SystemExit(f"GenerationHost decode arm: {out}")
    finally:
        host.stop(timeout=600)
    out["phase_s"] = time.perf_counter() - t0
    return out


def registry_families(card, reg):
    """Phase 22 (d): the families (b) and (c) published."""
    names = {f.name for f in reg.families()}
    missing = SERVING_FAMILIES - names
    extra = names - SERVING_FAMILIES - OTHER_SERVING_FAMILIES \
        - PROCESS_FAMILIES
    print(f"[{card}] registry after (b)-(c): {len(names)} families, the "
          f"{len(SERVING_FAMILIES)} serving families of "
          f"tests/test_metric_names.py all present: {not missing}; "
          f"others: {sorted(names - SERVING_FAMILIES)}", flush=True)
    if missing or extra:
        raise SystemExit(f"registry families: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    return sorted(names)


def serve_slice21(card):
    """Phase 22: (a) the book's last two chapters, (b) ModelHost serving
    ResNet-50, (c) the two-model GenerationHost, (d) the registry's
    families, on a fresh default registry, with the flight recorder's
    dumps in a scratch directory. Returns the summary and the launches
    of (a) and (c) (counts set to 0 just before each path and read just
    after it)."""
    import tempfile
    import torch
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import flight_recorder as fr
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    summary = {"card": card}
    launches = {}

    def count(part, fn, *args):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        res = fn(*args)
        torch.cuda.synchronize()
        for n, k in kernels.launch_counts().items():
            launches[n] = launches.get(n, 0) + k
        summary["part_s"][part] = time.perf_counter() - t1
        return res

    summary["part_s"] = {}
    prev_reg = obs.set_default_registry(obs.MetricsRegistry())
    with tempfile.TemporaryDirectory() as tmp:
        rec = fr.FlightRecorder(
            dump_dir=os.path.join(tmp, "flightrec")).enable()
        prev_rec = fr.set_flight_recorder(rec)
        try:
            t1 = time.perf_counter()
            summary["chapters"] = count("a", last_chapters_on_card, card)
            t1 = time.perf_counter()
            summary["resnet_host"] = count("b", resnet_host_on_card, card,
                                           tmp)
            t1 = time.perf_counter()
            summary["generation_host"] = count(
                "c", generation_host_on_card, card, tmp)
            summary["families"] = registry_families(
                card, obs.default_registry())
            summary["flight_dumps"] = sorted(
                os.path.basename(b).split("_", 4)[-1] for b in rec.dumps())
        finally:
            rec.disable()
            fr.set_flight_recorder(prev_rec)
            obs.set_default_registry(prev_reg)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"[{card}] phase 22: {summary['phase_s']:.1f} s "
          f"({summary['part_s']}); flight-recorder bundles "
          f"{summary['flight_dumps']}; launches "
          f"{ {n: k for n, k in launches.items() if k} }", flush=True)
    return summary, launches


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
    record_misses()
    rewrite_paths = {}

    def enter(path):
        """Close the current path's rewrite report (phase 20 (c)) and
        open `path`'s."""
        if CURRENT_PATH[0] != "setup":
            rewrite_paths[CURRENT_PATH[0]] = path_report(CURRENT_PATH[0],
                                                         card)
        CURRENT_PATH[0] = path
        torch.cuda.reset_peak_memory_stats()

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
    lstm_bf16_rows, lstm_bf16_err = check_lstm_bf16(card)
    gru_bf16_rows, gru_bf16_err = check_gru_bf16(card)
    lstm_rows.update(lstm_bf16_rows)
    lstm_coverage_err.update(lstm_bf16_err)
    gru_rows.update(gru_bf16_rows)
    for name, err in gru_bf16_err.items():
        gru_coverage_err[name] = max(gru_coverage_err.get(name, 0.0), err)
    conv_rows, conv_coverage_err = check_fused_conv(card)
    mega_coverage_err = check_megakernel(card)

    # -- 3. serve at Transformer-base width --------------------------------
    enter("serving")
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
          f"{serve_s:.3f} s on the card; kernel launches {launches}; "
          f"{capture_note(gpu.executor)}", flush=True)
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
    enter("training")
    training, train_launches, flash32 = train(card)

    # -- 5. train the stacked-LSTM LM ----------------------------------------
    enter("lstm_training")
    lstm_training, lstm_launches = train_lstm(card)

    # -- 6, 7. train the book's GRU encoder-decoder; reload it -------------
    enter("gru_nmt_training")
    gru_training, gru_launches = train_gru_nmt(card)

    # -- 8. train MNIST conv on the card and on the CPU ----------------------
    enter("mnist_training")
    mnist_training, mnist_launches = train_mnist(card)

    # -- 9. train ResNet-50 ----------------------------------------------------
    enter("resnet_training")
    resnet_training, resnet_launches = train_resnet(card)

    # -- 10. the bottleneck chain: fused conv kernels vs composed --------------
    enter("conv_chain")
    chain, chain_launches = conv_chain(card)

    # -- 11. the megakernel chain: batch-BN vs ghost composed vs the kernel --
    mega, mega_launches = megakernel_chain(card)

    # -- 12. the roll micro: the megakernel's four variants ------------------
    micro, micro_launches = roll_micro(card)

    # -- 13. the Trainer: the LSTM LM and DeepFM at full width --------------
    enter("trainer")
    trainer, trainer_launches = train_trainer(card)

    # -- 14. the eager arm beside the compiled arm ---------------------------
    enter("compiled")
    compiled = compiled_vs_eager(card)

    # -- 15. bf16 AMP: the bf16 flash kernels, NMT and ResNet-50 -------------
    enter("amp_training")
    amp_summary, amp_rows, amp_launches = train_amp(
        card, flash32, training["profiled_step"], compiled["resnet50"])
    del flash32

    # -- 16. RNNs under AMP: the LSTM LM, stacked_lstm_net, both GRU NMTs ----
    enter("rnn_amp_training")
    rnn_amp, rnn_amp_launches = train_rnn_amp(card)

    # -- 17. the dense optimizers and the learning-rate schedules ----------
    enter("optimizers")
    optimizers = train_optimizers(card)

    # -- 18. the sentiment program and the hierarchical LSTM ---------------
    enter("sequence_models")
    sequence_models, seq_launches = train_sequence_models(card)

    # -- 19. control flow: the MT decoder, dyn_rnn_lstm, the WhileGrad ------
    enter("control_flow")
    control_flow, cf_launches = train_control_flow(
        card, sequence_models["sentiment"])

    # -- 20. the rewrite pipeline: composed NMT, its cost, the gate ----------
    enter("train_rewrite")
    rewrite, rewrite_launches = train_rewrite(card)

    # -- 21. control flow under AMP, the image models, the book chapters -----
    enter("slice20")
    slice20, slice20_launches = train_slice20(card, control_flow)

    # -- 22. the book's last chapters, ModelHost, GenerationHost ----------
    enter("slice21")
    slice21, slice21_launches = serve_slice21(card)
    enter("done")
    rewrite["paths"] = rewrite_paths

    # -- 23. result lines ------------------------------------------------------
    main_case = attn[MAIN_CASE]
    train_shapes = {name: {label: r for (n, label), r in
                           list(attn_bwd.items()) + list(lstm_rows.items())
                           + list(gru_rows.items()) + list(amp_rows.items())
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
                      "roll_micro": micro_launches[name],
                      "trainer": trainer_launches[name],
                      "amp_training": amp_launches[name],
                      "rnn_amp_training": rnn_amp_launches.get(name, 0),
                      "sequence_models": seq_launches.get(name, 0),
                      "control_flow": cf_launches.get(name, 0),
                      "train_rewrite": rewrite_launches.get(name, 0),
                      "slice20": slice20_launches.get(name, 0),
                      "slice21": slice21_launches.get(name, 0)}
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
    # the bf16 entry points of the three flash kernels (the Pallas kernels'
    # bf16 arm): bound_ms at the dense bf16 rate, library_ms the bf16
    # F.scaled_dot_product_attention forward or its whole backward
    for name, line in (("flash_attention_fwd_bf16", 61),
                       ("flash_attention_bwd_dq_bf16", 213),
                       ("flash_attention_bwd_dkv_bf16", 265)):
        case = amp_rows[(name, AMP_MAIN_CASES[name])]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_"
                      f"{'fwd' if 'fwd' in name else 'bwd'}.cu",
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "max_abs_err": max(r["max_abs_err"] for (n, _), r in
                               amp_rows.items() if n == name),
            "shape": AMP_MAIN_CASES[name],
            **{k: case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "allowance_ratio")}})
    # the bf16 rows (the kernels' bf16 arm): bound_ms at the float32
    # products' rate with the bf16 streams' bytes, library_ms the bf16
    # torch.nn.LSTM; the GRU's library_ms is null as in float32
    for name, line in (("fused_lstm_fwd", 35), ("fused_lstm_bwd", 66),
                       ("fused_lstm_fwd_bf16", 35),
                       ("fused_lstm_bwd_bf16", 66)):
        case = lstm_rows[(name, LSTM_MAIN_CASE)]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_lstm.cu",
            "replaces": f"paddle_tpu/ops/pallas/fused_lstm.py:{line}",
            "max_abs_err": max([lstm_coverage_err[name]]
                               + [r["max_abs_err"] for r in
                                  train_shapes[name].values()]),
            **{k: case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "fma_bound_ms",
                                    "fma_bound_by", "barrier_floor_ms",
                                    "plan", "recurrence_device_ms",
                                    "dw_device_ms", "allowance_ratio",
                                    "library_max_abs_err") if k in case}})
    # no PyTorch call computes the GRU's function (torch.nn.GRU resets
    # after the recurrent product): library_ms is null, and the nn.GRU
    # same-FLOP yardstick rides beside it
    for name, line in (("fused_gru_fwd", 44), ("fused_gru_bwd", 63),
                       ("fused_gru_fwd_bf16", 44),
                       ("fused_gru_bwd_bf16", 63)):
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
                                    "recurrence_device_ms", "dw_device_ms",
                                    "recompute_device_ms", "allowance_ratio")
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
        "fma_bound_ms": stage["fma_bound_ms"],
        "fma_bound_by": stage["fma_bound_by"],
        "design_bytes_ms": stage["design_bytes_ms"],
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
        "design_bytes_ms": micro["design_bytes_ms"], "library_ms": None,
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
    print(json.dumps({"trainer": trainer}))
    print(json.dumps({"compiled": compiled}))
    print(json.dumps({"amp": amp_summary}))
    print(json.dumps({"rnn_amp": rnn_amp}))
    print(json.dumps({"optimizers": optimizers}))
    print(json.dumps({"sequence_models": sequence_models}))
    print(json.dumps({"control_flow": control_flow}))
    print(json.dumps({"rewrite": rewrite}, default=float))
    print(json.dumps({"slice20": slice20}, default=float))
    print(json.dumps({"slice21": slice21}, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
