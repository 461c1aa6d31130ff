#!/usr/bin/env python3
"""Smoke test of paddle_tpu_torch on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. card name and power limit (nvidia-smi); build every CUDA kernel of
     the port from the sources in the checkout.
  2. each kernel against its plain torch version on the card, at the
     shapes the serving path gives it, with times: kernel, plain,
     library (one PyTorch call computing the same function, a yardstick
     the port never calls) and the card's lower bound for the work.
  3. serve the decoder LM at Transformer-base width through the port's
     entry points (GenerationModel.build -> GenerationEngine.submit):
     6 requests on 4 slots, continuous batching, KV cache. Launch
     counts are set to 0 just before and read just after; every token
     stream must equal the same port model's on the CPU (same weights,
     plain path) or differ only at a near tie of the CPU logits.
  4. a JSON line of the kernels, then, last, the JSON result line.

Without a CUDA card, or outside a checkout, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

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
# (B, H, Sq, Sk, D, bias shape or None, causal)
COVERAGE_CASES = [
    (2, 3, 100, 130, 16, (2, 3, 100, 130), False),
    (2, 3, 130, 100, 32, (2, 1, 130, 100), True),
    (1, 2, 200, 200, 128, None, True),
    (4, 8, 1, 300, 64, (4, 1, 1, 300), False),
]


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


def attention_bound(b, h, s, d, live, bias_numel):
    """Least time for the forward on this card: bytes (q, k, v, bias read
    once; O, lse written once) over HBM rate vs the (q, k) pairs this
    data needs (k <= q and k < live: masked pairs contribute exp(-1e9)
    = 0) times 4*D flops, over the fp32 rate."""
    pairs = sum(min(q + 1, live) for q in range(s))
    flops = 4.0 * d * pairs * b * h
    nbytes = 4.0 * (4 * b * h * s * d + bias_numel + b * h * s)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
        o_k, lse_k = flash_attention_fwd(q, k, v, bias, causal=True)
        o_p, lse_p = flash_attention_fwd_plain(q, k, v, bias, causal=True)
        torch.cuda.synchronize()
        err = max((o_k - o_p).abs().max().item(),
                  (lse_k - lse_p).abs().max().item())
        ok = (torch.allclose(o_k, o_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
              and torch.allclose(lse_k, lse_p, rtol=KERNEL_RTOL,
                                 atol=KERNEL_ATOL))
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
        bound_ms, bound_by = attention_bound(b, h, s, d, live, bias.numel())
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        print(f"[{card}] flash_attention_fwd B={b} H={h} S={s} D={d} "
              f"live={live} causal: max_abs_err={err:.3e} kernel_ms="
              f"{ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})",
              flush=True)
    # the rest of what the wrapper accepts, for correctness only: every
    # head dim, Sq != Sk, a full and a head-broadcast bias, no bias
    coverage_err = 0.0
    for b, h, sq, sk, d, bias_shape, causal in COVERAGE_CASES:
        q = torch.randn(b, h, sq, d, device="cuda", generator=gen)
        k, v = (torch.randn(b, h, sk, d, device="cuda", generator=gen)
                for _ in range(2))
        bias = None if bias_shape is None else torch.randn(
            bias_shape, device="cuda", generator=gen)
        o_k, lse_k = flash_attention_fwd(q, k, v, bias, causal=causal)
        o_p, lse_p = flash_attention_fwd_plain(q, k, v, bias, causal=causal)
        err = max((o_k - o_p).abs().max().item(),
                  (lse_k - lse_p).abs().max().item())
        if not (torch.allclose(o_k, o_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
                and torch.allclose(lse_k, lse_p, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)):
            raise SystemExit(f"flash_attention_fwd disagrees with its plain "
                             f"version at B={b} H={h} Sq={sq} Sk={sk} D={d} "
                             f"bias={bias_shape} causal={causal}: {err:.3e}")
        coverage_err = max(coverage_err, err)
        print(f"flash_attention_fwd B={b} H={h} Sq={sq} Sk={sk} D={d} "
              f"bias={bias_shape} causal={causal}: max_abs_err={err:.3e}",
              flush=True)
    return rows, coverage_err


def seeded_weights(model, seed):
    """numpy weights for every parameter, drawn from `seed` with the
    distribution the startup program's init op names."""
    rng = np.random.RandomState(seed)
    out = {}
    for op in model.programs["startup"].desc.global_block.ops:
        name = op.output("Out")[0]
        if name.startswith("kv_cache."):
            continue
        shape = op.attrs["shape"]
        if op.type == "uniform_random":
            out[name] = rng.uniform(op.attrs["min"], op.attrs["max"],
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
    from paddle_tpu_torch import load_params
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.serving.generation import (GenerationModel,
                                                     GenerationSpec)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card and build ---------------------------------------------------
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(built)})", flush=True)
    for src, info in built.items():
        for line in (info["log"] or "").splitlines():
            if "ptxas" in line:
                print(f"  {src}: {line.strip()}")

    # -- 2. kernels against their plain versions ---------------------------
    attn, coverage_err = check_attention(card)

    # -- 3. serve at Transformer-base width --------------------------------
    spec = GenerationSpec(**SERVE_SPEC)
    t0 = time.perf_counter()
    gpu = GenerationModel.build(spec)
    weights = seeded_weights(gpu, seed=0)
    load_params(gpu, weights)
    cpu = GenerationModel(gpu.programs, spec, device="cpu")
    load_params(cpu, weights)
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
    for name, n in launches.items():
        if n == 0:
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

    # -- 4. result lines -----------------------------------------------------
    main_case = attn[MAIN_CASE]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:61",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max([coverage_err]
                           + [r["max_abs_err"] for r in attn.values()]),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]}))
    print(json.dumps({"serving": {
        "card": card, "requests": len(prompts), "tokens": n_tokens,
        "serve_s": serve_s, **timing}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
