"""paddle_tpu_torch token serving vs paddle_tpu, on the CPU.

The JAX model and the port model are built from one tiny spec (that of
tests/test_generation.py); the port takes the JAX model's weights with
io.load_param_arrays. Then prefill, decode and full programs give equal
next tokens and KV-cache rows, and logits fetched by var name agree at
float32 tolerance (rtol=1e-4, atol=1e-5) — with the naive attention, and
with use_flash=True stamped on every attention op (JAX interprets its
Pallas kernel, the port takes its plain flash path). The port's engine
reproduces the JAX engine's token streams, its cached decode is
bit-identical to its re-forward baseline, and the KV-cache ops clamp
out-of-range indices as jax.lax.dynamic_update_slice does.

The engine's health breaker, metrics and spans, GenerationHost and the
artifact round trip (tests/test_generation.py:146, :180, :201, :308)
run on the port too: a step fault retires a request with its completed
tokens and trips the breaker, a stop without drain keeps partial
tokens, two hosted models share one executor through budgets, a swap
and a rollback, and save / load reproduces the saved weights' stream
(an artifact of either package loads into the port).
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.core.ir import OpDesc as RefOpDesc
from paddle_tpu.core.registry import run_op as ref_run_op
from paddle_tpu.serving.generation import GenerationConfig as RefConfig
from paddle_tpu.serving.generation import GenerationModel as RefModel
from paddle_tpu.serving.generation import GenerationSpec as RefSpec
from paddle_tpu_torch.core.ir import OpDesc
from paddle_tpu_torch.core.registry import run_op
from paddle_tpu_torch.serving.generation import (GenerationConfig,
                                                 GenerationModel,
                                                 GenerationSpec, bucket_for)

SPEC_KW = dict(vocab_size=50, max_seq_len=24, slots=2,
               prompt_buckets=(8, 16, 24), cache_buckets=(8, 16, 24),
               n_layer=1, n_head=2, d_model=16, d_inner=32, seed=7,
               eos_id=1)
RTOL, ATOL = 1e-4, 1e-5
LOGITS = "lm_head.tmp_1"


def _weights(ref):
    return {n: np.asarray(ref.scope.get(n))
            for n in ref.programs["startup"].desc.global_block.vars
            if not n.startswith("kv_cache.")}


def _stamp_flash(programs, bump):
    for mode in ("prefill", "decode", "full"):
        for lm in programs[mode].values():
            for op in lm.main.desc.global_block.ops:
                if op.type == "scaled_dot_product_attention":
                    op.attrs["use_flash"] = True
            if bump:
                lm.main.desc._bump_version()


def _pair(use_flash):
    ref = RefModel.build(RefSpec(**SPEC_KW))
    port = GenerationModel.build(GenerationSpec(**SPEC_KW), device="cpu")
    if use_flash:
        _stamp_flash(ref.programs, bump=True)
        _stamp_flash(port.programs, bump=False)
    ptt.load_param_arrays(port, _weights(ref))
    return ref, port


@pytest.fixture(scope="module")
def pair():
    return _pair(use_flash=False)


def _run_both(ref, port, lm_ref, lm_port, feed):
    fetch = [lm_ref.fetch_name, LOGITS]
    r_tok, r_logits = ref.executor.run(lm_ref.main, feed=feed,
                                       fetch_list=fetch, scope=ref.scope)
    p_tok, p_logits = port.run(lm_port, feed, fetch)
    # the reference runs with x64 off: compare integers by value
    assert p_tok.reshape(-1).tolist() == \
        np.asarray(r_tok).reshape(-1).tolist()
    np.testing.assert_allclose(p_logits, np.asarray(r_logits), rtol=RTOL,
                               atol=ATOL)
    return p_tok.reshape(-1)


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_decode_full_match_reference(pair, use_flash):
    ref, port = pair if not use_flash else _pair(use_flash=True)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(2, 50, 11).tolist(), rng.randint(2, 50, 6).tolist()]
    first = []
    for slot, prompt in enumerate(prompts):
        ids = np.zeros((1, 16, 1), np.int64)
        ids[0, :len(prompt), 0] = prompt
        feed = {"token_ids": ids,
                "lengths": np.asarray([len(prompt)], np.int64),
                "slot": np.asarray([slot], np.int64)}
        first.append(int(_run_both(ref, port, ref.programs["prefill"][16],
                                   port.programs["prefill"][16], feed)[0]))
    for name in port.cache_names:
        r_cache = np.asarray(ref.scope.get(name))
        p_cache = port.scope.get(name).numpy()
        for slot, prompt in enumerate(prompts):
            np.testing.assert_allclose(p_cache[slot, :, :len(prompt)],
                                       r_cache[slot, :, :len(prompt)],
                                       rtol=RTOL, atol=ATOL)
    feed = {"token_ids": np.asarray(first, np.int64).reshape(2, 1, 1),
            "positions": np.asarray([len(p) for p in prompts], np.int64)}
    _run_both(ref, port, ref.programs["decode"][16],
              port.programs["decode"][16], feed)
    mat = np.zeros((2, 16, 1), np.int64)
    for i, p in enumerate(prompts):
        mat[i, :len(p), 0] = p
    feed = {"token_ids": mat,
            "lengths": np.asarray([len(p) for p in prompts], np.int64)}
    tok = _run_both(ref, port, ref.programs["full"][16],
                    port.programs["full"][16], feed)
    assert tok.tolist() == first    # re-forward agrees with prefill


def test_engine_streams_match_reference(pair):
    """The slice as a whole: continuous batching over the port's
    programs emits the JAX engine's token streams."""
    ref, port = pair
    prompts = [[5, 9, 3], [7, 3, 2, 4], [11, 6], [8, 8, 4, 9, 2]]
    budgets = [4, 9, 6, 12]

    def serve(model, config):
        eng = model.serve(config=config).start()
        try:
            futs = [eng.submit(p, max_new_tokens=b)
                    for p, b in zip(prompts, budgets)]
            return [f.result(timeout=120) for f in futs]
        finally:
            eng.stop(drain=True, timeout=120)

    r = serve(ref, RefConfig(max_new_tokens=16))
    p = serve(port, GenerationConfig(max_new_tokens=16))
    assert [x.tokens for x in p] == [x.tokens for x in r]
    assert [x.finish_reason for x in p] == [x.finish_reason for x in r]


def _generate_all(model, prompts, mode, max_new_tokens=16,
                  config=GenerationConfig):
    eng = model.serve(config=config(max_new_tokens=max_new_tokens),
                      mode=mode).start()
    try:
        futs = [eng.submit(p) for p in prompts]
        return [f.result(timeout=120) for f in futs]
    finally:
        eng.stop(drain=True, timeout=120)


def test_greedy_bit_identity_across_cache_buckets(pair):
    """Cached decode is BIT-identical to the full re-forward while the
    generation crosses >= 3 cache buckets (the port's run of
    tests/test_generation.py::test_greedy_bit_identity_across_cache_buckets)."""
    _, model = pair
    prompts = [[5, 9, 3, 2], [7, 3, 2, 4]]
    cached = _generate_all(model, prompts, "cached", max_new_tokens=18)
    reforward = _generate_all(model, prompts, "reforward",
                              max_new_tokens=18)
    for c, r in zip(cached, reforward):
        assert c.tokens == r.tokens
        assert c.finish_reason == r.finish_reason
    final_len = len(prompts[0]) + len(cached[0].tokens)
    crossed = {bucket_for(n, model.spec.cache_buckets)
               for n in range(len(prompts[0]) + 1, final_len + 1)}
    assert len(crossed) >= 3, (final_len, crossed)


def test_mid_generation_admit_retire_bit_identity(pair):
    """Continuous batching: late requests take slots freed mid-run, and
    every stream still equals its solo run."""
    _, model = pair
    prompts = [[5, 9, 3], [7, 3, 2, 4], [11, 6], [8, 8, 4, 9, 2]]
    budgets = [4, 9, 6, 12]
    eng = model.serve(config=GenerationConfig(max_new_tokens=16)).start()
    try:
        futs = [eng.submit(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        mixed = [f.result(timeout=120) for f in futs]
    finally:
        eng.stop(drain=True, timeout=120)
    for prompt, budget, got in zip(prompts, budgets, mixed):
        solo = _generate_all(model, [prompt], "cached",
                             max_new_tokens=budget)[0]
        assert got.tokens == solo.tokens
        assert got.finish_reason == solo.finish_reason


@pytest.mark.parametrize("pos", [[5, 0], [6, 2], [9, -3], [100, -9]])
def test_kv_cache_append_clamps_like_dynamic_update_slice(pos):
    """max_seq_len = 6: position 5 is the last row; 6, 9 and 100 must
    clamp to it; a negative position counts from the end and then
    clamps to 0 — as the reference's jax.lax.dynamic_update_slice
    does."""
    rng = np.random.RandomState(4)
    cache = rng.randn(2, 3, 6, 4).astype(np.float32)
    new = rng.randn(2, 3, 1, 4).astype(np.float32)
    pos = np.asarray(pos, np.int64)
    slots = {"Cache": ["c"], "New": ["n"], "Pos": ["p"]}
    ref = ref_run_op(RefOpDesc("kv_cache_append", slots, {"Out": ["c"]}),
                     {"c": jnp.asarray(cache), "n": jnp.asarray(new),
                      "p": jnp.asarray(pos)})["c"]
    out = run_op(OpDesc("kv_cache_append", slots, {"Out": ["c"]}),
                 {"c": torch.from_numpy(cache.copy()),
                  "n": torch.from_numpy(new), "p": torch.from_numpy(pos)})
    np.testing.assert_array_equal(out["c"].numpy(), np.asarray(ref))


@pytest.mark.parametrize("slot", [0, 1, 2, 7, -1, -5])
def test_kv_cache_write_clamps_slot_like_dynamic_update_slice(slot):
    rng = np.random.RandomState(5)
    cache = rng.randn(2, 3, 6, 4).astype(np.float32)
    new = rng.randn(1, 3, 4, 4).astype(np.float32)
    idx = np.asarray([slot], np.int64)
    slots = {"Cache": ["c"], "New": ["n"], "Slot": ["s"]}
    ref = ref_run_op(RefOpDesc("kv_cache_write", slots, {"Out": ["c"]}),
                     {"c": jnp.asarray(cache), "n": jnp.asarray(new),
                      "s": jnp.asarray(idx)})["c"]
    out = run_op(OpDesc("kv_cache_write", slots, {"Out": ["c"]}),
                 {"c": torch.from_numpy(cache.copy()),
                  "n": torch.from_numpy(new), "s": torch.from_numpy(idx)})
    np.testing.assert_array_equal(out["c"].numpy(), np.asarray(ref))


def test_load_params_rejects_mismatch(pair):
    ref, _ = pair
    port = GenerationModel.build(GenerationSpec(**SPEC_KW), device="cpu")
    good = _weights(ref)
    name = "lm_head.w_0"
    missing = dict(good)
    del missing[name]
    with pytest.raises(KeyError):
        ptt.load_param_arrays(port, missing)
    with pytest.raises(KeyError):
        ptt.load_param_arrays(port, dict(good,
                                         extra_param=np.zeros(3, np.float32)))
    with pytest.raises(ValueError):
        ptt.load_param_arrays(port, dict(good, **{name: good[name][:, :-1]}))
    with pytest.raises(ValueError):
        ptt.load_param_arrays(port, dict(good, **{
            name: good[name].astype(np.float64)}))
    before = port.scope.get(name).clone()
    ptt.load_param_arrays(port, good)
    assert not torch.equal(before, port.scope.get(name))
    np.testing.assert_array_equal(port.scope.get(name).numpy(), good[name])


def test_failed_prefill_fails_its_request_instead_of_dropping_it(pair):
    """A prefill that raises fails that request's future (and those
    taken from the queue with it) with the error; the engine lives on and
    serves the next request."""
    _, model = pair
    eng = model.serve(config=GenerationConfig(max_new_tokens=2)).start()
    real = model.run_prefill
    try:
        def broken(prompt, slot):
            raise RuntimeError("prefill failed")
        model.run_prefill = broken
        fut = eng.submit([5, 9, 3])
        with pytest.raises(RuntimeError, match="prefill failed"):
            fut.result(timeout=30)
        assert isinstance(eng.last_error, RuntimeError)
        model.run_prefill = real
        assert len(eng.submit([5, 9, 3]).result(timeout=30).tokens) == 2
    finally:
        model.run_prefill = real
        eng.stop(drain=True, timeout=30)


# -- the health breaker, metrics, hosting and artifacts (ROADMAP A8) ----------

def test_engine_stats_and_ledgers_match_reference(pair, monkeypatch):
    """The same streams through both engines leave equal stats() keys and
    equal volume counters and retirement ledgers; the port's steps are
    generation::* profiler events and publish MFU and the memory peak."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import default_registry
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    ref, port = pair
    prompts, budgets = [[5, 9, 3], [7, 3, 2, 4], [11, 6]], [4, 9, 6]
    stats = []
    profiler.start_profiler()
    try:
        for model, config in ((ref, RefConfig), (port, GenerationConfig)):
            eng = model.serve(config=config(max_new_tokens=16)).start()
            try:
                for f in [eng.submit(p, max_new_tokens=b)
                          for p, b in zip(prompts, budgets)]:
                    f.result(timeout=120)
            finally:
                eng.stop(drain=True, timeout=120)
            stats.append(eng.stats())
    finally:
        profiler.stop_profiler()
    r, p = stats

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    assert keys(p) == keys(r)
    for k in ("requests", "tokens", "steps", "prefills", "slots_active",
              "slots_total", "retired_by_reason", "shed_by_reason",
              "queued", "active", "mode", "slots", "cache_buckets"):
        assert p[k] == r[k], k
    assert p["health"]["breaker"] == r["health"]["breaker"]
    assert p["mfu"] > 0
    names = {e["name"].split("[")[0]
             for e in profiler.events(cat=profiler.CAT_SERVING)}
    assert names == {"generation::prefill", "generation::decode_step"}
    peaks = default_registry().get("paddle_tpu_memory_peak_bytes")
    assert any(k[0].startswith("engine_gen_") and g.value > 0
               for k, g in peaks.samples())
    assert port.last_cost() is port.executor.last_cost is not None
    assert port.last_memory() is port.executor.last_memory is not None


def test_breaker_trip_preserves_completed_tokens(pair):
    """tests/test_generation.py:146 on the port: a step fault after two
    steps with a trip-on-first-failure breaker retires the request with
    its three completed tokens (the reference's greedy prefix), and the
    open breaker sheds the next submit."""
    from paddle_tpu_torch.resilience.faults import FaultInjector
    from paddle_tpu_torch.resilience.health import (CircuitBreaker,
                                                    CircuitOpenError,
                                                    HealthMonitor)
    ref, port = pair
    solo = _generate_all(ref, [[5, 9, 3, 2]], "cached",
                         max_new_tokens=12, config=RefConfig)[0]
    health = HealthMonitor(breaker=CircuitBreaker(failure_threshold=1,
                                                  reset_timeout_s=3600))
    eng = port.serve(config=GenerationConfig(max_new_tokens=12),
                     health=health).start()
    try:
        with FaultInjector(seed=0) as fi:
            fi.on("generation.step", after=2)  # steps 3+ fail
            res = eng.submit([5, 9, 3, 2]).result(timeout=120)
        assert res.finish_reason == "aborted"
        assert res.tokens == solo.tokens[:3]
        assert eng.health.snapshot()["breaker"]["state"] == "open"
        with pytest.raises(CircuitOpenError):
            eng.submit([1, 2, 3])
        assert eng.metrics.stats()["shed_by_reason"] == \
            {"circuit_open": 1}
        assert eng.metrics.stats()["retired_by_reason"] == {"error": 1}
    finally:
        eng.stop(drain=False, timeout=120)


def test_stop_without_drain_keeps_partial_tokens(pair):
    """tests/test_generation.py:180 on the port."""
    _, port = pair
    eng = port.serve(config=GenerationConfig(max_new_tokens=500,
                                             idle_wait_s=0.005)).start()
    fut = eng.submit([5, 9, 3], max_new_tokens=500)
    deadline = time.monotonic() + 60
    while eng.metrics.tokens.value < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    eng.stop(drain=False, timeout=120)
    res = fut.result(timeout=120)
    assert res.finish_reason == "aborted" and len(res.tokens) >= 1
    assert eng.metrics.stats()["retired_by_reason"] == {"aborted": 1}


def test_host_routes_budgets_and_swap_preserves_inflight():
    """tests/test_generation.py:201 on the port: two models on one
    executor, a budget shed that leaves the other model serving, a swap
    whose in-flight request finishes on the old weights, and a rollback
    whose probe fails at ``generation.step``."""
    from paddle_tpu_torch.resilience.faults import FaultInjector
    from paddle_tpu_torch.serving import ServiceOverloadedError
    from paddle_tpu_torch.serving.generation import GenerationHost
    spec_a = GenerationSpec(**SPEC_KW)
    spec_b = GenerationSpec(**{**SPEC_KW, "seed": 11, "vocab_size": 40})
    host = GenerationHost(config=GenerationConfig(max_new_tokens=6),
                          default_budget=4, device="cpu")
    host.deploy("a", spec_a)
    host.deploy("b", spec_b)
    try:
        assert host._hosted["a"].model.executor is \
            host._hosted["b"].model.executor is host.executor
        ra = host.generate("a", [5, 9, 3], timeout=120)
        rb = host.generate("b", [7, 2], timeout=120)
        assert ra.tokens and rb.tokens
        host._hosted["a"].budget = 0
        with pytest.raises(ServiceOverloadedError):
            host.submit("a", [1, 2])
        assert host.generate("b", [7, 2], timeout=120).tokens
        host._hosted["a"].budget = 4

        old_solo = ra.tokens
        fut = host.submit("a", [5, 9, 3])
        report = host.swap("a", GenerationSpec(**{**SPEC_KW, "seed": 99}),
                           probe_prompts=([3, 4],))
        assert report["outcome"] == "completed", report
        assert fut.result(timeout=120).tokens == old_solo
        new = host.generate("a", [5, 9, 3], timeout=120)
        assert new.tokens != old_solo

        with FaultInjector(seed=0) as fi:
            fi.on("generation.step", times=1000)
            report = host.swap("a", GenerationSpec(**{**SPEC_KW,
                                                     "seed": 5}),
                               probe_prompts=([3, 4],))
        assert report["outcome"] == "rolled_back", report
        assert host.generate("a", [5, 9, 3], timeout=120).tokens \
            == new.tokens
        stats = host.stats()
        assert set(stats["models"]) == {"a", "b"}
        assert stats["models"]["a"]["shed_by_reason"] == {}
    finally:
        host.stop(drain=True, timeout=120)


def test_generation_spec_save_load_roundtrip(tmp_path, pair):
    """tests/test_generation.py:308 on the port: save -> load reproduces
    the stream from the SAVED weights (a perturbed one), with the
    version and spec; an artifact the reference saved loads into the
    port and streams the reference's tokens."""
    from paddle_tpu_torch import io
    ref, _ = pair
    src = GenerationModel.build(GenerationSpec(**SPEC_KW), device="cpu")
    ptt.load_param_arrays(src, _weights(ref))
    wname = next(n for n in src.scope.local_names()
                 if "lm_head" in n and ".w" in n)
    src.scope.set(wname, src.scope.get(wname) + 0.37)
    before = _generate_all(src, [[5, 9, 3]], "cached", max_new_tokens=8)[0]
    d = str(tmp_path / "gen_model")
    src.save(d, model_version="v7")
    loaded = GenerationModel.load(d, device="cpu")
    assert loaded.version == "v7" and loaded.spec == src.spec
    after = _generate_all(loaded, [[5, 9, 3]], "cached",
                          max_new_tokens=8)[0]
    assert after.tokens == before.tokens
    with ptt.scope_guard(ptt.Scope()):
        meta = io.load_inference_model(d, ptt.Executor("cpu"),
                                       return_meta=True)[3]
    gs = meta["generation_spec"]
    assert gs["max_seq_len"] == SPEC_KW["max_seq_len"]
    assert gs["kv_cache_layout"] == "[slots, n_head, max_seq_len, d_key]"

    d_ref = str(tmp_path / "ref_model")
    ref.save(d_ref, model_version="r1")
    from_ref = GenerationModel.load(d_ref, device="cpu")
    assert from_ref.version == "r1"
    want = _generate_all(ref, [[5, 9, 3]], "cached", max_new_tokens=8,
                         config=RefConfig)[0]
    got = _generate_all(from_ref, [[5, 9, 3]], "cached",
                        max_new_tokens=8)[0]
    assert got.tokens == want.tokens
    with pytest.raises(ValueError, match="no generation_spec"):
        serving_dir = str(tmp_path / "plain")
        lm = src.programs["full"][src.spec.prompt_buckets[-1]]
        with ptt.scope_guard(src.scope):
            io.save_inference_model(
                serving_dir, lm.feed_names,
                [lm.main.global_block().var(lm.fetch_name)],
                src.executor, main_program=lm.main)
        GenerationModel.load(serving_dir, device="cpu")
