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
"""
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


def _generate_all(model, prompts, mode, max_new_tokens=16):
    eng = model.serve(config=GenerationConfig(max_new_tokens=max_new_tokens),
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
