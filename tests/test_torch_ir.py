"""paddle_tpu_torch builds the same decoder-LM programs as paddle_tpu.

Both packages build the program set at the tiny spec of
tests/test_generation.py; every prefill/decode/full program and the
startup program serialize to equal parsed JSON, and the reference's
JSON, loaded with the port's Program.from_json, runs in the port. Also
here: the port imports neither jax nor paddle_tpu, and its entry points
refuse to fall back to the CPU silently.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.models.transformer import build_decoder_lm as ref_build
from paddle_tpu.serving.generation import GenerationModel as RefModel
from paddle_tpu.serving.generation import GenerationSpec as RefSpec
from paddle_tpu_torch.core import ir as port_ir
from paddle_tpu_torch.models.transformer import build_decoder_lm
from paddle_tpu_torch.serving.generation import (GenerationModel,
                                                 GenerationSpec)

SPEC_KW = dict(vocab_size=50, max_seq_len=24, slots=2,
               prompt_buckets=(8, 16, 24), cache_buckets=(8, 16, 24),
               n_layer=1, n_head=2, d_model=16, d_inner=32, seed=7)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both():
    return ref_build(**SPEC_KW), build_decoder_lm(**SPEC_KW)


@pytest.mark.parametrize("mode", ["prefill", "decode", "full"])
def test_program_json_equal(both, mode):
    ref, port = both
    assert sorted(ref[mode]) == sorted(port[mode])
    for bucket in ref[mode]:
        r, p = ref[mode][bucket], port[mode][bucket]
        assert json.loads(r.main.desc.to_json()) == \
            json.loads(p.main.desc.to_json()), (mode, bucket)
        assert r.feed_names == p.feed_names
        assert r.fetch_name == p.fetch_name


def test_startup_json_equal(both):
    ref, port = both
    assert json.loads(ref["startup"].desc.to_json()) == \
        json.loads(port["startup"].desc.to_json())
    assert ref["cache_names"] == port["cache_names"]
    assert ref["spec"] == port["spec"]


def test_reference_json_runs_in_port():
    """The JAX package's serialized prefill + startup programs load with
    the port's from_json and compute the reference's next token and
    logits once the weights are carried over."""
    spec_kw = dict(SPEC_KW, eos_id=1)
    ref = RefModel.build(RefSpec(**spec_kw))
    lm = ref.programs["prefill"][16]
    main = port_ir.Program.from_json(lm.main.desc.to_json())
    startup = port_ir.Program.from_json(ref.programs["startup"].desc.to_json())
    exe = ptt.Executor(place="cpu")
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    ptt.load_param_arrays(scope, {
        n: np.asarray(ref.scope.get(n)) for n in scope.local_names()
        if not n.startswith("kv_cache.")})
    ids = np.zeros((1, 16, 1), np.int64)
    ids[0, :11, 0] = np.random.RandomState(0).randint(2, 50, 11)
    feed = {"token_ids": ids, "lengths": np.asarray([11], np.int64),
            "slot": np.asarray([1], np.int64)}
    fetch = [lm.fetch_name, "lm_head.tmp_1"]
    tok, logits = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    rtok, rlogits = ref.executor.run(lm.main, feed=feed, fetch_list=fetch,
                                     scope=ref.scope)
    assert tok.reshape(-1).tolist() == np.asarray(rtok).reshape(-1).tolist()
    np.testing.assert_allclose(logits, np.asarray(rlogits), rtol=1e-4,
                               atol=1e-5)


def test_entry_points_default_to_cuda_and_refuse_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        ptt.Executor()
    with pytest.raises(RuntimeError, match="cpu"):
        GenerationModel.build(GenerationSpec(**SPEC_KW))
    assert ptt.Executor(place="cpu").device.type == "cpu"
    assert ptt.Executor(place=ptt.CPUPlace()).device.type == "cpu"


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.serving.generation\n"
        "import paddle_tpu_torch.io\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
