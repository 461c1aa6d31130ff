"""The 23 op types of ``paddle_tpu/ops/sequence_ops.py`` that slice 17
ported, against paddle_tpu on the CPU.

Every case below is a small program of one op (two for the
flatten -> pool -> pack chain) over its own inputs, drawn from one
``numpy.random.RandomState`` each. All cases are built, by each
package's builder, into ONE program whose loss is the sum of each
float case's ``reduce_sum``, with the backward taken w.r.t. every float
input of those cases; the two programs must serialize to equal JSON
(build-time shape inference over level-1 and nested inputs included).
Each package then runs it once (paddle_tpu's executor compiles it once;
the port runs its compiled executor), and one parametrised test per
case holds its forward outputs and its inputs' gradients. The port's
eager executor runs it too, and must give the compiled one's values bit
for bit.

Tolerances: float32 outputs atol 1e-5; gradients atol 1e-5 * max|g| of
the reference's gradient (the same sums in another order); integer
outputs (the CTC decoders, sequence_erase, sequence_mask, sequence_pad's
lengths and every ragged output's LoD) exact.
"""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu.core.backward import append_backward as ref_append_backward
from paddle_tpu.core.lod import LoDTensor as RefLoDTensor
from paddle_tpu_torch import framework
from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.core.lod import LoDTensor

ATOL = 1e-5
GRAD_ATOL_FRAC = 1e-5

F32, I64 = "float32", "int64"


def _seqs(rng, lengths, feat, scale=1.0):
    return [(rng.randn(n, feat) * scale).astype(np.float32) for n in lengths]


def _ids(rng, lengths, hi, lo=0):
    return [rng.randint(lo, hi, (n, 1)).astype(np.int64) for n in lengths]


def _nested(rng, shape, feat):
    """shape[i] = the token counts of outer sequence i's sub-sequences."""
    return [[rng.randn(n, feat).astype(np.float32) for n in outer]
            for outer in shape]


# Each case: (id, inputs, ops, loss var, differentiable inputs, fetches).
# inputs: {name: (shape, dtype, lod_level, feed value)}; a lod_level 1
# value is a list of [len, feat] arrays, lod_level 2 a list of lists of
# them. ops: [(type, inputs, {slot: [(name, dtype)]}, attrs)]. Output
# dtypes are declared as the layer wrappers declare them.
def _cases():
    rng = np.random.RandomState(0)
    lens = [3, 5, 1, 4]
    cases = []

    def add(cid, inputs, ops, loss=None, wrt=(), fetch=()):
        cases.append((cid, inputs, ops, loss, tuple(wrt), tuple(fetch)))

    add("nested_flatten",
        {"x": ([-1, 3], F32, 2, _nested(rng, [[2, 3], [1], [4, 1, 2]], 3))},
        [("nested_sequence_flatten", {"X": ["x"]}, {"Out": [("o", F32)]},
          {})], "o", ["x"], ["o"])
    add("nested_pack",
        {"x": ([-1, 3], F32, 2, _nested(rng, [[2, 3], [1], [4, 1, 2]], 3))},
        [("nested_sequence_flatten", {"X": ["x"]}, {"Out": [("f", F32)]},
          {}),
         ("sequence_pool", {"X": ["f"]}, {"Out": [("p", F32)]},
          {"pooltype": "SUM"}),
         ("nested_sequence_pack", {"X": ["p"], "Ref": ["x"]},
          {"Out": [("o", F32)]}, {})], "o", ["x"], ["o"])
    # the loss squares the probabilities: their plain sum is 1 a row,
    # whose gradient is 0
    add("softmax", {"x": ([-1, 1], F32, 1, _seqs(rng, lens, 1))},
        [("sequence_softmax", {"X": ["x"]}, {"Out": [("o", F32)]}, {}),
         ("elementwise_mul", {"X": ["o"], "Y": ["o"]},
          {"Out": [("sq", F32)]}, {"axis": -1})],
        "sq", ["x"], ["o"])
    add("expand",
        {"x": ([-1, 3], F32, 0, rng.randn(4, 3).astype(np.float32)),
         "y": ([-1, 2], F32, 1, _seqs(rng, lens, 2))},
        [("sequence_expand", {"X": ["x"], "Y": ["y"]},
          {"Out": [("o", F32)]}, {"ref_level": -1})], "o", ["x"], ["o"])
    add("concat",
        {"a": ([-1, 3], F32, 1, _seqs(rng, lens, 3)),
         "b": ([-1, 3], F32, 1, _seqs(rng, [2, 0, 3, 1], 3))},
        [("sequence_concat", {"X": ["a", "b"]}, {"Out": [("o", F32)]},
          {})], "o", ["a", "b"], ["o"])
    add("reshape", {"x": ([-1, 4], F32, 1, _seqs(rng, [2, 3, 1, 4], 4))},
        [("sequence_reshape", {"X": ["x"]}, {"Out": [("o", F32)]},
          {"new_dim": 2})], "o", ["x"], ["o"])
    add("slice",
        {"x": ([-1, 3], F32, 1, _seqs(rng, [5, 4, 3, 5], 3)),
         "off": ([-1, 1], I64, 0, np.array([[1], [0], [2], [3]])),
         "len": ([-1, 1], I64, 0, np.array([[3], [4], [1], [2]]))},
        [("sequence_slice", {"X": ["x"], "Offset": ["off"],
                             "Length": ["len"]},
          {"Out": [("o", F32)]}, {})], "o", ["x"], ["o"])
    add("erase", {"x": ([-1, 1], I64, 1, _ids(rng, [6, 3, 0, 5], 6))},
        [("sequence_erase", {"X": ["x"]}, {"Out": [("o", I64)]},
          {"tokens": [2, 5]})], fetch=["o"])
    add("conv",
        {"x": ([-1, 4], F32, 1, _seqs(rng, lens, 4)),
         "w": ([12, 5], F32, 0, rng.randn(12, 5).astype(np.float32) * 0.3)},
        [("sequence_conv", {"X": ["x"], "Filter": ["w"]},
          {"Out": [("o", F32)]},
          {"contextLength": 3, "contextStart": -1, "contextStride": 1})],
        "o", ["x", "w"], ["o"])
    add("conv_ctx4",
        {"x": ([-1, 2], F32, 1, _seqs(rng, [4, 0, 2, 3], 2)),
         "w": ([8, 3], F32, 0, rng.randn(8, 3).astype(np.float32) * 0.3)},
        [("sequence_conv", {"X": ["x"], "Filter": ["w"]},
          {"Out": [("o", F32)]},
          {"contextLength": 4, "contextStart": -2, "contextStride": 1})],
        "o", ["x", "w"], ["o"])
    add("row_conv",
        {"x": ([-1, 4], F32, 1, _seqs(rng, lens, 4)),
         "w": ([3, 4], F32, 0, rng.randn(3, 4).astype(np.float32) * 0.5)},
        [("row_conv", {"X": ["x"], "Filter": ["w"]}, {"Out": [("o", F32)]},
          {})], "o", ["x", "w"], ["o"])
    add("mask", {"x": ([-1], I64, 0, np.array([3, 0, 6, 1]))},
        [("sequence_mask", {"X": ["x"]}, {"Y": [("o", F32)]},
          {"maxlen": 6})], fetch=["o"])
    add("pad", {"x": ([-1, 3], F32, 1, _seqs(rng, lens, 3))},
        [("sequence_pad", {"X": ["x"]},
          {"Out": [("o", F32)], "Length": [("n", I64)]}, {})],
        "o", ["x"], ["o", "n"])
    add("unpad",
        {"x": ([-1, 5, 3], F32, 0, rng.randn(4, 5, 3).astype(np.float32)),
         "n": ([-1], I64, 0, np.array([5, 2, 0, 3]))},
        [("sequence_unpad", {"X": ["x"], "Length": ["n"]},
          {"Out": [("o", F32)]}, {})], "o", ["x"], ["o"])
    add("last_step", {"x": ([-1, 3], F32, 1, _seqs(rng, [3, 0, 5, 1], 3))},
        [("sequence_last_step", {"X": ["x"]}, {"Out": [("o", F32)]}, {})],
        "o", ["x"], ["o"])
    add("first_step", {"x": ([-1, 3], F32, 1, _seqs(rng, lens, 3))},
        [("sequence_first_step", {"X": ["x"]}, {"Out": [("o", F32)]},
          {})], "o", ["x"], ["o"])
    add("last_step_nested",
        {"x": ([-1, 3], F32, 2, _nested(rng, [[2, 3], [4], [1, 1, 2]], 3))},
        [("sequence_last_step", {"X": ["x"]}, {"Out": [("o", F32)]}, {})],
        "o", ["x"], ["o"])
    add("first_step_nested",
        {"x": ([-1, 3], F32, 2, _nested(rng, [[2], [3, 1], [1, 4]], 3))},
        [("sequence_first_step", {"X": ["x"]}, {"Out": [("o", F32)]}, {})],
        "o", ["x"], ["o"])
    for norm in (False, True):
        add(f"warpctc{'_norm' if norm else ''}",
            {"x": ([-1, 5], F32, 1, _seqs(rng, [6, 4, 7, 3], 5)),
             "lab": ([-1, 1], I64, 1, [np.array([[1], [2], [2]]),
                                      np.array([[3]]),
                                      np.array([[4], [1], [4], [1]]),
                                      np.zeros((0, 1), np.int64)])},
            [("warpctc", {"Logits": ["x"], "Label": ["lab"]},
              {"Loss": [("o", F32)]}, {"blank": 0, "norm_by_times": norm})],
            "o", ["x"], ["o"])
    add("ctc_greedy",
        {"x": ([-1, 4], F32, 1, _seqs(rng, [8, 5, 0, 7], 4))},
        [("ctc_greedy_decoder", {"Input": ["x"]},
          {"Out": [("o", "int32")]}, {"blank": 0})], fetch=["o"])
    for merge in (True, False):
        add(f"ctc_align{'' if merge else '_nomerge'}",
            {"x": ([-1, 1], I64, 1, [np.array([[1], [1], [0], [2], [2], [0],
                                               [3]]),
                                     np.array([[0], [0]]),
                                     np.array([[4], [4], [4]]),
                                     np.zeros((0, 1), np.int64)])},
            [("ctc_align", {"Input": ["x"]}, {"Output": [("o", "int32")]},
              {"blank": 0, "merge_repeated": merge})], fetch=["o"])
    d = 3
    add("lstm_unit",
        {"x": ([-1, 4 * d], F32, 0, rng.randn(4, 4 * d).astype(np.float32)),
         "c": ([-1, d], F32, 0, rng.randn(4, d).astype(np.float32))},
        [("lstm_unit", {"X": ["x"], "C_prev": ["c"]},
          {"C": [("oc", F32)], "H": [("o", F32)]}, {"forget_bias": 0.5})],
        "o", ["x", "c"], ["o", "oc"])
    add("gru_unit",
        {"x": ([-1, 3 * d], F32, 0, rng.randn(4, 3 * d).astype(np.float32)),
         "h": ([-1, d], F32, 0, rng.randn(4, d).astype(np.float32)),
         "w": ([d, 3 * d], F32, 0,
               rng.randn(d, 3 * d).astype(np.float32) * 0.5),
         "b": ([1, 3 * d], F32, 0,
               rng.randn(1, 3 * d).astype(np.float32) * 0.2)},
        [("gru_unit", {"Input": ["x"], "HiddenPrev": ["h"], "Weight": ["w"],
                       "Bias": ["b"]},
          {"Gate": [("g", F32)], "ResetHiddenPrev": [("r", F32)],
           "Hidden": [("o", F32)]},
          {"activation": "tanh", "gate_activation": "sigmoid"})],
        "o", ["x", "h", "w", "b"], ["o", "g", "r"])
    p = 2
    for peep in (False, True):
        nb = (7 if peep else 4) * d
        add(f"lstmp{'_peep' if peep else ''}",
            {"x": ([-1, 4 * d], F32, 1, _seqs(rng, [3, 0, 4, 2], 4 * d, 0.5)),
             "w": ([p, 4 * d], F32, 0,
                   rng.randn(p, 4 * d).astype(np.float32) * 0.4),
             "pw": ([d, p], F32, 0, rng.randn(d, p).astype(np.float32) * 0.4),
             "b": ([1, nb], F32, 0, rng.randn(1, nb).astype(np.float32) * 0.2)},
            [("lstmp", {"Input": ["x"], "Weight": ["w"], "ProjWeight": ["pw"],
                        "Bias": ["b"]},
              {"Projection": [("o", F32)], "Cell": [("cell", F32)],
               "LastH": [("lh", F32)], "LastC": [("lc", F32)]},
              {"gate_activation": "sigmoid", "cell_activation": "tanh",
               "candidate_activation": "tanh", "proj_activation": "tanh",
               "use_peepholes": peep, "is_reverse": False})],
            "o", ["x", "w", "pw", "b"], ["o", "cell", "lh", "lc"])
    add("reverse", {"x": ([-1, 3], F32, 1, _seqs(rng, [3, 0, 5, 1], 3))},
        [("sequence_reverse", {"X": ["x"]}, {"Y": [("o", F32)]}, {})],
        "o", ["x"], ["o"])
    e = 4
    add("multihead",
        {"q": ([-1, e], F32, 1, _seqs(rng, [3, 5, 1], e)),
         "k": ([-1, e], F32, 1, _seqs(rng, [4, 2, 6], e)),
         **{n: ([e, e], F32, 0, rng.randn(e, e).astype(np.float32) * 0.5)
            for n in ("wq", "wk", "wv", "wo")}},
        [("multihead_seq_attention",
          {"Q": ["q"], "K": ["k"], "V": ["k"], "WQ": ["wq"], "WK": ["wk"],
           "WV": ["wv"], "WO": ["wo"]},
          {"Out": [("o", F32)]}, {"num_heads": 2})],
        "o", ["q", "k", "wq", "wk", "wv", "wo"], ["o"])
    return cases


CASES = _cases()
CASE_IDS = [c[0] for c in CASES]
PORTED = ("nested_sequence_flatten", "nested_sequence_pack",
          "sequence_softmax", "sequence_expand", "sequence_concat",
          "sequence_reshape", "sequence_slice", "sequence_erase",
          "sequence_conv", "row_conv", "sequence_mask", "sequence_pad",
          "sequence_unpad", "sequence_last_step", "sequence_first_step",
          "warpctc", "ctc_greedy_decoder", "ctc_align", "lstm_unit",
          "gru_unit", "lstmp", "sequence_reverse",
          "multihead_seq_attention")


def _name(cid, n):
    return f"{cid}.{n}"


def _build(fw, backward):
    """Every case in one program of package framework `fw`: its inputs,
    ops and per-case totals; the backward of their sum."""
    main = fw.Program()
    wrt, totals = [], []
    with fw.isolated_name_scope():
        blk = main.global_block()
        for cid, inputs, ops, loss, case_wrt, _ in CASES:
            for n, (shape, dtype, lod_level, _) in inputs.items():
                blk.create_var(name=_name(cid, n), shape=shape, dtype=dtype,
                               lod_level=lod_level,
                               stop_gradient=n not in case_wrt)
            for op_type, ins, outs, attrs in ops:
                for slot in outs.values():
                    for n, dtype in slot:
                        blk.create_var(name=_name(cid, n), dtype=dtype)
                blk.append_op(
                    op_type,
                    {s: [_name(cid, n) for n in v] for s, v in ins.items()},
                    {s: [_name(cid, n) for n, _ in v]
                     for s, v in outs.items()}, dict(attrs))
            if loss is not None:
                total = _name(cid, "total")
                blk.create_var(name=total, dtype=F32)
                blk.append_op("reduce_sum", {"X": [_name(cid, loss)]},
                              {"Out": [total]},
                              {"dim": None, "keep_dim": False,
                               "reduce_all": True})
                totals.append(total)
                wrt.extend(_name(cid, n) for n in case_wrt)
        total = blk.create_var(name="total", dtype=F32)
        blk.append_op("sum", {"X": totals}, {"Out": ["total"]}, {})
        backward(total, parameter_list=wrt)
    return main, wrt


def _feed(lod_cls):
    feed = {}
    for cid, inputs, _, _, _, _ in CASES:
        for n, (_, _, lod_level, value) in inputs.items():
            if lod_level == 1:
                value = lod_cls.from_sequences(value)
            elif lod_level == 2:
                value = lod_cls.from_nested_sequences(value)
            feed[_name(cid, n)] = value
    return feed


def _fetch_names(wrt):
    names = [_name(c[0], n) for c in CASES for n in c[5]]
    return names + [n + "@GRAD" for n in wrt]


@pytest.fixture(scope="module")
def runs():
    ref_main, ref_wrt = _build(ref_framework, ref_append_backward)
    port_main, port_wrt = _build(framework, append_backward)
    assert ref_wrt == port_wrt
    fetch = _fetch_names(port_wrt)
    ref = pt.Executor().run(ref_main, feed=_feed(RefLoDTensor),
                            fetch_list=fetch, scope=pt.Scope())
    out = {"json": (json.loads(ref_main.desc.to_json()),
                    json.loads(port_main.desc.to_json())),
           "ref": dict(zip(fetch, ref)), "port_main": port_main}
    for label, compiled in (("port", True), ("eager", False)):
        exe = ptt.Executor(place="cpu", compiled=compiled)
        got = exe.run(port_main, feed=_feed(LoDTensor), fetch_list=fetch,
                      scope=ptt.Scope())
        out[label] = dict(zip(fetch, got))
    return out


def _host(v):
    if hasattr(v, "lod"):
        return np.asarray(v.data), v.lod
    return np.asarray(v), None


def test_programs_serialize_equal_and_register_every_op(runs):
    ref_json, port_json = runs["json"]
    assert ref_json == port_json
    types = {op["type"] for op in port_json["blocks"][0]["ops"]}
    assert set(PORTED) <= types
    from paddle_tpu.core.registry import OpRegistry as RefRegistry
    from paddle_tpu_torch.core.registry import OpRegistry
    for op_type in PORTED:
        assert OpRegistry.get(op_type).no_grad_slots == \
            RefRegistry.get(op_type).no_grad_slots, op_type
    # 118 with matmul and se_block (the analysis slice), lrn (the image
    # models) and cos_sim, linear_chain_crf and crf_decoding (the book's
    # last chapters)
    assert len(OpRegistry._ops) == 118


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_op_matches_reference(runs, case):
    """Forward outputs (their LoD too) and the gradients of the case's
    float inputs, port against paddle_tpu; the eager arm bit for bit
    against the compiled one."""
    cid, inputs, _, _, wrt, fetch = case
    ref, got, eager = runs["ref"], runs["port"], runs["eager"]
    for n in fetch:
        name = _name(cid, n)
        (gd, gl), (wd, wl) = _host(got[name]), _host(ref[name])
        assert gl == wl, f"{name}: lod {gl} vs {wl}"
        assert gd.shape == wd.shape, f"{name}: {gd.shape} vs {wd.shape}"
        if np.issubdtype(wd.dtype, np.integer):
            np.testing.assert_array_equal(gd, wd, err_msg=name)
        else:
            np.testing.assert_allclose(gd, wd, rtol=0, atol=ATOL,
                                       err_msg=name)
        ed, el = _host(eager[name])
        assert el == gl and np.array_equal(ed, gd), f"{name}: eager arm"
    for n in wrt:
        name = _name(cid, n) + "@GRAD"
        (gd, gl), (wd, wl) = _host(got[name]), _host(ref[name])
        assert gl == wl, f"{name}: lod {gl} vs {wl}"
        scale = max(float(np.abs(wd).max()), 1e-30)
        assert np.abs(wd).max() > 0, f"{name}: the reference's is all 0"
        np.testing.assert_allclose(gd, wd, rtol=0,
                                   atol=GRAD_ATOL_FRAC * scale, err_msg=name)
        ed, _ = _host(eager[name])
        assert np.array_equal(ed, gd), f"{name}: eager arm"
