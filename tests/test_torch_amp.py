"""paddle_tpu_torch's bf16 automatic mixed precision against paddle_tpu's.

- The ``amp`` API: PADDLE_TPU_AMP=1 at import, ``enable``, nested
  ``amp_guard``s, and ``amp_cast`` leaving int, bool, float64 and bf16
  tensors alone.
- The cast sites, each as a small program run in both executors under
  AMP on the same numpy inputs: ``mul`` (bf16 operands, float32 sums, a
  bf16 result), a mixed bf16/float32 elementwise pair (bf16 wins) and
  ``conv2d`` (bf16 in, bf16 out): output dtypes equal, values within one
  bf16 ulp.
- The compile key: one program run under ``amp_guard`` and outside it is
  two keys, and the executor's cache hits and misses over a run sequence
  equal the reference's.
- Three train programs under AMP, 3 steps each from the port's startup
  values carried into the reference: MNIST conv (Adam) at batch 8, a
  small ResNet (``resnet_cifar10`` at depth 8, widths 16/32/64, 3x16x16,
  Momentum) at batch 4, and the Transformer NMT at 1+1 layers, d32, S16
  with ``use_flash=True`` stamped (the reference interprets its Pallas
  kernels in bf16, the port runs their plain twins). Every variable the
  forward produces has the reference's dtype (int32 and int64 count as
  one: JAX runs with 64-bit types off), and the port sits much closer to
  the reference's AMP run than that run sits to the reference's float32
  run on the same feeds: each quantity's distance (2-norm) from the
  reference is at most AMP_FRACTION = 0.25 of the reference's own
  AMP-to-float32 distance for it. Quantities: at step 1 every forward
  value and every parameter's gradient, and all gradients as one
  vector; after 3 steps the losses and the parameters, each as one
  vector. So the port reproduces the AMP rounding, not float32.

Two things of XLA's are not the op rules' rounding. XLA keeps the
float32 result of a bf16 elementwise op unrounded inside a fusion (its
allow_excess_precision option), where the port stores every op's result
in bf16: the reference's programs here are compiled with that option
off (``_rounding_reference``), so both round each op's bf16 output as
the op rules write it. And XLA's CPU backend sums a bias's gradient, a
bf16 cotangent reduced over the broadcast dims, in bf16 one element at
a time, where the port (torch, and cuBLAS on the card) sums in float32:
a bias gradient alone sits at 0.1-0.9 of the AMP-to-float32 distance
(measured on the CPU), so the bias gradients are held within the vector
of all gradients (<= 0.05 measured) and not one by one. The ResNet's
batch_norms at batch 4 turn a single bf16 rounding flip (an output on a
rounding boundary, which the two packages' convolutions sum in another
order) into an O(AMP) difference downstream; from the reference's own
startup values one such flip in the first convolution moved the step-1
loss by 3.7x the AMP-to-float32 distance, and from the port's none
occurs (the losses agree exactly).
"""
import contextlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compiler as jax_compiler

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import framework as ref_framework
from paddle_tpu import layers as ref_layers
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.models import mnist as ref_mnist
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu.models import transformer as ref_transformer
from paddle_tpu_torch import amp, framework, layers
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.models import mnist, resnet, transformer
from test_torch_conv import PORT, REF, _program
from test_torch_training import KW as NMT_KW, _feed as nmt_feed, \
    _stamp_flash

AMP_FRACTION = 0.25
STEPS = 3
# numpy has no bfloat16: the dtype names both packages' values carry
_TORCH_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.float64: "float64", torch.int64: "int64",
                torch.int32: "int32", torch.bool: "bool"}


@pytest.fixture(autouse=True)
def _amp_off():
    """Every test starts and ends with AMP off in both packages."""
    pt.amp.enable(False)
    amp.enable(False)
    yield
    pt.amp.enable(False)
    amp.enable(False)


@contextlib.contextmanager
def _rounding_reference():
    """The reference's compiles inside round each bf16 op's result: XLA's
    allow_excess_precision off (see the module docstring)."""
    orig = jax_compiler.get_compile_options

    def get_compile_options(*args, **kwargs):
        env = dict(kwargs.get("env_options_overrides") or {})
        env["xla_allow_excess_precision"] = False
        kwargs["env_options_overrides"] = env
        return orig(*args, **kwargs)

    jax_compiler.get_compile_options = get_compile_options
    try:
        yield
    finally:
        jax_compiler.get_compile_options = orig


def _dtype_name(v):
    """The dtype's name; "int" for int32 and int64 alike (JAX runs with
    64-bit types off: the reference's int64 is int32)."""
    if isinstance(v, torch.Tensor):
        name = _TORCH_NAMES[v.dtype]
    else:
        name = str(getattr(v, "dtype", np.asarray(v).dtype))
    return "int" if name in ("int32", "int64") else name


def _f64(v):
    if isinstance(v, torch.Tensor):
        return v.detach().double().numpy()
    return np.asarray(np.asarray(v).astype(np.float32), np.float64)


# -- the amp API --------------------------------------------------------------

def test_env_switch_is_read_at_import(monkeypatch):
    try:
        monkeypatch.setenv("PADDLE_TPU_AMP", "1")
        assert importlib.reload(amp).amp_enabled()
        monkeypatch.setenv("PADDLE_TPU_AMP", "0")
        assert not importlib.reload(amp).amp_enabled()
    finally:
        monkeypatch.delenv("PADDLE_TPU_AMP")
        importlib.reload(amp)
    assert not amp.amp_enabled()
    assert ptt.flags.get("PADDLE_TPU_AMP") == "0"


def test_enable_and_nested_guards():
    assert not amp.amp_enabled()
    amp.enable()
    assert amp.amp_enabled()
    with amp.amp_guard(False):
        assert not amp.amp_enabled()
        with amp.amp_guard():
            assert amp.amp_enabled()
        assert not amp.amp_enabled()
    assert amp.amp_enabled()
    amp.enable(False)
    with pytest.raises(RuntimeError):
        with amp.amp_guard():
            raise RuntimeError("inside")
    assert not amp.amp_enabled()


def test_amp_cast_downcasts_only_float32():
    f32 = torch.ones(2, dtype=torch.float32)
    others = [torch.ones(2, dtype=dt) for dt in (
        torch.int64, torch.int32, torch.bool, torch.float64,
        torch.bfloat16)]
    assert amp.amp_cast(f32) is f32
    with amp.amp_guard():
        assert amp.amp_cast(f32).dtype == torch.bfloat16
        out = amp.amp_cast(f32, *others)
        assert out[0].dtype == torch.bfloat16
        assert all(o is t for o, t in zip(out[1:], others))


# -- the cast sites -----------------------------------------------------------

def _bf16_ulp(x):
    """One bf16 ulp at |x| (float64; the smallest normal's below it)."""
    ax = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(ax)) - 7)


def test_cast_sites_match_reference():
    """mul, a mixed bf16/float32 elementwise add and conv2d (with its
    strided 1x1 rewrite) under AMP: dtypes equal, values within one bf16
    ulp of the reference's."""
    rng = np.random.RandomState(0)
    vars_ = {"x": ([3, 4, 16], "float32", True, False),
             "w": ([16, 8], "float32", True, False),
             "b": ([8], "float32", True, False),
             "img": ([2, 3, 9, 9], "float32", True, False),
             "f": ([5, 3, 3, 3], "float32", True, False),
             "f1": ([4, 3, 1, 1], "float32", True, False)}
    ops = [("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["xw"]},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}),
           ("elementwise_add", {"X": ["xw"], "Y": ["b"]}, {"Out": ["xwb"]},
            {"axis": -1}),
           ("elementwise_mul", {"X": ["b"], "Y": ["b"]}, {"Out": ["bb"]},
            {"axis": -1}),
           ("conv2d", {"Input": ["img"], "Filter": ["f"]}, {"Output": ["y"]},
            dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1],
                 groups=1)),
           ("conv2d", {"Input": ["img"], "Filter": ["f1"]},
            {"Output": ["y1"]}, dict(strides=[2, 2], paddings=[0, 0],
                                     dilations=[1, 1], groups=1))]
    feed = {n: rng.randn(*shape).astype(np.float32)
            for n, (shape, _, _, _) in vars_.items()}
    fetch = ["xw", "xwb", "bb", "y", "y1"]
    want_dtypes = ["bfloat16", "bfloat16", "float32", "bfloat16", "bfloat16"]
    mains = [_program(pkg, vars_, ops) for pkg in (REF, PORT)]
    with pt.amp.amp_guard(), amp.amp_guard():
        ref = pt.Executor().run(mains[0], feed=feed, fetch_list=fetch,
                                scope=pt.Scope(), return_numpy=False)
        got = ptt.Executor(place="cpu").run(mains[1], feed=feed,
                                            fetch_list=fetch,
                                            scope=ptt.Scope(),
                                            return_numpy=False)
    for name, r, g, want in zip(fetch, ref, got, want_dtypes):
        assert _dtype_name(r) == _dtype_name(g) == want, name
        r, g = _f64(r), _f64(g)
        assert g.shape == r.shape, name
        assert np.all(np.abs(g - r) <= _bf16_ulp(r)), name


# -- the compile key ------------------------------------------------------------

def test_compile_key_carries_the_amp_flag():
    """One program, run outside, inside, inside, outside and inside an
    amp_guard: two keys, and the cache's hits and misses equal the
    reference executor's; the key under the guard says amp."""
    vars_ = {"x": ([2, 4], "float32", True, False),
             "w": ([4, 3], "float32", True, False)}
    ops = [("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["y"]}, {})]
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(2, 4).astype(np.float32),
            "w": rng.randn(4, 3).astype(np.float32)}
    mains = [_program(pkg, vars_, ops) for pkg in (REF, PORT)]
    exes = [pt.Executor(), ptt.Executor(place="cpu")]
    dtypes = []
    for on in (False, True, True, False, True):
        with pt.amp.amp_guard(on), amp.amp_guard(on):
            for exe, main, mod in zip(exes, mains, (pt, ptt)):
                out = exe.run(main, feed=feed, fetch_list=["y"],
                              scope=mod.Scope(), return_numpy=False)
            dtypes.append(_dtype_name(out[0]))
    assert exes[1].cache_stats == exes[0].cache_stats == \
        {"hits": 3, "misses": 2}
    assert dtypes == ["float32", "bfloat16", "bfloat16", "float32",
                      "bfloat16"]
    assert len(exes[1]._cache) == 2
    sig = (("x", (2, 4), "float32"),)
    with amp.amp_guard():
        on = ptt.Executor.compile_key(mains[1], sig, ["y"])
    off = ptt.Executor.compile_key(mains[1], sig, ["y"])
    assert on != off and on[5] is True and off[5] is False
    assert ptt.Executor.compile_key(mains[1], sig, ["y"], amp=True) == on


# -- train programs ---------------------------------------------------------------

def _small_resnet(fw, lay, optim, res):
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup):
        img = lay.data("img", [3, 16, 16], dtype="float32")
        label = lay.data("label", [1], dtype="int64")
        pred = res.resnet_cifar10(img, class_dim=10, depth=8)
        loss = lay.mean(lay.cross_entropy(input=pred, label=label))
        optim.MomentumOptimizer(learning_rate=0.01,
                                momentum=0.9).minimize(loss)
    return main, startup, loss


def _build(name):
    """Both packages' (main, startup, loss) of `name`, built from a
    snapshot count of 0 (see test_torch_conv_models._build)."""
    from test_torch_conv_models import _BACKWARDS
    saved = [m._SNAP_COUNTER[0] for m in _BACKWARDS]
    for m in _BACKWARDS:
        m._SNAP_COUNTER[0] = 0
    out = []
    try:
        for fw, lay, optim, mn, res, tr in (
                (ref_framework, ref_layers, ref_opt, ref_mnist, ref_resnet,
                 ref_transformer),
                (framework, layers, opt, mnist, resnet, transformer)):
            with fw.isolated_name_scope():
                if name == "mnist_conv":
                    main, startup, f = mn.build_train(net="conv")
                    out.append((main, startup, f["loss"]))
                elif name == "small_resnet":
                    out.append(_small_resnet(fw, lay, optim, res))
                else:
                    main, startup, f = tr.build_train(**NMT_KW)
                    _stamp_flash(main)
                    out.append((main, startup, f["loss"]))
    finally:
        for m, n in zip(_BACKWARDS, saved):
            m._SNAP_COUNTER[0] = n
    return out


def _feeds(name):
    rng = np.random.RandomState(0)
    if name == "mnist_conv":
        return [{"img": rng.rand(8, 1, 28, 28).astype(np.float32),
                 "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
                ] * STEPS
    if name == "small_resnet":
        return [{"img": rng.rand(4, 3, 16, 16).astype(np.float32),
                 "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
                for _ in range(STEPS)]
    return [nmt_feed()] * STEPS


def _forward_vars(main):
    """Every variable the forward ops produce (up to the first __vjp__)."""
    out = []
    for op in main.desc.global_block.ops:
        if op.type == "__vjp__":
            break
        out += [n for n in op.output_names() if n not in out]
    return out


def _arm(pkg, built, init, feeds, on):
    """STEPS steps of `built` (main, startup, loss) in `pkg` from the
    values `init`, AMP on or off: {"losses", "params" (final), "dtypes"
    (the dtype name of every forward variable at step 1), "step1" (every
    forward value and parameter gradient at step 1)}."""
    mod = pkg[0]
    main, startup, loss = built
    exe = mod.Executor() if mod is pt else mod.Executor(place="cpu")
    scope = mod.Scope()
    if mod is pt:   # `init` holds every value the startup program makes
        for n, v in init.items():
            scope.set(n, jnp.asarray(v))
    else:
        exe.run(startup, scope=scope)
        ptt.load_param_arrays(scope, init)
    fwd = _forward_vars(main)
    params = [p.name for p in main.all_parameters()]
    fetch = [loss.name] + fwd + [p + "@GRAD" for p in params]
    out = {"losses": []}
    with pt.amp.amp_guard(on), amp.amp_guard(on):
        for step, feed in enumerate(feeds):
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            out["losses"].append(float(_f64(got[0]).reshape(-1)[0]))
            if step == 0:
                out["dtypes"] = {n: _dtype_name(v)
                                 for n, v in zip(fwd, got[1:])}
                out["step1"] = {n: _f64(v) for n, v in zip(fetch, got)
                                if _dtype_name(v) in ("float32",
                                                      "bfloat16")}
    out["params"] = {p: _f64(scope.get(p)) for p in params}
    return out


PROGRAMS = ["mnist_conv", "small_resnet", "nmt_flash"]


def _biases(main):
    """The parameters that enter a program as the broadcast operand of
    an elementwise op (the fc and conv biases)."""
    params = {p.name for p in main.all_parameters()}
    return {op.input("Y")[0] for op in main.desc.global_block.ops
            if op.type.startswith("elementwise_")
            and op.input("Y")[0] in params}


@pytest.fixture(scope="module")
def trained():
    """Per program, from the port's startup values (carried into the
    reference) on the same feeds: the reference's AMP and float32 runs
    and the port's AMP run."""
    out = {}
    for name in PROGRAMS:
        ref, port = _build(name)
        scope = ptt.Scope()
        ptt.Executor(place="cpu").run(port[1], scope=scope)
        init = {n: scope.get(n).numpy() for n in scope.local_names()}
        feeds = _feeds(name)
        with _rounding_reference():
            out[name] = {"ref_amp": _arm(REF, ref, init, feeds, True),
                         "ref_f32": _arm(REF, ref, init, feeds, False)}
        out[name]["port_amp"] = _arm(PORT, port, init, feeds, True)
        out[name]["biases"] = _biases(port[0])
    return out


@pytest.mark.parametrize("name", PROGRAMS)
def test_forward_dtypes_match_reference(trained, name):
    ref = trained[name]["ref_amp"]["dtypes"]
    assert trained[name]["port_amp"]["dtypes"] == ref
    assert "bfloat16" in ref.values()
    # float32 outside AMP: no bf16 value anywhere
    assert "bfloat16" not in trained[name]["ref_f32"]["dtypes"].values()


def _far(pairs):
    """The quantities whose port distance exceeds AMP_FRACTION of the
    reference's AMP-to-float32 distance: {q: (distance, that, ratio)}."""
    return {q: (d, lim, d / lim) for q, (d, lim) in pairs.items()
            if not d <= AMP_FRACTION * lim}


def _gap(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)))


def _flat(values, names):
    return np.concatenate([values[n].ravel() for n in names])


@pytest.mark.parametrize("name", PROGRAMS)
def test_step1_reproduces_the_amp_rounding(trained, name):
    """Every forward value (the loss included) and every parameter's
    gradient at step 1, each by 2-norm, against the reference's AMP run,
    at AMP_FRACTION of that run's distance from its float32 run. The bias
    gradients, which the reference's CPU backend sums in bf16 one element
    at a time (the port in float32), are held together with every other
    gradient, as one vector."""
    runs = trained[name]
    ref, f32 = runs["ref_amp"]["step1"], runs["ref_f32"]["step1"]
    port = runs["port_amp"]["step1"]
    skip = {b + "@GRAD" for b in runs["biases"]}
    checked = [n for n in ref if n not in skip and n.endswith("@GRAD")
               or n in runs["ref_amp"]["dtypes"]]
    pairs = {n: (_gap(port[n], ref[n]), _gap(ref[n], f32[n]))
             for n in checked if _gap(ref[n], f32[n]) > 0}
    grads = [p + "@GRAD" for p in sorted(runs["ref_amp"]["params"])]
    pairs["every gradient"] = (
        _gap(_flat(port, grads), _flat(ref, grads)),
        _gap(_flat(ref, grads), _flat(f32, grads)))
    assert len(pairs) > 10
    assert not _far(pairs), f"{name}: {_far(pairs)}"


@pytest.mark.parametrize("name", PROGRAMS)
def test_three_steps_reproduce_the_amp_rounding(trained, name):
    """The three losses and the final parameters, each set as one vector,
    by 2-norm, at AMP_FRACTION of the reference's AMP-to-float32
    distance."""
    runs = trained[name]
    port, ref, f32 = (runs[k] for k in ("port_amp", "ref_amp", "ref_f32"))
    assert all(np.isfinite(port["losses"]))
    names = sorted(ref["params"])
    pairs = {"losses": (_gap(port["losses"], ref["losses"]),
                        _gap(ref["losses"], f32["losses"])),
             "parameters": (_gap(_flat(port["params"], names),
                                 _flat(ref["params"], names)),
                            _gap(_flat(ref["params"], names),
                                 _flat(f32["params"], names)))}
    assert not _far(pairs), f"{name}: {_far(pairs)}"
