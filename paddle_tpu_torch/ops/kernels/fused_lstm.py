"""Fused LSTM time loop: the hand-written CUDA kernels and their plain twins.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas/fused_lstm.py``:

  ``fused_lstm_fwd``   ``_run_fwd`` / ``_fwd_kernel``   (csrc/fused_lstm.cu)
  ``fused_lstm_bwd``   ``_fused_lstm_bwd`` / ``_bwd_kernel``

Layout, as the reference's: x [T, B, 4H] pre-projected gates, time-major,
gate order i, c_hat, f, o; w [H, 4H]; b [4H]; h0, c0 [B, H]; lengths [B]
int32. A row freezes past its length and its h_all/c_all there are 0;
h_last/c_last are the state at length-1 (h0/c0 for a zero-length row).
Each C call runs its recurrence as one persistent cooperative launch (W's
column strips resident in shared memory, one grid barrier a step, the
products in 3xTF32 on the tensor cores); the CUDA source's header says
what bounds the kernels on an H100 and how the design answers that.
``FusedLSTM`` is the torch.autograd.Function over the pair, the
counterpart of the reference's ``jax.custom_vjp``, and ``fused_lstm``
applies it.

Dtypes, as the Pallas kernels take them: the streams x, h_all, c_all (and
backward dh_all, dc_all, dx) are all float32 or all bfloat16; w, b, h0 and
c0 each float32 or bfloat16. Every value is widened to float32 at load,
the state and every product and sum stay float32, and each output is
rounded to its dtype at store: h_all, c_all, h_last, c_last and dx to the
streams', dw, db, dh0, dc0 to w's, b's, h0's, c0's (dW and db summed from
the float32 dgates). The twins do the same in torch; the wrappers give the
CUDA kernels the small tensors in float32 and round their results.

Every wrapper takes its kernel for CUDA tensors — there is no fallback:
a CUDA input the kernel cannot take raises, and so does a failed build or
launch — its plain torch twin for CPU tensors, and a shape-only path for
tensors on the "meta" device (build-time shape inference), which would
otherwise trace the twin's time loop.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

_SOURCE = "fused_lstm.cu"


# -- plain twins ------------------------------------------------------------

def _gates(x_t, h_prev, w, b, hidden):
    """The four activated gates of one step, in the kernels' order:
    (x_t + h_prev w) + b, then sigmoid/tanh/sigmoid/sigmoid."""
    g = (x_t + h_prev @ w) + b
    return (torch.sigmoid(g[:, :hidden]), torch.tanh(g[:, hidden:2 * hidden]),
            torch.sigmoid(g[:, 2 * hidden:3 * hidden]),
            torch.sigmoid(g[:, 3 * hidden:]))


def _alive(lengths, t_max):
    """[T, B, 1] bool: step t lies inside row b's length."""
    t = torch.arange(t_max, device=lengths.device, dtype=torch.int32)
    return (t[:, None] < lengths[None, :])[..., None]


def _f32(*tensors):
    """The tensors with bf16 widened to float32 (exact); other dtypes as
    they are (a float64 twin stays an oracle in float64)."""
    return [t.float() if t.dtype == torch.bfloat16 else t for t in tensors]


def fused_lstm_fwd_plain(x, w, b, h0, c0, lengths):
    """A torch loop over t with the forward kernel's arithmetic:
    (h_all, c_all [T,B,H], h_last, c_last [B,H]), in float32 from the
    widened inputs, each output rounded to x's dtype."""
    t_max, hidden, dtype = x.shape[0], w.shape[0], x.dtype
    alive = _alive(lengths, t_max)
    x, w, b, h, c = _f32(x, w, b, h0, c0)
    h_all, c_all = [], []
    for t in range(t_max):
        i, cand, f, o = _gates(x[t], h, w, b, hidden)
        c_new = f * c + i * cand
        h_new = o * torch.tanh(c_new)
        h_all.append(torch.where(alive[t], h_new, torch.zeros_like(h_new)))
        c_all.append(torch.where(alive[t], c_new, torch.zeros_like(c_new)))
        h = torch.where(alive[t], h_new, h)
        c = torch.where(alive[t], c_new, c)
    return tuple(v.to(dtype) for v in (torch.stack(h_all), torch.stack(c_all),
                                       h, c))


def fold_last(dh_all, dc_all, dh_last, dc_last, lengths):
    """Add the h_last/c_last cotangents into the per-step streams at
    max(len-1, 0), in the streams' dtype (a bf16 add rounds as the
    reference's .at[].add does), as the reference's _fused_lstm_bwd does;
    a None cotangent is zero."""
    idx = torch.clamp(lengths.long() - 1, min=0)
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    out = []
    for stream, last in ((dh_all, dh_last), (dc_all, dc_last)):
        stream = stream.clone()
        if last is not None:
            stream[idx, rows] = stream[idx, rows] + last.to(stream.dtype)
        out.append(stream)
    return out[0], out[1]


def fused_lstm_bwd_plain(x, w, b, h0, c0, lengths, h_all, c_all, dh_all,
                         dc_all, dh_last=None, dc_last=None):
    """A reverse torch loop with the backward kernels' arithmetic:
    (dx [T,B,4H], dw [H,4H], db [4H], dh0, dc0 [B,H]). It recomputes the
    gates from (x_t, h_{t-1}) with h_{t-1} and c_{t-1} read from the
    stored (rounded) h_all and c_all, takes dh_prev = dgates w^T per step,
    and sums dw and db over all T*B rows of the float32 dgates after the
    loop, as the kernels do; all in float32, each result rounded to its
    input's dtype. A None cotangent is zero."""
    dh_all = torch.zeros_like(h_all) if dh_all is None else dh_all
    dc_all = torch.zeros_like(c_all) if dc_all is None else dc_all
    dh_all, dc_all = fold_last(dh_all, dc_all, dh_last, dc_last, lengths)
    out_dtypes = (x.dtype, w.dtype, b.dtype, h0.dtype, c0.dtype)
    x, w, b, h0, c0, h_all, c_all, dh_all, dc_all = _f32(
        x, w, b, h0, c0, h_all, c_all, dh_all, dc_all)
    t_max, bsz, g4 = x.shape
    hidden = g4 // 4
    alive = _alive(lengths, t_max)
    dh_c = torch.zeros_like(h0)
    dc_c = torch.zeros_like(c0)
    dx = torch.empty_like(x)
    zero = torch.zeros_like(h0)
    for t in range(t_max - 1, -1, -1):
        h_prev = h_all[t - 1] if t else h0
        c_prev = c_all[t - 1] if t else c0
        i, cand, f, o = _gates(x[t], h_prev, w, b, hidden)
        c = f * c_prev + i * cand
        tc = torch.tanh(c)
        a = alive[t]
        dh = torch.where(a, dh_all[t] + dh_c, zero)
        dc = torch.where(a, dh * o * (1.0 - tc * tc) + dc_c + dc_all[t], dc_c)
        dg = torch.cat([torch.where(a, dc * cand * i * (1.0 - i), zero),
                        torch.where(a, dc * i * (1.0 - cand * cand), zero),
                        torch.where(a, dc * c_prev * f * (1.0 - f), zero),
                        torch.where(a, dh * tc * o * (1.0 - o), zero)], 1)
        dx[t] = dg
        dc_c = torch.where(a, dc * f, dc_c)
        dh_c = torch.where(a, dg @ w.t(), dh_c)
    h_prev = torch.cat([h0[None], h_all[:-1]]).reshape(t_max * bsz, hidden)
    dx2 = dx.reshape(t_max * bsz, g4)
    return tuple(v.to(d) for v, d in zip(
        (dx, h_prev.t() @ dx2, dx2.sum(0), dh_c, dc_c), out_dtypes))


# -- the bf16 rule ----------------------------------------------------------

def step_terms(a, w, *adds):
    """A bound of the sum of |terms| of a recurrent output, for bf16_excess:
    T times the largest per-step sum |a_t| |w| + |add_t| over rows and
    columns (a [T, B, K] the product's left operand per step, w [K, N],
    each add [T, B, N] or broadcast to it), float64: each step's float32
    sums in another order, carried through the T steps of the recurrence."""
    s = torch.matmul(a.double().abs(), w.double().abs())
    for add in adds:
        s = s + add.double().abs()
    return a.shape[0] * float(s.max()) if s.numel() else 0.0


def bf16_excess(got, want, terms):
    """How far a bf16 result sits from its twin's, in units of the rule
    for bf16 outputs: max over elements of |got - want| / (one bf16 ulp at
    max(|got|, |want|) + 1e-5 * terms), in float64; <= 1 holds. `terms`:
    the output's sum of |terms| (step_terms), a number or a tensor."""
    from .flash_attention import bf16_spacing
    g, w = got.double(), want.double()
    limit = bf16_spacing(torch.maximum(g.abs(), w.abs())) + 1e-5 * terms
    return float(((g - w).abs() / limit).max()) if g.numel() else 0.0


# -- the kernels ------------------------------------------------------------

def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the C entry points of
    csrc/fused_lstm.cu on `lib`."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for kind in ("f32", "bf16"):
        getattr(lib, f"fused_lstm_fwd_{kind}").argtypes = \
            [ptr] * 12 + [i32] * 3 + [ptr] * 2
    lib.fused_lstm_bwd_f32.argtypes = [ptr] * 18 + [i32] * 4 + [ptr] * 2
    lib.fused_lstm_bwd_bf16.argtypes = [ptr] * 19 + [i32] * 4 + [ptr] * 2
    lib.fused_lstm_barrier_floor.argtypes = [ptr] + [i32] * 4 + [ptr] * 2
    for name in ("fused_lstm_fwd_f32", "fused_lstm_bwd_f32",
                 "fused_lstm_fwd_bf16", "fused_lstm_bwd_bf16",
                 "fused_lstm_barrier_floor"):
        getattr(lib, name).restype = i32
    lib.fused_lstm_sync_words.argtypes = [i32]
    lib.fused_lstm_partial_floats.argtypes = [i32] * 2
    lib.fused_lstm_partial_floats.restype = ctypes.c_longlong
    lib.fused_lstm_dw_splits.argtypes = [i32] * 3
    lib.fused_lstm_error_string.argtypes = [i32]
    lib.fused_lstm_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    lib = build.library(_SOURCE)
    if not getattr(lib, "_paddle_bound", False):
        bind(lib)
        lib._paddle_bound = True
    return lib


#: the launch plan a C entry point reports (csrc/fused_lstm.cu plan_launch)
PLAN_FIELDS = ("tiles", "blocks_per_sm", "sms", "grid", "smem_bytes",
               "resident_w_rows", "barriers")


#: the dtypes the kernels take: every stream one of these, all alike; w,
#: b, h0 and c0 each one of them
DTYPES = (torch.float32, torch.bfloat16)


def _check(who, x, w, b, h0, c0, lengths, **more):
    """Raise unless every tensor is what the kernels take: streams (x and
    `more`) all float32 or all bfloat16, w, b, h0, c0 each float32 or
    bfloat16, int32 lengths; contiguous, on x's device, with the layout's
    shapes."""
    if x.ndim != 3 or x.shape[2] % 4 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{who}: x must be [T>=1, B>=1, 4H], got "
                         f"{tuple(x.shape)}")
    t_max, bsz, g4 = x.shape
    hidden = g4 // 4
    shapes = dict(x=(t_max, bsz, g4), w=(hidden, g4), b=(g4,),
                  h0=(bsz, hidden), c0=(bsz, hidden))
    tensors = dict(x=x, w=w, b=b, h0=h0, c0=c0)
    for name, t in more.items():
        shapes[name] = (t_max, bsz, hidden)
        tensors[name] = t
    for name, t in tensors.items():
        stream = name == "x" or name in more
        if stream and t.dtype != x.dtype:
            raise ValueError(f"{who}: {name} is {t.dtype} and x {x.dtype}: "
                             "the streams must all be float32 or all "
                             "bfloat16")
        if t.device != x.device or t.dtype not in DTYPES or \
                not t.is_contiguous() or tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{who}: {name} must be a contiguous float32 or bfloat16 "
                f"{shapes[name]} tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous: "
                f"{t.is_contiguous()})")
    if lengths.device != x.device or lengths.dtype != torch.int32 or \
            tuple(lengths.shape) != (bsz,) or not lengths.is_contiguous():
        raise ValueError(f"{who}: lengths must be a contiguous int32 "
                         f"({bsz},) tensor on {x.device}")
    if -(-bsz // 16) * -(-hidden // 16) >= 2 ** 31:
        raise ValueError(f"{who}: {bsz} x {hidden} has too many tiles")


def _sync_words(bsz, device):
    """The grid barriers' counters (csrc/grid_sync.cuh Barrier), as many
    words as the library asks for; the C functions zero them."""
    words = _library().fused_lstm_sync_words(bsz)
    return torch.empty(words, dtype=torch.int32, device=device)


def _launch(who, entry, device, *args):
    """build.launch_planned on this library (see there)."""
    lib = _library()
    return build.launch_planned(lib, entry, lib.fused_lstm_error_string,
                                PLAN_FIELDS, who, device, *args)


def _entry(kind, dtype):
    return f"fused_lstm_{kind}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"


def fused_lstm_fwd(x, w, b, h0, c0, lengths
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """LSTM over T steps: (h_all, c_all [T,B,H], h_last, c_last [B,H]),
    in x's dtype. CUDA tensors run the persistent forward kernel of x's
    dtype (float32 or bf16 streams, contiguous, int32 lengths — anything
    else raises, and so does a grid that cannot be co-resident), with w,
    b, h0, c0 in float32 and the state's h_last, c_last rounded after it;
    CPU tensors run fused_lstm_fwd_plain; meta tensors get outputs of the
    right shape."""
    if x.device.type == "meta":
        t_max, bsz, g4 = x.shape
        seq = x.new_empty((t_max, bsz, g4 // 4))
        return seq, seq.clone(), x.new_empty(h0.shape), \
            x.new_empty(c0.shape)
    if not x.is_cuda:
        return fused_lstm_fwd_plain(x, w, b, h0, c0, lengths)
    if x.dtype == torch.bfloat16:
        return fused_lstm_fwd_bf16(x, w, b, h0, c0, lengths)
    out = _run_fwd("fused_lstm_fwd", x, w, b, h0, c0, lengths)
    fused_lstm_fwd.launches += 1
    return out


def fused_lstm_fwd_bf16(x, w, b, h0, c0, lengths):
    """fused_lstm_fwd's bf16-stream kernel (its own launch count): bf16 x
    on a card (anything else there raises); CPU tensors run
    fused_lstm_fwd_plain."""
    if not x.is_cuda:
        return fused_lstm_fwd_plain(x, w, b, h0, c0, lengths)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_lstm_fwd_bf16: x is {x.dtype}")
    out = _run_fwd("fused_lstm_fwd_bf16", x, w, b, h0, c0, lengths)
    fused_lstm_fwd_bf16.launches += 1
    return out


def _run_fwd(who, x, w, b, h0, c0, lengths):
    _check(who, x, w, b, h0, c0, lengths)
    t_max, bsz, g4 = x.shape
    hidden = g4 // 4
    w, b, h0, c0 = _f32(w, b, h0, c0)
    h_all = torch.empty((t_max, bsz, hidden), dtype=x.dtype, device=x.device)
    c_all = torch.empty_like(h_all)
    # the float32 state: the h ping-pong (h_last, h_pong) and c_last
    h_last, c_last, h_pong = (torch.empty_like(h0) for _ in range(3))
    sync = _sync_words(bsz, x.device)
    _launch(who, _entry("fwd", x.dtype), x.device,
            x.data_ptr(), w.data_ptr(), b.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), lengths.data_ptr(), h_all.data_ptr(),
            c_all.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
            h_pong.data_ptr(), sync.data_ptr(), t_max, bsz, hidden)
    return h_all, c_all, h_last.to(x.dtype), c_last.to(x.dtype)


#: kernel launches since the count was last set to 0 (one per call of the
#: C function, which launches the one persistent kernel that walks all T
#: steps; the plain and meta paths do not count)
fused_lstm_fwd.launches = 0
fused_lstm_fwd_bf16.launches = 0


def fused_lstm_bwd(x, w, b, h0, c0, lengths, h_all, c_all, dh_all, dc_all,
                   dh_last=None, dc_last=None):
    """The backward of fused_lstm_fwd for the output cotangents dh_all,
    dc_all [T,B,H] and dh_last, dc_last [B,H] (None is zero; dh_all or
    dc_all None too): (dx [T,B,4H], dw [H,4H], db [4H], dh0, dc0 [B,H]),
    each in its input's dtype. The last-state cotangents are folded into
    the streams in torch; CUDA tensors then run the persistent backward
    kernel of the streams' dtype and the dW reduction (same conditions as
    fused_lstm_fwd; W is read as it is, no transposed copy; bf16 streams
    keep the float32 dgates in a [T,B,4H] scratch for dW and db), CPU
    tensors fused_lstm_bwd_plain."""
    if x.device.type == "meta":
        return (x.new_empty(x.shape), w.new_empty(w.shape),
                b.new_empty(b.shape), h0.new_empty(h0.shape),
                c0.new_empty(c0.shape))
    args = (x, w, b, h0, c0, lengths, h_all, c_all, dh_all, dc_all, dh_last,
            dc_last)
    if not x.is_cuda:
        return fused_lstm_bwd_plain(*args)
    if x.dtype == torch.bfloat16:
        return fused_lstm_bwd_bf16(*args)
    out = _run_bwd("fused_lstm_bwd", *args)
    fused_lstm_bwd.launches += 1
    return out


def fused_lstm_bwd_bf16(x, w, b, h0, c0, lengths, h_all, c_all, dh_all,
                        dc_all, dh_last=None, dc_last=None):
    """fused_lstm_bwd's bf16-stream kernels (their own launch count): bf16
    streams on a card (anything else there raises); CPU tensors run
    fused_lstm_bwd_plain."""
    args = (x, w, b, h0, c0, lengths, h_all, c_all, dh_all, dc_all, dh_last,
            dc_last)
    if not x.is_cuda:
        return fused_lstm_bwd_plain(*args)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_lstm_bwd_bf16: x is {x.dtype}")
    out = _run_bwd("fused_lstm_bwd_bf16", *args)
    fused_lstm_bwd_bf16.launches += 1
    return out


def _run_bwd(who, x, w, b, h0, c0, lengths, h_all, c_all, dh_all, dc_all,
             dh_last, dc_last):
    dh_all = torch.zeros_like(h_all) if dh_all is None else dh_all
    dc_all = torch.zeros_like(c_all) if dc_all is None else dc_all
    dh_all, dc_all = fold_last(dh_all.contiguous(), dc_all.contiguous(),
                               dh_last, dc_last, lengths)
    _check(who, x, w, b, h0, c0, lengths, h_all=h_all, c_all=c_all,
           dh_all=dh_all, dc_all=dc_all)
    t_max, bsz, g4 = x.shape
    hidden = g4 // 4
    out_dtypes = (w.dtype, b.dtype, h0.dtype, c0.dtype)
    w, b, h0, c0 = _f32(w, b, h0, c0)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    db = torch.empty_like(b)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    scratch = ()
    if x.dtype == torch.bfloat16:
        # the unrounded dgates, which dW and db are summed from
        scratch = (torch.empty(x.shape, dtype=torch.float32,
                               device=x.device),)
    lib = _library()
    with torch.cuda.device(x.device):
        # the partials of dh_prev (a ping-pong of one [B, H] a W strip) and
        # the dW reduction's partial sums, one (H + 1) x 4H a row split
        # when there are several
        partials = dw.new_empty(lib.fused_lstm_partial_floats(bsz, hidden))
        splits = lib.fused_lstm_dw_splits(t_max, bsz, hidden)
    dw_parts = dw.new_empty((splits if splits > 1 else 0,
                             (hidden + 1) * g4))
    sync = _sync_words(bsz, x.device)
    _launch(who, _entry("bwd", x.dtype), x.device,
            x.data_ptr(), w.data_ptr(), b.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), lengths.data_ptr(), h_all.data_ptr(),
            c_all.data_ptr(), dh_all.data_ptr(), dc_all.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), partials.data_ptr(), dw_parts.data_ptr(),
            *(s.data_ptr() for s in scratch), sync.data_ptr(),
            t_max, bsz, hidden, splits)
    return (dx,) + tuple(v.to(d) for v, d in zip((dw, db, dh0, dc0),
                                                 out_dtypes))


#: one per call of the C function, which launches the persistent kernel
#: of the recurrence and then the dW reduction (and with row splits their
#: sum)
fused_lstm_bwd.launches = 0
fused_lstm_bwd_bf16.launches = 0


def barrier_floor(t_max, bsz, hidden, backward, device):
    """Launch, on `device`'s current stream, the grid the forward
    (backward=True: the backward) would take at these shapes, stepping
    through the same grid-wide barriers with no products: what the
    barriers alone cost a call. Returns the launch plan. A measurement
    of the design (chip_smoke.py times it), not a route of any op."""
    sync = _sync_words(bsz, device)
    return _launch("fused_lstm barrier floor", "fused_lstm_barrier_floor",
                   device, sync.data_ptr(), t_max, bsz, hidden,
                   int(backward))


class FusedLSTM(torch.autograd.Function):
    """The fused LSTM with its backward kernel — the counterpart of the
    reference's ``jax.custom_vjp`` around ``fused_lstm``. forward saves
    the inputs, h_all and c_all; backward recomputes the gates (no
    [T,B,4H] activations are kept). An output that gets no cotangent
    counts as zeros; lengths gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, b, h0, c0, lengths):
        h_all, c_all, h_last, c_last = fused_lstm_fwd(x, w, b, h0, c0,
                                                      lengths)
        ctx.save_for_backward(x, w, b, h0, c0, lengths, h_all, c_all)
        ctx.set_materialize_grads(False)
        return h_all, c_all, h_last, c_last

    @staticmethod
    def backward(ctx, dh_all, dc_all, dh_last, dc_last):
        x, w, b, h0, c0, lengths, h_all, c_all = ctx.saved_tensors
        dx, dw, db, dh0, dc0 = fused_lstm_bwd(
            x, w, b, h0, c0, lengths, h_all, c_all,
            None if dh_all is None else dh_all.contiguous(),
            None if dc_all is None else dc_all.contiguous(),
            dh_last, dc_last)
        return dx, dw, db, dh0, dc0, None


def fused_lstm(x, w, b, h0, c0, lengths
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Differentiable fused LSTM: (h_all, c_all, h_last, c_last) for
    x [T,B,4H], w [H,4H], b [4H], h0/c0 [B,H] and int32 lengths [B]
    (see FusedLSTM). The CUDA kernels need contiguous tensors: float32 or
    bfloat16 streams, each other tensor float32 or bfloat16."""
    return FusedLSTM.apply(x, w, b, h0, c0, lengths)

