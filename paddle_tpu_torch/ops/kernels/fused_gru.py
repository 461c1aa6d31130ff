"""Fused GRU time loop: the hand-written CUDA kernels and their plain twins.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas/fused_gru.py``:

  ``fused_gru_fwd``   ``_run_fwd`` / ``_fwd_kernel``   (csrc/fused_gru.cu)
  ``fused_gru_bwd``   ``_fused_gru_bwd`` / ``_bwd_kernel``

Layout, as the reference's: x [T, B, 3H] pre-projected gates with the
bias folded in, time-major, gate order u (update), r (reset), c
(candidate); w [H, 3H] packs W_ur [H, 2H] and W_c [H, H]; h0 [B, H];
lengths [B] int32. h = u h_prev + (1 - u) tanh(x_c + (r h_prev) W_c). A
row freezes past its length and its h_all there is 0; h_last is the
state at length-1 (h0 for a zero-length row). The forward also returns
gates [T, B, 3H] (u, r, c of every step, float32), which the backward of
float32 streams reads where the reference recomputes them (the same
values).

Dtypes, as the Pallas kernels take them: the streams x, h_all (backward
dh_all, dx) are all float32 or all bfloat16; w and h0 each float32 or
bfloat16. Every value is widened to float32 at load, the state and every
product and sum stay float32, and each output is rounded to its dtype at
store: h_all, h_last, dx to the streams', dw to w's, dh0 to h0's (dW
summed from the float32 dgates). On bf16 streams the backward recomputes
the gates from x and the stored, rounded h_all, as the Pallas backward
reads them: the forward's gates came from its float32 state and differ.
The twins do the same in torch; the wrappers give the CUDA kernels w and
h0 in float32 and round their results. On the card each call is ONE persistent
launch that walks all T steps (the backward adds the dW reduction):
each block keeps its strip of W in shared memory for the whole call, and
grid-wide barriers stand between the two dependent stages of a step.
The grid is the co-resident maximum; a grid that cannot be co-resident
is refused by the cooperative launch, and the wrapper raises with the
plan (grid, blocks per SM, shared memory). The CUDA source's header says
what bounds the kernels on an H100 and how the design answers that.
``FusedGRU`` is the torch.autograd.Function over the pair, the
counterpart of the reference's ``jax.custom_vjp``, and ``fused_gru``
applies it.

Every wrapper takes its kernel for CUDA tensors — there is no fallback:
a CUDA input the kernel cannot take raises, and so does a failed build or
launch — its plain torch twin for CPU tensors, and a shape-only path for
tensors on the "meta" device (build-time shape inference).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .fused_lstm import DTYPES, _alive, _f32

_SOURCE = "fused_gru.cu"


# -- plain twins ------------------------------------------------------------

def fused_gru_fwd_plain(x, w, h0, lengths):
    """A torch loop over t with the forward kernels' arithmetic:
    (h_all [T,B,H], h_last [B,H], gates [T,B,3H]), in float32 from the
    widened inputs, h_all and h_last rounded to x's dtype (gates stay
    float32)."""
    t_max, hidden, dtype = x.shape[0], w.shape[0], x.dtype
    x, w, h0 = _f32(x, w, h0)
    w_ur, w_c = w[:, :2 * hidden], w[:, 2 * hidden:]
    alive = _alive(lengths, t_max)
    h = h0
    h_all, gates = [], []
    for t in range(t_max):
        x_t = x[t]
        ur = h @ w_ur
        u = torch.sigmoid(x_t[:, :hidden] + ur[:, :hidden])
        r = torch.sigmoid(x_t[:, hidden:2 * hidden] + ur[:, hidden:])
        c = torch.tanh(x_t[:, 2 * hidden:] + (r * h) @ w_c)
        h_new = u * h + (1.0 - u) * c
        h_all.append(torch.where(alive[t], h_new, torch.zeros_like(h_new)))
        gates.append(torch.cat([u, r, c], 1))
        h = torch.where(alive[t], h_new, h)
    return torch.stack(h_all).to(dtype), h.to(dtype), torch.stack(gates)


def gates_plain(x, w, h0, h_all):
    """u, r, c [T,B,3H] (float32) of every step from x_t and h_{t-1} read
    from the stored h_all (h0 at t = 0), as the Pallas backward
    recomputes them: all T steps at once (no recurrence), the products in
    float32 from the widened inputs."""
    hidden = w.shape[0]
    x, w, h0, h_all = _f32(x, w, h0, h_all)
    h_prev = torch.cat([h0[None], h_all[:-1]])
    ur = h_prev @ w[:, :2 * hidden]
    u = torch.sigmoid(x[..., :hidden] + ur[..., :hidden])
    r = torch.sigmoid(x[..., hidden:2 * hidden] + ur[..., hidden:])
    c = torch.tanh(x[..., 2 * hidden:] + (r * h_prev) @ w[:, 2 * hidden:])
    return torch.cat([u, r, c], -1)


def fold_last(dh_all, dh_last, lengths):
    """(dh_all with the h_last cotangent added at max(len-1, 0) for the
    rows of nonzero length, in dh_all's dtype (a bf16 add rounds as the
    reference's .at[].add does), the part of dh_last that goes straight
    to dh0: its zero-length rows), as the reference's _fused_gru_bwd folds
    them; a None cotangent is zero."""
    if dh_last is None:
        return dh_all, None
    idx = torch.clamp(lengths.long() - 1, min=0)
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    empty = (lengths == 0)[:, None]
    stream = dh_all.clone()
    stream[idx, rows] = stream[idx, rows] + torch.where(
        empty, torch.zeros_like(dh_last), dh_last).to(stream.dtype)
    return stream, torch.where(empty, dh_last, torch.zeros_like(dh_last))


def fused_gru_bwd_plain(w, h0, lengths, h_all, gates, dh_all,
                        dh_last=None, x=None):
    """A reverse torch loop with the backward kernels' arithmetic:
    (dx [T,B,3H], dw [H,3H], dh0 [B,H]). It reads u, r, c from `gates`
    (float32 streams: the forward's), or recomputes them from `x` and the
    stored h_all (gates_plain; bf16 streams pass x and no gates), masks dh
    before every product, takes d_rh = dc_pre W_c^T and dh_prev = dh u +
    d_rh r + [du_pre, dr_pre] W_ur^T per step, and sums dW over all T*B
    rows of the float32 dgates after the loop, as the kernels do; all in
    float32, dx rounded to the streams' dtype, dw to w's, dh0 to h0's
    (plus a zero-length row's h_last cotangent, promoted as jnp adds it).
    A None cotangent is zero."""
    dh_all = torch.zeros_like(h_all) if dh_all is None else dh_all
    dh_all, dh0_direct = fold_last(dh_all, dh_last, lengths)
    if x is not None:
        gates = gates_plain(x, w, h0, h_all)
    out_dtypes = (h_all.dtype, w.dtype, h0.dtype)
    w, h0, h_all, dh_all = _f32(w, h0, h_all, dh_all)
    t_max, bsz, g3 = gates.shape
    hidden = g3 // 3
    w_ur, w_c = w[:, :2 * hidden], w[:, 2 * hidden:]
    alive = _alive(lengths, t_max)
    carry = torch.zeros_like(h0)
    zero = torch.zeros_like(h0)
    dx = torch.empty_like(gates)
    h_prev_all = torch.cat([h0[None], h_all[:-1]])
    for t in range(t_max - 1, -1, -1):
        h_prev = h_prev_all[t]
        u, r, c = gates[t].split(hidden, 1)
        a = alive[t]
        dh = torch.where(a, dh_all[t] + carry, zero)
        du = torch.where(a, dh * (h_prev - c) * u * (1.0 - u), zero)
        dc = torch.where(a, dh * (1.0 - u) * (1.0 - c * c), zero)
        d_rh = dc @ w_c.t()
        dr = torch.where(a, d_rh * h_prev * r * (1.0 - r), zero)
        dur = torch.cat([du, dr], 1)
        dh_prev = dh * u + d_rh * r + dur @ w_ur.t()
        dx[t] = torch.cat([dur, dc], 1)
        carry = torch.where(a, dh_prev, carry)
    rows = t_max * bsz
    hp = h_prev_all.reshape(rows, hidden)
    rh = gates[..., hidden:2 * hidden].reshape(rows, hidden) * hp
    dx2 = dx.reshape(rows, g3)
    dw = torch.cat([hp.t() @ dx2[:, :2 * hidden],
                    rh.t() @ dx2[:, 2 * hidden:]], 1)
    dh0 = carry.to(out_dtypes[2])
    if dh0_direct is not None:
        dh0 = dh0 + dh0_direct
    return dx.to(out_dtypes[0]), dw.to(out_dtypes[1]), dh0


# -- the kernels ------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = build.library(_SOURCE)
    if not getattr(lib, "_paddle_bound", False):
        for kind in ("f32", "bf16"):
            fwd = getattr(lib, f"fused_gru_fwd_{kind}")
            fwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                            + [ctypes.c_void_p] * 2)
            fwd.restype = ctypes.c_int
        lib.fused_gru_bwd_f32.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 2)
        lib.fused_gru_bwd_f32.restype = ctypes.c_int
        lib.fused_gru_bwd_bf16.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 2)
        lib.fused_gru_bwd_bf16.restype = ctypes.c_int
        lib.fused_gru_dw_splits.argtypes = [ctypes.c_int] * 3
        lib.fused_gru_dw_splits.restype = ctypes.c_int
        lib.fused_gru_sync_words.argtypes = [ctypes.c_int]
        lib.fused_gru_sync_words.restype = ctypes.c_int
        lib.fused_gru_barrier_floor.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
        lib.fused_gru_barrier_floor.restype = ctypes.c_int
        lib.fused_gru_error_string.argtypes = [ctypes.c_int]
        lib.fused_gru_error_string.restype = ctypes.c_char_p
        lib._paddle_bound = True
    return lib


#: the launch plan a C entry point reports (csrc/fused_gru.cu plan_launch)
PLAN_FIELDS = ("tiles", "blocks_per_sm", "sms", "grid", "smem_bytes",
               "resident_w_quads", "a_chunk", "x_slots", "barriers")


def _check(who, lead, w, h0, lengths, **more):
    """Raise unless every tensor is what the kernels take: the streams
    (`more` but gates, which is float32) all float32 or all bfloat16, w
    and h0 each float32 or bfloat16, int32 lengths; contiguous, on one
    device, with the layout's shapes, which the [T, B, 3H] tensor
    more[lead] (x or gates) sets."""
    seq = more[lead]
    if seq.ndim != 3 or seq.shape[2] % 3 or seq.shape[0] < 1 or \
            seq.shape[1] < 1 or seq.shape[2] < 3:
        raise ValueError(f"{who}: {lead} must be [T>=1, B>=1, 3H>=3], got "
                         f"{tuple(seq.shape)}")
    t_max, bsz, g3 = seq.shape
    hidden = g3 // 3
    shapes = dict(x=(t_max, bsz, g3), w=(hidden, g3), h0=(bsz, hidden),
                  h_all=(t_max, bsz, hidden), gates=(t_max, bsz, g3),
                  dh_all=(t_max, bsz, hidden))
    tensors = dict(w=w, h0=h0, **more)
    streams = {n: t.dtype for n, t in more.items() if n != "gates"}
    if len(set(streams.values())) > 1:
        raise ValueError(f"{who}: the streams must all be float32 or all "
                         f"bfloat16, got {streams}")
    for name, t in tensors.items():
        dtypes = (torch.float32,) if name == "gates" else DTYPES
        if t.device != seq.device or t.dtype not in dtypes or \
                not t.is_contiguous() or tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{who}: {name} must be a contiguous "
                f"{' or '.join(str(d)[6:] for d in dtypes)} "
                f"{shapes[name]} tensor on {seq.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous: "
                f"{t.is_contiguous()})")
    if lengths.device != seq.device or lengths.dtype != torch.int32 or \
            tuple(lengths.shape) != (bsz,) or not lengths.is_contiguous():
        raise ValueError(f"{who}: lengths must be a contiguous int32 "
                         f"({bsz},) tensor on {seq.device}")
    if -(-bsz // 16) * -(-hidden // 16) >= 2 ** 31:
        raise ValueError(f"{who}: {bsz} x {hidden} has too many tiles")


def _sync_words(bsz, device):
    """The grid barriers' counters (csrc/fused_gru.cu Barrier), as many
    words as the library asks for; the C functions zero them."""
    words = _library().fused_gru_sync_words(bsz)
    return torch.empty(words, dtype=torch.int32, device=device)


def _launch(who, entry, device, *args):
    """build.launch_planned on this library (see there)."""
    lib = _library()
    return build.launch_planned(lib, entry, lib.fused_gru_error_string,
                                PLAN_FIELDS, who, device, *args)


def _entry(kind, dtype):
    return f"fused_gru_{kind}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"


def fused_gru_fwd(x, w, h0, lengths
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GRU over T steps: (h_all [T,B,H], h_last [B,H] in x's dtype, gates
    [T,B,3H] float32). CUDA tensors run the persistent forward kernel of
    x's dtype (float32 or bf16, contiguous, int32 lengths — anything else
    raises), with w and h0 in float32 and the state's h_last rounded
    after it; CPU tensors run fused_gru_fwd_plain; meta tensors get
    outputs of the right shape."""
    if x.device.type == "meta":
        t_max, bsz, g3 = x.shape
        return (x.new_empty((t_max, bsz, g3 // 3)), x.new_empty(h0.shape),
                x.new_empty(x.shape, dtype=torch.float32))
    if not x.is_cuda:
        return fused_gru_fwd_plain(x, w, h0, lengths)
    if x.dtype == torch.bfloat16:
        return fused_gru_fwd_bf16(x, w, h0, lengths)
    out = _run_fwd("fused_gru_fwd", x, w, h0, lengths)
    fused_gru_fwd.launches += 1
    return out


def fused_gru_fwd_bf16(x, w, h0, lengths):
    """fused_gru_fwd's bf16-stream kernel (its own launch count): bf16 x on
    a card (anything else there raises); CPU tensors run
    fused_gru_fwd_plain."""
    if not x.is_cuda:
        return fused_gru_fwd_plain(x, w, h0, lengths)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_gru_fwd_bf16: x is {x.dtype}")
    out = _run_fwd("fused_gru_fwd_bf16", x, w, h0, lengths)
    fused_gru_fwd_bf16.launches += 1
    return out


def _run_fwd(who, x, w, h0, lengths):
    _check(who, "x", w, h0, lengths, x=x)
    t_max, bsz, g3 = x.shape
    hidden = g3 // 3
    w, h0 = _f32(w, h0)
    h_all = torch.empty((t_max, bsz, hidden), dtype=x.dtype, device=x.device)
    gates = torch.empty_like(x, dtype=torch.float32)
    # the float32 state's ping-pong (h_last, h_pong) and rh
    h_last, rh, h_pong = (torch.empty_like(h0) for _ in range(3))
    sync = _sync_words(bsz, x.device)
    _launch(who, _entry("fwd", x.dtype), x.device,
            x.data_ptr(), w.data_ptr(), h0.data_ptr(), lengths.data_ptr(),
            h_all.data_ptr(), h_last.data_ptr(), gates.data_ptr(),
            rh.data_ptr(), h_pong.data_ptr(), sync.data_ptr(), t_max, bsz,
            hidden)
    return h_all, h_last.to(x.dtype), gates


#: kernel launches since the count was last set to 0 (one per call of the
#: C function, which launches the one persistent kernel that walks all T
#: steps; the plain and meta paths do not count)
fused_gru_fwd.launches = 0
fused_gru_fwd_bf16.launches = 0


def fused_gru_bwd(w, h0, lengths, h_all, gates, dh_all, dh_last=None,
                  x=None):
    """The backward of fused_gru_fwd for the output cotangents dh_all
    [T,B,H] and dh_last [B,H] (None is zero): (dx [T,B,3H] in the
    streams' dtype, dw [H,3H] in w's, dh0 [B,H] in h0's). float32 streams
    read the forward's gates; bf16 streams pass x (and gates None), from
    which the gates are recomputed at the stored h_all. The last-state
    cotangent is folded in torch (fold_last); CUDA tensors then run the
    backward kernels of the streams' dtype (bf16: the gate recompute
    first) and the dW reduction (same conditions as fused_gru_fwd; W is
    read as it is, no transposed copy), CPU tensors fused_gru_bwd_plain."""
    if h_all.device.type == "meta":
        t_max, bsz, hidden = h_all.shape
        return h_all.new_empty((t_max, bsz, 3 * hidden)), \
            w.new_empty(w.shape), h0.new_empty(h0.shape)
    bf16 = h_all.dtype == torch.bfloat16
    if bf16 and x is None:
        raise ValueError("fused_gru_bwd: bf16 streams recompute the gates "
                         "from x, and x was not given")
    args = (w, h0, lengths, h_all, None if bf16 else gates, dh_all, dh_last,
            x if bf16 else None)
    if not h_all.is_cuda:
        return fused_gru_bwd_plain(*args)
    if bf16:
        return fused_gru_bwd_bf16(*args)
    out = _run_bwd("fused_gru_bwd", *args)
    fused_gru_bwd.launches += 1
    return out


def fused_gru_bwd_bf16(w, h0, lengths, h_all, gates, dh_all, dh_last=None,
                       x=None):
    """fused_gru_bwd's bf16-stream kernels (their own launch count): bf16
    streams and x on a card (anything else there raises; gates is not
    read); CPU tensors run fused_gru_bwd_plain."""
    if not h_all.is_cuda:
        return fused_gru_bwd_plain(w, h0, lengths, h_all, None, dh_all,
                                   dh_last, x)
    if h_all.dtype != torch.bfloat16 or x is None:
        raise TypeError(f"fused_gru_bwd_bf16: h_all is {h_all.dtype}, x "
                        f"{None if x is None else x.dtype}")
    out = _run_bwd("fused_gru_bwd_bf16", w, h0, lengths, h_all, None,
                   dh_all, dh_last, x)
    fused_gru_bwd_bf16.launches += 1
    return out


def _run_bwd(who, w, h0, lengths, h_all, gates, dh_all, dh_last, x):
    bf16 = h_all.dtype == torch.bfloat16
    dh_all = torch.zeros_like(h_all) if dh_all is None else \
        dh_all.contiguous()
    dh_all, dh0_direct = fold_last(dh_all, dh_last, lengths)
    saved = dict(x=x) if bf16 else dict(gates=gates)
    _check(who, "x" if bf16 else "gates", w, h0, lengths, h_all=h_all,
           dh_all=dh_all, **saved)
    t_max, bsz, hidden = h_all.shape
    out_dtypes = (w.dtype, h0.dtype)
    w, h0 = _f32(w, h0)
    dx = torch.empty((t_max, bsz, 3 * hidden), dtype=h_all.dtype,
                     device=h_all.device)
    dw = torch.empty_like(w)
    dh0, dh_cur, d_rh = (torch.empty_like(h0) for _ in range(3))
    # the dW reduction's partial sums, one [H, 3H] a row split
    with torch.cuda.device(h_all.device):
        splits = _library().fused_gru_dw_splits(t_max, bsz, hidden)
    dw_parts = torch.empty((splits,) + tuple(w.shape), dtype=w.dtype,
                           device=w.device)
    sync = _sync_words(bsz, h_all.device)
    if bf16:
        # float32 scratch: the recomputed gates and the unrounded dgates
        gates = torch.empty(dx.shape, dtype=torch.float32, device=dx.device)
        dgates = torch.empty_like(gates)
        args = (x.data_ptr(), w.data_ptr(), h0.data_ptr(),
                lengths.data_ptr(), h_all.data_ptr(), gates.data_ptr(),
                dh_all.data_ptr(), dx.data_ptr(), dgates.data_ptr())
    else:
        args = (w.data_ptr(), h0.data_ptr(), lengths.data_ptr(),
                h_all.data_ptr(), gates.data_ptr(), dh_all.data_ptr(),
                dx.data_ptr())
    _launch(who, _entry("bwd", h_all.dtype), h_all.device,
            *args, dw.data_ptr(), dh0.data_ptr(), dh_cur.data_ptr(),
            d_rh.data_ptr(), dw_parts.data_ptr(), sync.data_ptr(), t_max,
            bsz, hidden, splits)
    dh0 = dh0.to(out_dtypes[1])
    if dh0_direct is not None:
        dh0 = dh0 + dh0_direct
    return dx, dw.to(out_dtypes[0]), dh0


#: one per call of the C function, which launches the persistent kernel
#: of the recurrence and then the dW reduction (row splits, then their sum)
fused_gru_bwd.launches = 0
fused_gru_bwd_bf16.launches = 0


def barrier_floor(t_max, bsz, hidden, backward, device):
    """Launch, on `device`'s current stream, the grid the forward
    (backward=True: the backward) would take at these shapes, stepping
    through the same grid-wide barriers with no products: what the
    barriers alone cost a call. Returns the launch plan. A measurement
    of the design (chip_smoke.py times it), not a route of any op."""
    sync = _sync_words(bsz, device)
    return _launch("fused_gru barrier floor", "fused_gru_barrier_floor",
                   device, sync.data_ptr(), t_max, bsz, hidden,
                   int(backward))


class FusedGRU(torch.autograd.Function):
    """The fused GRU with its backward kernels — the counterpart of the
    reference's ``jax.custom_vjp`` around ``fused_gru``. forward saves
    w, h0, lengths, h_all and, for float32 streams, the gates (the
    backward then reads no x), for bf16 streams x (the backward
    recomputes the gates from it and the rounded h_all); an output that
    gets no cotangent counts as zeros; lengths gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, h0, lengths):
        h_all, h_last, gates = fused_gru_fwd(x, w, h0, lengths)
        ctx.recompute = x.dtype == torch.bfloat16
        ctx.save_for_backward(w, h0, lengths, h_all,
                              x if ctx.recompute else gates)
        ctx.set_materialize_grads(False)
        return h_all, h_last

    @staticmethod
    def backward(ctx, dh_all, dh_last):
        w, h0, lengths, h_all, saved = ctx.saved_tensors
        gates, x = (None, saved) if ctx.recompute else (saved, None)
        dx, dw, dh0 = fused_gru_bwd(
            w, h0, lengths, h_all, gates,
            None if dh_all is None else dh_all.contiguous(), dh_last, x)
        return dx, dw, dh0, None


def fused_gru(x, w, h0, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused GRU: (h_all [T,B,H], h_last [B,H]) for
    x [T,B,3H], w [H,3H], h0 [B,H] and int32 lengths [B] (see FusedGRU).
    The CUDA kernels need contiguous tensors: float32 or bfloat16 x, w
    and h0 each float32 or bfloat16."""
    return FusedGRU.apply(x, w, h0, lengths)
