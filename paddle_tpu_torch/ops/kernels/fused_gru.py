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
gates [T, B, 3H] (u, r, c of every step), which the backward reads where
the reference recomputes them. On the card each call is ONE persistent
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
from .fused_lstm import _alive

_SOURCE = "fused_gru.cu"


# -- plain twins ------------------------------------------------------------

def fused_gru_fwd_plain(x, w, h0, lengths):
    """A torch loop over t with the forward kernels' arithmetic:
    (h_all [T,B,H], h_last [B,H], gates [T,B,3H])."""
    t_max, hidden = x.shape[0], w.shape[0]
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
    return torch.stack(h_all), h, torch.stack(gates)


def fold_last(dh_all, dh_last, lengths):
    """(dh_all with the h_last cotangent added at max(len-1, 0) for the
    rows of nonzero length, the part of dh_last that goes straight to
    dh0: its zero-length rows), as the reference's _fused_gru_bwd folds
    them; a None cotangent is zero."""
    if dh_last is None:
        return dh_all, None
    idx = torch.clamp(lengths.long() - 1, min=0)
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    empty = (lengths == 0)[:, None]
    stream = dh_all.clone()
    stream[idx, rows] = stream[idx, rows] + torch.where(
        empty, torch.zeros_like(dh_last), dh_last)
    return stream, torch.where(empty, dh_last, torch.zeros_like(dh_last))


def fused_gru_bwd_plain(w, h0, lengths, h_all, gates, dh_all,
                        dh_last=None):
    """A reverse torch loop with the backward kernels' arithmetic:
    (dx [T,B,3H], dw [H,3H], dh0 [B,H]). It reads u, r, c from `gates`,
    masks dh before every product, takes d_rh = dc_pre W_c^T and dh_prev
    = dh u + d_rh r + [du_pre, dr_pre] W_ur^T per step, and sums dW over
    all T*B rows after the loop, as the kernels do. A None cotangent is
    zero."""
    dh_all = torch.zeros_like(h_all) if dh_all is None else dh_all
    dh_all, dh0_direct = fold_last(dh_all, dh_last, lengths)
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
    dh0 = carry if dh0_direct is None else carry + dh0_direct
    return dx, dw, dh0


# -- the kernels ------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = build.library(_SOURCE)
    if not getattr(lib, "_paddle_bound", False):
        lib.fused_gru_fwd_f32.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 2)
        lib.fused_gru_fwd_f32.restype = ctypes.c_int
        lib.fused_gru_bwd_f32.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 2)
        lib.fused_gru_bwd_f32.restype = ctypes.c_int
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
    """Raise unless every tensor is what the kernels take: float32 (int32
    lengths), contiguous, on one device, with the layout's shapes, which
    the [T, B, 3H] tensor more[lead] (x or gates) sets."""
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
    for name, t in tensors.items():
        if t.device != seq.device or t.dtype != torch.float32 or \
                not t.is_contiguous() or tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{who}: {name} must be a contiguous float32 "
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
    """Call the C entry point `entry` on `device`'s current stream with a
    plan buffer; raise with the CUDA error and the launch plan (grid,
    blocks per SM, shared memory: a grid that cannot be co-resident is
    refused, and nothing falls back) unless it returns 0. Returns the
    plan as a dict."""
    lib = _library()
    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, ctypes.addressof(plan), stream)
    plan = dict(zip(PLAN_FIELDS, plan))
    if err != 0:
        raise RuntimeError(
            f"{who} kernel launch failed: "
            f"{lib.fused_gru_error_string(err).decode()} (grid "
            f"{plan['grid']} for {plan['tiles']} tiles, "
            f"{plan['blocks_per_sm']} blocks per SM on {plan['sms']} SMs "
            f"at {plan['smem_bytes']} bytes of shared memory a block)")
    return plan


def fused_gru_fwd(x, w, h0, lengths
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GRU over T steps: (h_all [T,B,H], h_last [B,H], gates [T,B,3H]).
    CUDA tensors run the persistent forward kernel (float32, contiguous,
    int32 lengths — anything else raises); CPU tensors run
    fused_gru_fwd_plain; meta tensors get outputs of the right shape."""
    if x.device.type == "meta":
        t_max, bsz, g3 = x.shape
        return (x.new_empty((t_max, bsz, g3 // 3)), h0.new_empty(h0.shape),
                x.new_empty(x.shape))
    if not x.is_cuda:
        return fused_gru_fwd_plain(x, w, h0, lengths)
    _check("fused_gru_fwd", "x", w, h0, lengths, x=x)
    t_max, bsz, g3 = x.shape
    hidden = g3 // 3
    h_all = torch.empty((t_max, bsz, hidden), dtype=x.dtype, device=x.device)
    gates = torch.empty_like(x)
    h_last, rh, h_pong = (torch.empty_like(h0) for _ in range(3))
    sync = _sync_words(bsz, x.device)
    _launch("fused_gru_fwd", "fused_gru_fwd_f32", x.device,
            x.data_ptr(), w.data_ptr(), h0.data_ptr(), lengths.data_ptr(),
            h_all.data_ptr(), h_last.data_ptr(), gates.data_ptr(),
            rh.data_ptr(), h_pong.data_ptr(), sync.data_ptr(), t_max, bsz,
            hidden)
    fused_gru_fwd.launches += 1
    return h_all, h_last, gates


#: kernel launches since the count was last set to 0 (one per call of the
#: C function, which launches the one persistent kernel that walks all T
#: steps; the plain and meta paths do not count)
fused_gru_fwd.launches = 0


def fused_gru_bwd(w, h0, lengths, h_all, gates, dh_all, dh_last=None):
    """The backward of fused_gru_fwd, from its h_all and gates, for the
    output cotangents dh_all [T,B,H] and dh_last [B,H] (None is zero):
    (dx [T,B,3H], dw [H,3H], dh0 [B,H]). The last-state cotangent is
    folded in torch (fold_last); CUDA tensors then run the persistent
    backward kernel and the dW reduction (same conditions as
    fused_gru_fwd; W is read as it is, no transposed copy), CPU tensors
    fused_gru_bwd_plain."""
    if gates.device.type == "meta":
        return gates.new_empty(gates.shape), w.new_empty(w.shape), \
            h0.new_empty(h0.shape)
    if not gates.is_cuda:
        return fused_gru_bwd_plain(w, h0, lengths, h_all, gates, dh_all,
                                   dh_last)
    dh_all = torch.zeros_like(h_all) if dh_all is None else \
        dh_all.contiguous()
    dh_all, dh0_direct = fold_last(dh_all, dh_last, lengths)
    _check("fused_gru_bwd", "gates", w, h0, lengths, gates=gates,
           h_all=h_all, dh_all=dh_all)
    t_max, bsz, g3 = gates.shape
    hidden = g3 // 3
    dx = torch.empty_like(gates)
    dw = torch.empty_like(w)
    dh0, dh_cur, d_rh = (torch.empty_like(h0) for _ in range(3))
    # the dW reduction's partial sums, one [H, 3H] a row split
    with torch.cuda.device(gates.device):
        splits = _library().fused_gru_dw_splits(t_max, bsz, hidden)
    dw_parts = torch.empty((splits,) + tuple(w.shape), dtype=w.dtype,
                           device=w.device)
    sync = _sync_words(bsz, gates.device)
    _launch("fused_gru_bwd", "fused_gru_bwd_f32", gates.device,
            w.data_ptr(), h0.data_ptr(), lengths.data_ptr(),
            h_all.data_ptr(), gates.data_ptr(), dh_all.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), dh0.data_ptr(), dh_cur.data_ptr(),
            d_rh.data_ptr(), dw_parts.data_ptr(), sync.data_ptr(), t_max,
            bsz, hidden, splits)
    fused_gru_bwd.launches += 1
    if dh0_direct is not None:
        dh0 = dh0 + dh0_direct
    return dx, dw, dh0


#: one per call of the C function, which launches the persistent kernel
#: of the recurrence and then the dW reduction (row splits, then their sum)
fused_gru_bwd.launches = 0


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
    w, h0, lengths, h_all and the gates (the backward reads no x); an
    output that gets no cotangent counts as zeros; lengths gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, h0, lengths):
        h_all, h_last, gates = fused_gru_fwd(x, w, h0, lengths)
        ctx.save_for_backward(w, h0, lengths, h_all, gates)
        ctx.set_materialize_grads(False)
        return h_all, h_last

    @staticmethod
    def backward(ctx, dh_all, dh_last):
        w, h0, lengths, h_all, gates = ctx.saved_tensors
        dx, dw, dh0 = fused_gru_bwd(
            w, h0, lengths, h_all, gates,
            None if dh_all is None else dh_all.contiguous(), dh_last)
        return dx, dw, dh0, None


def fused_gru(x, w, h0, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused GRU: (h_all [T,B,H], h_last [B,H]) for
    x [T,B,3H], w [H,3H], h0 [B,H] and int32 lengths [B] (see FusedGRU).
    The CUDA kernels need contiguous float32 tensors."""
    return FusedGRU.apply(x, w, h0, lengths)
