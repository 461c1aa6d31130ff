// Fused GRU time loop, forward and backward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/fused_gru.py:
//   fused_gru_fwd_f32  <- _run_fwd / _fwd_kernel
//   fused_gru_bwd_f32  <- _fused_gru_bwd / _bwd_kernel
// and computes what they compute, masking included:
//   x [T,B,3H] pre-projected gates with the bias folded in, time-major,
//   gate order u (update), r (reset), c (candidate); w [H,3H] packs
//   W_ur [H,2H] and W_c [H,H]; h0 [B,H]; lengths [B] int32.
//   u = sigmoid(x_u + h_{t-1} W_u), r = sigmoid(x_r + h_{t-1} W_r),
//   c = tanh(x_c + (r h_{t-1}) W_c), h_t = u h_{t-1} + (1 - u) c.
//   A row freezes past its length: its state is carried unchanged and its
//   h_all is 0. h_last is the state after the loop, i.e. the state at
//   length-1, or h0 for a zero-length row.
// The forward also writes gates [T,B,3H] = (u, r, c) of every step, and
// the backward reads them where the TPU kernel recomputes them from
// (x_t, h_{t-1}): the same values (h_{t-1} of a live row is h_all[t-1]),
// at 4 T B 3H bytes of device memory instead of two more products per
// step. The backward walks t in reverse with _bwd_kernel's selects: dh is
// masked to 0 on a dead row BEFORE any product (h_{t-1} is read from
// h_all, which is 0 past a row's length), dx_t is 0 there, and a dead row
// passes its dh carry on untouched. The caller folds the h_last cotangent
// into dh_all at max(len-1, 0) and adds it to dh0 for a zero-length row.
//
// Design. The TPU kernel runs a sequential grid over t with h and all of W
// resident in VMEM. On an H100 the blocks run in parallel and W (3 MB at
// H = 512 in float32) is far above one SM's 227 KB of shared memory, so,
// as in csrc/fused_lstm.cu, the recurrence is ONE HOST LOOP inside the C
// function (one ctypes call per op) that launches a few kernels per step,
// with the state in device memory between launches (L2-resident at these
// sizes). Unlike the LSTM, a block that owns a strip of hidden units
// cannot finish a GRU step alone: the candidate of one unit needs all of
// r h_{t-1} of its row, i.e. the reset gates of every unit. So each step
// has two dependent stages, and this file gives each its own launch:
//
//   forward, per step (2 launches):
//     1. gru_fwd_ur_kernel: h_{t-1} W_ur for 16 rows x 16 units (the u and
//        r strips of those units); writes u, r and rh = r h_{t-1}.
//     2. gru_fwd_c_kernel: rh W_c for 16 rows x 16 units; writes c, the
//        cell update, h_all_t and the state (in place: a block reads only
//        its own elements of h_{t-1} there).
//     Both grids are (H/16) x (B/16) blocks: 128 at the book model's
//     shapes, one wave on 132 SMs at one 256-thread block per SM (the
//     unrolled stage and its prefetch take 128-209 registers a thread).
//   Chosen over one persistent kernel with a grid-wide sync per stage
//   (cooperative launch) because it has no occupancy precondition to
//   check and no deadlock risk, and is right first: the launch boundary is
//   the grid-wide barrier. The persistent kernel, with W's strips resident
//   in shared memory across SMs, is the later fast version.
//
//   backward, per step (2 launches), after one elementwise launch for the
//   last step:
//     prep (elementwise, for step t): dh = alive ? dh_all_t + carry : 0;
//        du_pre = dh (h_{t-1} - c) u (1 - u), dc_pre = dh (1 - u)(1 - c^2)
//        into dx_t.
//     1. gru_bwd_dr_kernel: d_rh = dc_pre W_c^T (needs every candidate
//        column of a row); dr_pre = d_rh h_{t-1} r (1 - r) into dx_t.
//     2. gru_bwd_dh_kernel: dh_prev = dh u + d_rh r + [du_pre, dr_pre]
//        W_ur^T (needs every u and r column of a row); the carry of the
//        rows alive at t takes dh_prev, and the same thread then runs prep
//        for step t-1 on its element, which saves a third launch per step.
//     Both products read a W^T copy the wrapper makes once, so that their
//     operand loads run along rows.
//   backward, after the loop (1 launch): dW_ur = sum h_{t-1}^T [du, dr] and
//     dW_c = sum rh^T dc_pre as ONE tiled reduction over all T*B rows
//     (blockIdx.z picks the part; rh = r h_{t-1} is formed as the operand
//     is loaded). It replaces the TPU's running sum in a sequential grid
//     and needs no atomics. There is no db: the bias went into x, and
//     autograd through that add gives its gradient.
//
// Every product is the block-wide tiled product of csrc/rnn_tile.cuh (shared
// with the LSTM), its reduction split over thread groups and summed in a
// fixed order: deterministic. No cuBLAS.
//
// What bounds it on this card: the work is 2 L H 3H FLOP forward
// (L = sum of the lengths) and 2x that backward (it reads the saved gates,
// so its products are d_rh, the [du, dr] W_ur^T term and the two dW
// parts: 2 L H 6H), in float32 on the FMA units (67 TFLOP/s); the bytes
// are the inputs and the outputs once. At the book model's shapes (B 64,
// H 512, T 80) the bound is operations, ~0.07 ms forward and ~0.13 ms
// backward; this design also pays two
// launches per step and re-reads W and the state from L2 every step, which
// a persistent kernel would not.
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the current CUDA stream through ctypes and checks the
// returned cudaError_t (cudaGetLastError after every launch).

#include "rnn_tile.cuh"

namespace {

using rnn_tile::kThreads;
using rnn_tile::sigmoidf;
using rnn_tile::Tile;

// the per-step products: a 16 x 16 output tile, the reduction split 16 ways
constexpr int kRows = 16;
using StepTile = Tile<kRows, 16, 16, 8>;
// the update/reset stage: 16 units x 2 gates, the reduction split 8 ways
constexpr int kUrUnits = 16;
using UrTile = Tile<kRows, 2 * kUrUnits, 8, 16>;
// dW: 64 rows of W x 64 gate columns, over T*B
using DwTile = Tile<64, 64, 1, 16>;

// Forward stage 1 of step t: u, r of 16 rows x 16 units, and rh = r h_prev.
__global__ void __launch_bounds__(kThreads)
gru_fwd_ur_kernel(const float* __restrict__ x_t, const float* __restrict__ w,
                  const float* __restrict__ h_prev,
                  float* __restrict__ gates_t, float* __restrict__ rh, int B,
                  int H) {
  __shared__ __align__(16) float smem[UrTile::kSmem];
  const int r0 = blockIdx.y * kRows, j0 = blockIdx.x * kUrUnits;
  const int G = 3 * H;
  float acc[4][4];
  UrTile::product<true, false>(
      H,
      [&](int r, int k) {
        const int row = r0 + r;
        return row < B ? h_prev[(size_t)row * H + k] : 0.f;
      },
      [&](int k, int c) {
        const int j = j0 + c % kUrUnits;
        return j < H ? w[(size_t)k * G + (c / kUrUnits) * H + j] : 0.f;
      },
      smem, acc);
  UrTile::reduce(smem, acc);
  const int r = threadIdx.x / kUrUnits, q = threadIdx.x % kUrUnits;
  const int row = r0 + r, j = j0 + q;
  if (row >= B || j >= H) return;
  const float* xr = x_t + (size_t)row * G;
  const float* tr = smem + r * 2 * kUrUnits;
  const float u = sigmoidf(xr[j] + tr[q]);
  const float rg = sigmoidf(xr[H + j] + tr[kUrUnits + q]);
  float* gr = gates_t + (size_t)row * G;
  gr[j] = u;
  gr[H + j] = rg;
  const size_t at = (size_t)row * H + j;
  rh[at] = rg * h_prev[at];
}

// Forward stage 2 of step t: c = tanh(x_c + rh W_c) for 16 rows x 16 units,
// the cell update and the masks. h_prev and h_state may be one buffer.
__global__ void __launch_bounds__(kThreads)
gru_fwd_c_kernel(const float* __restrict__ x_t, const float* __restrict__ w,
                 const float* __restrict__ rh, const float* h_prev,
                 const int* __restrict__ lengths, int t, float* gates_t,
                 float* __restrict__ h_all_t, float* h_state, int B, int H) {
  __shared__ __align__(16) float smem[StepTile::kSmem];
  const int r0 = blockIdx.y * kRows, j0 = blockIdx.x * 16;
  const int G = 3 * H;
  float acc[4][4];
  StepTile::product<true, false>(
      H,
      [&](int r, int k) {
        const int row = r0 + r;
        return row < B ? rh[(size_t)row * H + k] : 0.f;
      },
      [&](int k, int c) {
        const int j = j0 + c;
        return j < H ? w[(size_t)k * G + 2 * H + j] : 0.f;
      },
      smem, acc);
  StepTile::reduce(smem, acc);
  const int r = threadIdx.x / 16, q = threadIdx.x % 16;
  const int row = r0 + r, j = j0 + q;
  if (row >= B || j >= H) return;
  float* gr = gates_t + (size_t)row * G;
  const float c = tanhf(x_t[(size_t)row * G + 2 * H + j] + smem[r * 16 + q]);
  const float u = gr[j];
  const size_t at = (size_t)row * H + j;
  const float hp = h_prev[at];
  const float h_new = u * hp + (1.f - u) * c;
  gr[2 * H + j] = c;
  const bool alive = t < lengths[row];
  h_all_t[at] = alive ? h_new : 0.f;
  h_state[at] = alive ? h_new : hp;
}

// Backward prep of step t for one element (row, k): the masked dh into
// dh_cur, and du_pre, dc_pre into dx_t.
__device__ __forceinline__ void bwd_prep(int row, int k, int t, int H,
                                         const float* __restrict__ gates_t,
                                         const float* __restrict__ h_prev,
                                         const float* __restrict__ dh_out_t,
                                         const float* carry,
                                         const int* __restrict__ lengths,
                                         float* dh_cur, float* dx_t) {
  const int G = 3 * H;
  const size_t at = (size_t)row * H + k;
  const bool alive = t < lengths[row];
  const float dh = alive ? dh_out_t[at] + carry[at] : 0.f;
  const float u = gates_t[(size_t)row * G + k];
  const float c = gates_t[(size_t)row * G + 2 * H + k];
  const float hp = h_prev[at];
  dh_cur[at] = dh;
  float* dxr = dx_t + (size_t)row * G;
  dxr[k] = alive ? dh * (hp - c) * u * (1.f - u) : 0.f;
  dxr[2 * H + k] = alive ? dh * (1.f - u) * (1.f - c * c) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
gru_bwd_prep_kernel(const float* __restrict__ gates_t,
                    const float* __restrict__ h_prev,
                    const float* __restrict__ dh_out_t, const float* carry,
                    const int* __restrict__ lengths, int t, float* dh_cur,
                    float* dx_t, int B, int H) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * H) return;
  bwd_prep(idx / H, idx % H, t, H, gates_t, h_prev, dh_out_t, carry, lengths,
           dh_cur, dx_t);
}

// Backward stage 1 of step t: d_rh = dc_pre W_c^T (wt = W^T [3H, H]) for 16
// rows x 16 units, dr_pre into dx_t, d_rh into its buffer.
__global__ void __launch_bounds__(kThreads)
gru_bwd_dr_kernel(const float* __restrict__ wt,
                  const float* __restrict__ gates_t,
                  const float* __restrict__ h_prev,
                  const int* __restrict__ lengths, int t, float* dx_t,
                  float* __restrict__ d_rh, int B, int H) {
  __shared__ __align__(16) float smem[StepTile::kSmem];
  const int r0 = blockIdx.y * kRows, k0 = blockIdx.x * 16;
  const int G = 3 * H;
  float acc[4][4];
  StepTile::product<true, false>(
      H,
      [&](int r, int j) {
        const int row = r0 + r;
        return row < B ? dx_t[(size_t)row * G + 2 * H + j] : 0.f;
      },
      [&](int j, int c) {
        const int k = k0 + c;
        return k < H ? wt[(size_t)(2 * H + j) * H + k] : 0.f;
      },
      smem, acc);
  StepTile::reduce(smem, acc);
  const int r = threadIdx.x / 16, q = threadIdx.x % 16;
  const int row = r0 + r, k = k0 + q;
  if (row >= B || k >= H) return;
  const size_t at = (size_t)row * H + k;
  const float drh = smem[r * 16 + q];
  const float rg = gates_t[(size_t)row * G + H + k];
  const bool alive = t < lengths[row];
  dx_t[(size_t)row * G + H + k] =
      alive ? drh * h_prev[at] * rg * (1.f - rg) : 0.f;
  d_rh[at] = drh;
}

// Backward stage 2 of step t: dh_prev = dh u + d_rh r + [du, dr] W_ur^T for
// 16 rows x 16 units into the carry of the rows alive at t; then the prep
// of step t-1 on the same element (t_prev_* describe step t-1; unused when
// t == 0).
__global__ void __launch_bounds__(kThreads)
gru_bwd_dh_kernel(const float* __restrict__ wt,
                  const float* __restrict__ gates_t,
                  const float* __restrict__ dx_t,
                  const float* __restrict__ d_rh,
                  const int* __restrict__ lengths, int t, float* dh_cur,
                  float* carry, const float* __restrict__ gates_p,
                  const float* __restrict__ h_prev_p,
                  const float* __restrict__ dh_out_p, float* dx_p, int B,
                  int H) {
  __shared__ __align__(16) float smem[StepTile::kSmem];
  const int r0 = blockIdx.y * kRows, k0 = blockIdx.x * 16;
  const int G = 3 * H;
  float acc[4][4];
  StepTile::product<true, false>(
      2 * H,
      [&](int r, int g) {
        const int row = r0 + r;
        return row < B ? dx_t[(size_t)row * G + g] : 0.f;
      },
      [&](int g, int c) {
        const int k = k0 + c;
        return k < H ? wt[(size_t)g * H + k] : 0.f;
      },
      smem, acc);
  StepTile::reduce(smem, acc);
  const int r = threadIdx.x / 16, q = threadIdx.x % 16;
  const int row = r0 + r, k = k0 + q;
  if (row >= B || k >= H) return;
  const size_t at = (size_t)row * H + k;
  const float* gr = gates_t + (size_t)row * G;
  const float dh_prev =
      dh_cur[at] * gr[k] + d_rh[at] * gr[H + k] + smem[r * 16 + q];
  if (t < lengths[row]) carry[at] = dh_prev;
  if (t > 0)
    bwd_prep(row, k, t - 1, H, gates_p, h_prev_p, dh_out_p, carry, lengths,
             dh_cur, dx_p);
}

// dW [H,3H]: part 0 (blockIdx.z == 0) dW_ur = sum_r hprev[r]^T dx[r, :2H],
// part 1 dW_c = sum_r (r_gate[r] hprev[r])^T dx[r, 2H:], over the R = T*B
// rows; hprev[r] = h0[r] for r < B, else h_all[r - B].
__global__ void __launch_bounds__(kThreads)
gru_dw_kernel(const float* __restrict__ h0, const float* __restrict__ h_all,
              const float* __restrict__ gates, const float* __restrict__ dx,
              float* __restrict__ dw, int R, int B, int H) {
  __shared__ __align__(16) float smem[DwTile::kSmem];
  const int part = blockIdx.z;
  const int k0 = blockIdx.y * 64, g0 = blockIdx.x * 64;
  const int G = 3 * H;
  const int cols = part == 0 ? 2 * H : H;
  const int col0 = part == 0 ? 0 : 2 * H;
  if (g0 >= cols) return;
  float acc[4][4];
  DwTile::product<false, false>(
      R,
      [&](int kk, int r) {
        const int k = k0 + kk;
        if (k >= H) return 0.f;
        const float hp = r < B ? h0[(size_t)r * H + k]
                               : h_all[(size_t)(r - B) * H + k];
        return part == 0 ? hp : gates[(size_t)r * G + H + k] * hp;
      },
      [&](int r, int c) {
        const int g = g0 + c;
        return g < cols ? dx[(size_t)r * G + col0 + g] : 0.f;
      },
      smem, acc);
  const int gy = threadIdx.x / 16, gx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + gy * 4 + i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = g0 + gx * 4 + j;
      if (g < cols) dw[(size_t)k * G + col0 + g] = acc[i][j];
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

const char* fused_gru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward over all T steps: h_all [T,B,H], h_last [B,H] (also the state,
// updated in place), gates [T,B,3H] (u, r, c of every step), rh [B,H]
// scratch. Returns a cudaError_t.
int fused_gru_fwd_f32(const float* x, const float* w, const float* h0,
                      const int* lengths, float* h_all, float* h_last,
                      float* gates, float* rh, int T, int B, int H,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid_ur(cdiv(H, kUrUnits), cdiv(B, kRows));
  const dim3 grid_c(cdiv(H, 16), cdiv(B, kRows));
  const size_t bh = (size_t)B * H, bg = (size_t)B * 3 * H;
  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? h0 : h_last;
    gru_fwd_ur_kernel<<<grid_ur, kThreads, 0, s>>>(x + t * bg, w, hp,
                                                   gates + t * bg, rh, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gru_fwd_c_kernel<<<grid_c, kThreads, 0, s>>>(x + t * bg, w, rh, hp,
                                                 lengths, t, gates + t * bg,
                                                 h_all + t * bh, h_last, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}

// Backward: dh_all [T,B,H] is the output cotangent with the h_last
// cotangent already folded in; wt is W^T [3H,H]; gates as the forward
// wrote them. Writes dx [T,B,3H], dw [H,3H] and dh0 [B,H] (used as the
// carry); dh_cur and d_rh [B,H] are scratch.
int fused_gru_bwd_f32(const float* wt, const float* h0,
                      const int* lengths, const float* h_all,
                      const float* gates, const float* dh_all, float* dx,
                      float* dw, float* dh0, float* dh_cur, float* d_rh,
                      int T, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bh = (size_t)B * H, bg = (size_t)B * 3 * H;
  cudaError_t err = cudaMemsetAsync(dh0, 0, bh * sizeof(float), s);
  if (err != cudaSuccess) return err;
  auto h_prev = [&](int t) { return t == 0 ? h0 : h_all + (t - 1) * bh; };
  const int grid_prep = cdiv(B * H, kThreads);
  gru_bwd_prep_kernel<<<grid_prep, kThreads, 0, s>>>(
      gates + (T - 1) * bg, h_prev(T - 1), dh_all + (T - 1) * bh, dh0,
      lengths, T - 1, dh_cur, dx + (T - 1) * bg, B, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(H, 16), cdiv(B, kRows));
  for (int t = T - 1; t >= 0; --t) {
    gru_bwd_dr_kernel<<<grid, kThreads, 0, s>>>(
        wt, gates + t * bg, h_prev(t), lengths, t, dx + t * bg, d_rh, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int p = t > 0 ? t - 1 : 0;
    gru_bwd_dh_kernel<<<grid, kThreads, 0, s>>>(
        wt, gates + t * bg, dx + t * bg, d_rh, lengths, t, dh_cur, dh0,
        gates + p * bg, h_prev(p), dh_all + p * bh, dx + p * bg, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_dw(cdiv(2 * H, 64), cdiv(H, 64), 2);
  gru_dw_kernel<<<grid_dw, kThreads, 0, s>>>(h0, h_all, gates, dx, dw, T * B,
                                             B, H);
  return cudaGetLastError();
}

}  // extern "C"
