// Fused LSTM time loop, forward and backward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/fused_lstm.py:
//   fused_lstm_fwd_f32  <- _run_fwd / _fwd_kernel
//   fused_lstm_bwd_f32  <- _fused_lstm_bwd / _bwd_kernel
// and computes what they compute, masking included:
//   x [T,B,4H] pre-projected gates, time-major, gate order i, c_hat, f, o;
//   w [H,4H]; b [4H]; h0, c0 [B,H]; lengths [B] int32.
//   gates_t = (x_t + h_{t-1} W) + b; i, f, o = sigmoid; c_hat = tanh;
//   c_t = f c_{t-1} + i c_hat; h_t = o tanh(c_t). A row freezes past its
//   length: its state is carried unchanged and its h_all/c_all are 0.
//   h_last/c_last are the state after the loop, i.e. the state at
//   length-1, or h0/c0 for a zero-length row.
// The backward walks t in reverse and recomputes the gates from
// (x_t, h_{t-1}) as _bwd_kernel does (only h_all and c_all are saved),
// with the same `alive` selects: dgates (= dx_t) is 0 on a dead row, and a
// dead row passes its dh and dc carries on untouched. The caller folds
// the h_last/c_last cotangents into dh_all/dc_all at max(len-1, 0).
//
// Design. The TPU kernel runs a sequential grid over t with (h, c) and all
// of W resident in VMEM. On an H100 the blocks run in parallel and W
// (4 MB at H = 512 in float32) is far above one SM's 227 KB of shared
// memory, so the recurrence cannot live in one block. This file takes the
// simple design: ONE LAUNCH PER TIMESTEP, issued by a host loop inside the
// C function (one ctypes call per layer, not T), with the state kept in
// device memory between launches (it stays in the 50 MB L2 at these
// sizes). Chosen over a persistent cooperative kernel (grid.sync() per
// step, W strips resident in shared memory) because it has no occupancy
// precondition to check and no deadlock risk, and is right first; the
// persistent kernel is the later fast version.
//
//   forward, per step: one kernel. A block owns 32 batch rows and 8 hidden
//     units j, i.e. the four column strips j, H+j, 2H+j, 3H+j of W, so the
//     gate, cell and mask update stays inside the block. The recurrent
//     product h_{t-1} W[:, strips] is a 32 x 32 tile whose reduction over H
//     is split over 4 thread groups (4x4 outputs per thread, operands
//     staged in shared memory, the next stage's operands loaded into
//     registers while this one computes) and summed in a fixed order:
//     deterministic.
//   backward, per step: kernel 1 recomputes the gates the same way and
//     writes dgates = dx_t and the dc carry; kernel 2 computes
//     dh_prev = dgates W^T (it needs every gate column of a row, hence a
//     second launch; it reads a W^T copy the wrapper makes once, so its
//     operand loads run along rows) and writes it into the dh carry of the
//     rows alive at t.
//   backward, after the loop: dW = sum_t h_{t-1}^T dgates_t and
//     db = sum_t dgates_t as ONE tiled reduction over all T*B rows (the
//     operand gets a column of ones, whose output row is db). It replaces
//     the TPU's running sum in a sequential grid and needs no atomics.
//
// What bounds it on this card: the work is 2 L H 4H FLOP per layer forward
// (L = sum of the lengths) and about 3x that backward, in float32 on the
// FMA units (67 TFLOP/s); the bytes are x, W and the outputs once. At the
// LM's shapes (B 64, H 512, T 64) the bound is operations, ~0.1 ms
// forward; this design also pays a launch per step and re-reads W and
// h_{t-1} from L2 every step, which a persistent kernel would not.
//
// No cuBLAS: every product of the recurrence is computed here.
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the current CUDA stream through ctypes and checks the
// returned cudaError_t (cudaGetLastError after every launch).

#include "rnn_tile.cuh"

namespace {

using rnn_tile::kThreads;
using rnn_tile::sigmoidf;
using rnn_tile::Tile;

// forward step and backward gate recompute: 32 rows x (8 units x 4 gates)
constexpr int kStepRows = 32;
constexpr int kStepUnits = 8;
using StepTile = Tile<kStepRows, 4 * kStepUnits, 4, 32>;
// backward dh_prev = dgates W^T: 16 rows x 16 units, reduction over 4H
using DhTile = Tile<16, 16, 16, 8>;
// dW / db: 64 rows of W (plus the ones row) x 64 gate columns, over T*B
using DwTile = Tile<64, 64, 1, 16>;

// The recurrent product of one step, h_prev [B,H] times the block's four
// W strips; leaves the 32 x 32 tile (column q*8+u = gate q of unit j0+u)
// in smem.
__device__ __forceinline__ void step_gates(const float* h_prev,
                                           const float* __restrict__ w,
                                           int r0, int j0, int B, int H,
                                           float* smem) {
  const int G = 4 * H;
  float acc[4][4];
  StepTile::product<true, false>(
      H,
      [&](int r, int k) {
        const int row = r0 + r;
        return row < B ? h_prev[(size_t)row * H + k] : 0.f;
      },
      [&](int k, int c) {
        const int j = j0 + c % kStepUnits;
        return j < H ? w[(size_t)k * G + (c / kStepUnits) * H + j] : 0.f;
      },
      smem, acc);
  StepTile::reduce(smem, acc);
}

__global__ void __launch_bounds__(kThreads)
lstm_fwd_step_kernel(const float* __restrict__ x_t,
                     const float* __restrict__ w,
                     const float* __restrict__ b, const float* h_prev,
                     const float* c_prev, const int* __restrict__ lengths,
                     int t, float* __restrict__ h_all_t,
                     float* __restrict__ c_all_t, float* h_next,
                     float* c_state, int B, int H) {
  __shared__ __align__(16) float smem[StepTile::kSmem];
  const int r0 = blockIdx.y * kStepRows;
  const int j0 = blockIdx.x * kStepUnits;
  step_gates(h_prev, w, r0, j0, B, H, smem);

  const int r = threadIdx.x / kStepUnits, u = threadIdx.x % kStepUnits;
  const int row = r0 + r, j = j0 + u;
  if (row >= B || j >= H) return;
  const int G = 4 * H;
  const float* xr = x_t + (size_t)row * G;
  const float* tr = smem + r * (4 * kStepUnits);
  const float gi = (xr[j] + tr[u]) + b[j];
  const float gc = (xr[H + j] + tr[kStepUnits + u]) + b[H + j];
  const float gf = (xr[2 * H + j] + tr[2 * kStepUnits + u]) + b[2 * H + j];
  const float go = (xr[3 * H + j] + tr[3 * kStepUnits + u]) + b[3 * H + j];
  const float i = sigmoidf(gi), cand = tanhf(gc), f = sigmoidf(gf),
              o = sigmoidf(go);
  const size_t at = (size_t)row * H + j;
  const float cp = c_prev[at], hp = h_prev[at];
  const float c_new = f * cp + i * cand;
  const float h_new = o * tanhf(c_new);
  const bool alive = t < lengths[row];
  h_all_t[at] = alive ? h_new : 0.f;
  c_all_t[at] = alive ? c_new : 0.f;
  h_next[at] = alive ? h_new : hp;
  c_state[at] = alive ? c_new : cp;
}

__global__ void __launch_bounds__(kThreads)
lstm_bwd_gates_kernel(const float* __restrict__ x_t,
                      const float* __restrict__ w,
                      const float* __restrict__ b,
                      const float* __restrict__ h_prev,
                      const float* __restrict__ c_prev,
                      const int* __restrict__ lengths, int t,
                      const float* __restrict__ dh_out_t,
                      const float* __restrict__ dc_out_t,
                      const float* __restrict__ dh_carry, float* dc_carry,
                      float* __restrict__ dx_t, int B, int H) {
  __shared__ __align__(16) float smem[StepTile::kSmem];
  const int r0 = blockIdx.y * kStepRows;
  const int j0 = blockIdx.x * kStepUnits;
  step_gates(h_prev, w, r0, j0, B, H, smem);

  const int r = threadIdx.x / kStepUnits, u = threadIdx.x % kStepUnits;
  const int row = r0 + r, j = j0 + u;
  if (row >= B || j >= H) return;
  const int G = 4 * H;
  const float* xr = x_t + (size_t)row * G;
  const float* tr = smem + r * (4 * kStepUnits);
  const float gi = (xr[j] + tr[u]) + b[j];
  const float gc = (xr[H + j] + tr[kStepUnits + u]) + b[H + j];
  const float gf = (xr[2 * H + j] + tr[2 * kStepUnits + u]) + b[2 * H + j];
  const float go = (xr[3 * H + j] + tr[3 * kStepUnits + u]) + b[3 * H + j];
  const float i = sigmoidf(gi), cand = tanhf(gc), f = sigmoidf(gf),
              o = sigmoidf(go);
  const size_t at = (size_t)row * H + j;
  const float cp = c_prev[at];
  const float c = f * cp + i * cand;
  const float tc = tanhf(c);
  const bool alive = t < lengths[row];
  const float dcc = dc_carry[at];
  float dh = dh_out_t[at] + dh_carry[at];
  dh = alive ? dh : 0.f;
  float dc = dh * o * (1.f - tc * tc) + dcc + dc_out_t[at];
  dc = alive ? dc : dcc;
  float* dxr = dx_t + (size_t)row * G;
  dxr[j] = alive ? dc * cand * i * (1.f - i) : 0.f;
  dxr[H + j] = alive ? dc * i * (1.f - cand * cand) : 0.f;
  dxr[2 * H + j] = alive ? dc * cp * f * (1.f - f) : 0.f;
  dxr[3 * H + j] = alive ? dh * tc * o * (1.f - o) : 0.f;
  dc_carry[at] = alive ? dc * f : dcc;
}

// wt is W^T [4H, H], so that the operand's loads run along its rows.
__global__ void __launch_bounds__(kThreads)
lstm_bwd_dh_kernel(const float* __restrict__ dx_t,
                   const float* __restrict__ wt,
                   const int* __restrict__ lengths, int t, float* dh_carry,
                   int B, int H) {
  __shared__ __align__(16) float smem[DhTile::kSmem];
  const int r0 = blockIdx.y * 16, k0 = blockIdx.x * 16;
  const int G = 4 * H;
  float acc[4][4];
  DhTile::product<true, false>(
      G,
      [&](int r, int g) {
        const int row = r0 + r;
        return row < B ? dx_t[(size_t)row * G + g] : 0.f;
      },
      [&](int g, int c) {
        const int k = k0 + c;
        return k < H ? wt[(size_t)g * H + k] : 0.f;
      },
      smem, acc);
  DhTile::reduce(smem, acc);
  const int r = threadIdx.x / 16, c = threadIdx.x % 16;
  const int row = r0 + r, k = k0 + c;
  if (row < B && k < H && t < lengths[row])
    dh_carry[(size_t)row * H + k] = smem[r * 16 + c];
}

// dW [H,4H] = sum_r hprev[r]^T dx[r] and db [4H] = sum_r dx[r] over the
// R = T*B rows, hprev[r] = h0[r] for r < B, else h_all[r - B]; operand
// row H of the product is a row of ones, and its output row is db.
__global__ void __launch_bounds__(kThreads)
lstm_dw_kernel(const float* __restrict__ h0, const float* __restrict__ h_all,
               const float* __restrict__ dx, float* __restrict__ dw,
               float* __restrict__ db, int R, int B, int H) {
  __shared__ __align__(16) float smem[DwTile::kSmem];
  const int k0 = blockIdx.y * 64, g0 = blockIdx.x * 64;
  const int G = 4 * H;
  float acc[4][4];
  DwTile::product<false, false>(
      R,
      [&](int kk, int r) {
        const int k = k0 + kk;
        if (k > H) return 0.f;
        if (k == H) return 1.f;
        return r < B ? h0[(size_t)r * H + k]
                     : h_all[(size_t)(r - B) * H + k];
      },
      [&](int r, int c) {
        const int g = g0 + c;
        return g < G ? dx[(size_t)r * G + g] : 0.f;
      },
      smem, acc);
  const int gy = threadIdx.x / 16, gx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + gy * 4 + i;
    if (k > H) continue;
    float* out = k == H ? db : dw + (size_t)k * G;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = g0 + gx * 4 + j;
      if (g < G) out[g] = acc[i][j];
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

const char* fused_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward over all T steps: h_all, c_all [T,B,H]; h_last, c_last [B,H];
// h_scratch [B,H] is the second buffer of the h ping-pong (c_last holds
// the c state in place). Returns a cudaError_t.
int fused_lstm_fwd_f32(const float* x, const float* w, const float* b,
                       const float* h0, const float* c0, const int* lengths,
                       float* h_all, float* c_all, float* h_last,
                       float* c_last, float* h_scratch, int T, int B, int H,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(cdiv(H, kStepUnits), cdiv(B, kStepRows));
  const size_t bh = (size_t)B * H;
  // step t writes buf[t % 2]; the last step's buffer is h_last
  float* buf[2];
  buf[(T - 1) % 2] = h_last;
  buf[T % 2] = h_scratch;
  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? h0 : buf[(t - 1) % 2];
    const float* cp = t == 0 ? c0 : c_last;
    lstm_fwd_step_kernel<<<grid, kThreads, 0, s>>>(
        x + (size_t)t * B * 4 * H, w, b, hp, cp, lengths, t, h_all + t * bh,
        c_all + t * bh, buf[t % 2], c_last, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}

// Backward: dh_all, dc_all [T,B,H] are the output cotangents with the
// h_last/c_last cotangents already folded in; wt is W^T [4H,H]. Writes
// dx [T,B,4H], dw [H,4H], db [4H], and dh0, dc0 [B,H] (used as the
// carries).
int fused_lstm_bwd_f32(const float* x, const float* w, const float* wt,
                       const float* b,
                       const float* h0, const float* c0, const int* lengths,
                       const float* h_all, const float* c_all,
                       const float* dh_all, const float* dc_all, float* dx,
                       float* dw, float* db, float* dh0, float* dc0, int T,
                       int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bh = (size_t)B * H;
  cudaError_t err = cudaMemsetAsync(dh0, 0, bh * sizeof(float), s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(dc0, 0, bh * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const dim3 grid_gates(cdiv(H, kStepUnits), cdiv(B, kStepRows));
  const dim3 grid_dh(cdiv(H, 16), cdiv(B, 16));
  for (int t = T - 1; t >= 0; --t) {
    const float* hp = t == 0 ? h0 : h_all + (t - 1) * bh;
    const float* cp = t == 0 ? c0 : c_all + (t - 1) * bh;
    float* dx_t = dx + (size_t)t * B * 4 * H;
    lstm_bwd_gates_kernel<<<grid_gates, kThreads, 0, s>>>(
        x + (size_t)t * B * 4 * H, w, b, hp, cp, lengths, t, dh_all + t * bh,
        dc_all + t * bh, dh0, dc0, dx_t, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    lstm_bwd_dh_kernel<<<grid_dh, kThreads, 0, s>>>(dx_t, wt, lengths, t,
                                                    dh0, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_dw(cdiv(4 * H, 64), cdiv(H + 1, 64));
  lstm_dw_kernel<<<grid_dw, kThreads, 0, s>>>(h0, h_all, dx, dw, db, T * B, B,
                                              H);
  return cudaGetLastError();
}

}  // extern "C"
