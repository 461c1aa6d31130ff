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
// Design: one persistent launch walks all T steps. The TPU kernel runs a
// sequential grid over t with h and all of W resident in VMEM. W (3 MB at
// H = 512 in float32) is far above one SM's 227 KB of shared memory, but
// not above the card's: spread over the SMs, each block keeps its strip
// of W in shared memory for the whole call. A step still has two
// dependent stages across blocks (a unit's candidate needs r h_{t-1} of
// its whole row, i.e. the reset gates of every unit), and a grid-wide
// barrier stands between them where a kernel launch stood before.
//
//   Tiles. A tile is 16 rows x 16 hidden units: R = ceil(B/16) row groups
//   x S = ceil(H/16) strips, strip-major; 4 x 32 = 128 tiles at the book
//   model's B 64, H 512, one 256-thread block each on 132 SMs. The grid
//   is the co-resident maximum (cudaOccupancyMaxActiveBlocksPerMultiprocessor
//   x the SM count) capped at the tile count, launched cooperatively: a
//   grid that cannot be co-resident is refused and the C function returns
//   the error (the wrapper raises with the plan; there is no fallback).
//   With fewer blocks than tiles, block b walks the contiguous tiles
//   [b n / G, (b+1) n / G) of each stage in turn.
//   Shared memory (dynamic, planned by the host; H 512: 135 KB forward,
//   166 KB backward):
//     W strip   by k-quads (4 rows, each column's 4 values together, 4
//               floats of padding a quad). Forward: W_u, W_r, W_c at the
//               strip's 16 units (98 KB at H 512). Backward: the strip's
//               16 ROWS of W, W_c's columns then W_ur's (102 KB), which
//               serve d_rh = dc W_c^T and [du, dr] W_ur^T: no W^T copy.
//     A         the tile's 16 rows of the stage's left operand (h_{t-1},
//               rh or dx), all K of it (H 512: 32 KB forward, 64 KB for
//               the backward's K = 2H), row-major.
//     x slots   forward, the block's first 4 tiles: each thread's x_u,
//               x_r, x_c (prefetched), u and h_{t-1} (5 KB a slot).
//   Streamed W. The strip is resident for the quads that fit (all of it
//   up to H ~870 forward, ~700 backward; past that A is staged 256 k at a
//   time); the rest, and the whole strip of a block's tiles of another
//   strip, is read from L2 every step. Slower, but right: every shape
//   runs.
//
//   A product (tile_product): A's rows come from L2 by 16-byte
//   cp.async.cg copies in groups of one quad a lane, two groups ahead of
//   the one being multiplied. Warp w owns an 8 x 8 block of the tile's
//   outputs; its 32 lanes split K by quads, each lane reading per quad 8
//   float4 of A and 8 of W (consecutive quads on distinct banks) for 256
//   FMA; a shuffle reduce-scatter then sums the lanes.
//
//   forward, step t (h_{t-1} in one state buffer, h_t into the other:
//   ping-pong, the last step's into h_last):
//     stage 1: [u r] = h_{t-1} W_ur for the tile (K = H); writes u, r and
//       rh = r h_{t-1}.                                     -- barrier --
//     stage 2: c = tanh(x_c + rh W_c) (K = H); the cell update, the masks,
//       h_all_t and h_t; then the tile's threads prefetch x_{t+1} into
//       their slots with cp.async, which lands during the   -- barrier --
//   backward, after prep(T-1) and a barrier; step t:
//     stage A: d_rh = dc_pre W_c^T (K = H, every candidate column of the
//       row); dr_pre = d_rh h_{t-1} r (1 - r) into dx_t.    -- barrier --
//     stage B: dh_prev = dh u + d_rh r + [du_pre, dr_pre] W_ur^T (K = 2H);
//       the carry of the rows alive at t takes it; then prep(t-1) on the
//       same element: dh = alive ? dh_all + carry : 0, du_pre = dh (h_{t-1}
//       - c) u (1 - u), dc_pre = dh (1 - u)(1 - c^2) into dx.  -- barrier --
//     then dW_ur = sum h_{t-1}^T [du, dr] and dW_c = sum rh^T dc_pre as one
//     tiled reduction over the T*B rows in row splits (enough blocks for
//     the card; blockIdx.z picks part and split) and a kernel that adds
//     the splits in order: no atomics. There is no db: the bias went into
//     x, and autograd through that add gives its gradient.
//
//   Barrier (struct Barrier): sense-reversing on a global counter that
//   the C function zeroes before the launch (csrc/grid_sync.cuh has the
//   ordering rule). The leader adds 2^31 - (members - 1), every other
//   member 1, so the counter's top bit flips exactly when all have
//   arrived and its low bits are 0 again for the next barrier. A step's
//   data never leaves a row group, so with a block a tile the blocks of
//   each row group meet on their own counter. Values other blocks write
//   during the call (state, rh, dx) are read through L2 (ld.global.cg,
//   cp.async.cg).
//
// Every product sums in a fixed order: each lane adds its quads' products
// in k order, the lanes are summed by a fixed shuffle tree, and two warps
// of a tile in warp order. No atomics but the barriers' counters: a rerun
// is bitwise equal.
//
// What bounds it on this card: the work is 2 L H 3H FLOP forward (L = sum
// of the lengths) and 2x that backward (d_rh, [du, dr] W_ur^T and the
// two dW parts: 2 L H 6H), float32 on the FMA units (67 TFLOP/s); at the
// book model's shapes (B 64, H 512, T 80) ~0.07 ms forward and ~0.13 ms
// backward. A step of this design costs two barriers (each a fence, an
// atomic and an acquire that invalidates L1), each block's copy of its 16
// rows of the left operand from L2 in each stage (32 tiles share a row
// group: ~4 MB a stage over the grid), and the block's FMA (0.8 M forward)
// on 8 warps of one SM, whose shared-memory reads and FMA run at about
// the same rate and overlap little. paddle_tpu_torch/tools/gru_step_split.py
// times each phase of a step on the card; PERF.md has its numbers.
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers, the current CUDA stream and a host int[9] that receives the
// launch plan (tiles, blocks per SM, SMs, grid, shared bytes, resident W
// quads, A chunk, x slots, barriers) through ctypes, and checks the
// returned cudaError_t.

#include "grid_sync.cuh"
#include "rnn_tile.cuh"

namespace {

using rnn_tile::kThreads;
using rnn_tile::sigmoidf;
using rnn_tile::Tile;

constexpr int kRows = 16;   // rows of a tile
constexpr int kUnits = 16;  // hidden units of a tile
constexpr int kWarps = kThreads / 32;
// W strips in shared memory by k-quad: quad q holds W[4q..4q+3][c] of each
// column c as 4 consecutive floats, and is padded by 4 floats, so that the
// lanes of a warp, each on its own quad, read on distinct banks
constexpr int kFwdCols = 3 * kUnits;         // forward: u, r, c columns
constexpr int kFwdQuad = 4 * kFwdCols + 4;   // floats a forward quad
constexpr int kBwdQuad = 4 * kUnits + 4;     // floats a backward quad
constexpr int kAPad = 4;            // floats past a staged row of A
constexpr int kAChunk = 256;        // k of A staged at a time when all of
                                    // it does not fit
constexpr int kOutFloats = 2 * kRows * kUnits;  // the product's partials
constexpr int kLag = 2;             // copy groups of A in flight ahead
constexpr int kMaxSlots = 4;        // tiles of a block with a slot
// a forward slot, one float a thread each: x_u, x_r, x_c of step t (the
// cp.async prefetch), then u and h_{t-1} carried from stage 1 to stage 2
constexpr int kSlot = 5 * kThreads;
// dW: 64 rows of W x 64 gate columns, over T*B
using DwTile = Tile<64, 64, 1, 16>;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The blocks a barrier must gather: a step's data flow never leaves a
// row group (a tile reads only its own rows of the state, rh and dx), so
// with one tile a block the blocks of row group g = blockIdx.x % R meet
// on counter g (its own 128-byte line), led by the block of strip 0;
// with fewer blocks than tiles all of them meet on counter 0, led by
// block 0. The counters need kSyncWords words each, zeroed before the
// launch.
constexpr int kSyncWords = 32;
struct Barrier {
  unsigned* counter;
  unsigned add;  // 2^31 - (members - 1) for the leader, else 1
  __device__ Barrier(unsigned* words, int B, int H) {
    const unsigned groups = cdiv(B, kRows), n = groups * cdiv(H, kUnits);
    const bool per_group = gridDim.x == n;
    counter = words + (per_group ? blockIdx.x % groups * kSyncWords : 0);
    const unsigned members = per_group ? n / groups : gridDim.x;
    const bool leader = per_group ? blockIdx.x < groups : blockIdx.x == 0;
    add = leader ? 0x80000000u - (members - 1) : 1u;
  }
  // Sense-reversing: the counter's top bit flips when the last member
  // arrives, and its low bits are 0 again for the next barrier.
  __device__ __forceinline__ void sync() const {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned old = grid::arrive(counter, add);
      while (((old ^ grid::load_acquire(counter)) & 0x80000000u) == 0) {
      }
    }
    __syncthreads();
  }
};

// The block's tiles [begin, end) of the R x S tiles, strip-major.
struct Tiles {
  int begin, end, groups;
  __device__ Tiles(int B, int H) : groups(cdiv(B, kRows)) {
    const long long n = (long long)groups * cdiv(H, kUnits);
    begin = (int)(n * blockIdx.x / gridDim.x);
    end = (int)(n * (blockIdx.x + 1) / gridDim.x);
  }
  __device__ int row0(int i) const { return (i % groups) * kRows; }
  __device__ int unit0(int i) const { return (i / groups) * kUnits; }
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One round of a warp's reduce-scatter of acc[0, 2N) to acc[0, N): with
// lane mask m = N / 2, a lane keeps the upper half iff (lane & m) and adds
// its partner's copy of that half. After the rounds N = 32, 16, ..., 2,
// lane l holds the warp's sums of values 2l and 2l + 1.
template <int N>
__device__ __forceinline__ void reduce_half(float (&acc)[64], int lane) {
  const bool hi = lane & (N / 2);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = hi ? acc[i] : acc[i + N];
    const float keep = hi ? acc[i + N] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, N / 2);
  }
}

// One tile's product: out[r][c] = sum_k A[r][k] B[k][c], r < 16, c < TC,
// into as[r * TC + c] (as is the A buffer).
//   A[r][k] = a[r * lda + k] for r < rows, k < K (0 past), written by other
//   blocks during the call: staged row-major in as (row stride a_cap + 4)
//   a_cap k at a time, by 16-byte cp.async.cg copies (through L2) where
//   every row is 16-byte aligned, in groups of one quad a lane, two groups
//   ahead of the one being multiplied; else by ld.global.cg loads.
//   B[k][c] = column c0 + c of the quad-interleaved W strip w_s (quad
//   stride w_quad) for k < 4 q_res, and w_at(k, c) (device memory, 0 past
//   K) beyond.
// Warp w owns the 8 x 8 outputs of tile w % (2 TC / 8) (rows 8 (w' / (TC /
// 8)), columns 8 (w' % (TC / 8))); its lane l sums them over the k-quads
// l, l + n, ... (n = 32 or, for TC = 16 with two warps a tile, 64), four
// k a quad in order: per quad, 8 float4 of A and 8 of W feed 256 FMA.
// The warp's partial tiles are summed by a shuffle reduce-scatter (lane l
// ends with outputs 2l, 2l + 1 of its 8 x 8), and for TC = 16 the two
// warps of a tile are added in warp order: a fixed order. Starts and ends
// with a block barrier.
template <int TC, class WG>
__device__ __forceinline__ void tile_product(const float* a, size_t lda,
                                             int rows, int K, int a_cap,
                                             const float* w_s, int w_quad,
                                             int c0, int q_res, WG w_at,
                                             float* as) {
  constexpr int kTiles = 2 * TC / 8;
  constexpr int kPerTile = kWarps / kTiles;  // warps of a tile
  constexpr int kSplit = 32 * kPerTile;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = warp % kTiles, part = warp / kTiles;
  const int r8 = (tile / (TC / 8)) * 8, g8 = (tile % (TC / 8)) * 8;
  const int s = part * 32 + lane;
  const int a_ld = a_cap + kAPad;
  const bool aligned =
      ((reinterpret_cast<size_t>(a) | (lda * sizeof(float))) & 15) == 0;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  __syncthreads();  // the previous product's result has been read
  for (int k0 = 0; k0 < K; k0 += a_cap) {
    const int len = min(a_cap, K - k0), quads = cdiv(len, 4);
    // copy groups of one quad a lane (128 or 256 k)
    const int subs = cdiv(quads, kSplit);
    if (k0 > 0) __syncthreads();  // the previous chunk has been read
    // copy group `sub` (empty past the last: the groups stay counted);
    // the index math divides by the constant kSplit (on an H100 a
    // runtime divisor here cost ~1500 cycles a step)
    auto issue = [&](int sub) {
      for (int idx = tid; idx < kRows * kSplit; idx += kThreads) {
        const int r = idx / kSplit, q = sub * kSplit + idx % kSplit;
        if (q >= quads) continue;
        float* dst = as + r * a_ld + 4 * q;
        if (r < rows)
          grid::cp_async16(dst, a + r * lda + k0 + 4 * q);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      grid::cp_async_commit();
    };
    if (aligned) {  // then K and k0 are multiples of 4
      for (int sub = 0; sub < kLag; ++sub) issue(sub);
    } else {
      for (int idx = tid; idx < kRows * 4 * quads; idx += kThreads) {
        const int r = idx / (4 * quads), k = idx % (4 * quads);
        as[r * a_ld + k] =
            (r < rows && k < len) ? grid::load_cg(a + r * lda + k0 + k) : 0.f;
      }
    }
    const int q0 = k0 / 4, res = max(0, min(quads, q_res - q0));
    const float* arow = as + r8 * a_ld;
    // each group is multiplied as soon as it has landed, kLag groups
    // ahead in flight
    for (int sub = 0; sub < subs; ++sub) {
      if (aligned) {
        issue(sub + kLag);
        grid::cp_async_wait(kLag);
      }
      __syncthreads();
      const int q = sub * kSplit + s;
      if (q < quads) {
        float4 w[8];
        if (q < res) {
          const float* wq = w_s + (size_t)(q0 + q) * w_quad + (c0 + g8) * 4;
#pragma unroll
          for (int c = 0; c < 8; ++c) w[c] = lds4(wq + 4 * c);
        } else {
          const int k = k0 + 4 * q;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            w[c] = make_float4(w_at(k, g8 + c), w_at(k + 1, g8 + c),
                               w_at(k + 2, g8 + c), w_at(k + 3, g8 + c));
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 av = lds4(arow + r * a_ld + 4 * q);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            float& d = acc[r * 8 + c];
            d = fmaf(av.x, w[c].x, d);
            d = fmaf(av.y, w[c].y, d);
            d = fmaf(av.z, w[c].z, d);
            d = fmaf(av.w, w[c].w, d);
          }
        }
      }
    }
  }
  reduce_half<32>(acc, lane);
  reduce_half<16>(acc, lane);
  reduce_half<8>(acc, lane);
  reduce_half<4>(acc, lane);
  reduce_half<2>(acc, lane);
  __syncthreads();  // every warp is done with the staged A
  // lane l: row r8 + l / 4, columns g8 + 2 (l % 4) and the next
  float* out = as + part * kRows * TC + (r8 + lane / 4) * TC + g8 +
               2 * (lane % 4);
  out[0] = acc[0];
  out[1] = acc[1];
  __syncthreads();
  if (kPerTile == 2) {
    for (int e = tid; e < kRows * TC; e += kThreads)
      as[e] = as[e] + as[kRows * TC + e];
    __syncthreads();
  }
}

struct FwdArgs {
  const float* x;
  const float* w;
  const float* h0;
  const int* lengths;
  float* h_all;
  float* h_last;
  float* h_pong;
  float* gates;
  float* rh;
  unsigned* sync;
  int T, B, H, q_res, a_cap, slots;
};

__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_persistent_kernel(const FwdArgs p) {
  extern __shared__ float smem[];
  const int B = p.B, H = p.H, G = 3 * H;
  const Tiles tiles(B, H);
  const Barrier barrier(p.sync, B, H);
  float* ws = smem;                                      // [q_res] quads
  float* as = ws + (size_t)p.q_res * kFwdQuad;           // A
  float* xs = as + max(kRows * (p.a_cap + kAPad), kOutFloats);  // slots
  const int r = threadIdx.x / kUnits, q = threadIdx.x % kUnits;
  const int n_tiles = tiles.end - tiles.begin;
  const int n_slot = min(n_tiles, p.slots);
  // the W strip of the block's first tile, k < 4 q_res (0 past H)
  const int j_strip = tiles.unit0(tiles.begin);
  for (int idx = threadIdx.x; idx < p.q_res * 4 * kFwdCols;
       idx += kThreads) {
    const int k = idx / kFwdCols, c = idx % kFwdCols;
    const int j = j_strip + c % kUnits;
    ws[(k / 4) * kFwdQuad + c * 4 + k % 4] =
        (k < H && j < H) ? p.w[(size_t)k * G + (c / kUnits) * H + j] : 0.f;
  }
  // slot i's floats of this thread: x_u, x_r, x_c, u, h_{t-1}
  auto slot = [&](int i, int part) -> float& {
    return xs[i * kSlot + part * kThreads + threadIdx.x];
  };
  // x_t of this thread's element of tile i into its slot
  auto prefetch = [&](int t, int i) {
    const int row = tiles.row0(tiles.begin + i) + r;
    const int j = tiles.unit0(tiles.begin + i) + q;
    if (row >= B || j >= H) return;
    const float* src = p.x + ((size_t)t * B + row) * G + j;
    for (int gate = 0; gate < 3; ++gate)
      grid::cp_async4(&slot(i, gate), src + gate * H);
  };
  for (int i = 0; i < n_slot; ++i) prefetch(0, i);
  grid::cp_async_commit();
  auto x_at = [&](int t, int i, int row, int j, int gate) {
    return i < n_slot ? slot(i, gate)
                      : p.x[((size_t)t * B + row) * G + gate * H + j];
  };
  // h_t goes to h_last for t = T-1 and alternates buffers before it
  auto state = [&](int t) {
    return ((p.T - 1 - t) & 1) ? p.h_pong : p.h_last;
  };
  for (int t = 0; t < p.T; ++t) {
    const float* hp = t == 0 ? p.h0 : state(t - 1);
    float* hn = state(t);
    float* gates_t = p.gates + (size_t)t * B * G;
    float* h_all_t = p.h_all + (size_t)t * B * H;
    grid::cp_async_wait_all();
    // stage 1: u and r of each tile, rh = r h_{t-1}
    for (int i = 0; i < n_tiles; ++i) {
      const int r0 = tiles.row0(tiles.begin + i);
      const int j0 = tiles.unit0(tiles.begin + i);
      const int row = r0 + r, j = j0 + q;
      const bool valid = row < B && j < H;
      const size_t at = (size_t)row * H + j;
      // loaded before the product, which hides its latency
      const float hpv = valid ? grid::load_cg(hp + at) : 0.f;
      tile_product<2 * kUnits>(
          hp + (size_t)r0 * H, H, min(kRows, B - r0), H, p.a_cap, ws,
          kFwdQuad, 0, j0 == j_strip ? p.q_res : 0,
          [&](int k, int c) {
            const int jj = j0 + c % kUnits;
            return (k < H && jj < H)
                       ? p.w[(size_t)k * G + (c / kUnits) * H + jj]
                       : 0.f;
          },
          as);
      if (valid) {
        const float u = sigmoidf(x_at(t, i, row, j, 0) + as[r * 32 + q]);
        const float rg =
            sigmoidf(x_at(t, i, row, j, 1) + as[r * 32 + kUnits + q]);
        float* gr = gates_t + (size_t)row * G;
        gr[j] = u;
        gr[H + j] = rg;
        p.rh[at] = rg * hpv;
        if (i < n_slot) {
          slot(i, 3) = u;
          slot(i, 4) = hpv;
        }
      }
    }
    barrier.sync();
    // stage 2: c of each tile, the cell update and the masks
    for (int i = 0; i < n_tiles; ++i) {
      const int r0 = tiles.row0(tiles.begin + i);
      const int j0 = tiles.unit0(tiles.begin + i);
      const int row = r0 + r, j = j0 + q;
      const bool valid = row < B && j < H;
      const size_t at = (size_t)row * H + j;
      float* gr = gates_t + (size_t)row * G;
      const bool spill = valid && i >= n_slot;  // no slot: reload u, h
      const float u_g = spill ? grid::load_cg(gr + j) : 0.f;
      const float hp_g = spill ? grid::load_cg(hp + at) : 0.f;
      const int len = valid ? p.lengths[row] : 0;
      tile_product<kUnits>(
          p.rh + (size_t)r0 * H, H, min(kRows, B - r0), H, p.a_cap, ws,
          kFwdQuad, 2 * kUnits, j0 == j_strip ? p.q_res : 0,
          [&](int k, int c) {
            const int jj = j0 + c;
            return (k < H && jj < H) ? p.w[(size_t)k * G + 2 * H + jj]
                                     : 0.f;
          },
          as);
      if (valid) {
        const float c = tanhf(x_at(t, i, row, j, 2) + as[r * kUnits + q]);
        const float u = spill ? u_g : slot(i, 3);
        const float hpv = spill ? hp_g : slot(i, 4);
        const float h_new = u * hpv + (1.f - u) * c;
        gr[2 * H + j] = c;
        const bool alive = t < len;
        h_all_t[at] = alive ? h_new : 0.f;
        hn[at] = alive ? h_new : hpv;
        if (i < n_slot && t + 1 < p.T) prefetch(t + 1, i);
      }
    }
    grid::cp_async_commit();
    if (t + 1 < p.T) barrier.sync();
  }
}

struct BwdArgs {
  const float* w;
  const float* h0;
  const int* lengths;
  const float* h_all;
  const float* gates;
  const float* dh_all;
  float* dx;
  float* carry;
  float* dh_cur;
  float* d_rh;
  unsigned* sync;
  int T, B, H, q_res, a_cap;
};

// What prep of step t reads of element (row, k), loaded ahead of use.
struct PrepIn {
  bool alive;
  float dh_out, u, c, hp;
};

__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_persistent_kernel(const BwdArgs p) {
  extern __shared__ float smem[];
  const int B = p.B, H = p.H, G = 3 * H;
  const size_t bh = (size_t)B * H;
  const Tiles tiles(B, H);
  const Barrier barrier(p.sync, B, H);
  // the strip's 16 rows of W by quads of columns: first W_c's (j = g - 2H
  // of [0, H)), then W_ur's (g of [0, 2H)), q_res quads in all
  const int qc = cdiv(H, 4), qc_res = min(qc, p.q_res);
  const int qur_res = p.q_res - qc_res;
  float* ws_c = smem;
  float* ws_ur = smem + (size_t)qc_res * kBwdQuad;
  float* as = smem + (size_t)p.q_res * kBwdQuad;
  const int r = threadIdx.x / kUnits, q = threadIdx.x % kUnits;
  const int k_strip = tiles.unit0(tiles.begin);
  for (int idx = threadIdx.x; idx < p.q_res * 4 * kUnits; idx += kThreads) {
    const int quad = idx / (4 * kUnits), kc = idx / 4 % kUnits, e = idx % 4;
    const bool c_part = quad < qc_res;
    const int g = c_part ? 4 * quad + e : 4 * (quad - qc_res) + e;
    const int k = k_strip + kc;
    const bool in = k < H && g < (c_part ? H : 2 * H);
    smem[idx / (4 * kUnits) * kBwdQuad + kc * 4 + e] =
        in ? p.w[(size_t)k * G + (c_part ? 2 * H : 0) + g] : 0.f;
  }
  auto h_prev = [&](int t, size_t at) {
    return t == 0 ? p.h0[at] : p.h_all[(t - 1) * bh + at];
  };
  auto prep_in = [&](int t, int row, int k) {
    const size_t at = (size_t)row * H + k;
    const float* gr = p.gates + ((size_t)t * B + row) * G;
    return PrepIn{t < p.lengths[row], p.dh_all[t * bh + at], gr[k],
                  gr[2 * H + k], h_prev(t, at)};
  };
  // prep of step t on element (row, k): the masked dh, du_pre and dc_pre
  auto prep = [&](int t, int row, int k, const PrepIn& in, float carry) {
    const size_t at = (size_t)row * H + k;
    const float dh = in.alive ? in.dh_out + carry : 0.f;
    p.dh_cur[at] = dh;
    float* dxr = p.dx + ((size_t)t * B + row) * G;
    dxr[k] = in.alive ? dh * (in.hp - in.c) * in.u * (1.f - in.u) : 0.f;
    dxr[2 * H + k] =
        in.alive ? dh * (1.f - in.u) * (1.f - in.c * in.c) : 0.f;
  };
  for (int i = tiles.begin; i < tiles.end; ++i) {
    const int row = tiles.row0(i) + r, k = tiles.unit0(i) + q;
    if (row < B && k < H)
      prep(p.T - 1, row, k, prep_in(p.T - 1, row, k),
           p.carry[(size_t)row * H + k]);
  }
  barrier.sync();
  for (int t = p.T - 1; t >= 0; --t) {
    const float* gates_t = p.gates + (size_t)t * B * G;
    float* dx_t = p.dx + (size_t)t * B * G;
    // stage A: d_rh = dc_pre W_c^T, dr_pre
    for (int i = tiles.begin; i < tiles.end; ++i) {
      const int r0 = tiles.row0(i), k0 = tiles.unit0(i);
      const int row = r0 + r, k = k0 + q;
      const bool valid = row < B && k < H;
      const size_t at = (size_t)row * H + k;
      // the epilogue's operands, loaded before the product
      const float rg = valid ? gates_t[(size_t)row * G + H + k] : 0.f;
      const float hpv = valid ? h_prev(t, at) : 0.f;
      const bool alive = valid && t < p.lengths[row];
      tile_product<kUnits>(
          dx_t + (size_t)r0 * G + 2 * H, G, min(kRows, B - r0), H, p.a_cap,
          ws_c, kBwdQuad, 0, k0 == k_strip ? qc_res : 0,
          [&](int j, int c) {
            const int kk = k0 + c;
            return (j < H && kk < H) ? p.w[(size_t)kk * G + 2 * H + j] : 0.f;
          },
          as);
      if (valid) {
        const float drh = as[r * kUnits + q];
        dx_t[(size_t)row * G + H + k] =
            alive ? drh * hpv * rg * (1.f - rg) : 0.f;
        p.d_rh[at] = drh;
      }
    }
    barrier.sync();
    // stage B: dh_prev = dh u + d_rh r + [du, dr] W_ur^T; then prep(t-1)
    for (int i = tiles.begin; i < tiles.end; ++i) {
      const int r0 = tiles.row0(i), k0 = tiles.unit0(i);
      const int row = r0 + r, k = k0 + q;
      const bool valid = row < B && k < H;
      const size_t at = (size_t)row * H + k;
      // the epilogue's operands (this thread's own d_rh, dh and carry, and
      // prep(t-1)'s inputs), loaded before the product
      float u = 0.f, rg = 0.f, dhc = 0.f, drh = 0.f, carry = 0.f;
      bool alive = false;
      PrepIn next{};
      if (valid) {
        const float* gr = gates_t + (size_t)row * G;
        u = gr[k];
        rg = gr[H + k];
        dhc = p.dh_cur[at];
        drh = p.d_rh[at];
        carry = p.carry[at];
        alive = t < p.lengths[row];
        if (t > 0) next = prep_in(t - 1, row, k);
      }
      tile_product<kUnits>(
          dx_t + (size_t)r0 * G, G, min(kRows, B - r0), 2 * H, p.a_cap,
          ws_ur, kBwdQuad, 0, k0 == k_strip ? qur_res : 0,
          [&](int g, int c) {
            const int kk = k0 + c;
            return (g < 2 * H && kk < H) ? p.w[(size_t)kk * G + g] : 0.f;
          },
          as);
      if (valid) {
        const float dh_prev = dhc * u + drh * rg + as[r * kUnits + q];
        if (alive) {
          carry = dh_prev;
          p.carry[at] = carry;
        }
        if (t > 0) prep(t - 1, row, k, next, carry);
      }
    }
    if (t > 0) barrier.sync();
  }
}

// The barrier floor: the same grid stepping through `barriers` of the
// same barriers with no products (chip_smoke.py times it).
__global__ void __launch_bounds__(kThreads, 1)
gru_barrier_kernel(unsigned* sync, int B, int H, int barriers) {
  const Barrier barrier(sync, B, H);
  for (int i = 0; i < barriers; ++i) barrier.sync();
}

// dW [H,3H] in `splits` row ranges: block (x, y, z) with part = z % 2 and
// split = z / 2 sums rows [split * rows, (split + 1) * rows) of the R =
// T*B rows into parts[split]: part 0 dW_ur = sum_r hprev[r]^T dx[r, :2H],
// part 1 dW_c = sum_r (r_gate[r] hprev[r])^T dx[r, 2H:]; hprev[r] = h0[r]
// for r < B, else h_all[r - B]. The splits give the card enough blocks;
// gru_dw_sum_kernel adds them in split order (no atomics).
__global__ void __launch_bounds__(kThreads)
gru_dw_kernel(const float* __restrict__ h0, const float* __restrict__ h_all,
              const float* __restrict__ gates, const float* __restrict__ dx,
              float* __restrict__ parts, int R, int B, int H, int rows) {
  __shared__ __align__(16) float smem[DwTile::kSmem];
  const int part = blockIdx.z % 2, r0 = (blockIdx.z / 2) * rows;
  const int k0 = blockIdx.y * 64, g0 = blockIdx.x * 64;
  const int G = 3 * H;
  const int cols = part == 0 ? 2 * H : H;
  const int col0 = part == 0 ? 0 : 2 * H;
  if (g0 >= cols) return;
  float* dw = parts + (size_t)(blockIdx.z / 2) * H * G;
  float acc[4][4];
  DwTile::product<false, false>(
      min(rows, R - r0),
      [&](int kk, int rr) {
        const int k = k0 + kk, r = r0 + rr;
        if (k >= H) return 0.f;
        const float hp = r < B ? h0[(size_t)r * H + k]
                               : h_all[(size_t)(r - B) * H + k];
        return part == 0 ? hp : gates[(size_t)r * G + H + k] * hp;
      },
      [&](int rr, int c) {
        const int g = g0 + c;
        return g < cols ? dx[(size_t)(r0 + rr) * G + col0 + g] : 0.f;
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

// dw[e] = parts[0][e] + parts[1][e] + ... in split order.
__global__ void __launch_bounds__(kThreads)
gru_dw_sum_kernel(const float* __restrict__ parts, float* __restrict__ dw,
                  int splits, int n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float sum = parts[e];
  for (int s = 1; s < splits; ++s) sum += parts[(size_t)s * n + e];
  dw[e] = sum;
}

// Row splits of the dW reduction: enough for ~4 blocks an SM, at least 64
// rows each.
int dw_splits(int R, int H) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 1;
  const int per_split = (cdiv(2 * H, 64) + cdiv(H, 64)) * cdiv(H, 64);
  const int want = cdiv(4 * sms, per_split), most = cdiv(R, 64);
  return want < 1 ? 1 : (want > most ? most : want);
}

// The launch plan of a persistent kernel, into plan[9]: tiles, blocks per
// SM, SMs, grid, dynamic shared bytes, resident W quads (4 rows of the
// forward strip, 4 columns of the backward's, each), the A chunk (k
// staged at a time), x slots, barriers. All of A and all of the strip
// when they fit; else A in chunks of 256 k and as many quads as fit.
template <class Kernel>
cudaError_t plan_launch(Kernel kernel, bool backward, int T, int B, int H,
                        int* plan) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(B, kRows) * cdiv(H, kUnits);
  const int per_block = cdiv(tiles, tiles < sms ? tiles : sms);
  const int slots = backward ? 0 : (per_block < kMaxSlots ? per_block
                                                          : kMaxSlots);
  const size_t x_bytes = sizeof(float) * (size_t)slots * kSlot;
  const size_t quad_bytes = sizeof(float) * (backward ? kBwdQuad : kFwdQuad);
  const int quads = backward ? cdiv(2 * H, 4) + cdiv(H, 4) : cdiv(H, 4);
  auto a_bytes = [](int cap) {
    const size_t f = (size_t)kRows * (cap + kAPad);
    return sizeof(float) * (f > (size_t)kOutFloats ? f : kOutFloats);
  };
  int a_cap = 4 * cdiv(backward ? 2 * H : H, 4), q_res = quads;
  if (x_bytes + a_bytes(a_cap) + quads * quad_bytes > (size_t)smem_max) {
    a_cap = a_cap < kAChunk ? a_cap : kAChunk;
    const size_t used = x_bytes + a_bytes(a_cap);
    const size_t room =
        (size_t)smem_max > used ? ((size_t)smem_max - used) / quad_bytes : 0;
    q_res = (int)(room < (size_t)quads ? room : quads);
  }
  const size_t smem = x_bytes + a_bytes(a_cap) + q_res * quad_bytes;
  int per_sm = 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  const int blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
  const int out[9] = {tiles, per_sm, sms,   blocks,
                      (int)smem, q_res, a_cap, slots,
                      backward ? 2 * T : 2 * T - 1};
  for (int i = 0; i < 9; ++i) plan[i] = out[i];
  if (err != cudaSuccess) return err;
  return blocks < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

// Words of the barriers' counters at batch B (see Barrier).
int sync_words(int B) { return kSyncWords * cdiv(B, kRows); }

// kernel<<<blocks, kThreads, smem, s>>>(args...) as a cooperative launch,
// which the runtime refuses (cudaErrorCooperativeLaunchTooLarge) unless
// every block can be resident at once.
template <class... P, class... A>
cudaError_t launch_cooperative(void (*kernel)(P...), int blocks, size_t smem,
                               cudaStream_t s, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

extern "C" {

const char* fused_gru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward over all T steps: h_all [T,B,H], h_last [B,H], gates [T,B,3H]
// (u, r, c of every step); rh and h_pong [B,H] and sync (the barriers'
// counters, fused_gru_sync_words(B) words, zeroed here) are scratch. Returns a
// cudaError_t (cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident); plan as above.
int fused_gru_fwd_f32(const float* x, const float* w, const float* h0,
                      const int* lengths, float* h_all, float* h_last,
                      float* gates, float* rh, float* h_pong, unsigned* sync,
                      int T, int B, int H, int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      plan_launch(gru_fwd_persistent_kernel, false, T, B, H, plan);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * sync_words(B), s);
  if (err != cudaSuccess) return err;
  const FwdArgs a{x,    w,    h0,   lengths, h_all,   h_last,
                  h_pong, gates, rh, sync,   T,       B,
                  H,    plan[5], plan[6], plan[7]};
  err = launch_cooperative(gru_fwd_persistent_kernel, plan[3], plan[4], s, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Words (unsigned) of the sync buffer the entry points take at batch B.
int fused_gru_sync_words(int B) { return sync_words(B); }

// Row splits of the backward's dW reduction at these shapes: dw_parts
// holds that many [H,3H] partial sums.
int fused_gru_dw_splits(int T, int B, int H) { return dw_splits(T * B, H); }

// Backward: dh_all [T,B,H] is the output cotangent with the h_last
// cotangent already folded in; w [H,3H]; gates as the forward wrote them.
// Writes dx [T,B,3H], dw [H,3H] and dh0 [B,H] (used as the carry); dh_cur
// and d_rh [B,H], dw_parts [splits,H,3H] (splits from
// fused_gru_dw_splits) and sync are scratch. One persistent launch for
// the recurrence, then the dW reduction and its sum over the splits.
int fused_gru_bwd_f32(const float* w, const float* h0, const int* lengths,
                      const float* h_all, const float* gates,
                      const float* dh_all, float* dx, float* dw, float* dh0,
                      float* dh_cur, float* d_rh, float* dw_parts,
                      unsigned* sync, int T, int B, int H, int splits,
                      int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      plan_launch(gru_bwd_persistent_kernel, true, T, B, H, plan);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(dh0, 0, (size_t)B * H * sizeof(float), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * sync_words(B), s);
  if (err != cudaSuccess) return err;
  const BwdArgs a{w,    h0,   lengths, h_all, gates, dh_all, dx,
                  dh0,  dh_cur, d_rh, sync,  T,     B,      H,
                  plan[5], plan[6]};
  err = launch_cooperative(gru_bwd_persistent_kernel, plan[3], plan[4], s, a);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int R = T * B, rows = cdiv(R, splits);
  const dim3 grid_dw(cdiv(2 * H, 64), cdiv(H, 64), 2 * cdiv(R, rows));
  gru_dw_kernel<<<grid_dw, kThreads, 0, s>>>(h0, h_all, gates, dx, dw_parts,
                                             R, B, H, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = H * 3 * H;
  const dim3 grid_sum(cdiv(n, kThreads));
  gru_dw_sum_kernel<<<grid_sum, kThreads, 0, s>>>(dw_parts, dw, cdiv(R, rows),
                                                  n);
  return cudaGetLastError();
}

// The barrier floor of the forward (backward != 0: the backward) at these
// shapes: its grid, block and shared memory, stepping through its plan's
// barriers (2T - 1, or 2T) with no work. sync as above.
int fused_gru_barrier_floor(unsigned* sync, int T, int B, int H,
                            int backward, int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      backward ? plan_launch(gru_bwd_persistent_kernel, true, T, B, H, plan)
               : plan_launch(gru_fwd_persistent_kernel, false, T, B, H, plan);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gru_barrier_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan[4]);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * sync_words(B), s);
  if (err != cudaSuccess) return err;
  err = launch_cooperative(gru_barrier_kernel, plan[3], plan[4], s, sync, B,
                           H, plan[8]);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
