// Fused LSTM time loop, forward and backward, for Hopper (sm_90a), on
// float32 or bfloat16 streams.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/fused_lstm.py:
//   fused_lstm_fwd_f32, fused_lstm_fwd_bf16  <- _run_fwd / _fwd_kernel
//   fused_lstm_bwd_f32, fused_lstm_bwd_bf16  <- _fused_lstm_bwd / _bwd_kernel
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
// with the same `alive` selects: dh is 0 on a dead row, dgates (= dx_t)
// are 0 there, and a dead row passes its dh and dc carries on untouched.
// The caller folds the h_last/c_last cotangents into dh_all/dc_all at
// max(len-1, 0).
//
// bf16 arm (the Pallas kernels' semantics on bf16 x): the [T,B,.] streams
// x, h_all, c_all, dh_all, dc_all and dx are all bfloat16 (rnn_tile.cuh
// bf16), read as bf16 and widened to float32 at load, rounded to nearest
// even at store; w, b, h0, c0 and the results dw, db, dh0, dc0 are float32
// here (the wrapper converts those small tensors to and from their own
// dtypes). Every product and sum and the recurrent state stay float32:
// the same 3xTF32 path. So the forward's state ping-pong is two float32
// buffers (h_last and h_pong; the wrapper rounds h_last and c_last, which
// gives the bits of the reference's gather from the rounded h_all); the
// backward recomputes its gates from the ROUNDED h_all and c_all (as
// _bwd_kernel reads them), and keeps the unrounded float32 dgates in a
// [T,B,4H] scratch beside the rounded dx, which dW and db are summed from
// (as _bwd_kernel sums them from its float32 dgates).
//
// Design: one persistent cooperative launch walks all T steps, with the
// W strips resident in shared memory and the products on the tensor cores
// in 3xTF32. The TPU kernel runs a sequential grid over t with (h, c) and
// all of W in VMEM; W (4 MB at H = 512 in float32) is far above one SM's
// 227 KB of shared memory, but not above the card's: spread over the SMs,
// each block keeps a column strip of W for the whole call.
//
//   Tiles. A tile is 16 rows x 16 hidden units: R = ceil(B/16) row groups
//   x S = ceil(H/16) strips, strip-major; 4 x 32 = 128 tiles at the LM's
//   B 64, H 512, one 256-thread block each on 132 SMs. A tile owns its
//   units' four gate columns of W (w[:, q H + j], q = i, c_hat, f, o: 64
//   columns, column c = 4 u + q), so a unit's cell update needs no other
//   tile's gates: ONE grid barrier a step. The grid is the co-resident
//   maximum (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count)
//   capped at the tile count, launched cooperatively: a grid that cannot
//   be co-resident is refused and the C function returns the error (the
//   wrapper raises with the plan; there is no fallback). With fewer blocks
//   than tiles, block b walks the contiguous tiles [b n / G, (b+1) n / G).
//
//   Shared memory (dynamic, planned by the host; H 512: 206 KB forward,
//   210 KB backward):
//     W strip  H rows x 64 columns (128 KB at H 512). Row k holds column
//              c at the 8 x 8 transpose p = (c % 8) 8 + c / 8, its 16-byte
//              chunks XORed with (k & 1) | (k & 2) << 1: a lane reads the
//              eight n-tiles of one row (the forward's B fragments) or the
//              eight k-steps of one row (W^T, the backward's) as two
//              16-byte chunks, and each quarter-warp's reads hit 32
//              distinct banks in both products. One copy serves both.
//     A        a buffer a warp: 16 rows x 64 k of the left operand
//              (h_{t-1}), staged 64 k at a time (34 KB); backward, also
//              where the reduce stages 32 strips' partials.
//     partials the eight warps' 16 x 64 gate partials (36 KB).
//     x        two slots of the first tile's 16 x 64 x values: x_{t+1}
//              lands by cp.async while step t runs (8 KB).
//     dgates   backward: the tile's 16 x 64 dgates, the A operand of
//              its partial of dh_prev (4 KB).
//   Streamed W. The strip is resident for the first rows that fit (all of
//   it up to H 592 forward, 576 backward); the rest, and the whole strip
//   of a block's tiles of another strip, is read from L2 every step.
//   Slower, but right: every shape runs.
//
//   A product (gate_product: 16 x 64 gates = A[16 x H] W_strip[H x 64])
//   splits K over the 8 warps. A warp stages its 16 x 64 k of A from L2 by
//   16-byte cp.async.cg copies into its own buffer (no block barrier), in
//   two groups so that the first half's products run while the second
//   half lands, then per k-step of 8 splits its A fragment and the eight
//   n-tiles' W fragments into TF32 hi and lo in registers
//   (grid::split_tf32) and issues lo*hi and hi*lo into one accumulator
//   and hi*hi into another (mma.sync m16n8k8); after each 64 k both join
//   a float32 running sum (grid::promote), so no lo product is truncated
//   against a hi*hi sum and no truncating sum runs over more than 64 k.
//   The warps' partials are added in warp order, a unit's four gates as
//   one 16-byte read a warp.
//
//   forward, step t (h_{t-1} in one state buffer, h_t into the other:
//   ping-pong, the last step's into h_last): the gate product, the
//   activations, the cell update and the masks, and h_t; then the row
//   group's barrier, whose arrive releases h_t and whose wait comes after
//   the stores of h_all_t and c_all_t and the prefetch of x_{t+1}. c and
//   the first tile's h stay in registers (further tiles' c in c_last).
//   backward, step t (reverse), per tile:
//     1. the gate product of step t from h_all[t-1] (saved data), which
//        runs while the barrier of step t+1 completes (arrive, product,
//        wait);
//     2. the dh carry of the rows alive at t+1 = the sum of step t+1's S
//        partials of dh_prev at the tile's 16 x 16 elements, in strip
//        order, staged into shared memory by cp.async.cg, 32 strips at a
//        time;
//     3. dh, dc and the dgates with _bwd_kernel's selects; dgates into
//        dx_t and shared memory; the dc carry stays in the block;
//     4. its partial P_t[s] = dgates[16 x 64] W_strip^T [64 x H] (K = 64,
//        a warp per eighth of H, two n-tiles at a time with the lo passes
//        in two accumulators: six dependent chains of 8 multiplies in
//        flight a warp) into the half of the partials' ping-pong
//        (2 x S x B x H floats, 8 MB at the LM's shape) that step t+1's
//        reduce does not read; then the arrive.
//     After step 0, dh0 is the reduce of P_0 on the rows alive at 0 (the
//     carry elsewhere) and dc0 the dc carry. Then dW = sum h_{t-1}^T dgates
//     and db = sum dgates over the T*B rows as a tensor-core GEMM in
//     3xTF32 (lstm_dw_kernel: 64 x 128 outputs a block, 64 rows a stage in
//     a ring of four filled by cp.async, each stage's products promoted
//     into float32 registers), in row splits summed in split order.
//
//   Barrier (grid::Barrier, csrc/grid_sync.cuh, shared with the fused
//   GRU): sense-reversing, one counter a row group with a block a tile (a
//   step's data never leaves a row group), zeroed by the C function before
//   the launch. T-1 barriers forward, T backward. Values other blocks
//   write during the call (h_t, the partials) are read through L2
//   (cp.async.cg, ld.global.cg) after the acquire.
//
// Every sum runs in a fixed order: each warp's mma sums in k order, the
// warps in warp order, the strips in strip order, dW's row splits in
// split order. No atomics but the barriers' counters: a rerun is bitwise
// equal.
//
// What bounds it on this card: the work is 2 L H 4H FLOP forward (L = sum
// of the lengths) and 3x that backward (the gate recompute, dh_prev and
// dW), which on the tensor cores as three TF32 passes runs at 494.7 / 3
// TFLOP/s: ~0.04-0.05 ms forward at the LM's shapes (B 64, H 512, T 64);
// the bytes are far less. What a step pays instead (lstm_step_split.py
// splits it on the card; PERF.md has the numbers): a barrier (~1 us
// alone: a fence, an atomic and an acquire that invalidates L1; more with
// the row group's slowest block), the copy of A from L2 (32 KB a block),
// 1536 mma.sync a block and their operand splits on 8 warps (at about
// half of what mma.sync alone reaches), and backward the 32 KB write and
// read of the partials a block (4 MB a step each way over the grid).
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers, the current CUDA stream and a host int[7] that receives the
// launch plan (tiles, blocks per SM, SMs, grid, shared bytes, resident W
// rows, barriers) through ctypes, and checks the returned cudaError_t.

#include "grid_sync.cuh"
#include "rnn_tile.cuh"

namespace {

using rnn_tile::bf16;
using rnn_tile::from_float;
using rnn_tile::kThreads;
using rnn_tile::ldg_f;
using rnn_tile::sigmoidf;
using rnn_tile::to_float;

constexpr int kRows = 16;              // rows of a tile (mma's m)
constexpr int kUnits = 16;             // hidden units of a tile
constexpr int kCols = 4 * kUnits;      // its gate columns, c = 4 u + q
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;              // k-steps of 8 a warp stages at once
constexpr int kALd = kChunk * 8 + 4;   // floats of a staged row of A
constexpr int kRedLd = kCols + 8;      // floats of a row of a partial
constexpr int kDgLd = kCols + 4;       // floats of a row of the dgates
constexpr int kAFloats = kWarps * kRows * kALd;
constexpr int kRedFloats = kWarps * kRows * kRedLd;
constexpr int kXFloats = kRows * kCols;  // values of one x slot
constexpr int kDgFloats = kRows * kDgLd;
constexpr int kStepFloats = 8 * kCols;   // a k-step (8 rows) of the strip
constexpr int kPlan = 7;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The block's tiles [begin, end) of the R x S tiles, strip-major.
struct Tiles {
  int begin, end, groups, n;
  __device__ Tiles(int B, int H)
      : groups(cdiv(B, kRows)), n(cdiv(B, kRows) * cdiv(H, kUnits)) {
    begin = (int)((long long)n * blockIdx.x / gridDim.x);
    end = (int)((long long)n * (blockIdx.x + 1) / gridDim.x);
  }
  __device__ int row0(int i) const { return (i % groups) * kRows; }
  __device__ int unit0(int i) const { return (i / groups) * kUnits; }
};

// The swizzle of row k of the strip, and the float index there of strip
// column c (see the header).
__device__ __forceinline__ int swizzle(int k) { return (k & 1) | (k & 2) << 1; }
__device__ __forceinline__ int strip_at(int k, int c) {
  const int p = (c % 8) * 8 + c / 8;
  return 4 * ((p / 4) ^ swizzle(k)) + p % 4;
}

// The 8 floats of two 16-byte chunks of shared memory, at p and q.
__device__ __forceinline__ void lds8(const float* p, const float* q,
                                     float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(q);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Strip column c of W row k for the strip of units j0.. (0 past H).
__device__ __forceinline__ float w_at(const float* w, int k, int c, int j0,
                                      int H) {
  const int j = j0 + c / 4;
  return (k < H && j < H) ? __ldg(w + (size_t)k * 4 * H + (c % 4) * H + j)
                          : 0.f;
}

// The first `steps` k-steps of the strip of units j0.. into ws
// (neighbouring threads read neighbouring units of one gate).
__device__ void load_strip(float* ws, const float* w, int j0, int H,
                           int steps) {
  for (int idx = threadIdx.x; idx < steps * kStepFloats; idx += kThreads) {
    const int k = idx / kCols, c = 4 * (idx % kUnits) + idx / kUnits % 4;
    ws[k * kCols + strip_at(k, c)] = w_at(w, k, c, j0, H);
  }
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) grid::split_tf32(v[i], hi[i], lo[i]);
}

// 3xTF32 apart from the hi*hi sum: lo*hi into la, hi*lo into lb (the
// same accumulator, or two for shorter dependent chains), hi*hi into hi.
__device__ __forceinline__ void mma3(float (&hi)[4], float (&la)[4],
                                     float (&lb)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh[2], bl[2];
  grid::split_tf32(b0, bh[0], bl[0]);
  grid::split_tf32(b1, bh[1], bl[1]);
  grid::mma_tf32(la, al, bh);
  grid::mma_tf32(lb, ah, bl);
  grid::mma_tf32(hi, ah, bh);
}

// This warp's share of a tile's gate product: sum[j] holds the 16 x 8
// n-tile j (strip columns 8j..8j+7, fragment layout of grid_sync.cuh) of
// A[16 x H] W_strip[H x 64] over the warp's k-steps. A's row r (< rows)
// is at a + r H. float32 A: a state other blocks wrote before the
// barrier, copied through L2. bf16 A (the backward's stored h_all, saved
// data): loaded in pairs and widened into abuf. W rows of k-steps below
// q_res come from the resident strip ws, the rest from w in device
// memory. abuf is the warp's A buffer.
template <class A>
__device__ void gate_product(const A* a, int rows, int H, int j0, int q_res,
                             const float* ws, const float* w, float* abuf,
                             float (&sum)[8][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int steps = cdiv(H, 8);
  const int s0 = warp * steps / kWarps, s1 = (warp + 1) * steps / kWarps;
  const bool vec = sizeof(A) == 4 &&
      ((reinterpret_cast<size_t>(a) | (size_t)H * 4) & 15) == 0;
  const bool pairs = ((reinterpret_cast<size_t>(a) & 3) | (H & 1)) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[j][e] = 0.f;
  for (int c0 = s0; c0 < s1; c0 += kChunk) {
    const int n = min(kChunk, s1 - c0), k0 = 8 * c0;
    float hi[8][4] = {}, lo[8][4] = {};
    // k-step s with b0[j] = W[k][8j + g], b1[j] = W[k + 4][8j + g] of the
    // strip, k = k0 + 8s + t
    auto step = [&](int s, const float (&b0)[8], const float (&b1)[8]) {
      const float* ar = abuf + g * kALd + 8 * s + t;
      const float av[4] = {ar[0], ar[8 * kALd], ar[4], ar[8 * kALd + 4]};
      uint32_t ah[4], al[4];
      split4(av, ah, al);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma3(hi[j], lo[j], lo[j], ah, al, b0[j], b1[j]);
    };
    // the products of the chunk's k-steps [from, to): the resident ones
    // (a lane's rows k = 8m + t share swizzle(t), so its two chunks of a
    // row sit at fixed offsets), then the streamed ones
    auto multiply = [&](int from, int to) {
      const int mid = max(from, min(to, q_res - c0));
      const int off0 = 4 * ((2 * g) ^ swizzle(t));
      const int off1 = 4 * ((2 * g + 1) ^ swizzle(t));
#pragma unroll 4
      for (int s = from; s < mid; ++s) {
        const float* r0 = ws + (size_t)(k0 + 8 * s + t) * kCols;
        const float* r1 = r0 + 4 * kCols;
        float b0[8], b1[8];
        lds8(r0 + off0, r0 + off1, b0);
        lds8(r1 + off0, r1 + off1, b1);
        step(s, b0, b1);
      }
      for (int s = mid; s < to; ++s) {
        const int k = k0 + 8 * s + t;
        float b0[8], b1[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          b0[j] = w_at(w, k, 8 * j + g, j0, H);
          b1[j] = w_at(w, k + 4, 8 * j + g, j0, H);
        }
        step(s, b0, b1);
      }
    };
    if (vec) {
      // A[:, k0 .. k0 + 8n) into abuf (zero past the rows and H) by
      // 16-byte copies in two groups, the first `half` k-steps and the
      // rest: a lane copies chunk q = lane % 16 of 8 rows, and the first
      // half is multiplied while the rest lands
      const int half = (n + 1) / 2, q = lane % 16, k = k0 + 4 * q;
      const float* a32 = reinterpret_cast<const float*>(a);
      for (int part = 0; part < 2; ++part) {
        if ((q < 2 * half) == (part == 0) && q < 2 * n) {
#pragma unroll
          for (int i = 0; i < kRows / 2; ++i) {
            const int r = lane / 16 + 2 * i;
            float* dst = abuf + r * kALd + 4 * q;
            if (r < rows && k < H)
              grid::cp_async16(dst, a32 + (size_t)r * H + k);
            else
              *reinterpret_cast<float4*>(dst) =
                  make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        grid::cp_async_commit();
      }
      grid::cp_async_wait(1);
      __syncwarp();
      multiply(0, half);
      grid::cp_async_wait(0);
      __syncwarp();
      multiply(half, n);
    } else if constexpr (sizeof(A) == 4) {
      for (int idx = lane; idx < kRows * 8 * kChunk; idx += 32) {
        const int r = idx / (8 * kChunk), kk = idx % (8 * kChunk);
        const int k = k0 + kk;
        if (kk < 8 * n)
          abuf[r * kALd + kk] =
              (r < rows && k < H) ? grid::load_cg(a + (size_t)r * H + k) : 0.f;
      }
      __syncwarp();
      multiply(0, n);
    } else {
      // bf16: a lane's 16 words of two values (one 4-byte load each
      // where aligned) are all loaded first, so that their latencies
      // overlap, then widened into abuf
      constexpr int kWords = kRows * 4 * kChunk / 32;
      unsigned words[kWords];
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int idx = lane + 32 * i;
        const int r = idx / (4 * kChunk), kk = 2 * (idx % (4 * kChunk));
        const int k = k0 + kk;
        const A* at = a + (size_t)r * H + k;
        words[i] = 0u;
        if (kk < 8 * n && r < rows) {
          if (pairs && k < H) {
            words[i] = __ldg(reinterpret_cast<const unsigned*>(at));
          } else {
            if (k < H) words[i] = at[0].bits;
            if (k + 1 < H) words[i] |= (unsigned)at[1].bits << 16;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int idx = lane + 32 * i;
        const int r = idx / (4 * kChunk), kk = 2 * (idx % (4 * kChunk));
        if (kk >= 8 * n) continue;
        abuf[r * kALd + kk] = __uint_as_float(words[i] << 16);
        abuf[r * kALd + kk + 1] = __uint_as_float(words[i] & 0xffff0000u);
      }
      __syncwarp();
      multiply(0, n);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) grid::promote(sum[j], hi[j], lo[j]);
    __syncwarp();  // every lane has read abuf before the next chunk's copy
  }
}

// The warp's gate partials into its slot of red (16 x 64, row stride
// kRedLd).
__device__ __forceinline__ void store_partial(const float (&sum)[8][4],
                                              float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* out =
      red + (warp * kRows + lane / 4) * kRedLd + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(out + 8 * j) = make_float2(sum[j][0], sum[j][1]);
    *reinterpret_cast<float2*>(out + 8 * kRedLd + 8 * j) =
        make_float2(sum[j][2], sum[j][3]);
  }
}

// The product's four gates of unit u at row r (strip columns 4u..4u+3):
// the warps' partials added in warp order.
__device__ __forceinline__ void gate_sums(const float* red, int r, int u,
                                          float (&g)[4]) {
  const float* at = red + r * kRedLd + 4 * u;
  float4 v = *reinterpret_cast<const float4*>(at);
  g[0] = v.x;
  g[1] = v.y;
  g[2] = v.z;
  g[3] = v.w;
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    v = *reinterpret_cast<const float4*>(at + w * kRows * kRedLd);
    g[0] += v.x;
    g[1] += v.y;
    g[2] += v.z;
    g[3] += v.w;
  }
}

// x_t of tile (r0, j0) into `slot` [16][64] (of the stream type S) by
// cp.async. float32: one 16-byte copy a thread where the rows are 16-byte
// aligned (vec), else four 4-byte copies. bf16: two 4-byte copies (pairs)
// where the rows are 4-byte aligned (vec), else plain loads. Rows past B
// and units past H are left as they are.
template <class S>
__device__ __forceinline__ void prefetch_x(const S* x_t, int r0, int j0,
                                           int B, int H, bool vec, S* slot) {
  const int tid = threadIdx.x;
  const int r = tid / 16, q = tid % 16 / 4, j = j0 + 4 * (tid % 4);
  if (r0 + r >= B) return;
  const S* src = x_t + (size_t)(r0 + r) * 4 * H + q * H + j;
  S* dst = slot + r * kCols + q * kUnits + 4 * (tid % 4);
  if constexpr (sizeof(S) == 4) {
    if (vec) {
      if (j < H) grid::cp_async16(dst, src);
    } else {
      for (int e = 0; e < 4; ++e)
        if (j + e < H) grid::cp_async4(dst + e, src + e);
    }
  } else if (vec) {  // H is even: a pair is in or out whole
    for (int e = 0; e < 4; e += 2)
      if (j + e < H)
        grid::cp_async4(reinterpret_cast<float*>(dst + e),
                        reinterpret_cast<const float*>(src + e));
  } else {
    for (int e = 0; e < 4; ++e)
      if (j + e < H) dst[e] = src[e];
  }
}

// Whether the x slots' copies of stream x can take their vector form.
template <class S>
__device__ __forceinline__ bool x_vector(const S* x, int H) {
  return sizeof(S) == 4
             ? ((reinterpret_cast<size_t>(x) & 15) | (H & 3)) == 0
             : ((reinterpret_cast<size_t>(x) & 3) | (H & 1)) == 0;
}

template <class S>
struct FwdArgs {
  const S* x;
  const float* w;
  const float* b;
  const float* h0;
  const float* c0;
  const int* lengths;
  S* h_all;
  S* c_all;
  float* h_last;
  float* c_last;
  float* h_pong;
  unsigned* sync;
  int T, B, H, q_res;
};

template <class S>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_persistent_kernel(const FwdArgs<S> p) {
  extern __shared__ float smem[];
  const int B = p.B, H = p.H, G = 4 * H;
  const Tiles tiles(B, H);
  const grid::Barrier barrier(p.sync, tiles.groups, tiles.n);
  float* ws = smem;
  float* abuf = ws + (size_t)p.q_res * kStepFloats +
                (threadIdx.x / 32) * kRows * kALd;
  float* red = ws + (size_t)p.q_res * kStepFloats + kAFloats;
  // two x slots of kXFloats floats, each [16][64] of the stream type
  S* xs = reinterpret_cast<S*>(red + kRedFloats);
  const int r = threadIdx.x / kUnits, u = threadIdx.x % kUnits;
  const int n_tiles = tiles.end - tiles.begin;
  const int j_strip = tiles.unit0(tiles.begin);
  const bool x_vec = x_vector(p.x, H);
  load_strip(ws, p.w, j_strip, H, p.q_res);
  if (n_tiles > 0)
    prefetch_x(p.x, tiles.row0(tiles.begin), j_strip, B, H, x_vec, xs);
  grid::cp_async_commit();
  __syncthreads();  // the strip is in place
  // the first tile's state in registers; the others' c in c_last
  float h_reg = 0.f, c_reg = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int row = tiles.row0(tiles.begin + i) + r;
    const int j = tiles.unit0(tiles.begin + i) + u;
    if (row >= B || j >= H) continue;
    const size_t at = (size_t)row * H + j;
    if (i == 0) {
      h_reg = p.h0[at];
      c_reg = p.c0[at];
    } else {
      p.c_last[at] = p.c0[at];
    }
  }
  // h_t goes to h_last for t = T-1 and alternates buffers before it
  auto state = [&](int t) {
    return ((p.T - 1 - t) & 1) ? p.h_pong : p.h_last;
  };
  const int row0 = tiles.row0(tiles.begin) + r, unit0 = j_strip + u;
  const bool valid0 = n_tiles > 0 && row0 < B && unit0 < H;
  const size_t at0 = (size_t)row0 * H + unit0;
  for (int t = 0; t < p.T; ++t) {
    const float* hp = t == 0 ? p.h0 : state(t - 1);
    float* hn = state(t);
    const size_t seq = (size_t)t * B * H;
    float out_h = 0.f, out_c = 0.f;  // the first tile's h_all_t, c_all_t
    for (int i = 0; i < n_tiles; ++i) {
      const int r0 = tiles.row0(tiles.begin + i);
      const int j0 = tiles.unit0(tiles.begin + i);
      const int row = r0 + r, j = j0 + u;
      const bool valid = row < B && j < H;
      const size_t at = (size_t)row * H + j;
      // the epilogue's loads, ahead of the product
      const int len = valid ? p.lengths[row] : 0;
      float bias[4] = {}, hpv = h_reg, cpv = c_reg;
      if (valid) {
#pragma unroll
        for (int q = 0; q < 4; ++q) bias[q] = __ldg(p.b + q * H + j);
        if (i > 0) {
          hpv = grid::load_cg(hp + at);
          cpv = p.c_last[at];
        }
      }
      if (i > 0) __syncthreads();  // the last tile's epilogue read red
      float sum[8][4];
      gate_product(hp + (size_t)r0 * H, min(kRows, B - r0), H, j0,
                   j0 == j_strip ? p.q_res : 0, ws, p.w, abuf, sum);
      store_partial(sum, red);
      grid::cp_async_wait_all();  // x_t of the first tile
      __syncthreads();
      if (valid) {
        float gate[4];
        gate_sums(red, r, u, gate);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float xv =
              i == 0 ? to_float(xs[(t & 1) * kXFloats + r * kCols +
                                   q * kUnits + u])
                     : ldg_f(p.x + (size_t)t * B * G + (size_t)row * G +
                             q * H + j);
          gate[q] = (xv + gate[q]) + bias[q];
        }
        const float ig = sigmoidf(gate[0]), cand = tanhf(gate[1]);
        const float fg = sigmoidf(gate[2]), og = sigmoidf(gate[3]);
        const float c_new = fg * cpv + ig * cand;
        const float h_new = og * tanhf(c_new);
        const bool alive = t < len;
        hn[at] = alive ? h_new : hpv;
        if (i == 0) {
          out_h = alive ? h_new : 0.f;
          out_c = alive ? c_new : 0.f;
          h_reg = alive ? h_new : hpv;
          c_reg = alive ? c_new : cpv;
        } else {
          p.h_all[seq + at] = from_float<S>(alive ? h_new : 0.f);
          p.c_all[seq + at] = from_float<S>(alive ? c_new : 0.f);
          p.c_last[at] = alive ? c_new : cpv;
        }
      }
    }
    // other blocks read only h_t: the arrive releases it, and the first
    // tile's other stores and the prefetch of x_{t+1} go out before the
    // wait
    const unsigned arrived = t + 1 < p.T ? barrier.arrive() : 0u;
    if (valid0) {
      p.h_all[seq + at0] = from_float<S>(out_h);
      p.c_all[seq + at0] = from_float<S>(out_c);
    }
    if (t + 1 < p.T) {
      prefetch_x(p.x + (size_t)(t + 1) * B * G, tiles.row0(tiles.begin),
                 j_strip, B, H, x_vec, xs + ((t + 1) & 1) * kXFloats);
      grid::cp_async_commit();
      barrier.wait(arrived);
    }
  }
  if (valid0) p.c_last[at0] = c_reg;
}

// This warp's share of a tile's partial of dh_prev: out[r][n] (r < rows,
// n < H, row stride H) = sum_c dg[r][c] W_strip[n][c], the warp's n-tiles
// of 8 W rows, K = the strip's 64 columns. dg is the tile's dgates in
// shared memory (row stride kDgLd); W rows of n-tiles below q_res come
// from ws, the rest from w.
__device__ void partial_product(const float* dg, const float* ws,
                                const float* w, int j0, int q_res, int H,
                                float* out, int rows) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  uint32_t ah[8][4], al[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float* ar = dg + g * kDgLd + 8 * s + t;
    const float av[4] = {ar[0], ar[8 * kDgLd], ar[4], ar[8 * kDgLd + 4]};
    split4(av, ah[s], al[s]);
  }
  const int tiles = cdiv(H, 8);
  const int n0 = warp * tiles / kWarps, n1 = (warp + 1) * tiles / kWarps;
  const bool even = (H & 1) == 0;
  // two n-tiles at a time, each with its lo passes in two accumulators:
  // six independent chains of 8 multiplies. b0[h][s] = W[n][8s + t],
  // b1[h][s] = W[n][8s + t + 4] of the strip, n = 8 (jn + h) + g the W
  // row of this lane's B fragments: in a resident row (swizzle(g), fixed
  // offsets) b0 is chunks 2t and 2t + 1, b1 the same 32 floats on
  auto pair_product = [&](int jn, int pair, const float (&b0)[2][8],
                          const float (&b1)[2][8]) {
    float hi[2][4] = {}, la[2][4] = {}, lb[2][4] = {}, sum[2][4] = {};
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mma3(hi[h], la[h], lb[h], ah[s], al[s], b0[h][s], b1[h][s]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      grid::promote(sum[h], hi[h], la[h], lb[h]);
      if (h >= pair) continue;
      const int col = 8 * (jn + h) + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = g + 8 * e;
        if (r >= rows) continue;
        float* o = out + (size_t)r * H + col;
        if (even && col < H) {
          *reinterpret_cast<float2*>(o) =
              make_float2(sum[h][2 * e], sum[h][2 * e + 1]);
        } else {
          if (col < H) o[0] = sum[h][2 * e];
          if (col + 1 < H) o[1] = sum[h][2 * e + 1];
        }
      }
    }
  };
  const int off0 = 4 * ((2 * t) ^ swizzle(g));
  const int off1 = 4 * ((2 * t + 1) ^ swizzle(g));
  const int res_end = min(n1, q_res);
  int jn = n0;
  for (; jn + 1 < res_end; jn += 2) {  // pairs of resident rows
    float b0[2][8], b1[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* row = ws + (size_t)(8 * (jn + h) + g) * kCols;
      lds8(row + off0, row + off1, b0[h]);
      lds8(row + off0 + 32, row + off1 + 32, b1[h]);
    }
    pair_product(jn, 2, b0, b1);
  }
  for (; jn < n1; jn += 2) {  // the rest, read from w where not resident
    const int pair = min(2, n1 - jn);
    float b0[2][8], b1[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 8 * (jn + h) + g;
      const float* row = ws + (size_t)n * kCols;
      if (h < pair && jn + h < q_res) {
        lds8(row + off0, row + off1, b0[h]);
        lds8(row + off0 + 32, row + off1 + 32, b1[h]);
      } else {
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          b0[h][s] = h < pair ? w_at(w, n, 8 * s + t, j0, H) : 0.f;
          b1[h][s] = h < pair ? w_at(w, n, 8 * s + t + 4, j0, H) : 0.f;
        }
      }
    }
    pair_product(jn, pair, b0, b1);
  }
}

template <class S>
struct BwdArgs {
  const S* x;
  const float* w;
  const float* b;
  const float* h0;
  const float* c0;
  const int* lengths;
  const S* h_all;
  const S* c_all;
  const S* dh_all;
  const S* dc_all;
  S* dx;
  float* dgates;  // bf16: the float32 dgates [T,B,4H] (dW's operand)
  float* dh0;
  float* dc0;
  float* partials;
  unsigned* sync;
  int T, B, H, q_res;
};

template <class S>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_persistent_kernel(const BwdArgs<S> p) {
  extern __shared__ float smem[];
  const int B = p.B, H = p.H, G = 4 * H, strips = cdiv(H, kUnits);
  const size_t bh = (size_t)B * H;
  const Tiles tiles(B, H);
  const grid::Barrier barrier(p.sync, tiles.groups, tiles.n);
  float* ws = smem;
  float* abuf = ws + (size_t)p.q_res * kStepFloats +
                (threadIdx.x / 32) * kRows * kALd;
  float* red = ws + (size_t)p.q_res * kStepFloats + kAFloats;
  S* xs = reinterpret_cast<S*>(red + kRedFloats);
  float* dg = red + kRedFloats + 2 * kXFloats;
  const int r = threadIdx.x / kUnits, u = threadIdx.x % kUnits;
  const int n_tiles = tiles.end - tiles.begin;
  const int j_strip = tiles.unit0(tiles.begin);
  const bool x_vec = x_vector(p.x, H);
  load_strip(ws, p.w, j_strip, H, p.q_res);
  if (n_tiles > 0)
    prefetch_x(p.x + (size_t)(p.T - 1) * B * G, tiles.row0(tiles.begin),
               j_strip, B, H, x_vec, xs + ((p.T - 1) & 1) * kXFloats);
  grid::cp_async_commit();
  __syncthreads();  // the strip is in place
  // step t's partials of dh_prev from strip s (row stride H)
  auto partial = [&](int t, int s) {
    return p.partials + ((size_t)(t & 1) * strips + s) * bh;
  };
  const bool p_vec =
      ((reinterpret_cast<size_t>(p.partials) & 15) | (H & 3)) == 0;
  // the reduce of step t's partials at the tile of rows r0.., units j0..
  // for this thread's element (r, u), in strip order. Where the rows are
  // 16-byte aligned, 32 strips at a time go into the A buffers (free
  // between products) by cp.async.cg: [strip][16 rows][16 units], four
  // copies a row; else each thread loads its element's partials. Every
  // thread of the block calls it.
  auto reduce = [&](int t, int r0, int j0) {
    float s = 0.f;
    const size_t at = (size_t)(r0 + r) * H + j0 + u;
    const bool in = r0 + r < B && j0 + u < H;
    if (!p_vec) {
      for (int k = 0; k < strips; ++k)
        if (in) s = k == 0 ? grid::load_cg(partial(t, k) + at)
                           : s + grid::load_cg(partial(t, k) + at);
      return s;
    }
    float* buf = ws + (size_t)p.q_res * kStepFloats;
    for (int k0 = 0; k0 < strips; k0 += 32) {
      const int n = min(32, strips - k0);
      __syncthreads();  // buf's last readers are done
      for (int idx = threadIdx.x; idx < n * kRows * 4; idx += kThreads) {
        const int k = idx / (kRows * 4), rr = idx / 4 % kRows, q = idx % 4;
        const int row = r0 + rr, j = j0 + 4 * q;
        if (row < B && j < H)
          grid::cp_async16(buf + (k * kRows + rr) * kUnits + 4 * q,
                           partial(t, k0 + k) + (size_t)row * H + j);
      }
      grid::cp_async_commit();
      grid::cp_async_wait_all();
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        const float v = buf[(k * kRows + r) * kUnits + u];
        s = k0 + k == 0 ? v : s + v;
      }
    }
    return s;
  };
  // the first tile's carries in registers; the others' in dh0 and dc0,
  // which the C function zeroes
  float dh_reg = 0.f, dc_reg = 0.f;
  unsigned arrived = 0;
  for (int t = p.T - 1; t >= 0; --t) {
    const S* hp = p.h_all + (size_t)(t > 0 ? t - 1 : 0) * bh;
    const size_t seq = (size_t)t * bh;
    for (int i = 0; i < n_tiles; ++i) {
      const int r0 = tiles.row0(tiles.begin + i);
      const int j0 = tiles.unit0(tiles.begin + i);
      const int row = r0 + r, j = j0 + u;
      const bool valid = row < B && j < H;
      const size_t at = (size_t)row * H + j;
      const int q_res = j0 == j_strip ? p.q_res : 0;
      // the epilogue's loads, ahead of the product
      const int len = valid ? p.lengths[row] : 0;
      float bias[4] = {}, cpv = 0.f, dh_out = 0.f, dc_out = 0.f;
      float dh_c = dh_reg, dc_c = dc_reg;
      if (valid) {
#pragma unroll
        for (int q = 0; q < 4; ++q) bias[q] = __ldg(p.b + q * H + j);
        cpv = t == 0 ? p.c0[at] : to_float(p.c_all[seq - bh + at]);
        dh_out = to_float(p.dh_all[seq + at]);
        dc_out = to_float(p.dc_all[seq + at]);
        if (i > 0) {
          dh_c = p.dh0[at];
          dc_c = p.dc0[at];
        }
      }
      if (i > 0) __syncthreads();  // the last tile has read red and dg
      float sum[8][4];
      if (t == 0)  // h_{-1} = h0, float32
        gate_product(p.h0 + (size_t)r0 * H, min(kRows, B - r0), H, j0,
                     q_res, ws, p.w, abuf, sum);
      else
        gate_product(hp + (size_t)r0 * H, min(kRows, B - r0), H, j0, q_res,
                     ws, p.w, abuf, sum);
      store_partial(sum, red);
      // step t+1's partials are in once its barrier has completed
      if (i == 0 && t + 1 < p.T) barrier.wait(arrived);
      if (t + 1 < p.T) {
        const float dh_next = reduce(t + 1, r0, j0);
        if (valid && t + 1 < len) dh_c = dh_next;
      }
      grid::cp_async_wait_all();  // x_t of the first tile
      __syncthreads();
      float dgate[4] = {};
      if (valid) {
        float gate[4];
        gate_sums(red, r, u, gate);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float xv =
              i == 0 ? to_float(xs[(t & 1) * kXFloats + r * kCols +
                                   q * kUnits + u])
                     : ldg_f(p.x + seq * 4 + (size_t)row * G + q * H + j);
          gate[q] = (xv + gate[q]) + bias[q];
        }
        const float ig = sigmoidf(gate[0]), cand = tanhf(gate[1]);
        const float fg = sigmoidf(gate[2]), og = sigmoidf(gate[3]);
        const float c = fg * cpv + ig * cand;
        const float tc = tanhf(c);
        const bool alive = t < len;
        float dh = dh_out + dh_c;
        dh = alive ? dh : 0.f;
        float dc = dh * og * (1.f - tc * tc) + dc_c + dc_out;
        dc = alive ? dc : dc_c;
        dgate[0] = alive ? dc * cand * ig * (1.f - ig) : 0.f;
        dgate[1] = alive ? dc * ig * (1.f - cand * cand) : 0.f;
        dgate[2] = alive ? dc * cpv * fg * (1.f - fg) : 0.f;
        dgate[3] = alive ? dh * tc * og * (1.f - og) : 0.f;
        S* dxr = p.dx + seq * 4 + (size_t)row * G;
#pragma unroll
        for (int q = 0; q < 4; ++q) dxr[q * H + j] = from_float<S>(dgate[q]);
        if constexpr (sizeof(S) == 2) {
          float* dgr = p.dgates + seq * 4 + (size_t)row * G;
#pragma unroll
          for (int q = 0; q < 4; ++q) dgr[q * H + j] = dgate[q];
        }
        dc_c = alive ? dc * fg : dc_c;
        if (i == 0) {
          dh_reg = dh_c;
          dc_reg = dc_c;
        } else {
          p.dh0[at] = dh_c;
          p.dc0[at] = dc_c;
        }
      }
      *reinterpret_cast<float4*>(dg + r * kDgLd + 4 * u) =
          make_float4(dgate[0], dgate[1], dgate[2], dgate[3]);
      if (i == 0 && t > 0) {
        prefetch_x(p.x + (size_t)(t - 1) * B * G, r0, j0, B, H, x_vec,
                   xs + ((t - 1) & 1) * kXFloats);
        grid::cp_async_commit();
      }
      __syncthreads();  // dg is complete
      partial_product(dg, ws, p.w, j0, q_res, H,
                      partial(t, j0 / kUnits) + (size_t)r0 * H,
                      min(kRows, B - r0));
    }
    arrived = barrier.arrive();
  }
  barrier.wait(arrived);
  // dh0: step 0's partials on the rows alive at 0, else the carry (0);
  // dc0: the dc carry
  for (int i = 0; i < n_tiles; ++i) {
    const int r0 = tiles.row0(tiles.begin + i);
    const int j0 = tiles.unit0(tiles.begin + i);
    const float dh_first = reduce(0, r0, j0);
    const int row = r0 + r, j = j0 + u;
    if (row >= B || j >= H) continue;
    const size_t at = (size_t)row * H + j;
    float dh_c = i == 0 ? dh_reg : p.dh0[at];
    if (0 < p.lengths[row]) dh_c = dh_first;
    p.dh0[at] = dh_c;
    if (i == 0) p.dc0[at] = dc_reg;
  }
}

// The barrier floor: the same grid stepping through `barriers` of the
// same barriers with no products (chip_smoke.py times it).
__global__ void __launch_bounds__(kThreads, 1)
lstm_barrier_kernel(unsigned* sync, int B, int H, int barriers) {
  const Tiles tiles(B, H);
  const grid::Barrier barrier(sync, tiles.groups, tiles.n);
  for (int i = 0; i < barriers; ++i) barrier.sync();
}

// dW and db on the tensor cores: a block's 64 W rows x 128 gate columns
// over its row split [split * rows, ...) of the R = T*B rows,
// dw[m][n] = sum_r hprev[r][m] dx[r][n] and, in the blocks of the first
// 64 W rows, db[n] = sum_r dx[r][n]; hprev[r] = h0[r] for r < B, else
// h_all[r - B] (of the stream type S: bf16 rows are widened into the
// stage by plain loads); dx is the float32 dgates. 64 rows a stage in a ring of `ring` stages (4 where the
// shared memory holds them) filled by cp.async, ring - 1 stages ahead of
// the one multiplied (one block an SM: the ring, not other blocks, hides
// L2's latency); warp (wm, wn)
// of 2 x 4 owns 32 x 32 outputs (2 x 4 mma tiles). Each stage's 3xTF32
// products (lo passes and hi*hi apart) are promoted into float32
// registers, and db's column sums add each stage's 64 rows first. The
// split's outputs go to dw_out / db_out + split * stride.
constexpr int kDwM = 64, kDwN = 128, kDwK = 64, kDwRing = 4;
constexpr int kDwALd = kDwM + 8, kDwBLd = kDwN + 8;
constexpr int kDwStage = kDwK * (kDwALd + kDwBLd);

// 4 floats from src, `valid` of them (0 past), to dst: one 16-byte copy
// when vec and all four are valid.
__device__ __forceinline__ void copy4(float* dst, const float* src, int valid,
                                      bool vec) {
  if (vec && valid >= 4) {
    grid::cp_async16(dst, src);
    return;
  }
  for (int e = 0; e < 4; ++e) {
    if (e < valid)
      grid::cp_async4(dst + e, src + e);
    else
      dst[e] = 0.f;
  }
}

template <class S>
__global__ void __launch_bounds__(kThreads)
lstm_dw_kernel(const float* __restrict__ h0, const S* __restrict__ h_all,
               const float* __restrict__ dx, float* dw_out, float* db_out,
               size_t stride, int R, int B, int H, int rows, int ring) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int n0 = blockIdx.x * kDwN, m0 = blockIdx.y * kDwM;
  const int r_begin = blockIdx.z * rows, r_end = min(R, r_begin + rows);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const bool vec_a =
      (((reinterpret_cast<size_t>(h0) |
         (sizeof(S) == 4 ? reinterpret_cast<size_t>(h_all) : 0)) &
        15) |
       (H & 3)) == 0;
  const bool vec_b = (reinterpret_cast<size_t>(dx) & 15) == 0;
  // bf16 rows of h_all: 8-byte loads of four values
  const bool vec_s =
      ((reinterpret_cast<size_t>(h_all) & 7) | (H & 3)) == 0;
  auto load_stage = [&](int r0, float* st) {
    float* as = st;
    float* bs = st + kDwK * kDwALd;
    for (int idx = tid; idx < kDwK * kDwM / 4; idx += kThreads) {
      const int kk = idx / (kDwM / 4), m = m0 + 4 * (idx % (kDwM / 4));
      const int r = r0 + kk;
      const bool in = r < r_end && m < H;
      if constexpr (sizeof(S) == 2) {
        if (in && r >= B) {
          const S* src = h_all + (size_t)(r - B) * H + m;
          float* dst = as + kk * kDwALd + m - m0;
          if (vec_s && m + 3 < H) {  // four values in one 8-byte load
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
            *reinterpret_cast<float4*>(dst) = make_float4(
                __uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                __uint_as_float(v.y << 16),
                __uint_as_float(v.y & 0xffff0000u));
          } else {
            for (int e = 0; e < 4; ++e)
              dst[e] = m + e < H ? to_float(src[e]) : 0.f;
          }
          continue;
        }
      }
      const float* row = r < B ? h0 + (size_t)r * H
                               : reinterpret_cast<const float*>(h_all) +
                                     (size_t)(r - B) * H;
      const float* src = in ? row + m : h0;
      copy4(as + kk * kDwALd + m - m0, src, in ? H - m : 0, vec_a);
    }
    for (int idx = tid; idx < kDwK * kDwN / 4; idx += kThreads) {
      const int kk = idx / (kDwN / 4), n = n0 + 4 * (idx % (kDwN / 4));
      const int r = r0 + kk;
      const bool in = r < r_end && n < G;
      copy4(bs + kk * kDwBLd + n - n0, in ? dx + (size_t)r * G + n : dx,
            in ? G - n : 0, vec_b);
    }
  };
  const int stages = r_end > r_begin ? cdiv(r_end - r_begin, kDwK) : 0;
  float acc[2][4][4] = {};
  float db_sum = 0.f;
  const bool db_block = blockIdx.y == 0 && tid < kDwN;
  // one copy group a stage, empty past the last (the groups stay counted)
  for (int s = 0; s < ring - 1; ++s) {
    if (s < stages) load_stage(r_begin + s * kDwK, smem + s * kDwStage);
    grid::cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    const float* st = smem + (s % ring) * kDwStage;
    grid::cp_async_wait(ring - 2);  // stage s has landed
    // every thread's copies of stage s are in, and stage s - 1 is read
    __syncthreads();
    const int next = s + ring - 1;
    if (next < stages)
      load_stage(r_begin + next * kDwK,
                 smem + (next % ring) * kDwStage);
    grid::cp_async_commit();
    const float* as = st;
    const float* bs = st + kDwK * kDwALd;
    float hi[2][4][4] = {}, lo[2][4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kDwK / 8; ++ks) {
      const float* a0 = as + (8 * ks + t) * kDwALd + wm * 32 + g;
      const float* b0 = bs + (8 * ks + t) * kDwBLd + wn * 32 + g;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* am = a0 + 16 * mi;
        const float av[4] = {am[0], am[8], am[4 * kDwALd],
                             am[4 * kDwALd + 8]};
        split4(av, ah[mi], al[mi]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float bv0 = b0[8 * ni], bv1 = b0[4 * kDwBLd + 8 * ni];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma3(hi[mi][ni], lo[mi][ni], lo[mi][ni], ah[mi], al[mi], bv0,
               bv1);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        grid::promote(acc[mi][ni], hi[mi][ni], lo[mi][ni]);
    if (db_block) {
      float part = 0.f;
      for (int kk = 0; kk < kDwK; ++kk) part += bs[kk * kDwBLd + tid];
      db_sum += part;
    }
  }
  float* dw = dw_out + blockIdx.z * stride;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + 16 * mi + g + 8 * (e / 2);
        const int n = n0 + wn * 32 + 8 * ni + 2 * t + e % 2;
        if (m < H && n < G) dw[(size_t)m * G + n] = acc[mi][ni][e];
      }
  if (db_block && n0 + tid < G) db_out[blockIdx.z * stride + n0 + tid] = db_sum;
}

// out[e] = parts[0][e] + parts[1][e] + ... in split order, e < n (the
// (H + 1) x 4H of dW and db); dW rows to dw, the last row to db.
__global__ void __launch_bounds__(kThreads)
lstm_dw_sum_kernel(const float* __restrict__ parts, float* __restrict__ dw,
                   float* __restrict__ db, int splits, int hg, int n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float sum = parts[e];
  for (int s = 1; s < splits; ++s) sum += parts[(size_t)s * n + e];
  if (e < hg)
    dw[e] = sum;
  else
    db[e - hg] = sum;
}

// Row splits of the dW reduction: one when the output tiles fill the SMs,
// else enough for about one block an SM, at least 256 rows each.
int dw_splits(int R, int H) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 1;
  const int tiles = cdiv(4 * H, kDwN) * cdiv(H, kDwM);
  const int want = sms / tiles, most = cdiv(R, 256);
  return want < 1 ? 1 : (want > most ? most : want);
}

// The launch plan of a persistent kernel, into plan[7]: tiles, blocks per
// SM, SMs, grid, dynamic shared bytes, resident W rows (k-steps of 8 rows
// that fit beside the fixed buffers), barriers.
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
  const size_t fixed = sizeof(float) * (kAFloats + kRedFloats + 2 * kXFloats +
                                        (backward ? kDgFloats : 0));
  const size_t step_bytes = sizeof(float) * kStepFloats;
  const size_t room =
      (size_t)smem_max > fixed ? ((size_t)smem_max - fixed) / step_bytes : 0;
  const int steps = cdiv(H, 8);
  const int q_res = (int)(room < (size_t)steps ? room : steps);
  const size_t smem = fixed + q_res * step_bytes;
  int per_sm = 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  const int blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
  const int res_rows = 8 * q_res < H ? 8 * q_res : H;
  const int out[kPlan] = {tiles, per_sm,   sms,
                          blocks, (int)smem, res_rows,
                          backward ? T : T - 1};
  for (int i = 0; i < kPlan; ++i) plan[i] = out[i];
  if (err != cudaSuccess) return err;
  return blocks < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

// Words of the barriers' counters at batch B (see grid::Barrier).
int sync_words(int B) { return grid::kSyncWords * cdiv(B, kRows); }

// The forward (see fused_lstm_fwd_f32) on streams of type S.
template <class S>
int lstm_fwd(const S* x, const float* w, const float* b, const float* h0,
             const float* c0, const int* lengths, S* h_all, S* c_all,
             float* h_last, float* c_last, float* h_pong, unsigned* sync,
             int T, int B, int H, int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      plan_launch(lstm_fwd_persistent_kernel<S>, false, T, B, H, plan);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * sync_words(B), s);
  if (err != cudaSuccess) return err;
  const FwdArgs<S> a{x,     w,     b,      h0,     c0,     lengths,
                     h_all, c_all, h_last, c_last, h_pong, sync,
                     T,     B,     H,      cdiv(plan[5], 8)};
  err = grid::launch_cooperative(lstm_fwd_persistent_kernel<S>, plan[3],
                                 kThreads, plan[4], s, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The backward (see fused_lstm_bwd_f32) on streams of type S; dgates is
// where the recurrence leaves the float32 dgates for dW and db (dx itself
// for float32 streams).
template <class S>
int lstm_bwd(const S* x, const float* w, const float* b, const float* h0,
             const float* c0, const int* lengths, const S* h_all,
             const S* c_all, const S* dh_all, const S* dc_all, S* dx,
             float* dgates, float* dw, float* db, float* dh0, float* dc0,
             float* partials, float* dw_parts, unsigned* sync, int T, int B,
             int H, int splits, int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      plan_launch(lstm_bwd_persistent_kernel<S>, true, T, B, H, plan);
  if (err != cudaSuccess) return err;
  const size_t bh = (size_t)B * H;
  err = cudaMemsetAsync(dh0, 0, bh * sizeof(float), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(dc0, 0, bh * sizeof(float), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * sync_words(B), s);
  if (err != cudaSuccess) return err;
  const BwdArgs<S> a{x,      w,      b,        h0,  c0,  lengths,
                     h_all,  c_all,  dh_all,   dc_all, dx, dgates,
                     dh0,    dc0,    partials, sync, T,   B,
                     H,      cdiv(plan[5], 8)};
  err = grid::launch_cooperative(lstm_bwd_persistent_kernel<S>, plan[3],
                                 kThreads, plan[4], s, a);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int R = T * B, G = 4 * H, rows = cdiv(R, splits);
  // the dW ring: kDwRing stages where they fit, at least 2
  int dev = 0, smem_max = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int fit = smem_max / (int)(sizeof(float) * kDwStage);
  const int ring = fit < 2 ? 2 : (fit < kDwRing ? fit : kDwRing);
  const size_t smem = sizeof(float) * ring * kDwStage;
  err = cudaFuncSetAttribute(lstm_dw_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_dw(cdiv(G, kDwN), cdiv(H, kDwM), cdiv(R, rows));
  if (splits == 1) {
    lstm_dw_kernel<S><<<grid_dw, kThreads, smem, s>>>(
        h0, h_all, dgates, dw, db, 0, R, B, H, rows, ring);
    return cudaGetLastError();
  }
  const size_t part = (size_t)(H + 1) * G;
  lstm_dw_kernel<S><<<grid_dw, kThreads, smem, s>>>(
      h0, h_all, dgates, dw_parts, dw_parts + (size_t)H * G, part, R, B, H,
      rows, ring);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (int)part;
  const dim3 grid_sum(cdiv(n, kThreads));
  lstm_dw_sum_kernel<<<grid_sum, kThreads, 0, s>>>(dw_parts, dw, db,
                                                   cdiv(R, rows), H * G, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Words (unsigned) of the sync buffer the entry points take at batch B.
int fused_lstm_sync_words(int B) { return sync_words(B); }

// Floats of the backward's partials of dh_prev at these shapes: a
// ping-pong of one [B,H] a strip.
long long fused_lstm_partial_floats(int B, int H) {
  return 2LL * cdiv(H, kUnits) * B * H;
}

// Row splits of the backward's dW reduction at these shapes: with more
// than one, dw_parts holds that many (H + 1) x 4H partial sums (dW, db).
int fused_lstm_dw_splits(int T, int B, int H) { return dw_splits(T * B, H); }

// Forward over all T steps: h_all, c_all [T,B,H]; h_last, c_last [B,H];
// h_pong [B,H] (the second buffer of the h ping-pong) and sync (the
// barriers' counters, fused_lstm_sync_words(B) words, zeroed here) are
// scratch. Returns a cudaError_t (cudaErrorCooperativeLaunchTooLarge when
// the grid cannot be co-resident); plan as above.
int fused_lstm_fwd_f32(const float* x, const float* w, const float* b,
                       const float* h0, const float* c0, const int* lengths,
                       float* h_all, float* c_all, float* h_last,
                       float* c_last, float* h_pong, unsigned* sync, int T,
                       int B, int H, int* plan, void* stream) {
  return lstm_fwd<float>(x, w, b, h0, c0, lengths, h_all, c_all, h_last,
                         c_last, h_pong, sync, T, B, H, plan, stream);
}

// The same on bf16 streams x, h_all, c_all (torch.bfloat16 data); w, b,
// h0, c0 and the state h_last, c_last, h_pong are float32.
int fused_lstm_fwd_bf16(const void* x, const float* w, const float* b,
                        const float* h0, const float* c0, const int* lengths,
                        void* h_all, void* c_all, float* h_last,
                        float* c_last, float* h_pong, unsigned* sync, int T,
                        int B, int H, int* plan, void* stream) {
  return lstm_fwd<bf16>(static_cast<const bf16*>(x), w, b, h0, c0, lengths,
                        static_cast<bf16*>(h_all), static_cast<bf16*>(c_all),
                        h_last, c_last, h_pong, sync, T, B, H, plan, stream);
}

// Backward: dh_all, dc_all [T,B,H] are the output cotangents with the
// h_last/c_last cotangents already folded in. Writes dx [T,B,4H],
// dw [H,4H], db [4H], and dh0, dc0 [B,H] (zeroed here, the carries of a
// block's further tiles). partials (fused_lstm_partial_floats), dw_parts
// ((H + 1) x 4H a split when there is more than one) and sync are
// scratch. One persistent launch for the recurrence, then dW and db, and
// with row splits their sum.
int fused_lstm_bwd_f32(const float* x, const float* w, const float* b,
                       const float* h0, const float* c0, const int* lengths,
                       const float* h_all, const float* c_all,
                       const float* dh_all, const float* dc_all, float* dx,
                       float* dw, float* db, float* dh0, float* dc0,
                       float* partials, float* dw_parts, unsigned* sync,
                       int T, int B, int H, int splits, int* plan,
                       void* stream) {
  return lstm_bwd<float>(x, w, b, h0, c0, lengths, h_all, c_all, dh_all,
                         dc_all, dx, dx, dw, db, dh0, dc0, partials, dw_parts,
                         sync, T, B, H, splits, plan, stream);
}

// The same on bf16 streams x, h_all, c_all, dh_all, dc_all and dx
// (torch.bfloat16 data); w, b, h0, c0, dw, db, dh0 and dc0 are float32,
// and dgates (float32 [T,B,4H]) is scratch: the unrounded dgates, which
// dW and db are summed from.
int fused_lstm_bwd_bf16(const void* x, const float* w, const float* b,
                        const float* h0, const float* c0, const int* lengths,
                        const void* h_all, const void* c_all,
                        const void* dh_all, const void* dc_all, void* dx,
                        float* dw, float* db, float* dh0, float* dc0,
                        float* partials, float* dw_parts, float* dgates,
                        unsigned* sync, int T, int B, int H, int splits,
                        int* plan, void* stream) {
  return lstm_bwd<bf16>(
      static_cast<const bf16*>(x), w, b, h0, c0, lengths,
      static_cast<const bf16*>(h_all), static_cast<const bf16*>(c_all),
      static_cast<const bf16*>(dh_all), static_cast<const bf16*>(dc_all),
      static_cast<bf16*>(dx), dgates, dw, db, dh0, dc0, partials, dw_parts,
      sync, T, B, H, splits, plan, stream);
}


// The barrier floor of the forward (backward != 0: the backward) at these
// shapes: its grid, block and shared memory, stepping through its plan's
// barriers (T - 1, or T) with no work. sync as above.
int fused_lstm_barrier_floor(unsigned* sync, int T, int B, int H,
                             int backward, int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      backward
          ? plan_launch(lstm_bwd_persistent_kernel<float>, true, T, B, H, plan)
          : plan_launch(lstm_fwd_persistent_kernel<float>, false, T, B, H,
                        plan);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lstm_barrier_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan[4]);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * sync_words(B), s);
  if (err != cudaSuccess) return err;
  err = grid::launch_cooperative(lstm_barrier_kernel, plan[3], kThreads,
                                 plan[4], s, sync, B, H, plan[6]);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
