// The ghost-BN identity bottleneck block, forward, float32 and bfloat16,
// for Hopper (sm_90a): tensor-core implicit GEMMs (wgmma; float32 as
// 3xTF32) with the ghost-BN statistics in their epilogues.
//
// Replaces the Pallas TPU kernels
//   paddle_tpu/ops/pallas/block_megakernel.py  bottleneck_block /
//       _bottleneck_kernel (variant full)
//   benchmarks/megakernel_roll_micro.py  block / _kernel (variants full,
//       strided, nobn, noroll)
// and computes what they compute, on NHWC-flat rows (M = N*H*W rows):
//   acc1 = x [M,Cin] @ w1 [Cin,Cm]
//   h1   = relu(acc1 * a1 + b1)
//   acc2 = sum over taps t = (dy+1)*3 + (dx+1) of tap_t(h1) @ w3[t]
//          [Cm,Cm]; tap_t at row (n, h, w) is h1 at (n, h+dy, w+dx) when
//          that pixel lies in the image, else 0 (the affine and ReLU come
//          BEFORE the edge mask: a padded tap is 0, not relu(b))
//   h2   = relu(acc2 * a2 + b2)
//   acc3 = h2 @ w2 [Cm,Cin]
//   y    = relu(acc3 * a3 + b3 + x)
// Ghost BN: (a, b) of each BN are taken per group of `tile` consecutive
// images (G = tile*H*W rows) from the float32 accumulator, single pass:
// mean = sum/G, var = sum(h^2)/G - mean^2, a = gamma / sqrt(var + eps),
// b = beta - mean * a. Sums are float32; with bfloat16 data the taps, h2
// and y are rounded to bfloat16 (nearest even) as the reference rounds
// them, and nowhere else. Variants: strided computes full's function
// (below); nobn uses a = p[0], b = p[1] with no statistics; noroll is
// wrong on purpose, as its reference is: every tap of a row is
// relu(acc1 * a1 + b1) of that row itself, unshifted and unmasked.
//
// What bounds it on this card: one block is 2*M*Cm*(2*Cin + 9*Cm) FLOP,
// 55.9 GFLOP at each ResNet-50 stage at batch 128 (stage 2: Cin 512, Cm
// 128 at 28x28; 3: 1024/256 at 14x14; 4: 2048/512 at 7x7), 0.057 ms at
// 989 TFLOP/s in bfloat16 and 0.339 ms at 494.7/3 TFLOP/s in 3xTF32. The
// hand-ideal traffic is x in and y out: 2*M*Cin*size bytes, 205.5 MB at
// stage 2 in bfloat16 (0.061 ms at 3.35 TB/s). This design keeps acc1
// and acc2 in device memory (float32) and h2 in the data type, and never
// stores acc3; at stage 2 in bfloat16 it moves
//   x, read by GEMM1 and by the final pass         2 x 102.8 MB
//   acc1, written once, read once by the 3x3       2 x  51.4
//   acc2, written once, read once (h2's pass)      2 x  51.4
//   h2, written once, read by GEMM3's two passes   3 x  25.7
//   y, written once                                     102.8
// = 591 MB (0.176 ms at 3.35 TB/s), against the 925 MB of the earlier
// SIMT design, which stored acc3; the halo rows that two row tiles of the
// 3x3 both read, and the A rows that every column tile of a GEMM reads,
// come again from L2 and are not counted. The next design (a cluster per
// ghost group, acc1 in distributed shared memory) moves only x and y.
//
// Design. One C call enqueues, on the caller's stream:
//   3 x pack_w_kernel: w1, w3, w2 packed K-major (implicit_gemm.cuh),
//       float32 as TF32 hi and lo planes;
//   GEMM1 (A = x): acc1 and its statistics partials; coef_kernel -> (a1, b1);
//   3x3 (A = the taps of relu(acc1 * a1 + b1)): acc2, partials; coef -> (a2, b2);
//   act_kernel: h2 = relu(acc2 * a2 + b2) in T (into acc1's space);
//   GEMM3, statistics pass (A = h2): partials only; coef -> (a3, b3);
//   GEMM3, final pass: the same products, y = relu(acc3 * a3 + b3 + x).
// (nobn: the packs, GEMM1, the 3x3, h2 and the final pass, with p as the
// coefficients.) Both GEMM3 passes run the same main loop in the same
// reduction order, so their acc3 are bitwise equal and the statistics
// describe exactly the values the final pass uses: 2*M*Cm*Cin more FLOP
// (13.2 GFLOP at stage 2) in place of writing and reading back M*Cin
// float32 (2 x 205.5 MB). h2 is one elementwise pass because GEMM3 has
// Cin/128 column tiles (4 to 16), each of which would apply BN2 to the
// same rows again in a prologue of its own; the pass costs 0.027 ms a
// block at stage 2 (bf16, H100; megakernel_split.py). The 3x3 keeps its
// prologue (Cm/128 = 1 to 4 column tiles; its taps are masked after the
// BN), which costs it 0.019 of 0.166 ms there (no_prologue).
//  * Tensor cores. Every GEMM is block_gemm_kernel: two warpgroups own a
//    128-row x 128-column output tile, each runs wgmma on its 64 rows with
//    A from registers and B from a 128-byte-swizzled shared tile. bf16:
//    m64n128k16. float32: 3xTF32, each k-step's two lo passes issued
//    before its hi*hi pass and, within a reduction step, every lo pass
//    before every hi*hi pass (an add into a tensor-core accumulator
//    truncates to the running sum's ulp, so the small terms go first).
//    Past kPromoteAfter multiplies into one accumulator, each reduction
//    step sums into fresh registers, added with a rounding add (K' is
//    1152 for the 3x3 at stage 2 and 4608 at stage 4; K 2048 for GEMM1
//    at stage 4).
//  * Staging, as fused_conv.cu's: a ring of up to 4 B stages by 16-byte
//    cp.async, and a slab of A rows: the 3x3's halo slab of 128 + 2W + 2
//    rows (a ring of two), read by its nine taps at their offsets; the
//    1x1's 128 rows with every step. A reduction step is one 128-byte
//    chunk of B (64 bf16 or 32 float32 channels). x is staged as it is
//    (rows that are not whole 16-byte chunks take the plain-load variant,
//    kVecA false). acc1, acc2 and h2 have rows padded to 8 channels (the
//    padding is written as 0), so they always go by cp.async; the 3x3's
//    slab holds float32 acc1 (in bfloat16 a 64-channel step is 256 bytes
//    a row, 288 apart so that a fragment's 8-byte reads hit every bank
//    once a half-warp). When the ring holds every step (GEMM3 at stages
//    2-3) all copies are issued at once; GEMM3's passes without promotion
//    (at most 128 registers) run two blocks an SM.
//  * Prologue (the 3x3). At a slab's first step the block applies BN1 in place,
//    each row with its own group's (a, b) (a valid tap always reads a row
//    of the same image, hence of the same group), multiply then add as
//    the reference rounds, ReLU, and in bfloat16 the rounding to bf16; so
//    nine taps share one application, and the edge mask comes after,
//    when a fragment is read (validity bits per row, computed once a
//    tile). In bfloat16 a fragment word packs the top halves of two
//    activated floats.
//  * Row tiles cross ghost groups. The grid runs 128-row tiles over all M
//    rows (no row is wasted when G is not a multiple of 128: stage 4 at
//    tile 1 has 49-row groups). A tile meets at most 127/G + 2 groups;
//    the epilogue stages the float32 tile in shared memory and writes the
//    column sums and sums of squares of each (row tile, group segment),
//    each thread one column, the rows in order. coef_kernel sums each
//    group's segments in tile order: no atomics, a rerun is bitwise
//    equal.
//  * Epilogues: acc stored as 16-byte rows from the staged tile; or only
//    the partials; or y = relu(acc3 * a3 + b3 + x) in x's type, each row
//    with its group's (a3, b3), 16 bytes at a time where rows allow (a
//    thread's x chunks are all loaded before the first is used).
// strided: the reference builds each dy-trio of taps with one strided
// roll in place of three shifts. Here each dy stages its own window of
// 128 + 2 rows (dy-major reduction) and its three dx taps read it at
// offsets 0, 1, 2; full stages one halo slab for all nine.
// Offsets of row x channel products are 64-bit. Shared memory limits the
// 3x3 image width (the smallest ring of 128 + 2W + 2 float32 rows must
// fit 227 KB: W up to about 190 in bfloat16); a wider image returns
// cudaErrorInvalidConfiguration. A kernel allocates nothing: the caller
// passes the workspace (accumulators, partials, coefficients, packed
// weights).
//
// All PTX lives in sm90_mma.cuh; the weight pack, operand types and tap
// bits are implicit_gemm.cuh's, shared with fused_conv.cu. The main
// kernel is not fused_conv_tc_kernel: the 3x3's A operand is a float32
// accumulator activated per row group, its row tiles report statistics
// per group segment, and its epilogues differ.
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the current CUDA stream through ctypes and checks the
// returned cudaError_t (cudaGetLastError after every launch).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "implicit_gemm.cuh"
#include "sm90_mma.cuh"

namespace {

constexpr int kBN = 128;             // output columns a block
constexpr int kTilePitch = kBN + 8;  // floats between staged tile rows
// The tensor cores' float32 sums are truncated, not rounded: past this
// many k-step multiplies into one accumulator (3xTF32 counts 3 a k-step)
// each reduction step sums into fresh registers, added with a rounding
// add. float32: fused_conv.cu's threshold (the source test holds acc2 at
// K' 2304 within 1e-6 of max|acc2| with it, and finds it past 1e-5
// without). bfloat16: past one reduction step; the roll micro's nobn
// chain (no BN renormalizes the truncation's drift toward zero) reads
// 1.056, 1.017 and 0.943 of its limit on an H100 with promotion past
// 96, 32 and 16 multiplies (megakernel_split.py).
constexpr int kPromoteAfter = 96;
constexpr int kPromoteAfterBf16 = 16;

// what a GEMM's epilogue does
constexpr int kStoreAcc = 0;   // acc (and its statistics partials)
constexpr int kStatsOnly = 1;  // the partials only
constexpr int kResidual = 2;   // y = relu(acc * a + b + x)

// the variants, in the wrapper's order
constexpr int kFull = 0, kStrided = 1, kNoBn = 2, kNoRoll = 3;

struct Args {
  const void* a;          // A rows: x or h2 [M, lda] of T, or acc1 float32
  const void* wp;         // packed weights [planes][npad][taps * cpad] of T
  const float* coef;      // the 3x3: BN1's (a, b) [groups][2][C];
                          // kResidual: BN3's [groups][2][N]
  int coef_stride;        // floats between groups (0: nobn's p for all)
  float* out;             // kStoreAcc: acc [M, ldo] float32
  float* partial;         // [row tiles][segs][2][N] or null
  const void* x;          // kResidual: x [M, N] of T
  void* y;                // kResidual: y [M, N] of T
  int M, C, N, H, W, G;   // rows, A channels, columns, image, group rows
  int lda, ldo, segs;     // row strides; group segments a row tile
  int taps, tps, shift;   // 9 or 1 taps, taps a slab (9, 3 or 1), 3x3
                          // taps shifted and masked (0: noroll)
  int cpad, npad, nc;     // channels padded to chunks, columns, chunks
  int n_it, n_slabs;      // reduction steps; slabs
  int nsb, lead, sa;      // B ring stages, steps issued ahead, slab stages
  int halo, slab_rows;    // rows above the tile a slab starts; its rows
  int vec_y;              // y and x rows are whole 16-byte chunks
};

// Two activated float32 values (already bf16) as one bf16 pair word, the
// lower channel in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (f32_word(hi) & 0xffff0000u) | (f32_word(lo) >> 16);
}

__device__ __forceinline__ float bf16_value(uint16_t h) {
  return word_f32(static_cast<uint32_t>(h) << 16);
}

// One 128 x 128 tile of A @ w; see the header. kFloatA: A is a float32
// accumulator activated per row group (the 3x3); else x or h2 as they
// are. kVecA: A rows are whole 16-byte chunks (cp.async), else plain
// loads.
// GEMM3's passes (short K, no promotion) take two blocks an SM: their
// few steps leave one block's copies, prologue and epilogue exposed.
template <class E, bool kFloatA, bool kVecA, bool kPromote, int kEpi>
__global__ void __launch_bounds__(kThreads,
                                  kEpi != kStoreAcc && !kPromote ? 2 : 1)
block_gemm_kernel(Args p) {
  using T = typename E::T;
  using S = typename std::conditional<kFloatA, float, T>::type;
  constexpr int kBPlane = kBN * kChunkBytes;      // one plane of a B stage
  constexpr int kBStage = kBPlane * E::kPlanes;
  constexpr int kSBytes = static_cast<int>(sizeof(S));
  constexpr int kSlabRow = E::kBK * kSBytes;     // 128 or 256 bytes
  constexpr int kSlabPitch = kSlabRow + (kSlabRow == 256 ? 32 : 16);
  constexpr int kRowChunks = kSlabRow / 16;      // 16-byte chunks a row
  constexpr int kRowStep = kThreads / kRowChunks;
  constexpr int kSE16 = 16 / kSBytes;            // slab elements in 16 B
  constexpr int kAcc = kBN / 2;

  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm90::dyn_smem()) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* bring = base;                     // nsb B stages
  unsigned char* sring = base + p.nsb * kBStage;   // sa slabs
  const int slab_bytes = p.slab_rows * kSlabPitch;

  const int tid = threadIdx.x;
  const int warp8 = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col0 = blockIdx.x * kBN, row0 = blockIdx.y * kBM;
  // this thread's two rows of the tile (fragment rows g and g + 8 of its
  // warp's 16) and the taps of each that stay in the image
  const int lr0 = warp8 * 16 + g, lr1 = lr0 + 8;
  uint32_t valid0 = 0x1ffu, valid1 = 0x1ffu;
  if (p.shift) {
    valid0 = tap_bits(row0 + lr0, p.H, p.W);
    valid1 = tap_bits(row0 + lr1, p.H, p.W);
  }

  // B copies, fixed for the whole loop: 16-byte chunk bc of tile rows
  // bn0 + 32i
  const int bc = tid % 8, bn0 = tid / 8;
  const int64_t krow_bytes =
      static_cast<int64_t>(p.taps) * p.cpad * E::kBytes;
  const int64_t plane_bytes = krow_bytes * p.npad;
  const unsigned char* bsrc = static_cast<const unsigned char*>(p.wp) +
                              (col0 + bn0) * krow_bytes + bc * 16;
  const int bdst = bn0 * kChunkBytes + ((bc ^ (bn0 & 7)) << 4);
  auto load_b = [&](int j, int tap, unsigned char* dst) {
    const unsigned char* src =
        bsrc + (static_cast<int64_t>(tap) * p.cpad +
                static_cast<int64_t>(j) * E::kBK) * E::kBytes;
#pragma unroll
    for (int i = 0; i < kBN / 32; ++i)
#pragma unroll
      for (int pl = 0; pl < E::kPlanes; ++pl)
        sm90::cp_async16(dst + pl * kBPlane + bdst + i * 32 * kChunkBytes,
                         src + pl * plane_bytes + i * 32 * krow_bytes, 16);
  };
  // A copies: 16-byte chunk sc of slab rows sr0 + kRowStep*i. Slab (o, j)
  // holds A rows [slab_first(o), + slab_rows) of chunk j; zeros outside
  // [0, M) x [0, C).
  const int sc = tid % kRowChunks, sr0 = tid / kRowChunks;
  const S* a = static_cast<const S*>(p.a);
  auto slab_first = [&](int o) {
    return static_cast<int64_t>(row0) + (p.tps == 3 ? (o - 1) * p.W : 0) -
           p.halo;
  };
  auto load_slab = [&](int o, int j, unsigned char* dst) {
    const int64_t g0 = slab_first(o);
    if constexpr (kVecA) {
      const int c = j * E::kBK + sc * kSE16;
      const S* src = a + (g0 + sr0) * p.lda + c;
      for (int r = sr0; r < p.slab_rows; r += kRowStep) {
        const int64_t gr = g0 + r;
        const bool in = c < p.C && gr >= 0 && gr < p.M;
        sm90::cp_async16(dst + r * kSlabPitch + sc * 16, in ? src : a,
                         in ? 16 : 0);
        src += static_cast<int64_t>(kRowStep) * p.lda;
      }
    } else {
      const int c0 = j * E::kBK;
      for (int q = tid; q < p.slab_rows * E::kBK; q += kThreads) {
        const int r = q / E::kBK, cc = q % E::kBK;
        const int64_t gr = g0 + r;
        const int c = c0 + cc;
        S v = 0;
        if (gr >= 0 && gr < p.M && c < p.C) v = a[gr * p.lda + c];
        *reinterpret_cast<S*>(dst + r * kSlabPitch + cc * kSBytes) = v;
      }
    }
  };
  // The copies run lead steps ahead of the multiplies. Steps are (outer
  // o, chunk j, tap k of the slab), tap o * tps + k; step q fills B stage
  // qs. Slab i goes with step slab_q: the 1x1's with every step; a 3x3's
  // slab 0 with step 0 and slab i + 1 with step lead + tps*i, issued as
  // slab i's first tap is multiplied, when slab i - 1's stage is free.
  int q = 0, qo = 0, qj = 0, qk = 0, qs = 0;
  int slab_i = 0, slab_o = 0, slab_j = 0, slab_q = 0, slab_s = 0;
  auto issue_next = [&]() {
    if (q < p.n_it) {
      load_b(qj, qo * p.tps + qk, bring + qs * kBStage);
      if (q == slab_q && slab_i < p.n_slabs) {
        load_slab(slab_o, slab_j, sring + slab_s * slab_bytes);
        ++slab_i;
        if (++slab_j == p.nc) {
          slab_j = 0;
          ++slab_o;
        }
        slab_s = slab_s + 1 == p.sa ? 0 : slab_s + 1;
        slab_q = p.tps == 1 ? q + 1
                            : (slab_i == 1 ? p.lead : slab_q + p.tps);
      }
    }
    ++q;
    if (++qk == p.tps) {
      qk = 0;
      if (++qj == p.nc) {
        qj = 0;
        ++qo;
      }
    }
    qs = qs + 1 == p.nsb ? 0 : qs + 1;
  };
  // (a, b) of A's BN for group grp at this thread's 4 channels of chunk j
  auto coef_of = [&](int grp, int j, float (&av)[4], float (&bv)[4]) {
    const int c = j * E::kBK + sc * 4;
    const float* ab = p.coef + static_cast<int64_t>(grp) * p.coef_stride;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = c + e < p.C;
      av[e] = in ? ab[c + e] : 0.f;
      bv[e] = in ? ab[p.C + c + e] : 0.f;
    }
  };
  // the group of this thread's first row of slab (o, j), clamped to [0, M)
  auto first_group = [&](int o) {
    const int64_t gr = slab_first(o) + sr0;
    return static_cast<int>(gr < 0 ? 0 : gr >= p.M ? p.M - 1 : gr) / p.G;
  };
  // The BN of A's rows in place (slab (o, j) in s), once per staged
  // element: each row with its group's (a, b) (av, bv hold group cur's,
  // the group of the thread's first row; the rows only grow, so the next
  // group starts at row `next`), multiply then add, ReLU, and in bfloat16
  // rounded to bf16. Rows outside [0, M) stay 0 (only masked taps read
  // them).
  auto activate = [&](int o, int j, unsigned char* s, int cur,
                      float (&av)[4], float (&bv)[4]) {
    int64_t gr = slab_first(o) + sr0;
    int64_t next = (static_cast<int64_t>(cur) + 1) * p.G;
#pragma unroll 4
    for (int r = sr0; r < p.slab_rows; r += kRowStep, gr += kRowStep) {
      if (gr < 0 || gr >= p.M) continue;
      if (gr >= next) {
        cur = static_cast<int>(gr) / p.G;
        next = (static_cast<int64_t>(cur) + 1) * p.G;
        coef_of(cur, j, av, bv);
      }
      float4* v4 = reinterpret_cast<float4*>(s + r * kSlabPitch + sc * 16);
      const float4 v = *v4;
      float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = fmaxf(__fadd_rn(__fmul_rn(f[e], av[e]), bv[e]), 0.f);
      if constexpr (E::kBf16) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const uint32_t h = sm90::bf16x2_rn(f[e], f[e + 1]);
          f[e] = word_f32(h << 16);
          f[e + 1] = word_f32(h & 0xffff0000u);
        }
      }
      *v4 = make_float4(f[0], f[1], f[2], f[3]);
    }
  };

  // acc: the tile's sums. With kPromote, part: one reduction step's
  // products, added into acc once they complete (the multiplies overwrite
  // it, then accumulate); without, the multiplies accumulate into acc.
  float acc[kAcc], part[kPromote ? kAcc : 1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  if constexpr (kPromote) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) part[i] = 0.f;
  }

  for (int i = 0; i < p.lead; ++i) {
    issue_next();
    sm90::cp_async_commit();
  }
  // the step multiplied: outer o, chunk j, tap k of the slab, in B stage
  // bs and slab stage ss
  int o = 0, j = 0, k = 0, bs = 0, ss = 0;
  for (int it = 0; it < p.n_it; ++it) {
    // a slab's first step: its first row's coefficients, loaded while the
    // copies land
    float av[4], bv[4];
    int cur = 0;
    if (kFloatA && k == 0) {
      cur = first_group(o);
      coef_of(cur, j, av, bv);
    }
    sm90::cp_async_wait(p.lead - 1);  // this thread's copies of step it
    __syncthreads();                  // and every thread's have landed
    unsigned char* slab = sring + ss * slab_bytes;
    if (kFloatA && k == 0) {
      activate(o, j, slab, cur, av, bv);
      __syncthreads();
    }
    const unsigned char* btile = bring + bs * kBStage;
    const int tap = o * p.tps + k;
    const int off =
        p.shift ? p.halo + (tap / 3 - 1) * p.W + tap % 3 - 1 -
                      (p.tps == 3 ? (o - 1) * p.W : 0)
                : 0;
    const bool v0 = (valid0 >> tap) & 1u, v1 = (valid1 >> tap) & 1u;
    const unsigned char* row_0 = slab + (lr0 + off) * kSlabPitch;
    const unsigned char* row_1 = slab + (lr1 + off) * kSlabPitch;
    const uint32_t* w0 = reinterpret_cast<const uint32_t*>(row_0);
    const uint32_t* w1 = reinterpret_cast<const uint32_t*>(row_1);
    // k-steps of this chunk that reach a channel below C
    const int nks = min(4, cdiv(p.C - j * E::kBK, E::kK));

    // this step's products into d (overwriting it first unless keep)
    auto multiply = [&](float (&d)[kAcc], int keep) {
      if constexpr (E::kBf16) {
        uint32_t af[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if constexpr (kFloatA) {
            const float* f0 = reinterpret_cast<const float*>(row_0);
            const float* f1 = reinterpret_cast<const float*>(row_1);
            const int c = ks * 16 + 2 * t;
            af[ks][0] = v0 ? bf16_pair(f0[c], f0[c + 1]) : 0u;
            af[ks][1] = v1 ? bf16_pair(f1[c], f1[c + 1]) : 0u;
            af[ks][2] = v0 ? bf16_pair(f0[c + 8], f0[c + 9]) : 0u;
            af[ks][3] = v1 ? bf16_pair(f1[c + 8], f1[c + 9]) : 0u;
          } else {
            const int u = ks * 8 + t;
            af[ks][0] = v0 ? w0[u] : 0u;
            af[ks][1] = v1 ? w1[u] : 0u;
            af[ks][2] = v0 ? w0[u + 4] : 0u;
            af[ks][3] = v1 ? w1[u + 4] : 0u;
          }
        }
        sm90::wgmma_fence();
        sm90::fence_acc(d);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < nks)
            sm90::wgmma<kBN, true>(d, af[ks], btile + ks * 32, ks | keep);
      } else {
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int u = ks * 8 + t;
          const float e[4] = {v0 ? word_f32(w0[u]) : 0.f,
                              v1 ? word_f32(w1[u]) : 0.f,
                              v0 ? word_f32(w0[u + 4]) : 0.f,
                              v1 ? word_f32(w1[u + 4]) : 0.f};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            hi[ks][r] = sm90::tf32_rna(e[r]);
            lo[ks][r] = sm90::tf32_rna(e[r] - word_f32(hi[ks][r]));
          }
        }
        sm90::wgmma_fence();
        sm90::fence_acc(d);
        // every lo pass of the step before any hi*hi pass
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks < nks) {
            const unsigned char* bk = btile + ks * 32;
            sm90::wgmma<kBN, false>(d, lo[ks], bk, ks | keep);
            sm90::wgmma<kBN, false>(d, hi[ks], bk + kBPlane, 1);
          }
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < nks)
            sm90::wgmma<kBN, false>(d, hi[ks], btile + ks * 32, 1);
      }
      sm90::wgmma_commit();
      // the copies of step it + lead run with the multiplies: they refill
      // the stages step it - 1 read, done before the last barrier
      issue_next();
      sm90::cp_async_commit();
      sm90::wgmma_wait0();
      sm90::fence_acc(d);
    };
    if constexpr (kPromote) {
      multiply(part, 0);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    } else {
      multiply(acc, 1);
    }
    __syncthreads();  // every read of this stage is done before a refill
    bs = bs + 1 == p.nsb ? 0 : bs + 1;
    if (++k == p.tps) {
      k = 0;
      ss = ss + 1 == p.sa ? 0 : ss + 1;
      if (++j == p.nc) {
        j = 0;
        ++o;
      }
    }
  }

  // The float32 tile in shared memory (the ring is free: the loop ended
  // with a barrier), rows kTilePitch floats apart.
  float* tile = reinterpret_cast<float*>(base);
#pragma unroll
  for (int jn = 0; jn < kBN / 8; ++jn) {
    const int c = jn * 8 + 2 * t;
    *reinterpret_cast<float2*>(tile + lr0 * kTilePitch + c) =
        make_float2(acc[4 * jn], acc[4 * jn + 1]);
    *reinterpret_cast<float2*>(tile + lr1 * kTilePitch + c) =
        make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
  }
  __syncthreads();
  const int rows = min(kBM, p.M - row0);

  if (kEpi != kResidual && p.partial != nullptr) {
    // column sums (s 0) and sums of squares (s 1) of each group segment
    // of the tile: one column a thread, its rows in order
    const int first_g = row0 / p.G;
    for (int e = tid; e < 2 * kBN; e += kThreads) {
      const int s = e / kBN, c = e % kBN;
      if (col0 + c >= p.N) continue;
      float* dst = p.partial +
                   (static_cast<int64_t>(blockIdx.y) * p.segs * 2 + s) * p.N +
                   col0 + c;
      int next = (first_g + 1) * p.G - row0;  // the next group's first row
      for (int r = 0, seg = 0;; ++seg) {
        const int end = min(next, rows);
        float sum = 0.f;
#pragma unroll 8
        for (; r < end; ++r) {
          const float v = tile[r * kTilePitch + c];
          sum += s ? v * v : v;
        }
        dst[static_cast<int64_t>(seg) * 2 * p.N] = sum;
        if (r >= rows) break;
        next += p.G;
      }
    }
  }

  if constexpr (kEpi == kStoreAcc) {
    // acc rows of ldo floats (N padded to 4: the padding columns are 0,
    // the products of zero-padded weights), 16 bytes a store
    constexpr int kQ = kBN / 4;
    for (int qq = tid; qq < kBM * kQ; qq += kThreads) {
      const int r = qq / kQ, n = col0 + (qq % kQ) * 4;
      if (r < rows && n < p.ldo)
        *reinterpret_cast<float4*>(
            p.out + static_cast<int64_t>(row0 + r) * p.ldo + n) =
            *reinterpret_cast<const float4*>(tile + r * kTilePitch + n - col0);
    }
  }

  if constexpr (kEpi == kResidual) {
    // y = relu(acc * a + b + x) in T, each row with its group's (a, b)
    const T* x = static_cast<const T*>(p.x);
    T* y = static_cast<T*>(p.y);
    auto relu_out = [](float acc_v, float a_v, float b_v, float x_v) {
      return fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(acc_v, a_v), b_v), x_v),
                   0.f);
    };
    if (p.vec_y) {
      // 16 bytes a chunk; this thread's chunks are rows rq + kRows*i at
      // the same columns n: x loaded for all of them first, (a, b)
      // reloaded only where the group changes
      constexpr int kE16 = 16 / E::kBytes;
      constexpr int kQ = kBN / kE16;
      constexpr int kRows = kThreads / kQ;
      constexpr int kPer = kBM / kRows;
      const int n = col0 + (tid % kQ) * kE16, rq = tid / kQ;
      uint4 xv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = rq + kRows * i;
        xv[i] = r < rows && n < p.N
                    ? *reinterpret_cast<const uint4*>(
                          x + static_cast<int64_t>(row0 + r) * p.N + n)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
      float av[kE16], bv[kE16];
      int cur = -1;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = rq + kRows * i;
        if (r >= rows || n >= p.N) continue;
        const int grp = (row0 + r) / p.G;
        if (grp != cur) {
          cur = grp;
          const float* ab =
              p.coef + static_cast<int64_t>(grp) * p.coef_stride + n;
#pragma unroll
          for (int e = 0; e < kE16; ++e) {
            av[e] = ab[e];
            bv[e] = ab[p.N + e];
          }
        }
        const float* a_row = tile + r * kTilePitch + n - col0;
        const uint32_t w[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
        uint32_t u[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (E::kBf16)
            u[e] = sm90::bf16x2_rn(
                relu_out(a_row[2 * e], av[2 * e], bv[2 * e],
                         word_f32(w[e] << 16)),
                relu_out(a_row[2 * e + 1], av[2 * e + 1], bv[2 * e + 1],
                         word_f32(w[e] & 0xffff0000u)));
          else
            u[e] = f32_word(relu_out(a_row[e], av[e], bv[e], word_f32(w[e])));
        }
        *reinterpret_cast<uint4*>(
            y + static_cast<int64_t>(row0 + r) * p.N + n) =
            make_uint4(u[0], u[1], u[2], u[3]);
      }
    } else {
      for (int qq = tid; qq < kBM * kBN; qq += kThreads) {
        const int r = qq / kBN, n = col0 + qq % kBN;
        if (r >= rows || n >= p.N) continue;
        const int64_t i = static_cast<int64_t>(row0 + r) * p.N + n;
        const float* ab =
            p.coef + static_cast<int64_t>((row0 + r) / p.G) * p.coef_stride;
        float xf;
        if constexpr (E::kBf16)
          xf = bf16_value(x[i]);
        else
          xf = x[i];
        const float v = relu_out(tile[r * kTilePitch + n - col0], ab[n],
                                 ab[p.N + n], xf);
        if constexpr (E::kBf16)
          y[i] = static_cast<uint16_t>(sm90::bf16x2_rn(v, 0.f));
        else
          y[i] = v;
      }
    }
  }
}

// coef [groups, 2, N] (a, b) of each group from the partial sums of its
// row tiles' segments, summed in tile order; p [2, N] is (gamma, beta).
__global__ void __launch_bounds__(kBN)
coef_kernel(const float* __restrict__ partial, const float* __restrict__ p,
            float* __restrict__ coef, int N, int G, int segs, float eps) {
  const int g = blockIdx.y;
  const int c = blockIdx.x * kBN + threadIdx.x;
  if (c >= N) return;
  const int g0 = g, g1 = g;  // the groups whose rows these statistics take
  float s1 = 0.f, s2 = 0.f;
  for (int gg = g0; gg <= g1; ++gg) {
    const int64_t r0 = static_cast<int64_t>(gg) * G;
    // unrolled so that the loads of several tiles are in flight at once
#pragma unroll 4
    for (int64_t t = r0 / kBM; t <= (r0 + G - 1) / kBM; ++t) {
      const int64_t s = gg - t * kBM / G;  // gg's segment of row tile t
      const float* at = partial + ((t * segs + s) * 2) * N + c;
      s1 += at[0];
      s2 += at[N];
    }
  }
  const float n_rows = static_cast<float>(g1 - g0 + 1) * G;
  const float mean = s1 / n_rows;
  const float var = s2 / n_rows - mean * mean;
  const float a = p[c] * (1.f / sqrtf(var + eps));
  coef[(static_cast<int64_t>(g) * 2) * N + c] = a;
  coef[(static_cast<int64_t>(g) * 2 + 1) * N + c] = p[N + c] - mean * a;
}

// h [M, ldc] of T = relu(acc * a + b) (in bfloat16 rounded to bf16), each
// row with its group's (a, b) [groups][2][C] (coef_stride apart; 0: p
// itself), 0 in the padding columns [C, ldc); ldc a multiple of 8, eight
// channels a thread.
template <class E>
__global__ void __launch_bounds__(kThreads)
act_kernel(const float* __restrict__ acc, const float* __restrict__ coef,
           int coef_stride, typename E::T* __restrict__ h, int M, int C,
           int ldc, int G) {
  const int chunks = ldc / 8;
  const int64_t total = static_cast<int64_t>(M) * chunks;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       q < total; q += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int m = static_cast<int>(q / chunks);
    const int c = static_cast<int>(q - static_cast<int64_t>(m) * chunks) * 8;
    const float* ab = coef + static_cast<int64_t>(m / G) * coef_stride;
    const float4* src =
        reinterpret_cast<const float4*>(acc + static_cast<int64_t>(m) * ldc + c);
    const float4 v0 = src[0], v1 = src[1];
    float f[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = c + e < C ? fmaxf(__fadd_rn(__fmul_rn(f[e], ab[c + e]),
                                         ab[C + c + e]),
                               0.f)
                       : 0.f;
    typename E::T* dst = h + static_cast<int64_t>(m) * ldc + c;
    if constexpr (E::kBf16) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          sm90::bf16x2_rn(f[0], f[1]), sm90::bf16x2_rn(f[2], f[3]),
          sm90::bf16x2_rn(f[4], f[5]), sm90::bf16x2_rn(f[6], f[7]));
    } else {
      reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// group segments a 128-row tile may meet
int segments(int G) { return (kBM - 1) / G + 2; }

long long round_up(long long v, int m) { return (v + m - 1) / m * m; }

// Bytes of w [taps*C, N] packed (float32: two planes of 4 bytes; the
// workspace is sized for float32, which also holds bfloat16's).
long long wpack_bytes_f32(int taps, int c, int n) {
  return F32::kPlanes * round_up(n, kBN) * taps * round_up(c, F32::kBK) *
         F32::kBytes;
}

// The workspace, in floats, each part 256-byte aligned: acc1 (later h2
// [M, ldc] of T), acc2 [M, ldc] (ldc = Cm padded to 8), the partials
// [row tiles, segs, 2, max(Cm, Cin)], the coefficients of the three BNs
// [groups, 2, Cm | Cm | Cin], and w1, w3, w2 packed.
struct Workspace {
  float *acc1, *acc2, *partial, *coef1, *coef2, *coef3, *wp1, *wp3, *wp2;
  long long floats;
  Workspace(float* base, int n, int hw, int cin, int cm, int tile) {
    const long long m = static_cast<long long>(n) * hw;
    const long long groups = n / tile;
    const long long ldc = round_up(cm, 8);
    const long long sizes[9] = {
        m * ldc, m * ldc,
        cdiv(m, kBM) * static_cast<long long>(segments(tile * hw)) * 2 *
            (cm > cin ? cm : cin),
        groups * 2 * cm, groups * 2 * cm, groups * 2 * cin,
        wpack_bytes_f32(1, cin, cm) / 4, wpack_bytes_f32(9, cm, cm) / 4,
        wpack_bytes_f32(1, cm, cin) / 4};
    float** parts[9] = {&acc1, &acc2, &partial, &coef1, &coef2,
                        &coef3, &wp1, &wp3, &wp2};
    floats = 0;
    for (int i = 0; i < 9; ++i) {
      *parts[i] = base == nullptr ? nullptr : base + floats;
      floats += round_up(sizes[i], 64);
    }
  }
};

template <class E>
cudaError_t pack(const void* w, void* wpack, int taps, int C, int N,
                 cudaStream_t s) {
  const int cpad = cdiv(C, E::kBK) * E::kBK, npad = cdiv(N, kBN) * kBN;
  const dim3 pack_grid(taps * cpad / 32, npad / 32);
  pack_w_kernel<E><<<pack_grid, kThreads, 0, s>>>(
      static_cast<const typename E::T*>(w), static_cast<uint32_t*>(wpack),
      static_cast<uint16_t*>(wpack), taps, C, N, cpad, npad);
  return cudaGetLastError();
}

template <class E, bool kFloatA, bool kVecA, bool kPromote, int kEpi>
cudaError_t run_main(const Args& p, int smem, cudaStream_t s) {
  auto* const kernel = block_gemm_kernel<E, kFloatA, kVecA, kPromote, kEpi>;
  static int allowed = 0;  // dynamic shared memory the kernel may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(cdiv(p.N, kBN), cdiv(p.M, kBM));
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <class E, bool kFloatA, bool kVecA, int kEpi>
cudaError_t run_main(const Args& p, int smem, bool promote, cudaStream_t s) {
  return promote ? run_main<E, kFloatA, kVecA, true, kEpi>(p, smem, s)
                 : run_main<E, kFloatA, kVecA, false, kEpi>(p, smem, s);
}

// One GEMM of the block: p carries the operands and shapes (a, wp, coef,
// out, partial, x, y, M, C, N, H, W, G, lda, ldo, segs, taps, tps, shift,
// halo, vec_y); this plans the rest (chunks, steps, the deepest ring that fits)
// and launches. GEMM1 (A = x, epilogue kStoreAcc), the 3x3 (float_a: A =
// acc1, kStoreAcc) or a GEMM3 pass (A = h2, kStatsOnly or kResidual).
template <class E>
cudaError_t gemm(Args p, bool float_a, int epi, cudaStream_t s) {
  p.nc = cdiv(p.C, E::kBK);
  p.cpad = p.nc * E::kBK;
  p.npad = cdiv(p.N, kBN) * kBN;
  p.n_it = p.nc * p.taps;
  p.n_slabs = p.n_it / p.tps;
  p.slab_rows = kBM + 2 * p.halo;
  const int slab_row = E::kBK * (float_a ? 4 : E::kBytes);
  const int pitch = slab_row + (slab_row == 256 ? 32 : 16);
  // the deepest ring that fits. The copies of step it + nsb - 1 are issued
  // while step it is multiplied, into the stage step it - 1 used, so a
  // ring has two stages or more (one only when there is one step); a 3x3
  // keeps two slabs, and its slab i + 1 goes with the step issued as slab
  // i begins.
  const int min_nsb = p.n_it == 1 ? 1 : 2;
  const long long out_tile = static_cast<long long>(kBM) * kTilePitch * 4;
  // promote the steps' sums once more than kPromoteAfter multiplies would
  // go into one accumulator
  const bool promote = p.n_it * 4 * (E::kBf16 ? 1 : 3) >
                       (E::kBf16 ? kPromoteAfterBf16 : kPromoteAfter);
  // GEMM3's passes without promotion run two blocks an SM (each block's
  // share of the SM's 228 KB less 1 KB the system keeps a block)
  const bool two = epi != kStoreAcc && !promote;
  const long long budget =
      two ? (max_dynamic_smem() - 2048) / 2 : max_dynamic_smem();
  long long smem = 0;
  for (p.nsb = p.n_it < kMaxStages ? p.n_it : kMaxStages;; --p.nsb) {
    p.sa = p.tps == 1 ? p.nsb : (p.n_slabs < 2 ? p.n_slabs : 2);
    const long long ring =
        static_cast<long long>(p.nsb) * kBN * kChunkBytes * E::kPlanes +
        static_cast<long long>(p.sa) * p.slab_rows * pitch;
    smem = 1024 + (ring > out_tile ? ring : out_tile);
    if (smem <= budget) break;
    if (p.nsb == min_nsb) return cudaErrorInvalidConfiguration;
  }
  // steps issued ahead: every step when the ring holds them all (no stage
  // is refilled), else all but the stage being read
  p.lead = p.n_it <= p.nsb ? p.n_it : p.nsb - 1;
  const int bytes = static_cast<int>(smem);
  if (float_a) return run_main<E, true, true, kStoreAcc>(p, bytes, promote, s);
  // h2's rows are padded to 16 bytes; x's may take plain loads
  if (epi == kStatsOnly)
    return run_main<E, false, true, kStatsOnly>(p, bytes, promote, s);
  if (epi == kResidual)
    return run_main<E, false, true, kResidual>(p, bytes, promote, s);
  const bool vec = (static_cast<long long>(p.lda) * E::kBytes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.a) % 16 == 0;
  return vec ? run_main<E, false, true, kStoreAcc>(p, bytes, promote, s)
             : run_main<E, false, false, kStoreAcc>(p, bytes, promote, s);
}

template <class E>
int run(const void* x, const void* w1, const void* w3, const void* w2,
        const float* p1, const float* p2, const float* p3, void* y,
        float* base, int n, int h_img, int w_img, int cin, int cm, int tile,
        float eps, int variant, cudaStream_t s) {
  if (variant < kFull || variant > kNoRoll) return cudaErrorInvalidValue;
  const int hw = h_img * w_img;
  Workspace ws(base, n, hw, cin, cm, tile);
  const int groups = n / tile;
  const bool stats = variant != kNoBn;
  cudaError_t err;
  if ((err = pack<E>(w1, ws.wp1, 1, cin, cm, s)) != cudaSuccess ||
      (err = pack<E>(w3, ws.wp3, 9, cm, cm, s)) != cudaSuccess ||
      (err = pack<E>(w2, ws.wp2, 1, cm, cin, s)) != cudaSuccess)
    return err;

  Args common = {};
  common.M = n * hw;
  common.H = h_img;
  common.W = w_img;
  common.G = tile * hw;
  common.segs = segments(common.G);
  common.taps = 1;
  common.tps = 1;
  const int ldc = static_cast<int>(round_up(cm, 8));
  // (a, b) of one BN [groups, 2, c]: from the partials, or p itself (one
  // pair for every row) with no statistics
  auto coefs = [&](const float* p, float* coef, int c, const float** out,
                   int* stride) {
    if (!stats) {
      *out = p;
      *stride = 0;
      return cudaSuccess;
    }
    const dim3 grid(cdiv(c, kBN), groups);
    coef_kernel<<<grid, kBN, 0, s>>>(ws.partial, p, coef, c, common.G,
                                     common.segs, eps);
    *out = coef;
    *stride = 2 * c;
    return cudaGetLastError();
  };

  // GEMM1: acc1 = x @ w1
  Args a1 = common;
  a1.a = x;
  a1.lda = cin;
  a1.C = cin;
  a1.N = cm;
  a1.wp = ws.wp1;
  a1.out = ws.acc1;
  a1.ldo = ldc;
  a1.partial = stats ? ws.partial : nullptr;
  if ((err = gemm<E>(a1, false, kStoreAcc, s)) != cudaSuccess) return err;
  const float *c1, *c2, *c3;
  int s1, s2, s3;
  if ((err = coefs(p1, ws.coef1, cm, &c1, &s1)) != cudaSuccess) return err;

  // the 3x3: acc2 = taps(relu(acc1 * a1 + b1)) @ w3
  Args a2 = common;
  a2.a = ws.acc1;
  a2.lda = ldc;
  a2.C = cm;
  a2.N = cm;
  a2.coef = c1;
  a2.coef_stride = s1;
  a2.wp = ws.wp3;
  a2.out = ws.acc2;
  a2.ldo = ldc;
  a2.partial = stats ? ws.partial : nullptr;
  a2.taps = 9;
  a2.shift = variant != kNoRoll;
  a2.tps = variant == kStrided ? 3 : 9;
  a2.halo = variant == kNoRoll ? 0 : variant == kStrided ? 1 : w_img + 1;
  if ((err = gemm<E>(a2, true, kStoreAcc, s)) != cudaSuccess) return err;
  if ((err = coefs(p2, ws.coef2, cm, &c2, &s2)) != cudaSuccess) return err;

  // h2 = relu(acc2 * a2 + b2) in T, into acc1's space (acc1 is read)
  using T = typename E::T;
  T* h2 = reinterpret_cast<T*>(ws.acc1);
  {
    const long long chunks = static_cast<long long>(common.M) * (ldc / 8);
    const dim3 act_grid(static_cast<unsigned>(
        chunks / kThreads + 1 < 132 * 8 ? chunks / kThreads + 1 : 132 * 8));
    act_kernel<E><<<act_grid, kThreads, 0, s>>>(ws.acc2, c2, s2, h2,
                                                 common.M, cm, ldc, common.G);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // GEMM3: acc3 = h2 @ w2, twice: its statistics, then y = relu(acc3 *
  // a3 + b3 + x)
  Args a3 = common;
  a3.a = h2;
  a3.lda = ldc;
  a3.C = cm;
  a3.N = cin;
  a3.wp = ws.wp2;
  if (stats) {
    a3.partial = ws.partial;
    if ((err = gemm<E>(a3, false, kStatsOnly, s)) != cudaSuccess) return err;
    a3.partial = nullptr;
  }
  if ((err = coefs(p3, ws.coef3, cin, &c3, &s3)) != cudaSuccess) return err;
  a3.x = x;
  a3.y = y;
  a3.coef = c3;
  a3.coef_stride = s3;
  a3.vec_y = (static_cast<long long>(cin) * E::kBytes) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return gemm<E>(a3, false, kResidual, s);
}

}  // namespace

extern "C" {

const char* block_megakernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of the workspace one call needs (the wrapper allocates it).
long long block_megakernel_workspace(int n, int hw, int cin, int cm,
                                     int tile) {
  return Workspace(nullptr, n, hw, cin, cm, tile).floats;
}

// One block: x, y [n, h_img*w_img, cin]; w1 [cin, cm]; w3 [9, cm, cm]
// tap-major; w2 [cm, cin]; p1, p2 [2, cm] and p3 [2, cin] float32 (gamma,
// beta); workspace of block_megakernel_workspace floats, 256-byte
// aligned; n a multiple of tile; variant 0 full, 1 strided, 2 nobn, 3
// noroll. _f32: x, the weights and y float32; _bf16: bfloat16. Returns a
// cudaError_t.
int block_megakernel_f32(const void* x, const void* w1, const void* w3,
                         const void* w2, const float* p1, const float* p2,
                         const float* p3, void* y, float* workspace, int n,
                         int h_img, int w_img, int cin, int cm, int tile,
                         float eps, int variant, void* stream) {
  return run<F32>(x, w1, w3, w2, p1, p2, p3, y, workspace, n, h_img, w_img,
                  cin, cm, tile, eps, variant,
                  static_cast<cudaStream_t>(stream));
}

int block_megakernel_bf16(const void* x, const void* w1, const void* w3,
                          const void* w2, const float* p1, const float* p2,
                          const float* p3, void* y, float* workspace, int n,
                          int h_img, int w_img, int cin, int cm, int tile,
                          float eps, int variant, void* stream) {
  return run<BF16>(x, w1, w3, w2, p1, p2, p3, y, workspace, n, h_img, w_img,
                   cin, cm, tile, eps, variant,
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
