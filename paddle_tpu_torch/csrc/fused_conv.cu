// Fused conv + BatchNorm prologue/epilogue for Hopper (sm_90a): a
// tensor-core implicit GEMM, in bfloat16 and in float32 (3xTF32).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/fused_conv.py:
//   fused_conv1x1_{f32,bf16}  <- conv1x1_bn_act / _conv1x1_kernel
//   fused_conv3x3_{f32,bf16}  <- conv3x3_bn_act / _conv3x3_kernel
// and computes what they compute, on NHWC-flat rows (M = N*H*W rows of
// C channels, row-major):
//   1x1: out [M,N] = act(x) [M,K] @ w [K,N]
//   3x3 (stride 1, pad 1): out [M,N] = im2col(act(x)) [M,9C] @ w [9C,N],
//        w tap-major (tap t = (dh+1)*3 + (dw+1) holds rows t*C..t*C+C-1);
//        output row r = (n, h, w) reads tap t from row r + dh*W + dw when
//        0 <= h+dh < H and 0 <= w+dw < W, and 0 otherwise.
//   act(x) = x*a + b per input channel when a, b are given (the producer
//   BatchNorm's affine, a and b float32), then max(., 0) when relu is set,
//   and in bfloat16 the result rounded to bfloat16, as the reference
//   rounds it before its MXU product; with relu and no affine, max(x, 0).
//   In the 3x3 conv the prologue is applied BEFORE the edge mask: an
//   out-of-image tap is 0, not act(0) = relu(b), as zero padding of the
//   activated map requires.
//   The products accumulate in float32; out is stored in x's type.
//   stats [2,N] (optional) = per output channel sum and sum of squares of
//   the float32 accumulator over all M rows (the consumer BatchNorm's
//   statistics); rows past M add nothing.
// Every M, C and N is taken: rows and columns past the edge are masked.
//
// What bounds it on this card (ResNet-50 bottleneck chain, batch 128): the
// work is 2*M*K'*N operations (K' = K, or 9C) against (M*C + M*N)*size +
// K'*N*size + 2N*4 bytes at 3.35 TB/s. On the tensor cores (989 TFLOP/s
// bf16; 494.7 TF32, three passes for float32) every 1x1 is bound by bytes
// in both types, and so is the bf16 3x3 (about balanced at stage 1); the
// float32 3x3 is bound by its three TF32 passes. On the FMA units (67
// TFLOP/s), where the earlier kernel of this file ran, the 3x3s and the
// wide 1x1s were bound by operations.
//
// Design, and what each part answers (the earlier kernel, a register-tiled
// SIMT GEMM on the FMA units, staged the A operand element by element and
// reached 26-35% of the FMA rate):
//  * Tensor cores. One block of two warpgroups owns a 128-row x BN-column
//    output tile (BN = 128 for N >= 128, else 64, so N = 64 wastes no half
//    tile); each warpgroup runs wgmma.mma_async on its 64 rows, the
//    accumulators in registers. bf16: one m64nBNk16 pass. float32: each
//    operand is split into hi = tf32(v) and lo = tf32(v - hi), and three
//    m64nBNk8 TF32 passes (lo*hi, hi*lo, hi*hi) accumulate into the same
//    float32 registers (the 3xTF32 recipe): a one-pass TF32 product keeps
//    3 digits, this about float32's. The tensor cores' float32 sums are
//    truncated, not rounded, and that error grows with the number of
//    steps added (past 1e-5 of max|out| at K' 1152 when all of K' goes
//    into one accumulator: tests/test_torch_fused_conv_cuda_source.py
//    simulates it); so past kPromoteAfter
//    multiplies (a template choice: the extra registers cost occupancy)
//    each reduction step's products (one tap of a 128-byte channel
//    chunk: 4 k-steps, 12 TF32 passes) go into fresh registers, added
//    into the block's float32 accumulators with a rounding add.
//  * Staging. A ring of up to 4 stages in dynamic shared memory, filled by
//    16-byte cp.async with zero-fill (the edges of M and C read zeros) and
//    completed by cp.async.wait_group and a block barrier: the copies of
//    the next 3 reduction steps are in flight while one is multiplied.
//    Every thread issues copies (no producer warp): right after it issues
//    a step's multiplies, so the address work runs beside the tensor
//    cores; each thread's copy addresses are fixed once per tile, and
//    stage and step indices are counters, not divisions. A reduction step
//    covers 128 bytes of channels (64 bf16, 32 float32), not 8 values.
//    x rows whose byte width is not a multiple of 16 (C odd in bf16, C %
//    4 in float32) take a template variant whose slab is staged by plain
//    loads and stores; the weights always go by cp.async.
//  * Weights. A first small kernel packs w [K', N] K-major, as wgmma's
//    TF32 B operand must be (and bf16 takes it too), padded to whole
//    channel chunks and column tiles, and for float32 split into hi and
//    lo planes: [planes][N'][taps][C'] in the caller's scratch. The main
//    kernel copies B tiles into the 128-byte swizzle, which wgmma reads
//    without bank conflicts.
//  * The 3x3 as nine shifted windows of one slab. For output rows [r0,
//    r0+128) tap (dh, dw) reads x rows [r0 + dh*W + dw, ... + 128): one
//    contiguous range. The block stages the halo slab (128 + 2W + 2 rows
//    of one 128-byte channel chunk) once a chunk, in a ring of two, and
//    the nine taps read it from shared memory at their offsets. The 1x1
//    is the same loop with one tap and no halo.
//  * Prologue once per staged element. When the chunk's first reduction
//    step comes, the block applies x*a + b and the ReLU to the slab in
//    place, 16 bytes a thread at a time (rounding pairs to bf16 with one
//    cvt.rn.bf16x2 in bf16), so the 9 taps of the 3x3 share one
//    application; the mask comes after, when a tap is read.
//  * A from registers. Each thread reads its A fragment words from the
//    activated slab at the tap's offset (the slab's rows are 144 bytes
//    apart, so the 8 rows x 4 words of a fragment load hit 32 banks), and
//    zeros the rows whose tap leaves the image, from 9 validity bits per
//    row computed once per tile: no division in the loop. In float32 the
//    thread splits each word into hi and lo as it loads it.
//  * Epilogue. out is stored from the accumulator fragments in x's type
//    with rows and columns past M and N masked; where out's rows are whole
//    16-byte chunks the tile goes through shared memory and out in full
//    lines. Statistics: each thread sums its two rows of each of its
//    columns, shuffles across the 8 lanes that share the columns, and the
//    8 warps' sums are added in order through shared memory: one partial
//    [2, BN] per row tile; a second launch reduces the partials over the
//    row tiles in tile order.
//    Deterministic, no atomics. With stats off neither is written nor
//    launched.
// Offsets of row x channel products are 64-bit. Shared memory limits the
// 3x3 image width: the smallest ring (two B stages, two slabs) of 128 +
// 2W + 2 rows must fit 227 KB (float32, N >= 128: W up to about 220); a
// wider image returns cudaErrorInvalidConfiguration.
//
// All PTX (cp.async, wgmma, cvt.rna.tf32, cvt.rn.bf16x2) lives in
// sm90_mma.cuh; the block shape, the operand types, the tap bits and the
// weight pack are shared with block_megakernel.cu through
// implicit_gemm.cuh.
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the current CUDA stream through ctypes and checks the
// returned cudaError_t (cudaGetLastError after every launch).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "implicit_gemm.cuh"
#include "sm90_mma.cuh"

namespace {

constexpr int kSlabPitch = 144;    // bytes between slab rows (128 + 16)
// The tensor cores' float32 sums are truncated, not rounded: past this
// many k-step multiplies into one accumulator (3xTF32 counts 3 a k-step)
// each reduction step sums into fresh registers, added with a rounding
// add. The source test's simulation of the truncation holds 96 multiplies
// (the float32 1x1 at K 256) within half the float32 limit of 1e-5 of
// max|out| and puts 432 (K' 1152) past it.
constexpr int kPromoteAfter = 96;

struct Args {
  const void* x;      // [M, C] of T
  const void* wp;     // packed weights [planes][npad][taps * cpad] of T
  const float* a;     // [C] or null
  const float* b;
  void* out;          // [M, N] of T
  float* partial;     // [tiles, 2, N] or null
  int M, C, N, H, W, relu, taps;
  int cpad, npad, nc;  // channels padded to chunks, columns to tiles, chunks
  int n_it;            // reduction steps: chunks x taps
  int nsb, lead;       // B ring stages, steps issued ahead (nsb - 1)
  int sa;              // slab ring stages
  int halo, slab_rows;  // W + 1 (3x3) or 0; 128 + 2 * halo
  int vec_out;          // out rows are whole 16-byte chunks, 16-aligned
};

// out tile [128 x BN] of act(x) @ w, and its column partial sums.
template <class E, int BN, bool kVecX, bool kPromote>
__global__ void __launch_bounds__(kThreads, 1)
fused_conv_tc_kernel(Args p) {
  using T = typename E::T;
  constexpr int kBPlane = BN * kChunkBytes;       // one plane of a B stage
  constexpr int kBStage = kBPlane * E::kPlanes;
  constexpr int kE16 = 16 / E::kBytes;           // elements in 16 bytes
  constexpr int kAcc = BN / 2;

  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm90::dyn_smem()) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* bring = base;                     // nsb B stages
  unsigned char* sring = base + p.nsb * kBStage;   // sa slabs
  const int slab_bytes = p.slab_rows * kSlabPitch;

  const int tid = threadIdx.x;
  const int warp8 = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * kBM;
  // this thread's two rows of the tile (fragment rows g and g + 8 of its
  // warp's 16) and their tap validity
  const int lr0 = warp8 * 16 + g, lr1 = lr0 + 8;
  uint32_t valid0 = 1, valid1 = 1;
  if (p.taps == 9) {
    valid0 = tap_bits(row0 + lr0, p.H, p.W);
    valid1 = tap_bits(row0 + lr1, p.H, p.W);
  }
  const bool affine = p.a != nullptr;
  const bool prologue = affine || p.relu != 0;

  // This thread's copies, fixed for the whole loop: 16-byte chunk bc of B
  // tile rows bn0 + 32i and of slab rows bn0 + 32i.
  const int bc = tid % 8, bn0 = tid / 8;
  const int64_t krow_bytes =
      static_cast<int64_t>(p.taps) * p.cpad * E::kBytes;
  const int64_t plane_bytes = krow_bytes * p.npad;
  const unsigned char* bsrc = static_cast<const unsigned char*>(p.wp) +
                              (col0 + bn0) * krow_bytes + bc * 16;
  const int bdst = bn0 * kChunkBytes + ((bc ^ (bn0 & 7)) << 4);
  // B tile of step (chunk j, tap), swizzled, into dst
  auto load_b = [&](int j, int tap, unsigned char* dst) {
    const unsigned char* src =
        bsrc + (static_cast<int64_t>(tap) * p.cpad +
                static_cast<int64_t>(j) * E::kBK) * E::kBytes;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i)
#pragma unroll
      for (int pl = 0; pl < E::kPlanes; ++pl)
        sm90::cp_async16(dst + pl * kBPlane + bdst + i * 32 * kChunkBytes,
                         src + pl * plane_bytes + i * 32 * krow_bytes, 16);
  };
  // slab of chunk j into dst: x rows [row0 - halo, row0 + 128 + halo), 128
  // bytes of channels from j * kBK; zeros outside [0, M) x [0, C)
  const T* x = static_cast<const T*>(p.x);
  const int64_t g0 = static_cast<int64_t>(row0) - p.halo;
  auto load_slab = [&](int j, unsigned char* dst) {
    if (kVecX) {
      const int c = j * E::kBK + bc * kE16;
      const T* src = x + (g0 + bn0) * p.C + c;
      for (int r = bn0; r < p.slab_rows; r += kThreads / 8) {
        const int64_t gr = g0 + r;
        const bool in = c < p.C && gr >= 0 && gr < p.M;
        sm90::cp_async16(dst + r * kSlabPitch + bc * 16, in ? src : x,
                         in ? 16 : 0);
        src += static_cast<int64_t>(kThreads / 8) * p.C;
      }
    } else {
      constexpr int kRow = E::kBK;
      const int c0 = j * E::kBK;
      for (int q = tid; q < p.slab_rows * kRow; q += kThreads) {
        const int r = q / kRow, cc = q % kRow;
        const int64_t gr = g0 + r;
        const int c = c0 + cc;
        T v = 0;
        if (gr >= 0 && gr < p.M && c < p.C) v = x[gr * p.C + c];
        *reinterpret_cast<T*>(dst + r * kSlabPitch + cc * E::kBytes) = v;
      }
    }
  };
  // The copies run lead steps ahead of the multiplies. Step q = (chunk qj,
  // tap qt) fills B stage qs; the slab of chunk slab_j goes with step
  // slab_q: the 1x1's with every step; the 3x3's slab 0 with step 0 and
  // slab j + 1 with step lead + 9j, which is issued as chunk j's first tap
  // is multiplied, when chunk j - 1's slab stage is free.
  int q = 0, qj = 0, qt = 0, qs = 0;
  int slab_j = 0, slab_q = 0, slab_s = 0;
  auto issue_next = [&]() {
    if (q < p.n_it) {
      load_b(qj, qt, bring + qs * kBStage);
      if (q == slab_q && slab_j < p.nc) {
        load_slab(slab_j, sring + slab_s * slab_bytes);
        ++slab_j;
        slab_s = slab_s + 1 == p.sa ? 0 : slab_s + 1;
        slab_q = p.taps == 1 ? q + 1 : (slab_j == 1 ? p.lead : slab_q + p.taps);
      }
    }
    ++q;
    if (++qt == p.taps) {
      qt = 0;
      ++qj;
    }
    qs = qs + 1 == p.nsb ? 0 : qs + 1;
  };
  // act() of slab s (chunk j) in place, once per staged element, 16 bytes
  // at a time (the multiply and the add are not fused into one rounding,
  // as the reference rounds them)
  auto activate = [&](int j, unsigned char* s) {
    const int c = j * E::kBK + bc * kE16;
    float av[kE16], bv[kE16];
#pragma unroll
    for (int e = 0; e < kE16; ++e) {
      const bool in = affine && c + e < p.C;
      av[e] = in ? p.a[c + e] : 0.f;
      bv[e] = in ? p.b[c + e] : 0.f;
    }
    auto act = [&](float f, int e) {
      if (affine) f = __fadd_rn(__fmul_rn(f, av[e]), bv[e]);
      return p.relu ? fmaxf(f, 0.f) : f;
    };
    for (int r = bn0; r < p.slab_rows; r += kThreads / 8) {
      uint4* q = reinterpret_cast<uint4*>(s + r * kSlabPitch + bc * 16);
      const uint4 v = *q;
      uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (E::kBf16)
          u[k] = sm90::bf16x2_rn(act(word_f32(u[k] << 16), 2 * k),
                                 act(word_f32(u[k] & 0xffff0000u), 2 * k + 1));
        else
          u[k] = f32_word(act(word_f32(u[k]), k));
      }
      *q = make_uint4(u[0], u[1], u[2], u[3]);
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
  // the step multiplied: chunk j, tap, in B stage bs and slab stage ss
  int j = 0, tap = 0, bs = 0, ss = 0;
  for (int it = 0; it < p.n_it; ++it) {
    sm90::cp_async_wait(p.lead - 1);  // this thread's copies of step it
    __syncthreads();                  // and every thread's have landed
    unsigned char* slab = sring + ss * slab_bytes;
    if (tap == 0 && prologue) {
      activate(j, slab);
      __syncthreads();
    }
    const unsigned char* btile = bring + bs * kBStage;
    const int off = p.taps == 9 ? p.halo + (tap / 3 - 1) * p.W + tap % 3 - 1
                                : 0;
    const bool v0 = (valid0 >> tap) & 1u, v1 = (valid1 >> tap) & 1u;
    const uint32_t* w0 =
        reinterpret_cast<const uint32_t*>(slab + (lr0 + off) * kSlabPitch);
    const uint32_t* w1 =
        reinterpret_cast<const uint32_t*>(slab + (lr1 + off) * kSlabPitch);
    // k-steps of this chunk that reach a channel below C
    const int nks = min(4, cdiv(p.C - j * E::kBK, E::kK));

    // this step's products into d (overwriting it first unless keep)
    auto multiply = [&](float (&d)[kAcc], int keep) {
      if constexpr (E::kBf16) {
        uint32_t af[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int u = ks * 8 + t;
          af[ks][0] = v0 ? w0[u] : 0u;
          af[ks][1] = v1 ? w1[u] : 0u;
          af[ks][2] = v0 ? w0[u + 4] : 0u;
          af[ks][3] = v1 ? w1[u + 4] : 0u;
        }
        sm90::wgmma_fence();
        sm90::fence_acc(d);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < nks)
            sm90::wgmma<BN, true>(d, af[ks], btile + ks * 32, ks | keep);
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
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks < nks) {
            const unsigned char* bk = btile + ks * 32;
            sm90::wgmma<BN, false>(d, lo[ks], bk, ks | keep);
            sm90::wgmma<BN, false>(d, hi[ks], bk + kBPlane, 1);
            sm90::wgmma<BN, false>(d, hi[ks], bk, 1);
          }
        }
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
    if (++tap == p.taps) {
      tap = 0;
      ++j;
      ss = ss + 1 == p.sa ? 0 : ss + 1;
    }
  }

  const int m0 = row0 + lr0, m1 = row0 + lr1;
  if (p.partial != nullptr) {
    // column sums: this thread's two rows (rows past M add nothing), the
    // 8 lanes that share the columns, then the 8 warps in order
    float* red = reinterpret_cast<float*>(base);  // [8 warps][2][BN]
    const bool in0 = m0 < p.M, in1 = m1 < p.M;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d0 = in0 ? acc[4 * jn + e] : 0.f;
        const float d1 = in1 ? acc[4 * jn + 2 + e] : 0.f;
        float s1 = d0 + d1, s2 = d0 * d0 + d1 * d1;
#pragma unroll
        for (int mask = 4; mask < 32; mask <<= 1) {
          s1 += sm90::shfl_xor(s1, mask);
          s2 += sm90::shfl_xor(s2, mask);
        }
        if (g == 0) {
          red[(warp8 * 2 + 0) * BN + jn * 8 + 2 * t + e] = s1;
          red[(warp8 * 2 + 1) * BN + jn * 8 + 2 * t + e] = s2;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < 2 * BN; e += kThreads) {
      const int s = e / BN, c = e % BN;
      if (col0 + c >= p.N) continue;
      float sum = 0.f;
      for (int w8 = 0; w8 < kWarps; ++w8) sum += red[(w8 * 2 + s) * BN + c];
      p.partial[(static_cast<int64_t>(blockIdx.y) * 2 + s) * p.N + col0 + c] =
          sum;
    }
    __syncthreads();  // red is read before the tile below reuses it
  }

  // out in x's type. Rows of whole 16-byte chunks: the tile goes through
  // shared memory (padded rows: the fragment writes hit 32 banks) and out
  // as 16-byte stores that fill whole lines; otherwise each thread stores
  // its fragment pairs, masked at M and N.
  T* out = static_cast<T*>(p.out);
  if (p.vec_out) {
    constexpr int kPitch = out_pitch(BN, E::kBytes);
    constexpr int kChunks = BN * E::kBytes / 16;  // 16-byte chunks a row
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int c = (jn * 8 + 2 * t) * E::kBytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned char* o = base + (h ? lr1 : lr0) * kPitch + c;
        const float e0 = acc[4 * jn + 2 * h], e1 = acc[4 * jn + 2 * h + 1];
        if constexpr (E::kBf16)
          *reinterpret_cast<uint32_t*>(o) = sm90::bf16x2_rn(e0, e1);
        else
          *reinterpret_cast<float2*>(o) = make_float2(e0, e1);
      }
    }
    __syncthreads();
    for (int q = tid; q < kBM * kChunks; q += kThreads) {
      const int r = q / kChunks, ch = q % kChunks;
      const int m = row0 + r, n = col0 + ch * kE16;
      if (m < p.M && n < p.N)
        *reinterpret_cast<uint4*>(out + static_cast<int64_t>(m) * p.N + n) =
            *reinterpret_cast<const uint4*>(base + r * kPitch + ch * 16);
    }
    return;
  }
  const bool pairs = p.N % 2 == 0;
  auto store = [&](int m, int n, float e0, float e1) {
    if (m >= p.M || n >= p.N) return;
    T* o = out + static_cast<int64_t>(m) * p.N + n;
    if constexpr (E::kBf16) {
      const uint32_t h = sm90::bf16x2_rn(e0, e1);
      if (pairs) {
        *reinterpret_cast<uint32_t*>(o) = h;
        return;
      }
      o[0] = static_cast<uint16_t>(h);
      if (n + 1 < p.N) o[1] = static_cast<uint16_t>(h >> 16);
    } else {
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(e0, e1);
        return;
      }
      o[0] = e0;
      if (n + 1 < p.N) o[1] = e1;
    }
  };
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int n = col0 + jn * 8 + 2 * t;
    store(m0, n, acc[4 * jn], acc[4 * jn + 1]);
    store(m1, n, acc[4 * jn + 2], acc[4 * jn + 3]);
  }
}

// stats[e] (e < 2N, [2, N] flattened) = sum over the row tiles, in tile
// order within each of kStatGroups strided groups, then the groups in
// order; a block takes kStatCols columns.
constexpr int kStatCols = 8, kStatGroups = kThreads / kStatCols;

__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ partial,
                    float* __restrict__ stats, int tiles, int two_n) {
  __shared__ float red[kStatGroups][kStatCols];
  const int col = threadIdx.x % kStatCols, g = threadIdx.x / kStatCols;
  const int e = blockIdx.x * kStatCols + col;
  float sum = 0.f;
  if (e < two_n)
    for (int t = g; t < tiles; t += kStatGroups)
      sum += partial[static_cast<int64_t>(t) * two_n + e];
  red[g][col] = sum;
  __syncthreads();
  if (g == 0 && e < two_n) {
    float total = 0.f;
    for (int k = 0; k < kStatGroups; ++k) total += red[k][col];
    stats[e] = total;
  }
}

int bn_of(int n) { return n >= 128 ? 128 : 64; }

template <class E>
long long wpack_bytes(int taps, int c, int n) {
  const long long cpad = static_cast<long long>(cdiv(c, E::kBK)) * E::kBK;
  const long long npad = static_cast<long long>(cdiv(n, bn_of(n))) * bn_of(n);
  return E::kPlanes * npad * taps * cpad * E::kBytes;
}

template <class E, int BN, bool kVecX, bool kPromote>
cudaError_t run_main(const Args& p, int smem, cudaStream_t s) {
  static int allowed = 0;  // dynamic shared memory the kernel may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_conv_tc_kernel<E, BN, kVecX, kPromote>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(cdiv(p.N, BN), cdiv(p.M, kBM));
  fused_conv_tc_kernel<E, BN, kVecX, kPromote><<<grid, kThreads, smem, s>>>(
      p);
  return cudaGetLastError();
}

template <class E, int BN>
cudaError_t run_main(const Args& p, int smem, bool vec, bool promote,
                     cudaStream_t s) {
  if (vec)
    return promote ? run_main<E, BN, true, true>(p, smem, s)
                   : run_main<E, BN, true, false>(p, smem, s);
  return promote ? run_main<E, BN, false, true>(p, smem, s)
                 : run_main<E, BN, false, false>(p, smem, s);
}

template <class E>
int launch(const void* x, const void* w, const float* a, const float* b,
           void* out, float* partial, float* stats, void* wpack, int M,
           int C, int N, int H, int W, int taps, int relu, cudaStream_t s) {
  const int bn = bn_of(N);
  Args p;
  p.x = x;
  p.wp = wpack;
  p.a = a;
  p.b = b;
  p.out = out;
  p.partial = stats ? partial : nullptr;
  p.M = M;
  p.C = C;
  p.N = N;
  p.H = H;
  p.W = W;
  p.relu = relu;
  p.taps = taps;
  p.nc = cdiv(C, E::kBK);
  p.cpad = p.nc * E::kBK;
  p.npad = cdiv(N, bn) * bn;
  p.n_it = p.nc * taps;
  p.halo = taps == 9 ? W + 1 : 0;
  p.slab_rows = kBM + 2 * p.halo;

  // the deepest ring that fits. The copies of step it + nsb - 1 are issued
  // while step it is multiplied, into the stage step it - 1 used, so a
  // ring has two stages or more (one only when there is one step); the
  // 3x3 keeps two slabs, and its slab j + 1 goes with the step issued as
  // chunk j begins.
  const int min_nsb = p.n_it == 1 ? 1 : 2;
  p.vec_out = (static_cast<long long>(N) * E::kBytes) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // the staged output tile reuses the ring
  const long long out_tile =
      p.vec_out ? static_cast<long long>(kBM) * out_pitch(bn, E::kBytes) : 0;
  long long smem = 0;
  for (p.nsb = p.n_it < kMaxStages ? p.n_it : kMaxStages;; --p.nsb) {
    p.sa = taps == 1 ? p.nsb : (p.nc < 2 ? p.nc : 2);
    const long long ring =
        static_cast<long long>(p.nsb) * bn * kChunkBytes * E::kPlanes +
        static_cast<long long>(p.sa) * p.slab_rows * kSlabPitch;
    smem = 1024 + (ring > out_tile ? ring : out_tile);
    if (smem <= max_dynamic_smem()) break;
    if (p.nsb == min_nsb) return cudaErrorInvalidConfiguration;
  }
  p.lead = p.nsb > 1 ? p.nsb - 1 : 1;

  const dim3 pack_grid(taps * p.cpad / 32, p.npad / 32);
  pack_w_kernel<E><<<pack_grid, kThreads, 0, s>>>(
      static_cast<const typename E::T*>(w), static_cast<uint32_t*>(wpack),
      static_cast<uint16_t*>(wpack), taps, C, N, p.cpad, p.npad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool vec = (static_cast<long long>(C) * E::kBytes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // promote the steps' sums once more than kPromoteAfter multiplies would
  // go into one accumulator
  const bool promote = p.n_it * 4 * (E::kBf16 ? 1 : 3) > kPromoteAfter;
  const int bytes = static_cast<int>(smem);
  err = bn == 128 ? run_main<E, 128>(p, bytes, vec, promote, s)
                  : run_main<E, 64>(p, bytes, vec, promote, s);
  if (err != cudaSuccess || stats == nullptr) return err;
  const dim3 red_grid(cdiv(2LL * N, kStatCols));
  stats_reduce_kernel<<<red_grid, kThreads, 0, s>>>(partial, stats,
                                                    cdiv(M, kBM), 2 * N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Row tiles of the kernels (the wrapper sizes the partial-sum scratch,
// [tiles, 2, N], from it).
int fused_conv_row_tile() { return kBM; }

// Bytes of the packed-weight scratch a call needs: taps 1 or 9, c input
// channels, n output channels, bf16 1 for the bfloat16 entry points.
long long fused_conv_wpack_bytes(int taps, int c, int n, int bf16) {
  return bf16 ? wpack_bytes<BF16>(taps, c, n) : wpack_bytes<F32>(taps, c, n);
}

// 1x1 conv: x [M,K], w [K,N], a/b [K] float32 or NULL, out [M,N]; stats
// [2,N] and partial [ceil(M/128), 2, N] float32 scratch, or both NULL for
// no statistics; wpack scratch of fused_conv_wpack_bytes(1, K, N, .).
// _f32: x, w, out float32; _bf16: bfloat16. Returns a cudaError_t.
int fused_conv1x1_f32(const void* x, const void* w, const float* a,
                      const float* b, void* out, float* partial, float* stats,
                      void* wpack, int M, int K, int N, int relu,
                      void* stream) {
  return launch<F32>(x, w, a, b, out, partial, stats, wpack, M, K, N, 1, 1,
                     1, relu, static_cast<cudaStream_t>(stream));
}

int fused_conv1x1_bf16(const void* x, const void* w, const float* a,
                       const float* b, void* out, float* partial,
                       float* stats, void* wpack, int M, int K, int N,
                       int relu, void* stream) {
  return launch<BF16>(x, w, a, b, out, partial, stats, wpack, M, K, N, 1, 1,
                      1, relu, static_cast<cudaStream_t>(stream));
}

// 3x3 stride-1 pad-1 conv on NHWC-flat rows of img_h x img_w images:
// x [M,C], w [9C,N] tap-major, a/b [C] or NULL, wpack of
// fused_conv_wpack_bytes(9, C, N, .), the rest as the 1x1.
int fused_conv3x3_f32(const void* x, const void* w, const float* a,
                      const float* b, void* out, float* partial, float* stats,
                      void* wpack, int M, int C, int N, int img_h, int img_w,
                      int relu, void* stream) {
  return launch<F32>(x, w, a, b, out, partial, stats, wpack, M, C, N, img_h,
                     img_w, 9, relu, static_cast<cudaStream_t>(stream));
}

int fused_conv3x3_bf16(const void* x, const void* w, const float* a,
                       const float* b, void* out, float* partial,
                       float* stats, void* wpack, int M, int C, int N,
                       int img_h, int img_w, int relu, void* stream) {
  return launch<BF16>(x, w, a, b, out, partial, stats, wpack, M, C, N, img_h,
                      img_w, 9, relu, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
