// Flash-attention forward for Hopper (sm_90a), float32 (the products on
// the tensor cores in 3xTF32) and bfloat16 (one bf16 pass; its kernel and
// entry point, flash_attention_fwd_bf16, are at the end of this file).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// (_fwd / _fwd_kernel): online-softmax attention that returns O [B,H,Sq,D]
// and the row log-sum-exp lse [B,H,Sq], with an additive bias broadcast
// over any of its four dims, keys at or past Sk masked, the causal mask
// qpos >= kpos, and an explicit softmax scale:
//   s = scale * q.k + bias, then NEG_INF where k >= Sk or (causal) q < k,
//   in the reference's order; O = softmax(s) v; lse = m + log(max(l,
//   1e-37)); a row whose l is 0 gives O = 0.
//
// What bounds it on this card: 4*D operations per live (q, k) pair. The
// inputs are float32; on the tensor cores a float32 product takes three
// TF32 passes (494.7 / 3 TFLOP/s on an H100 SXM), against 67 TFLOP/s on
// the FMA units, where the earlier kernel of this file ran its scalar
// loops (25-28% of that rate, and 1.5x slower than PyTorch's own
// attention, which runs 3xTF32 on the tensor cores). Reading q, k, v once
// and writing O once is a few MB at the serving shapes and tens of MB at
// the training shapes: the kernel is bound by operations, so it never
// writes the S x S scores to device memory.
//
// Design, and what each part answers:
//  * 3xTF32 on wgmma. Each operand is split into hi = tf32(v) and lo =
//    tf32(v - hi), and each k-step runs three m64nNk8 TF32 passes (lo*hi,
//    hi*lo, hi*hi) into the same float32 accumulators: a one-pass TF32
//    product keeps 3 digits, this about float32's. S = Q.K^T, then
//    O += P.V. Each product issues the lo passes of all its k-steps
//    before the hi*hi passes: every add into a tensor-core accumulator
//    truncates to the ulp of the running sum, so the small lo terms are
//    summed while it is small (as dq's, flash_attention_bwd.cu).
//  * One warpgroup (128 threads) a block owns 64 query rows, so the
//    serving shapes (B1 H8 S1024: 16 x 8 blocks) fill the card; a loop
//    over key tiles (the TPU's sequential grid axis) keeps the online
//    softmax's running max and sum in registers (rows g and g + 8 of each
//    warp's 16, reduced across the 4 lanes that share a row).
//  * A from registers. Q's fragments are loaded and split once a block
//    (D <= 64); P's are the S accumulator read in place, split in the
//    thread: no shuffle, because the pack permutes V's keys within each
//    group of 8 to match the accumulator's column order (flash_tiles.cuh,
//    perm8). At D = 128 Q's fragments would not fit beside O, so Q is
//    split once into swizzled shared tiles and read from there (wgmma_ss).
//  * B from 128-byte-swizzled shared tiles filled by cp.async. A pack
//    kernel ahead of the main kernel writes K (the B of Q.K^T, K-major as
//    it lies) and V^T (the B of P.V) as TF32 hi and lo planes, padded to
//    whole tiles (flash_tiles.cuh); a copy is then a straight 16-byte
//    cp.async per piece, and no thread splits a B element in the loop.
//    One tile buffer is refilled in two halves: the next tile's K as soon
//    as Q.K^T has read this one's (while the softmax and P.V run), its V
//    as soon as P.V has (while the next Q.K^T runs).
//  * Promotion. The tensor cores' float32 sums truncate; each key tile's
//    P.V goes into fresh registers and is added to O on the CUDA cores,
//    O = alpha * O + P.V_tile, as the online softmax rescales O anyway.
//    A tile's product is 3 * BK / 8 multiplies and Q.K^T 3 * D / 8, both
//    under kPromoteAfter.
//  * Key tiles wholly above the causal diagonal are never loaded. The
//    bias is read through per-dimension strides (stride 0 on a broadcast
//    dim), so a [B,1,1,Sk] key-row mask is never expanded; the bias loads
//    of a tile are issued while its Q.K^T runs on the tensor cores.
//  * Two blocks an SM. A block has one warpgroup, so the SM hides its
//    waits (on the copies, and on the tensor cores between the softmax
//    and the two products) only behind a second block: one tile buffer
//    (64 KB at D = 64) and at most 255 registers let two share an SM.
//    Key tiles of 64 keys, 32 at D = 128, where a 64-key tile would take
//    128 KB beside Q's 64 KB.
// All PTX (cp.async, wgmma, cvt.rna.tf32) lives in sm90_mma.cuh.
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers, a scratch buffer of flash_attention_fwd_scratch_bytes() for
// the packed planes, and the current CUDA stream through ctypes, and
// checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "sm90_mma.cuh"

namespace {

using flash::kNegInf;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBQ = 64;        // query rows a block

template <int D>
struct Cfg {
  static constexpr int kBK = D <= 64 ? 64 : 32;   // keys a tile
  static constexpr int kDc = flash::dpad(D) / 32;  // d chunks of K rows
  static constexpr int kKc = kBK / 32;             // key chunks of V^T
  static constexpr bool kQReg = D <= 64;           // Q fragments in registers
  static constexpr int kKPlane = kDc * kBK * 128;  // bytes, one plane
  static constexpr int kVPlane = kKc * D * 128;
  static constexpr int kQPlane = kQReg ? 0 : kDc * kBQ * 128;
  static_assert(3 * kBK / 8 <= flash::kPromoteAfter &&
                    3 * D / 8 <= flash::kPromoteAfter,
                "a product's multiplies exceed the promotion threshold");
};

struct Args {
  const float* q;
  const uint32_t* kp;  // rows planes of K
  const uint32_t* vp;  // cols planes of V
  const float* bias;
  float* o;
  float* lse;
  int H, Sq, Sk;
  long long kplane, vplane;  // elements of one plane
  long long bs_b, bs_h, bs_q, bs_k;
  int causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(Args a) {
  using C = Cfg<D>;
  constexpr int kBK = C::kBK;
  constexpr int kS = kBK / 2;   // S accumulator registers
  constexpr int kO = D / 2;     // O accumulator registers
  constexpr int kQSteps = D / 8, kPSteps = kBK / 8;

  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm90::dyn_smem()) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* qs = base;                   // Q planes (D = 128)
  unsigned char* ks = base + 2 * C::kQPlane;  // K tile: hi, lo planes
  unsigned char* vs = ks + 2 * C::kKPlane;    // V^T tile: hi, lo planes
  // wgmma descriptors of the three tiles; a k-step's is one add on
  const uint64_t qd = sm90::b_desc(qs), kd = sm90::b_desc(ks),
                 vd = sm90::b_desc(vs);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBQ;
  const int lr0 = warp * 16 + g;
  const int qr0 = q0 + lr0, qr1 = qr0 + 8;
  const float* qb = a.q + static_cast<size_t>(bh) * a.Sq * D;
  const long long sp = flash::pad_rows(a.Sk);

  // Q: fragments of this thread's rows (a[0] = (g, t), a[1] = (g + 8, t),
  // a[2] = (g, t + 4), a[3] = (g + 8, t + 4) of each k-step of 8 d), or
  // the whole tile into swizzled shared planes
  uint32_t qh[C::kQReg ? kQSteps : 1][4], ql[C::kQReg ? kQSteps : 1][4];
  if constexpr (C::kQReg) {
#pragma unroll
    for (int s = 0; s < kQSteps; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e & 1 ? qr1 : qr0, col = 8 * s + t + (e & 2 ? 4 : 0);
        const float v = row < a.Sq ? qb[static_cast<size_t>(row) * D + col]
                                   : 0.f;
        flash::split(v, qh[s][e], ql[s][e]);
      }
  } else {
    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D, e = i % D;
      const float v = q0 + r < a.Sq ? qb[static_cast<size_t>(q0 + r) * D + e]
                                    : 0.f;
      flash::store_split(qs, kBQ, C::kQPlane, r, e, v);
    }
  }

  int n_tiles = flash::cdiv(a.Sk, kBK);
  if (a.causal) {
    // key tiles whose first key lies past this block's last query row
    const int last = (q0 + kBQ - 1) / kBK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  const uint32_t* kb = a.kp + static_cast<long long>(bh) * C::kDc * sp * 32;
  const uint32_t* vb = a.vp + static_cast<long long>(bh) * (sp / 32) * D * 32;
  // K rows (the B of Q.K^T) and V^T columns (the B of P.V) of key tile
  // kt into their halves of the tile buffer
  auto issue_k = [&](int kt) {
#pragma unroll
    for (int c = 0; c < C::kDc; ++c)
      flash::copy_tile(ks + c * kBK * 128, kb + (c * sp + kt * kBK) * 32, kBK,
                       a.kplane, C::kKPlane, kThreads);
  };
  auto issue_v = [&](int kt) {
#pragma unroll
    for (int c = 0; c < C::kKc; ++c)
      flash::copy_tile(vs + c * D * 128,
                       vb + static_cast<long long>(kt * kBK / 32 + c) * D * 32,
                       D, a.vplane, C::kVPlane, kThreads);
  };

  // this thread's two bias rows (a row past Sq reads row Sq - 1: its
  // output is never stored, and rows do not mix)
  const float* brow0 = nullptr;
  const float* brow1 = nullptr;
  if (a.bias != nullptr) {
    const float* bb = a.bias + b * a.bs_b + h * a.bs_h;
    brow0 = bb + (qr0 < a.Sq ? qr0 : a.Sq - 1) * a.bs_q;
    brow1 = bb + (qr1 < a.Sq ? qr1 : a.Sq - 1) * a.bs_q;
  }

  float o[kO], m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;

  // One buffer, refilled in two halves: K of tile kt + 1 is copied while
  // tile kt's softmax and P.V run, V of tile kt + 1 while tile kt + 1's
  // Q.K^T runs. Each half's copies are one commit group, so waiting until
  // one group is in flight finds the older half landed.
  issue_k(0);
  sm90::cp_async_commit();
  issue_v(0);
  sm90::cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    sm90::cp_async_wait(1);  // this thread's copies of K (tile kt)
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's
    const int k0 = kt * kBK;

    // S = Q.K^T, 3xTF32: the lo passes of every k-step first, then the
    // hi*hi passes, so that only those add into a sum of the result's size
    float s[kS];
    sm90::wgmma_fence();
    sm90::fence_acc(s);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass)
#pragma unroll
      for (int kq = 0; kq < kQSteps; ++kq) {
        const uint64_t kk =
            sm90::desc_add(kd, (kq / 4) * kBK * 128 + (kq % 4) * 32);
        const uint64_t kl = sm90::desc_add(kk, C::kKPlane);
        if constexpr (C::kQReg) {
          if (pass == 0) {
            sm90::wgmma<kBK, false>(s, ql[kq], kk, kq > 0);
            sm90::wgmma<kBK, false>(s, qh[kq], kl, 1);
          } else {
            sm90::wgmma<kBK, false>(s, qh[kq], kk, 1);
          }
        } else {
          const uint64_t qq =
              sm90::desc_add(qd, (kq / 4) * kBQ * 128 + (kq % 4) * 32);
          if (pass == 0) {
            sm90::wgmma_ss<kBK>(s, sm90::desc_add(qq, C::kQPlane), kk,
                                kq > 0);
            sm90::wgmma_ss<kBK>(s, qq, kl, 1);
          } else {
            sm90::wgmma_ss<kBK>(s, qq, kk, 1);
          }
        }
      }
    sm90::wgmma_commit();
    // the tile's bias while the tensor cores run: s[4j + 2r + e] is row
    // (r ? qr1 : qr0), key k0 + 8j + 2t + e. A tile whose keys all lie
    // below Sk reads contiguous keys at fixed offsets and needs no key
    // mask; only such a tile that also lies below the causal diagonal
    // skips the masks altogether.
    const bool full = k0 + kBK <= a.Sk;
    const bool edge = !full || (a.causal && k0 + kBK - 1 > q0);
    float bv[kS];
    if (brow0 != nullptr && full && a.bs_k == 1) {
#pragma unroll
      for (int i = 0; i < kS; ++i)
        bv[i] = (i & 2 ? brow1 : brow0)[k0 + 8 * (i / 4) + 2 * t + (i & 1)];
    } else {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        bv[i] = brow0 != nullptr && col < a.Sk
                    ? (i & 2 ? brow1 : brow0)[col * a.bs_k]
                    : 0.f;
      }
    }
    sm90::wgmma_wait0();
    sm90::fence_acc(s);
    __syncthreads();  // every thread's Q.K^T has read K: refill it
    if (kt + 1 < n_tiles) issue_k(kt + 1);
    sm90::cp_async_commit();

    // online softmax over the tile
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = i & 2 ? qr1 : qr0;
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      float x = s[i] * a.scale + bv[i];
      if (edge) {
        if (col >= a.Sk) x = kNegInf;
        if (a.causal && row < col) x = kNegInf;
      }
      s[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int mask = 1; mask < 4; mask <<= 1) {
      mx0 = fmaxf(mx0, sm90::shfl_xor(mx0, mask));
      mx1 = fmaxf(mx1, sm90::shfl_xor(mx1, mask));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const float p = __expf(s[i] - (i & 2 ? mn1 : mn0));
      s[i] = p;
      if (i & 2)
        ps1 += p;
      else
        ps0 += p;
    }
    // this thread's share of l; the 4 lanes of a row are summed at the end
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;

    // P.V into fresh registers: P's fragment of k-step j is its
    // accumulator in place, keys 8j + 2t (words t) and 8j + 2t + 1 (words
    // t + 4), which V^T's packed planes hold at those positions
    uint32_t ph[kPSteps][4], pl[kPSteps][4];
#pragma unroll
    for (int j = 0; j < kPSteps; ++j) {
      flash::split(s[4 * j], ph[j][0], pl[j][0]);
      flash::split(s[4 * j + 2], ph[j][1], pl[j][1]);
      flash::split(s[4 * j + 1], ph[j][2], pl[j][2]);
      flash::split(s[4 * j + 3], ph[j][3], pl[j][3]);
    }
    sm90::cp_async_wait(1);  // this thread's copies of V (tile kt)
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's
    float part[kO];
    sm90::wgmma_fence();
    sm90::fence_acc(part);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass)  // lo passes first, as for S
#pragma unroll
      for (int j = 0; j < kPSteps; ++j) {
        const uint64_t vv =
            sm90::desc_add(vd, (j / 4) * D * 128 + (j % 4) * 32);
        if (pass == 0) {
          sm90::wgmma<D, false>(part, pl[j], vv, j > 0);
          sm90::wgmma<D, false>(part, ph[j], sm90::desc_add(vv, C::kVPlane),
                                1);
        } else {
          sm90::wgmma<D, false>(part, ph[j], vv, 1);
        }
      }
    sm90::wgmma_commit();
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] *= i & 2 ? al1 : al0;
    sm90::wgmma_wait0();
    sm90::fence_acc(part);
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] += part[i];
    __syncthreads();  // every thread's P.V has read V: refill it
    if (kt + 1 < n_tiles) issue_v(kt + 1);
    sm90::cp_async_commit();
  }

#pragma unroll
  for (int mask = 1; mask < 4; mask <<= 1) {
    l0 += sm90::shfl_xor(l0, mask);
    l1 += sm90::shfl_xor(l1, mask);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? qr1 : qr0;
    if (row >= a.Sq) continue;
    const float l = r ? l1 : l0, m = r ? m1 : m0;
    const float denom = l == 0.f ? 1.f : l;  // fully-masked row -> 0
    float* orow = a.o + (static_cast<size_t>(bh) * a.Sq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
          make_float2(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    if (t == 0)
      a.lse[static_cast<size_t>(bh) * a.Sq + row] = m + logf(fmaxf(l, 1e-37f));
  }
}

template <int D>
cudaError_t launch(Args a, int B, cudaStream_t stream) {
  using C = Cfg<D>;
  // alignment slack, Q planes (D = 128), the K and V^T tile
  const int smem = 1024 + 2 * (C::kQPlane + C::kKPlane + C::kVPlane);
  if (smem > flash::max_dynamic_smem()) return cudaErrorInvalidConfiguration;
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(flash::cdiv(a.Sq, kBQ), B * a.H);
  flash_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// -- bfloat16 ----------------------------------------------------------------
// The same online softmax with bf16 operands, as the Pallas kernel runs it
// on bf16 inputs: one m64nNk16 bf16 pass a k-step (float32 accumulators),
// P = exp(s - m) rounded to bf16 (bf16x2_rn) before P.V, O stored in bf16;
// the softmax statistics, lse and O's accumulator stay float32, and the
// bias is read as float32. Q's fragments stay in registers (16 at D = 64,
// 32 at D = 128: no split planes), K's rows tile is copied straight from K
// (flash_tiles.cuh copy_rows_bf16) and V^T's from the cols plane one pack
// writes ahead; P's fragments are the S accumulator in place. One tile
// buffer refilled in two halves, as the float32 kernel's. Key tiles of 64;
// at D = 128 P.V goes in two 64-column halves, so that O, S and a product
// fit the registers together. Bound: 4*D operations a live (q, k) pair
// at the dense bf16 rate (989 TFLOP/s on an H100 SXM); its bytes are half
// the float32 kernel's, so it stays bound by operations. A first, simple
// version: no TMA producer warp and one warpgroup a block, as the float32
// kernel.

constexpr int kBK16 = 64;  // keys a bf16 tile

template <int D>
struct Cfg16 {
  static constexpr int kDc = flash::dchunks_bf16(D);  // d chunks of K rows
  static constexpr int kKTile = kDc * kBK16 * 128;    // bytes
  static constexpr int kVTile = D * 128;
  static constexpr int kPvN = D <= 64 ? D : 64;  // columns of a P.V product
};

struct Args16 {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* vp;  // cols plane of V
  const float* bias;
  uint16_t* o;
  float* lse;
  int H, Sq, Sk;
  long long bs_b, bs_h, bs_q, bs_k;
  int causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(Args16 a) {
  using C = Cfg16<D>;
  constexpr int kS = kBK16 / 2;  // S accumulator registers
  constexpr int kO = D / 2;      // O accumulator registers
  constexpr int kQSteps = D / 16, kPSteps = kBK16 / 16;

  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm90::dyn_smem()) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* ks = base;             // K rows tile
  unsigned char* vs = ks + C::kKTile;   // V^T tile
  const uint64_t kd = sm90::b_desc(ks), vd = sm90::b_desc(vs);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBQ;
  const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;
  const long long sp = flash::pad_rows(a.Sk);

  // Q's fragments: word t of k-step s is columns 16s + 2t, 16s + 2t + 1;
  // rows past Sq are zeros
  uint32_t qf[kQSteps][4];
  {
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(
        a.q + static_cast<size_t>(bh) * a.Sq * D);
#pragma unroll
    for (int st = 0; st < kQSteps; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e & 1 ? qr1 : qr0;
        qf[st][e] = row < a.Sq ? qw[static_cast<size_t>(row) * (D / 2) +
                                    8 * st + t + (e & 2 ? 4 : 0)]
                               : 0u;
      }
  }

  int n_tiles = flash::cdiv(a.Sk, kBK16);
  if (a.causal) {
    const int last = (q0 + kBQ - 1) / kBK16 + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  const uint16_t* kb = a.k + static_cast<size_t>(bh) * a.Sk * D;
  const uint16_t* vb = a.vp + static_cast<long long>(bh) * (sp / 64) * D * 64;
  auto issue_k = [&](int kt) {
    flash::copy_rows_bf16(ks, kb, kt * kBK16, kBK16, a.Sk, D, kThreads);
  };
  auto issue_v = [&](int kt) {
    flash::copy_plane_bf16(vs, vb + static_cast<long long>(kt) * D * 64, D,
                           kThreads);
  };

  const float* brow0 = nullptr;
  const float* brow1 = nullptr;
  if (a.bias != nullptr) {
    const float* bb = a.bias + b * a.bs_b + h * a.bs_h;
    brow0 = bb + (qr0 < a.Sq ? qr0 : a.Sq - 1) * a.bs_q;
    brow1 = bb + (qr1 < a.Sq ? qr1 : a.Sq - 1) * a.bs_q;
  }

  float o[kO], m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;

  issue_k(0);
  sm90::cp_async_commit();
  issue_v(0);
  sm90::cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    sm90::cp_async_wait(1);  // this thread's copies of K (tile kt)
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's
    const int k0 = kt * kBK16;

    // S = Q.K^T, one bf16 pass a k-step of 16 d
    float s[kS];
    sm90::wgmma_fence();
    sm90::fence_acc(s);
#pragma unroll
    for (int kq = 0; kq < kQSteps; ++kq)
      sm90::wgmma<kBK16, true>(
          s, qf[kq], sm90::desc_add(kd, (kq / 4) * kBK16 * 128 + (kq % 4) * 32),
          kq > 0);
    sm90::wgmma_commit();
    // the tile's bias while the tensor cores run (as the float32 kernel)
    const bool full = k0 + kBK16 <= a.Sk;
    const bool edge = !full || (a.causal && k0 + kBK16 - 1 > q0);
    float bv[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      bv[i] = brow0 != nullptr && col < a.Sk
                  ? (i & 2 ? brow1 : brow0)[col * a.bs_k]
                  : 0.f;
    }
    sm90::wgmma_wait0();
    sm90::fence_acc(s);
    __syncthreads();  // every thread's Q.K^T has read K: refill it
    if (kt + 1 < n_tiles) issue_k(kt + 1);
    sm90::cp_async_commit();

    // online softmax over the tile, in float32
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = i & 2 ? qr1 : qr0;
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      float x = s[i] * a.scale + bv[i];
      if (edge) {
        if (col >= a.Sk) x = kNegInf;
        if (a.causal && row < col) x = kNegInf;
      }
      s[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int mask = 1; mask < 4; mask <<= 1) {
      mx0 = fmaxf(mx0, sm90::shfl_xor(mx0, mask));
      mx1 = fmaxf(mx1, sm90::shfl_xor(mx1, mask));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const float p = __expf(s[i] - (i & 2 ? mn1 : mn0));
      s[i] = p;
      if (i & 2)
        ps1 += p;
      else
        ps0 += p;
    }
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;

    // P rounded to bf16, in place as the A fragments of P.V
    uint32_t pf[kPSteps][4];
#pragma unroll
    for (int j = 0; j < kPSteps; ++j) flash::acc_fragment_bf16(s, j, pf[j]);
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] *= i & 2 ? al1 : al0;
    sm90::cp_async_wait(1);  // this thread's copies of V (tile kt)
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's
    // P.V into fresh registers, added to O with a rounding add
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += C::kPvN) {
      float tile_sum[C::kPvN / 2];
      sm90::wgmma_fence();
      sm90::fence_acc(tile_sum);
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)
        sm90::wgmma<C::kPvN, true>(
            tile_sum, pf[j], sm90::desc_add(vd, n0 * 128 + j * 32), j > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_acc(tile_sum);
#pragma unroll
      for (int i = 0; i < C::kPvN / 2; ++i) o[n0 / 2 + i] += tile_sum[i];
    }
    __syncthreads();  // every thread's P.V has read V: refill it
    if (kt + 1 < n_tiles) issue_v(kt + 1);
    sm90::cp_async_commit();
  }

#pragma unroll
  for (int mask = 1; mask < 4; mask <<= 1) {
    l0 += sm90::shfl_xor(l0, mask);
    l1 += sm90::shfl_xor(l1, mask);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? qr1 : qr0;
    if (row >= a.Sq) continue;
    const float l = r ? l1 : l0, m = r ? m1 : m0;
    const float denom = l == 0.f ? 1.f : l;  // fully-masked row -> 0
    uint16_t* orow = a.o + (static_cast<size_t>(bh) * a.Sq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) = sm90::bf16x2_rn(
          o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    if (t == 0)
      a.lse[static_cast<size_t>(bh) * a.Sq + row] = m + logf(fmaxf(l, 1e-37f));
  }
}

template <int D>
cudaError_t launch16(Args16 a, int B, cudaStream_t stream) {
  using C = Cfg16<D>;
  const int smem = 1024 + C::kKTile + C::kVTile;  // alignment slack, tiles
  if (smem > flash::max_dynamic_smem()) return cudaErrorInvalidConfiguration;
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(flash::cdiv(a.Sq, kBQ), B * a.H);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch flash_attention_fwd_f32 needs: K's rows planes and
// V's cols planes (flash_tiles.cuh).
extern "C" long long flash_attention_fwd_scratch_bytes(int B, int H, int Sq,
                                                        int Sk, int D) {
  (void)Sq;
  return 4LL * 2 * (flash::rows_plane(B * H, Sk, D) +
                    flash::cols_plane(B * H, Sk, D));
}

extern "C" int flash_attention_fwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    float* o, float* lse, void* scratch, int B, int H, int Sq, int Sk, int D,
    long long bias_stride_b, long long bias_stride_h,
    long long bias_stride_q, long long bias_stride_k, int causal,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 16 && D != 32 && D != 64 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.bias = bias;
  a.o = o;
  a.lse = lse;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.kplane = flash::rows_plane(B * H, Sk, D);
  a.vplane = flash::cols_plane(B * H, Sk, D);
  uint32_t* kp = static_cast<uint32_t*>(scratch);
  uint32_t* vp = kp + 2 * a.kplane;
  a.kp = kp;
  a.vp = vp;
  a.bs_b = bias_stride_b;
  a.bs_h = bias_stride_h;
  a.bs_q = bias_stride_q;
  a.bs_k = bias_stride_k;
  a.causal = causal;
  a.scale = sm_scale;
  cudaError_t err = flash::pack_rows(k, kp, B * H, Sk, D, s);
  if (err != cudaSuccess) return err;
  err = flash::pack_cols(v, vp, B * H, Sk, D, s);
  if (err != cudaSuccess) return err;
  switch (D) {
    case 16: return launch<16>(a, B, s);
    case 32: return launch<32>(a, B, s);
    case 64: return launch<64>(a, B, s);
    default: return launch<128>(a, B, s);
  }
}

// Bytes of the scratch flash_attention_fwd_bf16 needs: V's bf16 cols plane.
extern "C" long long flash_attention_fwd_bf16_scratch_bytes(int B, int H,
                                                             int Sq, int Sk,
                                                             int D) {
  (void)Sq;
  return 2LL * flash::cols_plane(B * H, Sk, D);
}

// O (bf16) and lse (float32) of bf16 q, k, v (16-byte aligned, as torch
// allocates them) and a float32 bias; scratch of
// flash_attention_fwd_bf16_scratch_bytes().
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const float* bias, void* o,
    float* lse, void* scratch, int B, int H, int Sq, int Sk, int D,
    long long bias_stride_b, long long bias_stride_h,
    long long bias_stride_q, long long bias_stride_k, int causal,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 16 && D != 32 && D != 64 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(q)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);  // cp.async takes 16 B
  Args16 a;
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.bias = bias;
  a.o = static_cast<uint16_t*>(o);
  a.lse = lse;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  uint16_t* vp = static_cast<uint16_t*>(scratch);
  a.vp = vp;
  a.bs_b = bias_stride_b;
  a.bs_h = bias_stride_h;
  a.bs_q = bias_stride_q;
  a.bs_k = bias_stride_k;
  a.causal = causal;
  a.scale = sm_scale;
  const cudaError_t err = flash::pack_cols_bf16(
      static_cast<const uint16_t*>(v), vp, B * H, Sk, D, s);
  if (err != cudaSuccess) return err;
  switch (D) {
    case 16: return launch16<16>(a, B, s);
    case 32: return launch16<32>(a, B, s);
    case 64: return launch16<64>(a, B, s);
    default: return launch16<128>(a, B, s);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
