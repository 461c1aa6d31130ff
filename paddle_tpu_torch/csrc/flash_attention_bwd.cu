// Flash-attention backward for Hopper (sm_90a): two kernels, both with
// their products on the tensor cores, in float32 (3xTF32) and in bfloat16
// (one bf16 pass; those kernels and their entry points,
// flash_attention_bwd_{dq,dkv}_bf16, are at the end of this file).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// (_bwd): _dq_kernel, which gives dq = scale * sum_k ds * k and, in its
// bias_grad mode, the exact bias gradient ds, and _dkv_kernel, which gives
// dv = sum_q p^T * dO and dk = scale * sum_q ds^T * q. Both rebuild the
// probabilities from the forward's row log-sum-exp,
//   s  = scale * q.k + bias, NEG_INF where k >= Sk or (causal) q < k,
//   p  = exp(s - lse),  dp = dO.v,  ds = p * (dp - delta),
// with delta = rowsum(dO * O) computed by the caller (a torch reduction, as
// the reference computes it outside its kernels). The masks are applied in
// the reference's order with the reference's NEG_INF, so p matches it on
// masked and fully-masked rows.
//
// What bounds them on this card: 6*D operations per live (q, k) pair for
// dq, 8*D for dk/dv. Reading q, k, v, dO (and a bias) once and writing the
// gradients once is tens of MB at the training shapes, a few microseconds
// at 3.35 TB/s: both kernels are bound by operations, so neither writes the
// S x S probabilities to device memory. Both run their products on the
// tensor cores in 3xTF32 (494.7 / 3 TFLOP/s on an H100 SXM), as PyTorch's
// own attention backward does; the earlier kernels ran scalar loops on the
// FMA units (67 TFLOP/s), at 25-27% of that rate.
//
// What the two share, and what each part answers:
//  * 3xTF32 on wgmma. Each operand is split into hi = tf32(v) and lo =
//    tf32(v - hi); each k-step runs three m64nNk8 TF32 passes (lo*hi,
//    hi*lo, hi*hi): a one-pass TF32 product keeps 3 digits, this about
//    float32's.
//  * One warpgroup (128 threads) a block owns 64 rows of the gradient's
//    side (queries for dq, keys for dk/dv); a loop over 32-row tiles of the
//    other side is the TPU's sequential grid axis. Under causal, tiles that
//    lie wholly on the masked side of the diagonal are skipped (their p is
//    exactly 0 in the reference too; dq leaves their ds zero).
//  * Two blocks an SM. A block has one warpgroup, whose waits on its
//    copies, on the tensor cores and on the elementwise work between the
//    products leave the SM idle unless a second block fills the gaps; so a
//    block keeps under half an SM's shared memory and at most 255
//    registers (D <= 64). One tile buffer is refilled in two halves: the
//    operands of the first two products as soon as those have read them,
//    those of the last two as soon as they have, so each half's copy runs
//    beside the other half's products.
//  * B operands from 128-byte-swizzled shared tiles filled by cp.async: a
//    pack kernel ahead writes them as TF32 hi and lo planes, padded to
//    whole tiles (flash_tiles.cuh), so a copy is a straight 16-byte
//    cp.async a piece and no thread splits a B element in the loop.
//  * The accumulator as the next A operand. ds (dq), and p and ds (dk/dv),
//    are A fragments straight from the accumulator of the product before,
//    split in the thread: its columns 2t, 2t + 1 are the fragment's words
//    t, t + 4, so the pack permutes the reduction index of the next B
//    operand within each group of 8 (perm8): no shuffle.
//  * Promotion. The tensor cores' float32 sums truncate (past 1e-5 over a
//    2048-long reduction in one accumulator: the source test's model shows
//    it); each tile's gradient product goes into fresh registers, added
//    with a rounding add. A tile's product is 3 * 32 / 8 = 12 multiplies,
//    and S (dP) 3 * D / 8, all under kPromoteAfter.
//  * The bias is read through per-dimension strides (stride 0 on a
//    broadcast dim), so a [B,1,1,Sk] key-row mask or a [B,1,Sq,Sk] bias is
//    never expanded; in the accumulator layout the 4 lanes of a quad read
//    8 neighbouring keys of one query, whole 32-byte sectors of a dense
//    bias (and, for dq's bias_grad, whole sectors of ds written).
//  * Each CTA owns its output tile: no atomics, deterministic results.
//
// dq (flash_bwd_dq_tc_kernel): S = Q.K^T and dP = dO.V^T over d, then
// dq += dS.K over the tile's 32 keys. Q's A fragments are loaded and split
// once a block (D <= 64; at D = 128 they would not fit beside dq, so Q is
// split once into swizzled shared planes and read with wgmma_ss, as the
// forward does). dO's fragments beside Q's would take 64 more registers
// for the whole loop, so dO is kept as float32 in shared memory (rows
// padded by 4 floats, so a fragment load hits 32 banks) and each k-step's
// fragments are read and split in the thread, while S runs on the tensor
// cores. A pack ahead writes K and V as rows (the B of Q.K^T and dO.V^T)
// and K as cols with its keys permuted (the B of dS.K). At D = 128 dq is
// multiplied 64 columns at a time and dP waits every 4 k-steps. Each of
// dq's products issues the lo passes of all its k-steps before the hi*hi
// passes: every add into a tensor-core accumulator truncates to the ulp of
// the running sum, so the small lo terms are summed while it is small
// (the source test's interleaved mutant errs over 1.5x more; chip_smoke's
// hold on the Q and K projections' gradients needs it); dk/dv and the
// forward issue theirs in the same order. bias_grad: ds of
// every computed tile
// goes from the accumulator into a zero-filled [B,H,Sq,Sk] buffer; the
// wrapper sums it over the bias's broadcast dims.
//
// dk/dv (flash_bwd_dkv_tc_kernel): per query tile S^T = K.Q^T and dP^T =
// V.dO^T, then dV += P^T.dO and dK += dS^T.Q. K and V stay as float32 in
// shared memory, their A fragments read and split in the thread at each
// k-step (as hi/lo shared tiles read by wgmma they would take 64 KB at
// D = 64, as register fragments 128 registers beside four accumulators).
// The pack writes Q and dO as rows and cols. At D = 128 the registers hold
// dK and dV (128) beside a 64-column product at a time and 4 k-steps of K
// or V fragments.
//
// All PTX (cp.async, wgmma, cvt.rna.tf32) lives in sm90_mma.cuh. C
// interface (no PyTorch headers): the Python wrapper passes raw device
// pointers, a scratch buffer of flash_attention_bwd_{dq,dkv}_scratch_bytes()
// for the packed planes, and the current CUDA stream through ctypes, and
// checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "sm90_mma.cuh"

namespace {

using flash::kNegInf;

// -- dq on the tensor cores (3xTF32) ----------------------------------------

constexpr int kDqThreads = 128;  // one warpgroup
constexpr int kDqBQ = 64;        // query rows a block
constexpr int kDqBK = 32;        // keys a tile

template <int D>
struct DqCfg {
  static constexpr int kDc = flash::dpad(D) / 32;  // d chunks of rows tiles
  static constexpr bool kQReg = D <= 64;           // Q fragments in registers
  static constexpr int kPitch = D + 4;  // floats between dO rows: the 8 rows
                                        // x 4 lanes of a fragment load hit
                                        // 32 banks
  static constexpr int kQPlane = kQReg ? 0 : kDc * kDqBQ * 128;  // bytes
  static constexpr int kRPlane = kDc * kDqBK * 128;  // K or V rows tile
  static constexpr int kTPlane = D * 128;            // K^T tile (32 keys)
  // k-steps of dP issued before a wait, and output columns of a dq
  // product: what the registers hold beside dq at D = 128
  static constexpr int kGroup = D <= 64 ? D / 8 : 4;
  static constexpr int kDqN = D <= 64 ? D : 64;
  // alignment slack, Q planes (D = 128), the K, V and K^T tile, dO
  static constexpr int kSmem = 1024 + 2 * (kQPlane + 2 * kRPlane + kTPlane) +
                               kDqBQ * kPitch * 4;
  static_assert(3 * kDqBK / 8 <= flash::kPromoteAfter &&
                    3 * D / 8 <= flash::kPromoteAfter,
                "a product's multiplies exceed the promotion threshold");
};

struct DqArgs {
  const float* q;
  const float* dout;
  const float* bias;
  const float* lse;
  const float* delta;
  const uint32_t* kp;   // rows planes of K
  const uint32_t* vp;   // rows planes of V
  const uint32_t* ktp;  // cols planes of K
  float* dq;
  float* dbias;  // the full-shape ds, or null
  int H, Sq, Sk;
  long long rplane, tplane;  // elements of one plane
  long long bs_b, bs_h, bs_q, bs_k;
  int causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_tc_kernel(DqArgs a) {
  using C = DqCfg<D>;
  constexpr int kS = kDqBK / 2;  // S and dP accumulator registers
  constexpr int kO = D / 2;      // dq accumulator registers
  constexpr int kDSteps = D / 8, kKSteps = kDqBK / 8;

  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm90::dyn_smem()) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* qs = base;                   // Q planes (D = 128)
  unsigned char* ks = qs + 2 * C::kQPlane;    // K rows: hi, lo planes
  unsigned char* vs = ks + 2 * C::kRPlane;    // V rows: hi, lo planes
  unsigned char* ts = vs + 2 * C::kRPlane;    // K^T: hi, lo planes
  float* dof = reinterpret_cast<float*>(ts + 2 * C::kTPlane);  // [64][kPitch]
  // wgmma descriptors of the four tiles; a k-step's is one add on
  const uint64_t qd = sm90::b_desc(qs), kd = sm90::b_desc(ks),
                 vd = sm90::b_desc(vs), td = sm90::b_desc(ts);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kDqBQ;
  const int lr0 = warp * 16 + g;
  const int qr0 = q0 + lr0, qr1 = qr0 + 8;
  const float* qb = a.q + static_cast<size_t>(bh) * a.Sq * D;
  const float* dob = a.dout + static_cast<size_t>(bh) * a.Sq * D;
  const long long sp = flash::pad_rows(a.Sk);

  // Q: fragments of this thread's rows (a[0] = (g, t), a[1] = (g + 8, t),
  // a[2] = (g, t + 4), a[3] = (g + 8, t + 4) of each k-step of 8 d), or
  // the whole tile into swizzled shared planes; dO as float32 into shared
  // memory (rows past Sq are zeros)
  uint32_t qh[C::kQReg ? kDSteps : 1][4], ql[C::kQReg ? kDSteps : 1][4];
  if constexpr (C::kQReg) {
#pragma unroll
    for (int s = 0; s < kDSteps; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e & 1 ? qr1 : qr0, col = 8 * s + t + (e & 2 ? 4 : 0);
        const float v = row < a.Sq ? qb[static_cast<size_t>(row) * D + col]
                                   : 0.f;
        flash::split(v, qh[s][e], ql[s][e]);
      }
  }
  for (int i = tid; i < kDqBQ * D; i += kDqThreads) {
    const int r = i / D, e = i % D;
    const bool in = q0 + r < a.Sq;
    const size_t at = static_cast<size_t>(q0 + r) * D + e;
    if constexpr (!C::kQReg)
      flash::store_split(qs, kDqBQ, C::kQPlane, r, e, in ? qb[at] : 0.f);
    dof[r * C::kPitch + e] = in ? dob[at] : 0.f;
  }
  const float lse0 = qr0 < a.Sq ? a.lse[static_cast<size_t>(bh) * a.Sq + qr0]
                                : 0.f;
  const float lse1 = qr1 < a.Sq ? a.lse[static_cast<size_t>(bh) * a.Sq + qr1]
                                : 0.f;
  const float dl0 = qr0 < a.Sq ? a.delta[static_cast<size_t>(bh) * a.Sq + qr0]
                               : 0.f;
  const float dl1 = qr1 < a.Sq ? a.delta[static_cast<size_t>(bh) * a.Sq + qr1]
                               : 0.f;

  int n_tiles = flash::cdiv(a.Sk, kDqBK);
  if (a.causal) {
    // key tiles whose first key lies past this block's last query row
    const int last = (q0 + kDqBQ - 1) / kDqBK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  const long long rb = static_cast<long long>(bh) * C::kDc * sp * 32;
  const uint32_t* tb = a.ktp + static_cast<long long>(bh) * (sp / 32) * D * 32;
  // K and V rows (the B of Q.K^T and dO.V^T) and the K^T columns (the B of
  // dS.K) of key tile kt into their halves of the tile buffer
  auto issue_rows = [&](int kt) {
#pragma unroll
    for (int c = 0; c < C::kDc; ++c) {
      const long long at = rb + (c * sp + kt * kDqBK) * 32;
      flash::copy_tile(ks + c * kDqBK * 128, a.kp + at, kDqBK, a.rplane,
                       C::kRPlane, kDqThreads);
      flash::copy_tile(vs + c * kDqBK * 128, a.vp + at, kDqBK, a.rplane,
                       C::kRPlane, kDqThreads);
    }
  };
  auto issue_cols = [&](int kt) {
    flash::copy_tile(ts, tb + static_cast<long long>(kt) * D * 32, D,
                     a.tplane, C::kTPlane, kDqThreads);
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

  float dq[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) dq[i] = 0.f;

  // One buffer, refilled in two halves: K and V rows of tile kt + 1 are
  // copied while tile kt's elementwise step and dS.K run, K^T of tile
  // kt + 1 while tile kt + 1's Q.K^T and dO.V^T run. Each half's copies
  // are one commit group, so waiting until one group is in flight finds
  // the older half landed.
  issue_rows(0);
  sm90::cp_async_commit();
  issue_cols(0);
  sm90::cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    sm90::cp_async_wait(1);  // this thread's copies of the rows (tile kt)
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's (and dO, Q)
    const int k0 = kt * kDqBK;

    // S = Q.K^T, 3xTF32: the lo passes of every k-step first, then the
    // hi*hi passes, so that only those add into a sum of the result's size
    float s[kS], dp[kS];
    sm90::wgmma_fence();
    sm90::fence_acc(s);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass)
#pragma unroll
      for (int kq = 0; kq < kDSteps; ++kq) {
        const uint64_t kk =
            sm90::desc_add(kd, (kq / 4) * kDqBK * 128 + (kq % 4) * 32);
        const uint64_t kl = sm90::desc_add(kk, C::kRPlane);
        if constexpr (C::kQReg) {
          if (pass == 0) {
            sm90::wgmma<kDqBK, false>(s, ql[kq], kk, kq > 0);
            sm90::wgmma<kDqBK, false>(s, qh[kq], kl, 1);
          } else {
            sm90::wgmma<kDqBK, false>(s, qh[kq], kk, 1);
          }
        } else {
          const uint64_t qq =
              sm90::desc_add(qd, (kq / 4) * kDqBQ * 128 + (kq % 4) * 32);
          if (pass == 0) {
            sm90::wgmma_ss<kDqBK>(s, sm90::desc_add(qq, C::kQPlane), kk,
                                  kq > 0);
            sm90::wgmma_ss<kDqBK>(s, qq, kl, 1);
          } else {
            sm90::wgmma_ss<kDqBK>(s, qq, kk, 1);
          }
        }
      }
    sm90::wgmma_commit();
    // the tile's bias while the tensor cores run: s[4j + 2r + e] is row
    // (r ? qr1 : qr0), key k0 + 8j + 2t + e. A tile whose keys all lie
    // below Sk reads contiguous keys at fixed offsets and needs no key
    // mask; only such a tile that also lies below the causal diagonal
    // skips the masks altogether.
    const bool full = k0 + kDqBK <= a.Sk;
    const bool edge = !full || (a.causal && k0 + kDqBK - 1 > q0);
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
    // dP = dO.V^T, 3xTF32, dO's fragments (rows lr0 and lr0 + 8, columns
    // 8s + t and 8s + t + 4) read from shared memory and split while the
    // tensor cores run; kGroup k-steps in flight at a time
#pragma unroll
    for (int s0 = 0; s0 < kDSteps; s0 += C::kGroup) {
      uint32_t fh[C::kGroup][4], fl[C::kGroup][4];
#pragma unroll
      for (int i = 0; i < C::kGroup; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          flash::split(dof[(e & 1 ? lr0 + 8 : lr0) * C::kPitch +
                           8 * (s0 + i) + t + (e & 2 ? 4 : 0)],
                       fh[i][e], fl[i][e]);
      sm90::wgmma_fence();
      sm90::fence_acc(dp);
#pragma unroll
      for (int pass = 0; pass < 2; ++pass)  // lo passes first, as for S
#pragma unroll
        for (int i = 0; i < C::kGroup; ++i) {
          const int st = s0 + i;
          const uint64_t vv =
              sm90::desc_add(vd, (st / 4) * kDqBK * 128 + (st % 4) * 32);
          if (pass == 0) {
            sm90::wgmma<kDqBK, false>(dp, fl[i], vv, st > 0);
            sm90::wgmma<kDqBK, false>(dp, fh[i],
                                      sm90::desc_add(vv, C::kRPlane), 1);
          } else {
            sm90::wgmma<kDqBK, false>(dp, fh[i], vv, 1);
          }
        }
      sm90::wgmma_commit();
      if (s0 + C::kGroup < kDSteps) {  // D = 128: free the fragments
        sm90::wgmma_wait0();
        sm90::fence_acc(dp);
      }
    }
    sm90::wgmma_wait0();
    sm90::fence_acc(s);
    sm90::fence_acc(dp);
    __syncthreads();  // every thread's products have read the rows
    if (kt + 1 < n_tiles) issue_rows(kt + 1);
    sm90::cp_async_commit();

    // p = exp(s - lse), ds = p (dp - delta), with the masks in the
    // reference's order; bias_grad: ds into the full-shape buffer (a
    // quad's lanes write 8 neighbouring keys of one query)
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = i & 2 ? qr1 : qr0;
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      float x = s[i] * a.scale + bv[i];
      if (edge) {
        if (col >= a.Sk) x = kNegInf;
        if (a.causal && row < col) x = kNegInf;
      }
      const float p = row < a.Sq ? __expf(x - (i & 2 ? lse1 : lse0)) : 0.f;
      const float ds = p * (dp[i] - (i & 2 ? dl1 : dl0));
      s[i] = ds;
      if (a.dbias != nullptr && row < a.Sq && col < a.Sk)
        a.dbias[(static_cast<size_t>(bh) * a.Sq + row) * a.Sk + col] = ds;
    }

    // dq += dS.K, each tile's product into fresh registers added with a
    // rounding add. The A fragment of k-step j is the accumulator in place
    // (keys 8j + 2t, words t; 8j + 2t + 1, words t + 4), which the packed
    // K^T holds at those positions.
    uint32_t fh[kKSteps][4], fl[kKSteps][4];
#pragma unroll
    for (int j = 0; j < kKSteps; ++j) {
      flash::split(s[4 * j], fh[j][0], fl[j][0]);
      flash::split(s[4 * j + 2], fh[j][1], fl[j][1]);
      flash::split(s[4 * j + 1], fh[j][2], fl[j][2]);
      flash::split(s[4 * j + 3], fh[j][3], fl[j][3]);
    }
    sm90::cp_async_wait(1);  // this thread's copies of K^T (tile kt)
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += C::kDqN) {
      float pdq[C::kDqN / 2];
      sm90::wgmma_fence();
      sm90::fence_acc(pdq);
#pragma unroll
      for (int pass = 0; pass < 2; ++pass)  // lo passes first, as for S
#pragma unroll
        for (int j = 0; j < kKSteps; ++j) {
          const uint64_t bj = sm90::desc_add(td, n0 * 128 + j * 32);
          if (pass == 0) {
            sm90::wgmma<C::kDqN, false>(pdq, fl[j], bj, j > 0);
            sm90::wgmma<C::kDqN, false>(pdq, fh[j],
                                        sm90::desc_add(bj, C::kTPlane), 1);
          } else {
            sm90::wgmma<C::kDqN, false>(pdq, fh[j], bj, 1);
          }
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_acc(pdq);
#pragma unroll
      for (int i = 0; i < C::kDqN / 2; ++i) dq[n0 / 2 + i] += pdq[i];
    }
    __syncthreads();  // every thread's dS.K has read K^T: refill it
    if (kt + 1 < n_tiles) issue_cols(kt + 1);
    sm90::cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? qr1 : qr0;
    if (row >= a.Sq) continue;
    float* drow = a.dq + (static_cast<size_t>(bh) * a.Sq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(drow + 8 * j + 2 * t) = make_float2(
          a.scale * dq[4 * j + 2 * r], a.scale * dq[4 * j + 2 * r + 1]);
  }
}

template <int D>
cudaError_t launch_dq(DqArgs a, int B, cudaStream_t stream) {
  using C = DqCfg<D>;
  if (C::kSmem > flash::max_dynamic_smem())
    return cudaErrorInvalidConfiguration;
  static int allowed = 0;
  if (C::kSmem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err != cudaSuccess) return err;
    allowed = C::kSmem;
  }
  const dim3 grid(flash::cdiv(a.Sq, kDqBQ), B * a.H);
  flash_bwd_dq_tc_kernel<D><<<grid, kDqThreads, C::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// -- dk/dv on the tensor cores (3xTF32) -------------------------------------

constexpr int kDkvThreads = 128;  // one warpgroup
constexpr int kBK = 64;           // key rows a block
constexpr int kBQ = 32;           // queries a tile

template <int D>
struct DkvCfg {
  static constexpr int kDc = flash::dpad(D) / 32;  // d chunks of rows tiles
  static constexpr int kPitch = D + 4;  // floats between K (V) rows: the 8
                                        // rows x 4 lanes of a fragment load
                                        // hit 32 banks
  static constexpr int kKV = (2 * kBK * kPitch * 4 + 1023) / 1024 * 1024;
  static constexpr int kRPlane = kDc * kBQ * 128;  // Q or dO rows tile
  static constexpr int kTPlane = D * 128;          // Q^T or dO^T tile
  // k-steps of S^T (dP^T) issued before a wait, and output columns of a
  // dV (dK) product: what the registers hold beside dK and dV at D = 128
  static constexpr int kGroup = D <= 64 ? D / 8 : 4;
  static constexpr int kN = D <= 64 ? D : 64;
  static_assert(3 * kBQ / 8 <= flash::kPromoteAfter &&
                    3 * D / 8 <= flash::kPromoteAfter,
                "a product's multiplies exceed the promotion threshold");
};

struct DkvArgs {
  const float* k;
  const float* v;
  const float* bias;
  const float* lse;
  const float* delta;
  const uint32_t* qp;    // rows planes of Q
  const uint32_t* dop;   // rows planes of dO
  const uint32_t* qtp;   // cols planes of Q
  const uint32_t* dotp;  // cols planes of dO
  float* dk;
  float* dv;
  int H, Sq, Sk;
  long long rplane, tplane;  // elements of one plane
  long long bs_b, bs_h, bs_q, bs_k;
  int causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_tc_kernel(DkvArgs a) {
  using C = DkvCfg<D>;
  constexpr int kS = kBQ / 2;  // S^T and dP^T accumulator registers
  constexpr int kO = D / 2;    // dK and dV accumulator registers
  constexpr int kDSteps = D / 8, kQSteps = kBQ / 8;

  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm90::dyn_smem()) + 1023) &
      ~static_cast<uintptr_t>(1023));
  float* kf = reinterpret_cast<float*>(base);  // K, then V: [64][kPitch]
  float* vf = kf + kBK * C::kPitch;
  unsigned char* rt = base + C::kKV;         // rows tiles
  unsigned char* tt = rt + 4 * C::kRPlane;   // cols tiles
  // wgmma descriptors of the two; a k-step's is one add on
  const uint64_t rd = sm90::b_desc(rt), td = sm90::b_desc(tt);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBK;
  const int lr0 = warp * 16 + g;
  const int kr0 = k0 + lr0, kr1 = kr0 + 8;
  const long long sp = flash::pad_rows(a.Sq);

  // K and V, the A operands of K.Q^T and V.dO^T, into shared memory once
  // (rows past Sk are zeros); each k-step's fragments are read from there
  // and split in the thread
  const float* kb = a.k + static_cast<size_t>(bh) * a.Sk * D;
  const float* vb = a.v + static_cast<size_t>(bh) * a.Sk * D;
  for (int i = tid; i < kBK * D; i += kDkvThreads) {
    const int r = i / D, e = i % D;
    const bool in = k0 + r < a.Sk;
    const size_t at = static_cast<size_t>(k0 + r) * D + e;
    kf[r * C::kPitch + e] = in ? kb[at] : 0.f;
    vf[r * C::kPitch + e] = in ? vb[at] : 0.f;
  }

  const int n_tiles = flash::cdiv(a.Sq, kBQ);
  // under causal, query tiles that end before this block's first key see
  // none of its keys
  const int first = a.causal ? k0 / kBQ : 0;
  const long long rb = static_cast<long long>(bh) * C::kDc * sp * 32;
  const long long tb = static_cast<long long>(bh) * (sp / 32) * D * 32;
  // the query tile buffer: Q rows (hi, lo) and dO rows at rt (the B of
  // K.Q^T and V.dO^T), Q^T and dO^T at tt (the B of dS^T.Q and P^T.dO)
  auto issue_rows = [&](int qt) {
    const int q0 = qt * kBQ;
#pragma unroll
    for (int c = 0; c < C::kDc; ++c) {
      const long long at = rb + (c * sp + q0) * 32;
      flash::copy_tile(rt + c * kBQ * 128, a.qp + at, kBQ, a.rplane,
                       C::kRPlane, kDkvThreads);
      flash::copy_tile(rt + 2 * C::kRPlane + c * kBQ * 128, a.dop + at, kBQ,
                       a.rplane, C::kRPlane, kDkvThreads);
    }
  };
  auto issue_cols = [&](int qt) {
    const long long at = tb + static_cast<long long>(qt) * D * 32;
    flash::copy_tile(tt, a.qtp + at, D, a.tplane, C::kTPlane, kDkvThreads);
    flash::copy_tile(tt + 2 * C::kTPlane, a.dotp + at, D, a.tplane,
                     C::kTPlane, kDkvThreads);
  };
  // acc (+)= A.B^T over d, A = K or V from shared (its fragments: rows
  // lr0 and lr0 + 8, columns 8s + t and 8s + t + 4), B the rows tile at
  // bt; kGroup k-steps in flight at a time
  auto scores = [&](const float* af, uint64_t bt, float (&acc)[kS]) {
#pragma unroll
    for (int s0 = 0; s0 < kDSteps; s0 += C::kGroup) {
      uint32_t fh[C::kGroup][4], fl[C::kGroup][4];
#pragma unroll
      for (int i = 0; i < C::kGroup; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          flash::split(af[(e & 1 ? lr0 + 8 : lr0) * C::kPitch + 8 * (s0 + i) +
                          t + (e & 2 ? 4 : 0)],
                       fh[i][e], fl[i][e]);
      sm90::wgmma_fence();
      sm90::fence_acc(acc);
#pragma unroll
      for (int pass = 0; pass < 2; ++pass)  // lo passes first, as dq's
#pragma unroll
        for (int i = 0; i < C::kGroup; ++i) {
          const int s = s0 + i;
          const uint64_t bb =
              sm90::desc_add(bt, (s / 4) * kBQ * 128 + (s % 4) * 32);
          if (pass == 0) {
            sm90::wgmma<kBQ, false>(acc, fl[i], bb, s > 0);
            sm90::wgmma<kBQ, false>(acc, fh[i],
                                    sm90::desc_add(bb, C::kRPlane), 1);
          } else {
            sm90::wgmma<kBQ, false>(acc, fh[i], bb, 1);
          }
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_acc(acc);
    }
  };

  float dk[kO], dv[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) dk[i] = dv[i] = 0.f;

  // One buffer, refilled in two halves: the next tile's rows as soon as
  // S^T and dP^T have read this one's (while the elementwise step and the
  // dV, dK products run), its columns as soon as those products have
  // (while the next S^T and dP^T run). Each half's copies are one commit
  // group, so waiting until one group is in flight finds the older half
  // landed.
  if (first < n_tiles) issue_rows(first);
  sm90::cp_async_commit();
  if (first < n_tiles) issue_cols(first);
  sm90::cp_async_commit();
  for (int qt = first; qt < n_tiles; ++qt) {
    sm90::cp_async_wait(1);  // this thread's copies of the rows (tile qt)
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's (and K and V)
    const int q0 = qt * kBQ;

    // lse and delta of this thread's query columns (q0 + 8j + 2t + e,
    // index 2j + e) and the bias of its (key row, query column) pairs,
    // sT[4j + 2r + e] being key (r ? kr1 : kr0), query q0 + 8j + 2t + e:
    // in this layout the 8 lanes of a quad row read 8 neighbouring keys of
    // one query, whole 32-byte sectors of a dense bias
    float lq[kS / 2], dl[kS / 2], bv[kS];
#pragma unroll
    for (int i = 0; i < kS / 2; ++i) {
      const int col = q0 + 8 * (i / 2) + 2 * t + (i & 1);
      const size_t at = static_cast<size_t>(bh) * a.Sq + col;
      lq[i] = col < a.Sq ? a.lse[at] : 0.f;
      dl[i] = col < a.Sq ? a.delta[at] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = i & 2 ? kr1 : kr0;
      const int col = q0 + 8 * (i / 4) + 2 * t + (i & 1);
      bv[i] = a.bias != nullptr && col < a.Sq && row < a.Sk
                  ? a.bias[b * a.bs_b + h * a.bs_h + col * a.bs_q +
                           row * a.bs_k]
                  : 0.f;
    }
    // S^T = K.Q^T and dP^T = V.dO^T, 3xTF32
    float sT[kS], dpT[kS];
    scores(kf, rd, sT);
    scores(vf, sm90::desc_add(rd, 2 * C::kRPlane), dpT);
    __syncthreads();  // every thread's products have read the rows
    if (qt + 1 < n_tiles) issue_rows(qt + 1);
    sm90::cp_async_commit();

    // p = exp(s - lse), ds = p (dp - delta), with the masks in the
    // reference's order
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = i & 2 ? kr1 : kr0;
      const int col = q0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int c = 2 * (i / 4) + (i & 1);
      float x = sT[i] * a.scale + bv[i];
      if (row >= a.Sk) x = kNegInf;
      if (a.causal && col < row) x = kNegInf;
      const float p = col < a.Sq ? __expf(x - lq[c]) : 0.f;
      sT[i] = p;
      dpT[i] = p * (dpT[i] - dl[c]);
    }

    // dV += P^T.dO and dK += dS^T.Q, each tile's product into fresh
    // registers added with a rounding add. The A fragment of k-step j is
    // the accumulator in place (queries 8j + 2t, words t; 8j + 2t + 1,
    // words t + 4), which the packed dO^T and Q^T hold at those positions.
    auto product = [&](const float (&acc)[kS], uint64_t bt,
                       float (&sum)[kO]) {
      uint32_t fh[kQSteps][4], fl[kQSteps][4];
#pragma unroll
      for (int j = 0; j < kQSteps; ++j) {
        flash::split(acc[4 * j], fh[j][0], fl[j][0]);
        flash::split(acc[4 * j + 2], fh[j][1], fl[j][1]);
        flash::split(acc[4 * j + 1], fh[j][2], fl[j][2]);
        flash::split(acc[4 * j + 3], fh[j][3], fl[j][3]);
      }
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += C::kN) {
        const uint64_t bn = sm90::desc_add(bt, n0 * 128);
        float part[C::kN / 2];
        sm90::wgmma_fence();
        sm90::fence_acc(part);
#pragma unroll
        for (int pass = 0; pass < 2; ++pass)  // lo passes first
#pragma unroll
          for (int j = 0; j < kQSteps; ++j) {
            const uint64_t bj = sm90::desc_add(bn, j * 32);
            if (pass == 0) {
              sm90::wgmma<C::kN, false>(part, fl[j], bj, j > 0);
              sm90::wgmma<C::kN, false>(part, fh[j],
                                        sm90::desc_add(bj, C::kTPlane), 1);
            } else {
              sm90::wgmma<C::kN, false>(part, fh[j], bj, 1);
            }
          }
        sm90::wgmma_commit();
        sm90::wgmma_wait0();
        sm90::fence_acc(part);
#pragma unroll
        for (int i = 0; i < C::kN / 2; ++i) sum[n0 / 2 + i] += part[i];
      }
    };
    sm90::cp_async_wait(1);  // this thread's copies of the columns
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's
    product(sT, sm90::desc_add(td, 2 * C::kTPlane), dv);  // dO^T
    product(dpT, td, dk);                                   // Q^T
    __syncthreads();  // every thread's products have read the columns
    if (qt + 1 < n_tiles) issue_cols(qt + 1);
    sm90::cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? kr1 : kr0;
    if (row >= a.Sk) continue;
    const size_t at = (static_cast<size_t>(bh) * a.Sk + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<float2*>(a.dk + at + 8 * j + 2 * t) =
          make_float2(a.scale * dk[i], a.scale * dk[i + 1]);
      *reinterpret_cast<float2*>(a.dv + at + 8 * j + 2 * t) =
          make_float2(dv[i], dv[i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv(DkvArgs a, int B, cudaStream_t stream) {
  using C = DkvCfg<D>;
  // alignment slack, K and V, the query tile
  const int smem = 1024 + C::kKV + 4 * (C::kRPlane + C::kTPlane);
  if (smem > flash::max_dynamic_smem()) return cudaErrorInvalidConfiguration;
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(flash::cdiv(a.Sk, kBK), B * a.H);
  flash_bwd_dkv_tc_kernel<D><<<grid, kDkvThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// -- bfloat16 ----------------------------------------------------------------
// Both kernels with bf16 operands, as the Pallas kernels run on bf16
// inputs: one m64nNk16 bf16 pass a k-step (float32 accumulators), p and
// ds rebuilt and kept in float32 (dq's bias_grad ds is float32), rounded
// to bf16 (bf16x2_rn) only as the A fragments of dS.K, P^T.dO and
// dS^T.Q, and dq, dk, dv stored in bf16; the bias is read as float32.
// Tiles of 64 on both sides. The rows tiles (K and V for dq; Q and dO for
// dk/dv) are copied straight from the inputs (copy_rows_bf16), the cols
// tiles (K^T; Q^T and dO^T) from the planes one pack writes ahead; the
// accumulators are the next product's A fragments as they lie. Each
// tile's gradient product goes into fresh registers, added with a
// rounding add; at D = 128 it goes in two 64-column halves. Bound: 6*D
// (dq) and 8*D (dk/dv) operations a live pair at the dense bf16 rate (989
// TFLOP/s); a first, simple version (no TMA producer warp), as the
// float32 kernels. At D = 128 both spill a little (ptxas: 255 registers).

constexpr int kBT16 = 64;  // rows a bf16 block, and rows a tile

template <int D>
struct Cfg16 {
  static constexpr int kDc = flash::dchunks_bf16(D);  // d chunks of rows
  static constexpr int kRTile = kDc * kBT16 * 128;    // bytes
  static constexpr int kTTile = D * 128;
  static constexpr int kN = D <= 64 ? D : 64;  // columns of a product
  static constexpr int kPitch = D / 2 + 4;     // words between K (V) rows
                                               // in dk/dv's shared copy
};

struct DqArgs16 {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* dout;
  const float* bias;
  const float* lse;
  const float* delta;
  const uint16_t* ktp;  // cols plane of K
  uint16_t* dq;
  float* dbias;  // the full-shape ds, or null
  int H, Sq, Sk;
  long long bs_b, bs_h, bs_q, bs_k;
  int causal;
  float scale;
};

// the A fragments of k-step st (rows r0 and r0 + 8, columns 16st + 2t,
// + 1 and 16st + 8 + 2t, + 1) of rows of the bf16 [S][D] matrix m, rows
// past `rows` zeros
template <int D>
__device__ __forceinline__ void global_fragment_bf16(const uint16_t* m,
                                                     int rows, int r0,
                                                     int st, int t,
                                                     uint32_t (&a)[4]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(m);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = e & 1 ? r0 + 8 : r0;
    a[e] = row < rows ? w[static_cast<size_t>(row) * (D / 2) + 8 * st + t +
                          (e & 2 ? 4 : 0)]
                      : 0u;
  }
}

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_bf16_kernel(DqArgs16 a) {
  using C = Cfg16<D>;
  constexpr int kS = kBT16 / 2;  // S and dP accumulator registers
  constexpr int kO = D / 2;      // dq accumulator registers
  constexpr int kDSteps = D / 16, kKSteps = kBT16 / 16;

  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm90::dyn_smem()) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* ks = base;             // K rows
  unsigned char* vs = ks + C::kRTile;   // V rows
  unsigned char* ts = vs + C::kRTile;   // K^T
  const uint64_t kd = sm90::b_desc(ks), vd = sm90::b_desc(vs),
                 td = sm90::b_desc(ts);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBT16;
  const int lr0 = warp * 16 + g;
  const int qr0 = q0 + lr0, qr1 = qr0 + 8;
  const long long sp = flash::pad_rows(a.Sk);

  // Q's and dO's fragments, once a block
  uint32_t qf[kDSteps][4], df[kDSteps][4];
  {
    const uint16_t* qb = a.q + static_cast<size_t>(bh) * a.Sq * D;
    const uint16_t* dob = a.dout + static_cast<size_t>(bh) * a.Sq * D;
#pragma unroll
    for (int st = 0; st < kDSteps; ++st) {
      global_fragment_bf16<D>(qb, a.Sq, qr0, st, t, qf[st]);
      global_fragment_bf16<D>(dob, a.Sq, qr0, st, t, df[st]);
    }
  }
  const float lse0 = qr0 < a.Sq ? a.lse[static_cast<size_t>(bh) * a.Sq + qr0]
                                : 0.f;
  const float lse1 = qr1 < a.Sq ? a.lse[static_cast<size_t>(bh) * a.Sq + qr1]
                                : 0.f;
  const float dl0 = qr0 < a.Sq ? a.delta[static_cast<size_t>(bh) * a.Sq + qr0]
                               : 0.f;
  const float dl1 = qr1 < a.Sq ? a.delta[static_cast<size_t>(bh) * a.Sq + qr1]
                               : 0.f;

  int n_tiles = flash::cdiv(a.Sk, kBT16);
  if (a.causal) {
    const int last = (q0 + kBT16 - 1) / kBT16 + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  const uint16_t* kb = a.k + static_cast<size_t>(bh) * a.Sk * D;
  const uint16_t* vb = a.v + static_cast<size_t>(bh) * a.Sk * D;
  const uint16_t* tb = a.ktp + static_cast<long long>(bh) * (sp / 64) * D * 64;
  auto issue_rows = [&](int kt) {
    flash::copy_rows_bf16(ks, kb, kt * kBT16, kBT16, a.Sk, D, kDqThreads);
    flash::copy_rows_bf16(vs, vb, kt * kBT16, kBT16, a.Sk, D, kDqThreads);
  };
  auto issue_cols = [&](int kt) {
    flash::copy_plane_bf16(ts, tb + static_cast<long long>(kt) * D * 64, D,
                           kDqThreads);
  };

  const float* brow0 = nullptr;
  const float* brow1 = nullptr;
  if (a.bias != nullptr) {
    const float* bb = a.bias + b * a.bs_b + h * a.bs_h;
    brow0 = bb + (qr0 < a.Sq ? qr0 : a.Sq - 1) * a.bs_q;
    brow1 = bb + (qr1 < a.Sq ? qr1 : a.Sq - 1) * a.bs_q;
  }

  float dq[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) dq[i] = 0.f;

  issue_rows(0);
  sm90::cp_async_commit();
  issue_cols(0);
  sm90::cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    sm90::cp_async_wait(1);  // this thread's copies of the rows (tile kt)
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's
    const int k0 = kt * kBT16;

    // S = Q.K^T and dP = dO.V^T
    float s[kS], dp[kS];
    sm90::wgmma_fence();
    sm90::fence_acc(s);
    sm90::fence_acc(dp);
#pragma unroll
    for (int st = 0; st < kDSteps; ++st) {
      const int off = (st / 4) * kBT16 * 128 + (st % 4) * 32;
      sm90::wgmma<kBT16, true>(s, qf[st], sm90::desc_add(kd, off), st > 0);
      sm90::wgmma<kBT16, true>(dp, df[st], sm90::desc_add(vd, off), st > 0);
    }
    sm90::wgmma_commit();
    const bool edge = k0 + kBT16 > a.Sk || (a.causal && k0 + kBT16 - 1 > q0);
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
    sm90::fence_acc(dp);
    __syncthreads();  // every thread's products have read the rows
    if (kt + 1 < n_tiles) issue_rows(kt + 1);
    sm90::cp_async_commit();

    // p = exp(s - lse), ds = p (dp - delta) in float32, with the masks in
    // the reference's order; bias_grad: ds into the full-shape buffer
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = i & 2 ? qr1 : qr0;
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      float x = s[i] * a.scale + bv[i];
      if (edge) {
        if (col >= a.Sk) x = kNegInf;
        if (a.causal && row < col) x = kNegInf;
      }
      const float p = row < a.Sq ? __expf(x - (i & 2 ? lse1 : lse0)) : 0.f;
      const float ds = p * (dp[i] - (i & 2 ? dl1 : dl0));
      s[i] = ds;
      if (a.dbias != nullptr && row < a.Sq && col < a.Sk)
        a.dbias[(static_cast<size_t>(bh) * a.Sq + row) * a.Sk + col] = ds;
    }

    // dq += dS.K, dS rounded to bf16 as the A fragments
    uint32_t sf[kKSteps][4];
#pragma unroll
    for (int j = 0; j < kKSteps; ++j) flash::acc_fragment_bf16(s, j, sf[j]);
    sm90::cp_async_wait(1);  // this thread's copies of K^T (tile kt)
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += C::kN) {
      float tile_sum[C::kN / 2];
      sm90::wgmma_fence();
      sm90::fence_acc(tile_sum);
#pragma unroll
      for (int j = 0; j < kKSteps; ++j)
        sm90::wgmma<C::kN, true>(tile_sum, sf[j],
                                 sm90::desc_add(td, n0 * 128 + j * 32), j > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_acc(tile_sum);
#pragma unroll
      for (int i = 0; i < C::kN / 2; ++i) dq[n0 / 2 + i] += tile_sum[i];
    }
    __syncthreads();  // every thread's dS.K has read K^T: refill it
    if (kt + 1 < n_tiles) issue_cols(kt + 1);
    sm90::cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? qr1 : qr0;
    if (row >= a.Sq) continue;
    uint16_t* drow = a.dq + (static_cast<size_t>(bh) * a.Sq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(drow + 8 * j + 2 * t) = sm90::bf16x2_rn(
          a.scale * dq[4 * j + 2 * r], a.scale * dq[4 * j + 2 * r + 1]);
  }
}

template <int D>
cudaError_t launch_dq16(DqArgs16 a, int B, cudaStream_t stream) {
  using C = Cfg16<D>;
  const int smem = 1024 + 2 * C::kRTile + C::kTTile;
  if (smem > flash::max_dynamic_smem()) return cudaErrorInvalidConfiguration;
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(flash::cdiv(a.Sq, kBT16), B * a.H);
  flash_bwd_dq_bf16_kernel<D><<<grid, kDqThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

struct DkvArgs16 {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* dout;
  const float* bias;
  const float* lse;
  const float* delta;
  const uint16_t* qtp;   // cols plane of Q
  const uint16_t* dotp;  // cols plane of dO
  uint16_t* dk;
  uint16_t* dv;
  int H, Sq, Sk;
  long long bs_b, bs_h, bs_q, bs_k;
  int causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_bf16_kernel(DkvArgs16 a) {
  using C = Cfg16<D>;
  constexpr int kS = kBT16 / 2;  // S^T and dP^T accumulator registers
  constexpr int kO = D / 2;      // dK and dV accumulator registers
  constexpr int kDSteps = D / 16, kQSteps = kBT16 / 16;
  // K and V as bf16 in shared memory, C::kPitch words a row
  constexpr int kKV = (2 * kBT16 * C::kPitch * 4 + 1023) / 1024 * 1024;

  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm90::dyn_smem()) + 1023) &
      ~static_cast<uintptr_t>(1023));
  uint32_t* kw = reinterpret_cast<uint32_t*>(base);  // K, then V
  uint32_t* vw = kw + kBT16 * C::kPitch;
  unsigned char* qs = base + kKV;        // Q rows
  unsigned char* ds_ = qs + C::kRTile;   // dO rows
  unsigned char* qts = ds_ + C::kRTile;  // Q^T
  unsigned char* dts = qts + C::kTTile;  // dO^T
  const uint64_t qd = sm90::b_desc(qs), dd = sm90::b_desc(ds_),
                 qtd = sm90::b_desc(qts), dtd = sm90::b_desc(dts);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBT16;
  const int lr0 = warp * 16 + g;
  const int kr0 = k0 + lr0, kr1 = kr0 + 8;
  const long long sp = flash::pad_rows(a.Sq);

  {  // K and V rows into shared memory (rows past Sk are zeros)
    const uint32_t* kg = reinterpret_cast<const uint32_t*>(
        a.k + static_cast<size_t>(bh) * a.Sk * D);
    const uint32_t* vg = reinterpret_cast<const uint32_t*>(
        a.v + static_cast<size_t>(bh) * a.Sk * D);
    for (int i = tid; i < kBT16 * (D / 2); i += kDkvThreads) {
      const int r = i / (D / 2), w = i % (D / 2);
      const bool in = k0 + r < a.Sk;
      const size_t at = static_cast<size_t>(k0 + r) * (D / 2) + w;
      kw[r * C::kPitch + w] = in ? kg[at] : 0u;
      vw[r * C::kPitch + w] = in ? vg[at] : 0u;
    }
  }

  const int n_tiles = flash::cdiv(a.Sq, kBT16);
  const int first = a.causal ? k0 / kBT16 : 0;
  const uint16_t* qb = a.q + static_cast<size_t>(bh) * a.Sq * D;
  const uint16_t* dob = a.dout + static_cast<size_t>(bh) * a.Sq * D;
  const long long tb = static_cast<long long>(bh) * (sp / 64) * D * 64;
  auto issue_rows = [&](int qt) {
    flash::copy_rows_bf16(qs, qb, qt * kBT16, kBT16, a.Sq, D, kDkvThreads);
    flash::copy_rows_bf16(ds_, dob, qt * kBT16, kBT16, a.Sq, D, kDkvThreads);
  };
  auto issue_cols = [&](int qt) {
    const long long at = tb + static_cast<long long>(qt) * D * 64;
    flash::copy_plane_bf16(qts, a.qtp + at, D, kDkvThreads);
    flash::copy_plane_bf16(dts, a.dotp + at, D, kDkvThreads);
  };

  float dk[kO], dv[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) dk[i] = dv[i] = 0.f;

  if (first < n_tiles) issue_rows(first);
  sm90::cp_async_commit();
  if (first < n_tiles) issue_cols(first);
  sm90::cp_async_commit();
  for (int qt = first; qt < n_tiles; ++qt) {
    sm90::cp_async_wait(1);  // this thread's copies of the rows (tile qt)
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's (and K and V)
    const int q0 = qt * kBT16;

    // S^T = K.Q^T and dP^T = V.dO^T, K's and V's fragments read from
    // shared memory a k-step at a time
    float sT[kS], dpT[kS];
    sm90::wgmma_fence();
    sm90::fence_acc(sT);
    sm90::fence_acc(dpT);
#pragma unroll
    for (int st = 0; st < kDSteps; ++st) {
      uint32_t kf[4], vf[4];
      flash::row_fragment_bf16(kw, C::kPitch, lr0, st, t, kf);
      flash::row_fragment_bf16(vw, C::kPitch, lr0, st, t, vf);
      const int off = (st / 4) * kBT16 * 128 + (st % 4) * 32;
      sm90::wgmma<kBT16, true>(sT, kf, sm90::desc_add(qd, off), st > 0);
      sm90::wgmma<kBT16, true>(dpT, vf, sm90::desc_add(dd, off), st > 0);
    }
    sm90::wgmma_commit();
    // lse and delta of this thread's query columns, the bias of its (key
    // row, query column) pairs, while the tensor cores run
    float lq[kS / 2], dl[kS / 2], bv[kS];
#pragma unroll
    for (int i = 0; i < kS / 2; ++i) {
      const int col = q0 + 8 * (i / 2) + 2 * t + (i & 1);
      const size_t at = static_cast<size_t>(bh) * a.Sq + col;
      lq[i] = col < a.Sq ? a.lse[at] : 0.f;
      dl[i] = col < a.Sq ? a.delta[at] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = i & 2 ? kr1 : kr0;
      const int col = q0 + 8 * (i / 4) + 2 * t + (i & 1);
      bv[i] = a.bias != nullptr && col < a.Sq && row < a.Sk
                  ? a.bias[b * a.bs_b + h * a.bs_h + col * a.bs_q +
                           row * a.bs_k]
                  : 0.f;
    }
    sm90::wgmma_wait0();
    sm90::fence_acc(sT);
    sm90::fence_acc(dpT);
    __syncthreads();  // every thread's products have read the rows
    if (qt + 1 < n_tiles) issue_rows(qt + 1);
    sm90::cp_async_commit();

    // p = exp(s - lse), ds = p (dp - delta) in float32, with the masks in
    // the reference's order
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int row = i & 2 ? kr1 : kr0;
      const int col = q0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int c = 2 * (i / 4) + (i & 1);
      float x = sT[i] * a.scale + bv[i];
      if (row >= a.Sk) x = kNegInf;
      if (a.causal && col < row) x = kNegInf;
      const float p = col < a.Sq ? __expf(x - lq[c]) : 0.f;
      sT[i] = p;
      dpT[i] = p * (dpT[i] - dl[c]);
    }

    // dV += P^T.dO and dK += dS^T.Q, P and dS rounded to bf16 as the A
    // fragments
    auto product = [&](const float (&acc)[kS], uint64_t bt,
                       float (&sum)[kO]) {
      uint32_t af[kQSteps][4];
#pragma unroll
      for (int j = 0; j < kQSteps; ++j) flash::acc_fragment_bf16(acc, j, af[j]);
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += C::kN) {
        float tile_sum[C::kN / 2];
        sm90::wgmma_fence();
        sm90::fence_acc(tile_sum);
#pragma unroll
        for (int j = 0; j < kQSteps; ++j)
          sm90::wgmma<C::kN, true>(tile_sum, af[j],
                                   sm90::desc_add(bt, n0 * 128 + j * 32),
                                   j > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait0();
        sm90::fence_acc(tile_sum);
#pragma unroll
        for (int i = 0; i < C::kN / 2; ++i) sum[n0 / 2 + i] += tile_sum[i];
      }
    };
    sm90::cp_async_wait(1);  // this thread's copies of the columns
    sm90::fence_proxy_async();
    __syncthreads();         // and every thread's
    product(sT, dtd, dv);    // dO^T
    product(dpT, qtd, dk);   // Q^T
    __syncthreads();  // every thread's products have read the columns
    if (qt + 1 < n_tiles) issue_cols(qt + 1);
    sm90::cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? kr1 : kr0;
    if (row >= a.Sk) continue;
    const size_t at = (static_cast<size_t>(bh) * a.Sk + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<uint32_t*>(a.dk + at + 8 * j + 2 * t) =
          sm90::bf16x2_rn(a.scale * dk[i], a.scale * dk[i + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + at + 8 * j + 2 * t) =
          sm90::bf16x2_rn(dv[i], dv[i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv16(DkvArgs16 a, int B, cudaStream_t stream) {
  using C = Cfg16<D>;
  constexpr int kKV = (2 * kBT16 * C::kPitch * 4 + 1023) / 1024 * 1024;
  const int smem = 1024 + kKV + 2 * (C::kRTile + C::kTTile);
  if (smem > flash::max_dynamic_smem()) return cudaErrorInvalidConfiguration;
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(flash::cdiv(a.Sk, kBT16), B * a.H);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kDkvThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch flash_attention_bwd_dq_f32 needs: the rows planes of
// K and V and the cols planes of K (flash_tiles.cuh).
extern "C" long long flash_attention_bwd_dq_scratch_bytes(int B, int H,
                                                           int Sq, int Sk,
                                                           int D) {
  (void)Sq;
  return 4LL * 2 *
         (2 * flash::rows_plane(B * H, Sk, D) + flash::cols_plane(B * H, Sk, D));
}

// dq [B,H,Sq,D] and, when dbias is not null, the full-shape bias gradient
// ds into dbias [B,H,Sq,Sk] (which the caller zero-fills); scratch of
// flash_attention_bwd_dq_scratch_bytes().
extern "C" int flash_attention_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout, const float* lse, const float* delta, float* dq,
    float* dbias, void* scratch, int B, int H, int Sq, int Sk, int D,
    long long bias_stride_b, long long bias_stride_h,
    long long bias_stride_q, long long bias_stride_k, int causal,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 16 && D != 32 && D != 64 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  DqArgs a;
  a.q = q;
  a.dout = dout;
  a.bias = bias;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dbias = dbias;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.rplane = flash::rows_plane(B * H, Sk, D);
  a.tplane = flash::cols_plane(B * H, Sk, D);
  uint32_t* kp = static_cast<uint32_t*>(scratch);
  uint32_t* vp = kp + 2 * a.rplane;
  uint32_t* ktp = vp + 2 * a.rplane;
  a.kp = kp;
  a.vp = vp;
  a.ktp = ktp;
  a.bs_b = bias_stride_b;
  a.bs_h = bias_stride_h;
  a.bs_q = bias_stride_q;
  a.bs_k = bias_stride_k;
  a.causal = causal;
  a.scale = sm_scale;
  cudaError_t err = flash::pack_rows(k, kp, B * H, Sk, D, s);
  if (err == cudaSuccess) err = flash::pack_rows(v, vp, B * H, Sk, D, s);
  if (err == cudaSuccess) err = flash::pack_cols(k, ktp, B * H, Sk, D, s);
  if (err != cudaSuccess) return err;
  switch (D) {
    case 16: return launch_dq<16>(a, B, s);
    case 32: return launch_dq<32>(a, B, s);
    case 64: return launch_dq<64>(a, B, s);
    default: return launch_dq<128>(a, B, s);
  }
}

// Bytes of the scratch flash_attention_bwd_dkv_f32 needs: the rows and
// cols planes of Q and dO (flash_tiles.cuh).
extern "C" long long flash_attention_bwd_dkv_scratch_bytes(int B, int H,
                                                            int Sq, int Sk,
                                                            int D) {
  (void)Sk;
  return 4LL * 2 * 2 *
         (flash::rows_plane(B * H, Sq, D) + flash::cols_plane(B * H, Sq, D));
}

// dk, dv [B,H,Sk,D]; scratch of flash_attention_bwd_dkv_scratch_bytes().
extern "C" int flash_attention_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout, const float* lse, const float* delta, float* dk,
    float* dv, void* scratch, int B, int H, int Sq, int Sk, int D,
    long long bias_stride_b, long long bias_stride_h,
    long long bias_stride_q, long long bias_stride_k, int causal,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 16 && D != 32 && D != 64 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  DkvArgs a;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.rplane = flash::rows_plane(B * H, Sq, D);
  a.tplane = flash::cols_plane(B * H, Sq, D);
  uint32_t* qp = static_cast<uint32_t*>(scratch);
  uint32_t* dop = qp + 2 * a.rplane;
  uint32_t* qtp = dop + 2 * a.rplane;
  uint32_t* dotp = qtp + 2 * a.tplane;
  a.qp = qp;
  a.dop = dop;
  a.qtp = qtp;
  a.dotp = dotp;
  a.bs_b = bias_stride_b;
  a.bs_h = bias_stride_h;
  a.bs_q = bias_stride_q;
  a.bs_k = bias_stride_k;
  a.causal = causal;
  a.scale = sm_scale;
  cudaError_t err = flash::pack_rows(q, qp, B * H, Sq, D, s);
  if (err == cudaSuccess) err = flash::pack_rows(dout, dop, B * H, Sq, D, s);
  if (err == cudaSuccess) err = flash::pack_cols(q, qtp, B * H, Sq, D, s);
  if (err == cudaSuccess) err = flash::pack_cols(dout, dotp, B * H, Sq, D, s);
  if (err != cudaSuccess) return err;
  switch (D) {
    case 16: return launch_dkv<16>(a, B, s);
    case 32: return launch_dkv<32>(a, B, s);
    case 64: return launch_dkv<64>(a, B, s);
    default: return launch_dkv<128>(a, B, s);
  }
}

// Bytes of the scratch flash_attention_bwd_dq_bf16 needs: K's bf16 cols
// plane.
extern "C" long long flash_attention_bwd_dq_bf16_scratch_bytes(int B, int H,
                                                                int Sq, int Sk,
                                                                int D) {
  (void)Sq;
  return 2LL * flash::cols_plane(B * H, Sk, D);
}

// Bytes of the scratch flash_attention_bwd_dkv_bf16 needs: the bf16 cols
// planes of Q and dO.
extern "C" long long flash_attention_bwd_dkv_bf16_scratch_bytes(int B, int H,
                                                                 int Sq,
                                                                 int Sk,
                                                                 int D) {
  (void)Sk;
  return 2LL * 2 * flash::cols_plane(B * H, Sq, D);
}

namespace {

// the bf16 inputs the kernels copy with cp.async must be 16-byte aligned
bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// dq [B,H,Sq,D] (bf16) of bf16 q, k, v and dO and float32 lse, delta and
// bias; with dbias not null, the full-shape float32 ds into dbias
// [B,H,Sq,Sk] (which the caller zero-fills); scratch of
// flash_attention_bwd_dq_bf16_scratch_bytes().
extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout, const float* lse, const float* delta, void* dq,
    float* dbias, void* scratch, int B, int H, int Sq, int Sk, int D,
    long long bias_stride_b, long long bias_stride_h,
    long long bias_stride_q, long long bias_stride_k, int causal,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 16 && D != 32 && D != 64 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  DqArgs16 a;
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.dout = static_cast<const uint16_t*>(dout);
  a.bias = bias;
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<uint16_t*>(dq);
  a.dbias = dbias;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  uint16_t* ktp = static_cast<uint16_t*>(scratch);
  a.ktp = ktp;
  a.bs_b = bias_stride_b;
  a.bs_h = bias_stride_h;
  a.bs_q = bias_stride_q;
  a.bs_k = bias_stride_k;
  a.causal = causal;
  a.scale = sm_scale;
  const cudaError_t err =
      flash::pack_cols_bf16(a.k, ktp, B * H, Sk, D, s);
  if (err != cudaSuccess) return err;
  switch (D) {
    case 16: return launch_dq16<16>(a, B, s);
    case 32: return launch_dq16<32>(a, B, s);
    case 64: return launch_dq16<64>(a, B, s);
    default: return launch_dq16<128>(a, B, s);
  }
}

// dk, dv [B,H,Sk,D] (bf16); scratch of
// flash_attention_bwd_dkv_bf16_scratch_bytes().
extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, void* scratch, int B, int H, int Sq, int Sk, int D,
    long long bias_stride_b, long long bias_stride_h,
    long long bias_stride_q, long long bias_stride_k, int causal,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 16 && D != 32 && D != 64 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  DkvArgs16 a;
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.dout = static_cast<const uint16_t*>(dout);
  a.bias = bias;
  a.lse = lse;
  a.delta = delta;
  a.dk = static_cast<uint16_t*>(dk);
  a.dv = static_cast<uint16_t*>(dv);
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  const long long plane = flash::cols_plane(B * H, Sq, D);
  uint16_t* qtp = static_cast<uint16_t*>(scratch);
  uint16_t* dotp = qtp + plane;
  a.qtp = qtp;
  a.dotp = dotp;
  a.bs_b = bias_stride_b;
  a.bs_h = bias_stride_h;
  a.bs_q = bias_stride_q;
  a.bs_k = bias_stride_k;
  a.causal = causal;
  a.scale = sm_scale;
  cudaError_t err = flash::pack_cols_bf16(a.q, qtp, B * H, Sq, D, s);
  if (err == cudaSuccess)
    err = flash::pack_cols_bf16(a.dout, dotp, B * H, Sq, D, s);
  if (err != cudaSuccess) return err;
  switch (D) {
    case 16: return launch_dkv16<16>(a, B, s);
    case 32: return launch_dkv16<32>(a, B, s);
    case 64: return launch_dkv16<64>(a, B, s);
    default: return launch_dkv16<128>(a, B, s);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
