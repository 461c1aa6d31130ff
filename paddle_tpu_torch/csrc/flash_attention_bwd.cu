// Flash-attention backward, float32, for Hopper (sm_90a): two kernels.
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
// S x S probabilities to device memory. dq still runs its products on the
// fp32 FMA units (67 TFLOP/s on an H100 SXM); dk/dv runs them on the tensor
// cores in 3xTF32 (494.7 / 3 TFLOP/s), as PyTorch's own attention backward
// does, where its earlier kernel ran scalar loops at ~25% of the FMA rate.
//
// dq (simple and correct first; the tensor cores are later work): one CTA
// of 256 threads per (batch*head, 64-row query tile); the query and dO
// tiles are staged once, transposed, in shared memory; a loop over 64-row
// key tiles (the TPU's sequential grid axis) stages K (transposed and
// row-major) and V (transposed). Each thread owns a 4x4 block of the
// 64x64 score and dp tiles and 4 rows x D/16 columns of the dq
// accumulator; ds goes through shared memory into the ds * K product.
// bias_grad: it writes ds for every tile it computes into a zero-filled
// [B,H,Sq,Sk] buffer; the wrapper sums it over the bias's broadcast dims.
// Shared memory 5*64*D + 64*64 floats (176 KB at D=128).
//
// dk/dv, and what each part of its design answers:
//  * 3xTF32 on wgmma. Each operand is split into hi = tf32(v) and lo =
//    tf32(v - hi); each k-step runs three m64nNk8 TF32 passes (lo*hi,
//    hi*lo, hi*hi). Per query tile: S^T = K.Q^T and dP^T = V.dO^T, then
//    dV += P^T.dO and dK += dS^T.Q.
//  * One warpgroup (128 threads) a block owns 64 key rows; a loop over
//    query tiles of 32 is the TPU's sequential grid axis.
//  * Two blocks an SM. A block has one warpgroup, whose waits on the
//    tensor cores and elementwise work between the four products leave
//    them idle unless a second block fills the gaps; so a block keeps
//    under half an SM's shared memory: K and V once as float32 (rows
//    padded by 4 floats, so a fragment load hits 32 banks), their A
//    fragments read and split in the thread at each k-step, and one
//    buffer of query tiles. As hi/lo shared tiles read by wgmma K and V
//    would take 64 KB at D = 64, and as register fragments 128 registers
//    beside four accumulators.
//  * P^T and dS^T are the A operands of the dV and dK products straight
//    from the S^T and dP^T accumulators, split in the thread: the pack
//    permutes the queries of dO^T and Q^T within each group of 8 to match
//    the accumulator's column order (flash_tiles.cuh, perm8).
//  * B operands from 128-byte-swizzled shared tiles filled by cp.async: a
//    pack kernel ahead writes Q and dO (rows: the B of K.Q^T and V.dO^T)
//    and Q^T and dO^T (cols: the B of dS^T.Q and P^T.dO) as TF32 hi and lo
//    planes, padded to whole tiles. The one buffer is refilled in two
//    halves: the next tile's rows as soon as S^T and dP^T have read this
//    one's, its columns as soon as dV and dK have, so each half's copy
//    runs beside the other half's products. lse, delta and the bias of a
//    tile are loaded ahead of its products: in this fragment layout the 8
//    lanes of a quad row read 8 neighbouring keys of one query, so a dense
//    [B,1,S,S] bias is read in whole 32-byte sectors (the earlier kernel
//    gathered it transposed).
//  * Promotion. The tensor cores' float32 sums truncate (past 1e-5 over a
//    2048-query reduction in one accumulator: the source test's model
//    shows it); each tile's dV and dK products go into fresh registers,
//    added with a rounding add. A tile's product is 3 * 32 / 8 = 12
//    multiplies, under kPromoteAfter.
//  * At D = 128 the registers hold dK and dV (128) beside a 64-column
//    product at a time and 4 k-steps of K or V fragments.
//  * Under causal, query tiles that end before the block's first key are
//    skipped (their p is exactly 0 in the reference too).
// Both kernels: each CTA owns its output tile (no atomics, deterministic
// results); the masks are applied in the reference's order; the bias is
// read through per-dimension strides (stride 0 on a broadcast dim), so a
// [B,1,1,Sk] key-row mask or a [B,1,Sq,Sk] bias is never expanded. All PTX
// of dk/dv (cp.async, wgmma, cvt.rna.tf32) lives in sm90_mma.cuh.
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers (and, for dk/dv, a scratch buffer of
// flash_attention_bwd_dkv_scratch_bytes() for the packed planes) and the
// current CUDA stream through ctypes and checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "sm90_mma.cuh"

namespace {

constexpr int kBlock = 64;     // query rows and key rows per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
using flash::kNegInf;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const float* dout;
  const float* lse;
  const float* delta;
  float* out1;  // dq | dk
  float* out2;  // dbias (or null) | dv
  int H, Sq, Sk;
  long long bs_b, bs_h, bs_q, bs_k;
  int causal;
  float scale;
};

// scale * dot + bias, then the k >= Sk and causal masks, in the
// reference's order
__device__ __forceinline__ float masked_score(const Args& a, float dot,
                                              int b, int h, int qr, int kc) {
  float x = dot * a.scale;
  if (a.bias != nullptr && qr < a.Sq && kc < a.Sk)
    x += a.bias[b * a.bs_b + h * a.bs_h + (long long)qr * a.bs_q +
                (long long)kc * a.bs_k];
  if (kc >= a.Sk) x = kNegInf;
  if (a.causal && qr < kc) x = kNegInf;
  return x;
}

// rows [r0, r0 + 64) of a [S, D] matrix into T (transposed, [D][64])
// and/or R (row-major, [64][D]); rows at or past S read as 0
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ src, int r0,
                                      int S, float* T, float* R) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float x = r0 + r < S ? src[(size_t)(r0 + r) * D + c] : 0.f;
    if (T != nullptr) T[c * kBlock + r] = x;
    if (R != nullptr) R[r * D + c] = x;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qt, dOt, Kt, Vt [D][64]; Ks [64][D]; dSt [64 k][64 q]
  return sizeof(float) * (size_t)(5 * D * kBlock + kBlock * kBlock);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(Args a) {
  constexpr int kCols = D / 16;  // dq columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* dOt = Qt + D * kBlock;
  float* Kt = dOt + D * kBlock;
  float* Vt = Kt + D * kBlock;
  float* Ks = Vt + D * kBlock;
  float* dSt = Ks + kBlock * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key columns tx*4.., dq columns tx*kCols..
  const int ty = tid / 16;  // query rows ty*4..ty*4+3
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBlock;
  const float* qb = a.q + (size_t)bh * a.Sq * D;
  const float* dob = a.dout + (size_t)bh * a.Sq * D;
  const float* kb = a.k + (size_t)bh * a.Sk * D;
  const float* vb = a.v + (size_t)bh * a.Sk * D;
  float* dbias = a.out2;

  stage<D>(qb, q0, a.Sq, Qt, nullptr);
  stage<D>(dob, q0, a.Sq, dOt, nullptr);
  float lse[4], delta[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    lse[i] = qr < a.Sq ? a.lse[(size_t)bh * a.Sq + qr] : 0.f;
    delta[i] = qr < a.Sq ? a.delta[(size_t)bh * a.Sq + qr] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (a.Sk + kBlock - 1) / kBlock;
  if (a.causal) {
    // key tiles whose first key lies past this CTA's last query row
    const int last = (q0 + kBlock - 1) / kBlock + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();  // the previous tile's Kt/Vt/Ks/dSt are consumed
    stage<D>(kb, k0, a.Sk, Kt, Ks);
    stage<D>(vb, k0, a.Sk, Vt, nullptr);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kBlock + ty * 4]);
      const float4 ov = *reinterpret_cast<const float4*>(&dOt[d * kBlock + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&Kt[d * kBlock + tx * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&Vt[d * kBlock + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx * 4 + j;
        const float x = masked_score(a, s[i][j], b, h, qr, kc);
        const float p = qr < a.Sq ? expf(x - lse[i]) : 0.f;
        const float ds = p * (dp[i][j] - delta[i]);
        s[i][j] = ds;
        if (dbias != nullptr && qr < a.Sq && kc < a.Sk)
          dbias[((size_t)bh * a.Sq + qr) * a.Sk + kc] = ds;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dSt[(tx * 4 + j) * kBlock + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      const float4 dv4 = *reinterpret_cast<const float4*>(&dSt[kk * kBlock + ty * 4]);
      const float da[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
      float ka[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) ka[c] = Ks[kk * D + tx * kCols + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(da[i], ka[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= a.Sq) continue;
    float* row = a.out1 + ((size_t)bh * a.Sq + qr) * D + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) row[c] = a.scale * acc[i][c];
  }
}

template <int D>
cudaError_t launch_dq(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBlock - 1) / kBlock, B * a.H);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, stream>>>(a);
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
      for (int i = 0; i < C::kGroup; ++i) {
        const int s = s0 + i;
        const uint64_t bb =
            sm90::desc_add(bt, (s / 4) * kBQ * 128 + (s % 4) * 32);
        sm90::wgmma<kBQ, false>(acc, fl[i], bb, s > 0);
        sm90::wgmma<kBQ, false>(acc, fh[i], sm90::desc_add(bb, C::kRPlane),
                                1);
        sm90::wgmma<kBQ, false>(acc, fh[i], bb, 1);
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
        for (int j = 0; j < kQSteps; ++j) {
          const uint64_t bj = sm90::desc_add(bn, j * 32);
          sm90::wgmma<C::kN, false>(part, fl[j], bj, j > 0);
          sm90::wgmma<C::kN, false>(part, fh[j],
                                    sm90::desc_add(bj, C::kTPlane), 1);
          sm90::wgmma<C::kN, false>(part, fh[j], bj, 1);
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

Args make_args(const float* q, const float* k, const float* v,
               const float* bias, const float* dout, const float* lse,
               const float* delta, float* out1, float* out2, int H, int Sq,
               int Sk, long long bs_b, long long bs_h, long long bs_q,
               long long bs_k, int causal, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.out1 = out1;
  a.out2 = out2;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.bs_b = bs_b;
  a.bs_h = bs_h;
  a.bs_q = bs_q;
  a.bs_k = bs_k;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

// dq [B,H,Sq,D] and, when dbias is not null, the full-shape bias gradient
// ds into dbias [B,H,Sq,Sk] (which the caller zero-fills).
extern "C" int flash_attention_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout, const float* lse, const float* delta, float* dq,
    float* dbias, int B, int H, int Sq, int Sk, int D,
    long long bias_stride_b, long long bias_stride_h,
    long long bias_stride_q, long long bias_stride_k, int causal,
    float sm_scale, void* stream) {
  const Args a = make_args(q, k, v, bias, dout, lse, delta, dq, dbias, H, Sq,
                           Sk, bias_stride_b, bias_stride_h, bias_stride_q,
                           bias_stride_k, causal, sm_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(a, B, s);
    case 32: return launch_dq<32>(a, B, s);
    case 64: return launch_dq<64>(a, B, s);
    case 128: return launch_dq<128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
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

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
