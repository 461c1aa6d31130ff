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
// masked and fully-masked rows, and no padded copies are needed.
//
// What bounds them on this card: the inputs are float32, so the matrix
// products run on the fp32 FMA units (67 TFLOP/s on an H100 SXM), not on
// the tensor cores: 6*D operations per (q, k) pair for dq, 8*D for dk/dv.
// Reading q, k, v, dO (and a bias) once and writing the gradients once is
// tens of MB at the training shapes, a few microseconds at 3.35 TB/s. Both
// kernels are bound by operations, so neither writes the S x S
// probabilities to device memory: every operand of the inner loops sits in
// shared memory or registers.
//
// Design (simple and correct first; wgmma, TMA and bf16 are later work):
//   * dq: one CTA of 256 threads per (batch*head, 64-row query tile); the
//     query and dO tiles are staged once, transposed, in shared memory; a
//     loop over 64-row key tiles (the TPU's sequential grid axis) stages
//     K (transposed and row-major) and V (transposed). Each thread owns a
//     4x4 block of the 64x64 score and dp tiles and 4 rows x D/16 columns
//     of the dq accumulator; ds goes through shared memory into the
//     ds * K product.
//   * dk/dv: one CTA of 256 threads per (batch*head, 64-row key tile);
//     K and V are staged once, transposed; a loop over 64-row query tiles
//     stages Q and dO (transposed and row-major) with their lse and delta.
//     Each thread owns a 4x4 block of the transposed score tile and
//     4 key rows x D/16 columns of both accumulators; p and ds go through
//     shared memory into the p^T * dO and ds^T * Q products.
//   * each CTA owns its output tile: no atomics, deterministic results;
//   * under causal, key tiles wholly above the diagonal are skipped (their
//     p is exactly 0 in the reference too);
//   * the bias is read through per-dimension strides (stride 0 on a
//     broadcast dim), so a [B,1,1,Sk] key-row mask or a [B,1,Sq,Sk] bias
//     is never expanded;
//   * bias_grad: the dq kernel writes ds for every tile it computes into a
//     zero-filled [B,H,Sq,Sk] buffer; the wrapper sums it over the bias's
//     broadcast dims.
// Shared memory: dq 5*64*D + 64*64 floats (176 KB at D=128); dk/dv
// 6*64*D + 2*64*64 + 2*64 floats (225 KB at D=128, under the 227 KB a
// block may use).
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the current CUDA stream through ctypes and checks the
// returned cudaError_t.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 64;     // query rows and key rows per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

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
constexpr size_t dkv_smem_bytes() {
  // Kt, Vt, Qt, dOt [D][64]; Qs, dOs [64][D]; Ps, dSs [64 q][64 k];
  // lse, delta [64]
  return sizeof(float) *
         (size_t)(6 * D * kBlock + 2 * kBlock * kBlock + 2 * kBlock);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(Args a) {
  constexpr int kCols = D / 16;  // dk/dv columns per thread
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);
  float* Vt = Kt + D * kBlock;
  float* Qt = Vt + D * kBlock;
  float* dOt = Qt + D * kBlock;
  float* Qs = dOt + D * kBlock;
  float* dOs = Qs + kBlock * D;
  float* Ps = dOs + kBlock * D;
  float* dSs = Ps + kBlock * kBlock;
  float* lse_s = dSs + kBlock * kBlock;
  float* delta_s = lse_s + kBlock;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // query columns tx*4.., dk/dv columns tx*kCols..
  const int ty = tid / 16;  // key rows ty*4..ty*4+3
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBlock;
  const float* qb = a.q + (size_t)bh * a.Sq * D;
  const float* dob = a.dout + (size_t)bh * a.Sq * D;
  const float* kb = a.k + (size_t)bh * a.Sk * D;
  const float* vb = a.v + (size_t)bh * a.Sk * D;

  stage<D>(kb, k0, a.Sk, Kt, nullptr);
  stage<D>(vb, k0, a.Sk, Vt, nullptr);
  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  // under causal, query tiles that end before this key tile's first key
  // see none of its keys
  const int n_tiles = (a.Sq + kBlock - 1) / kBlock;
  const int first = a.causal ? blockIdx.x : 0;

  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();  // the previous tile's Q/dO/P/dS are consumed
    stage<D>(qb, q0, a.Sq, Qt, Qs);
    stage<D>(dob, q0, a.Sq, dOt, dOs);
    if (tid < kBlock) {
      const int qr = q0 + tid;
      lse_s[tid] = qr < a.Sq ? a.lse[(size_t)bh * a.Sq + qr] : 0.f;
      delta_s[tid] = qr < a.Sq ? a.delta[(size_t)bh * a.Sq + qr] : 0.f;
    }
    __syncthreads();

    // transposed tiles: row i = key ty*4+i, column j = query tx*4+j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 kv = *reinterpret_cast<const float4*>(&Kt[d * kBlock + ty * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&Vt[d * kBlock + ty * 4]);
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kBlock + tx * 4]);
      const float4 ov = *reinterpret_cast<const float4*>(&dOt[d * kBlock + tx * 4]);
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qa[j], s[i][j]);
          dp[i][j] = fmaf(va[i], oa[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qr = q0 + tx * 4 + j;
      const float l = lse_s[tx * 4 + j], dl = delta_s[tx * 4 + j];
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = k0 + ty * 4 + i;
        const float x = masked_score(a, s[i][j], b, h, qr, kc);
        p[i] = qr < a.Sq ? expf(x - l) : 0.f;
        ds[i] = p[i] * (dp[i][j] - dl);
      }
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * kBlock + ty * 4]) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(&dSs[(tx * 4 + j) * kBlock + ty * 4]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < kBlock; ++qq) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[qq * kBlock + ty * 4]);
      const float4 d4 = *reinterpret_cast<const float4*>(&dSs[qq * kBlock + ty * 4]);
      const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
      const float da[4] = {d4.x, d4.y, d4.z, d4.w};
      float oa[kCols], qa[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        oa[c] = dOs[qq * D + tx * kCols + c];
        qa[c] = Qs[qq * D + tx * kCols + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv[i][c] = fmaf(pa[i], oa[c], dv[i][c]);
          dk[i][c] = fmaf(da[i], qa[c], dk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= a.Sk) continue;
    float* krow = a.out1 + ((size_t)bh * a.Sk + kr) * D + tx * kCols;
    float* vrow = a.out2 + ((size_t)bh * a.Sk + kr) * D + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      krow[c] = a.scale * dk[i][c];
      vrow[c] = dv[i][c];
    }
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

template <int D>
cudaError_t launch_dkv(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + kBlock - 1) / kBlock, B * a.H);
  flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, stream>>>(a);
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

// dk, dv [B,H,Sk,D].
extern "C" int flash_attention_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout, const float* lse, const float* delta, float* dk,
    float* dv, int B, int H, int Sq, int Sk, int D,
    long long bias_stride_b, long long bias_stride_h,
    long long bias_stride_q, long long bias_stride_k, int causal,
    float sm_scale, void* stream) {
  const Args a = make_args(q, k, v, bias, dout, lse, delta, dk, dv, H, Sq,
                           Sk, bias_stride_b, bias_stride_h, bias_stride_q,
                           bias_stride_k, causal, sm_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(a, B, s);
    case 32: return launch_dkv<32>(a, B, s);
    case 64: return launch_dkv<64>(a, B, s);
    case 128: return launch_dkv<128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
