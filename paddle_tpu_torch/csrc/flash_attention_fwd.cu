// Flash-attention forward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// (_fwd / _fwd_kernel): online-softmax attention that returns O [B,H,Sq,D]
// and the row log-sum-exp lse [B,H,Sq], with an additive bias broadcast
// over any of its four dims, keys at or past Sk masked, the causal mask
// qpos >= kpos, and an explicit softmax scale.
//
// What bounds it on this card: the inputs are float32, so the two matrix
// products per tile run on the fp32 FMA units (67 TFLOP/s on an H100 SXM),
// not on the tensor cores; reading q/k/v once and writing O once is a few
// MB at the serving shapes, microseconds at 3.35 TB/s. The kernel is bound
// by operations. The design therefore keeps every operand of the inner
// loops in shared memory or registers and never writes the S x S scores
// to device memory:
//   * one CTA of 256 threads per (batch*head, 64-row query tile); the
//     query tile is staged once, transposed, in shared memory;
//   * a loop over 64-row key/value tiles staged in shared memory (keys
//     transposed) — the sequential TPU grid axis becomes this loop;
//   * each thread owns a 4x4 block of the 64x64 score tile and 4 rows x
//     D/16 columns of the output accumulator, so the running max/sum of
//     the online softmax stay in registers and reduce across the 16
//     threads of a row group with warp shuffles;
//   * key tiles wholly above the causal diagonal are never loaded;
//   * the bias is read through per-dimension strides (stride 0 on a
//     broadcast dim), so a [B,1,1,Sk] key-row mask is never expanded.
// wgmma/TMA and lower-precision inputs are later work; this kernel is the
// simple correct float32 version.
//
// C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the current CUDA stream through ctypes and checks the
// returned cudaError_t.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;    // query rows per CTA
constexpr int kBlockK = 64;    // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

template <int D>
constexpr size_t smem_bytes() {
  // Qt [D][BQ], Kt [D][BK], V [BK][D], Pt [BK][BQ]
  return sizeof(float) *
         (size_t)(D * kBlockQ + D * kBlockK + kBlockK * D + kBlockK * kBlockQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     long long bs_b, long long bs_h, long long bs_q,
                     long long bs_k, int causal, float scale) {
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + D * kBlockQ;
  float* Vs = Kt + D * kBlockK;
  float* Pt = Vs + kBlockK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // key columns tx*4.., output columns tx*kCols..
  const int ty = tid / 16;   // query rows ty*4..ty*4+3
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;

  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    Qt[c * kBlockQ + r] = qr < Sq ? qb[(size_t)qr * D + c] : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    // tiles whose first key lies past this CTA's last query row
    const int last = (q0 + kBlockQ - 1) / kBlockK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's Kt/Vs/Pt are consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kr = k0 + r;
      const bool ok = kr < Sk;
      Kt[c * kBlockK + r] = ok ? kb[(size_t)kr * D + c] : 0.f;
      Vs[r * D + c] = ok ? vb[(size_t)kr * D + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kBlockQ + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&Kt[d * kBlockK + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (bias != nullptr && qr < Sq && kc < Sk)
          x += bias[b * bs_b + h * bs_h + (long long)qr * bs_q +
                    (long long)kc * bs_k];
        if (kc >= Sk) x = kNegInf;
        if (causal && qr < kc) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }

#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kBlockQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[kk * kBlockQ + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      float va[kCols];
      if constexpr (kCols % 4 == 0) {
#pragma unroll
        for (int c = 0; c < kCols; c += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[kk * D + tx * kCols + c]);
          va[c] = vv.x;
          va[c + 1] = vv.y;
          va[c + 2] = vv.z;
          va[c + 3] = vv.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) va[c] = Vs[kk * D + tx * kCols + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pa[i], va[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];  // fully-masked row -> 0
    float* orow = o + ((size_t)bh * Sq + qr) * D + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[c] = acc[i][c] / denom;
    if (tx == 0) lse[(size_t)bh * Sq + qr] = m[i] + logf(fmaxf(l[i], 1e-37f));
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* o, float* lse, int B, int H,
                   int Sq, int Sk, long long bs_b, long long bs_h,
                   long long bs_q, long long bs_k, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, o, lse, H, Sq, Sk, bs_b, bs_h, bs_q, bs_k, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    float* o, float* lse, int B, int H, int Sq, int Sk, int D,
    long long bias_stride_b, long long bias_stride_h,
    long long bias_stride_q, long long bias_stride_k, int causal,
    float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, bias, o, lse, B, H, Sq, Sk, bias_stride_b,
                        bias_stride_h, bias_stride_q, bias_stride_k, causal,
                        sm_scale, s);
    case 32:
      return launch<32>(q, k, v, bias, o, lse, B, H, Sq, Sk, bias_stride_b,
                        bias_stride_h, bias_stride_q, bias_stride_k, causal,
                        sm_scale, s);
    case 64:
      return launch<64>(q, k, v, bias, o, lse, B, H, Sq, Sk, bias_stride_b,
                        bias_stride_h, bias_stride_q, bias_stride_k, causal,
                        sm_scale, s);
    case 128:
      return launch<128>(q, k, v, bias, o, lse, B, H, Sq, Sk, bias_stride_b,
                         bias_stride_h, bias_stride_q, bias_stride_k, causal,
                         sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
