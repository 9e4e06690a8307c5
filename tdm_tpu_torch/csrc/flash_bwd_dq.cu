// Flash-attention backward, the dQ pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bwd_dq_kernel`
// (tdm_tpu/ops/attention.py:600-632, `pallas_call` :744 in `_bwd_core`).
// Same function, per (b,h) and query row i:
//   P[i,j]  = exp(q_scaled[i] . k[j] + bias[j] - lse[i])
//   dS[i,j] = P[i,j] * (dO[i] . v[j] - delta[i])
//   dQ[i]   = scale * sum_j dS[i,j] k[j]
// with q the forward's PRE-SCALED q (so the logits match the forward's
// bit for bit and P renormalises exactly against its lse), lse the forward's
// [B,H,Sq] fp32 output (+1e30 on all-masked rows, so their P and dQ are 0),
// and delta = rowsum(dO * O) [B,H,Sq] fp32, computed outside (the JAX package
// leaves it to XLA, `:718-724`). dS is rounded to q's dtype before the
// product with K and every sum is fp32, as on the TPU; `scale` is applied
// once, here, which makes dQ the gradient with respect to the unscaled q.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//   * PixArt self-attention, B=4 H=16 S=1024 D=72: three products per
//     (query, key) pair (S, dP, dQ) = 6*B*H*Sq*Sk*D = 29.0 GFLOP -> 0.0293 ms,
//     operations-bound (q, k, v, dO, dQ, lse, delta: 47 MB -> 0.014 ms).
//   * cross-attention, Sk = 120 masked T5 tokens: 3.5 GFLOP against q, dO,
//     dQ (9.4 MB each in bf16) -> bytes-bound.
// Design: the TPU kernel's grid (b·h, q-block, k-block) with an accumulator
// carried across the sequential k axis becomes one block per 64 query rows
// that loops over 64-key tiles with the dQ accumulator in registers. Each
// block writes only its own rows: no atomics, and dQ is the same bits run to
// run. Q and dO stay in registers as A fragments; per key tile, K is staged
// twice (row-major for S = Q K^T, transposed for dQ += dS K) and V row-major
// for dP = dO V^T, D zero-padded to a multiple of 16 in shared memory only
// (72 -> 80); all three products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate). Ragged keys get the -1e30 bias and
// zero K/V rows; query rows past Sq read lse = +1e30 and are not written.
// Simple first version: one stage, no cp.async/TMA, no wgmma.
//
// Layout: q/dO/dQ [B,H,Sq,D], k/v [B,H,Sk,D], contiguous; bias [B,Sk] fp32 or
// null. bf16 through the tensor-core kernel, fp32 through a scalar-FMA kernel.
// C interface (ctypes): tdm_flash_bwd_dq returns a cudaError_t code.

#include "flash_common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kKT = kBK + 8;  // row stride of the transposed K tile

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Sq,
                         int Sk, int D, float scale, int vec) {
  constexpr int RS = DP + 8;
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = kBK / 8;
  constexpr int ND = DP / 8;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const bf16* qg = q + (size_t)bh * Sq * D;
  const bf16* dg = dout + (size_t)bh * Sq * D;
  const bf16* kg = k + (size_t)bh * Sk * D;
  const bf16* vg = v + (size_t)bh * Sk * D;
  const float* bg = bias ? bias + (size_t)(bh / H) * Sk : nullptr;

  // [Q | dO] first, then reused as [K | V] once the fragments are in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBK * RS;
  bf16* kt = vs + kBK * RS;
  float* bs = reinterpret_cast<float*>(kt + DP * kKT);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_rows<DP, kBQ>(ks, qg, q0, Sq, D, vec);
  load_rows<DP, kBQ>(vs, dg, q0, Sq, D, vec);
  __syncthreads();
  uint32_t qf[KSTEPS][4], df[KSTEPS][4];
  load_a_frags<DP>(qf, ks + warp * 16 * RS, g, t);
  load_a_frags<DP>(df, vs + warp * 16 * RS, g, t);

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* lg = lse + (size_t)bh * Sq;
  const float* dlg = delta + (size_t)bh * Sq;
  const float lse0 = r0 < Sq ? lg[r0] : kLseMasked, lse1 = r1 < Sq ? lg[r1] : kLseMasked;
  const float dl0 = r0 < Sq ? dlg[r0] : 0.f, dl1 = r1 < Sq ? dlg[r1] : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();  // the fragments (first tile) or the previous tile are read
    load_rows<DP, kBK>(ks, kg, k0, Sk, D, vec);
    load_rows<DP, kBK>(vs, vg, k0, Sk, D, vec);
    load_transposed<DP, kBK>(kt, kg, k0, Sk, D, vec);
    if (threadIdx.x < kBK) {
      const int j = k0 + threadIdx.x;
      bs[threadIdx.x] = j < Sk ? (bg ? bg[j] : 0.f) : kNegInf;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 16 rows x 64 keys each
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      const bf16* kr = ks + (n * 8 + g) * RS + t * 2;
      const bf16* vr = vs + (n * 8 + g) * RS + t * 2;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_16816(s[n], qf[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
        mma_16816(dp[n], df[kk], lds32(vr + kk * 16), lds32(vr + kk * 16 + 8));
      }
    }
    // dS = P * (dP - delta), P = exp(S + bias - lse); kept in s
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = bs[n * 8 + t * 2], b1 = bs[n * 8 + t * 2 + 1];
      s[n][0] = __expf(s[n][0] + b0 - lse0) * (dp[n][0] - dl0);
      s[n][1] = __expf(s[n][1] + b1 - lse0) * (dp[n][1] - dl0);
      s[n][2] = __expf(s[n][2] + b0 - lse1) * (dp[n][2] - dl1);
      s[n][3] = __expf(s[n][3] + b1 - lse1) * (dp[n][3] - dl1);
    }
    // dQ += dS K, dS rounded to bf16 (q's dtype)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* kr = kt + (n * 8 + g) * kKT + kk * 16 + t * 2;
        mma_16816(acc[n], a, lds32(kr), lds32(kr + 8));
      }
    }
  }

  bf16* og = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t * 2;
    if (r0 < Sq) {
      if (c < D) og[(size_t)r0 * D + c] = __float2bfloat16(acc[n][0] * scale);
      if (c + 1 < D) og[(size_t)r0 * D + c + 1] = __float2bfloat16(acc[n][1] * scale);
    }
    if (r1 < Sq) {
      if (c < D) og[(size_t)r1 * D + c] = __float2bfloat16(acc[n][2] * scale);
      if (c + 1 < D) og[(size_t)r1 * D + c + 1] = __float2bfloat16(acc[n][3] * scale);
    }
  }
}

template <int DP>
struct LaunchBf16 {
  static cudaError_t run(const void* q, const void* k, const void* v, const float* bias,
                         const void* dout, const float* lse, const float* delta, void* dq, int B,
                         int H, int Sq, int Sk, int D, float scale, int vec, cudaStream_t stream) {
    const size_t smem = (size_t)(2 * kBK * (DP + 8) + DP * kKT) * 2 + kBK * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
    flash_bwd_dq_bf16_kernel<DP><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        bias, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, Sq, Sk, D,
        scale, vec);
    return cudaGetLastError();
  }
};

// fp32: scalar-FMA kernel. Block = 32 query rows of one (b,h), 4 lanes per
// row (lane t owns columns t, t+4, ...); loop over 32-key tiles.
constexpr int kFR = 32;
constexpr int kFK = 32;

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq, int H, int Sq,
                        int Sk, int D, float scale) {
  constexpr int DPAD = NJ * 4;
  __shared__ float ks[kFK][DPAD];
  __shared__ float vs[kFK][DPAD];
  __shared__ float bs[kFK];

  const int bh = blockIdx.x;
  const int row = blockIdx.y * kFR + threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const float* qg = q + (size_t)bh * Sq * D;
  const float* dg = dout + (size_t)bh * Sq * D;
  const float* kg = k + (size_t)bh * Sk * D;
  const float* vg = v + (size_t)bh * Sk * D;
  const float* bg = bias ? bias + (size_t)(bh / H) * Sk : nullptr;

  float qr[NJ], dr[NJ], acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = j * 4 + t;
    const bool in = row < Sq && c < D;
    qr[j] = in ? qg[(size_t)row * D + c] : 0.f;
    dr[j] = in ? dg[(size_t)row * D + c] : 0.f;
    acc[j] = 0.f;
  }
  const float lr = row < Sq ? lse[(size_t)bh * Sq + row] : kLseMasked;
  const float dl = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kFK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFK * DPAD; i += kThreads) {
      const int r = i / DPAD, c = i % DPAD;
      const bool in = k0 + r < Sk && c < D;
      ks[r][c] = in ? kg[(size_t)(k0 + r) * D + c] : 0.f;
      vs[r][c] = in ? vg[(size_t)(k0 + r) * D + c] : 0.f;
    }
    if (threadIdx.x < kFK) {
      const int j = k0 + threadIdx.x;
      bs[threadIdx.x] = j < Sk ? (bg ? bg[j] : 0.f) : kNegInf;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kFK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        s = fmaf(qr[c], ks[j][c * 4 + t], s);
        dp = fmaf(dr[c], vs[j][c * 4 + t], dp);
      }
      const float ds = expf(quad_sum(s) + bs[j] - lr) * (quad_sum(dp) - dl);
#pragma unroll
      for (int c = 0; c < NJ; ++c) acc[c] = fmaf(ds, ks[j][c * 4 + t], acc[c]);
    }
  }
  if (row < Sq) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = j * 4 + t;
      if (c < D) dq[(size_t)bh * Sq * D + (size_t)row * D + c] = acc[j] * scale;
    }
  }
}

template <int NJ>
struct LaunchF32 {
  static cudaError_t run(const void* q, const void* k, const void* v, const float* bias,
                         const void* dout, const float* lse, const float* delta, void* dq, int B,
                         int H, int Sq, int Sk, int D, float scale, int /*vec*/,
                         cudaStream_t stream) {
    dim3 grid(B * H, (Sq + kFR - 1) / kFR);
    flash_bwd_dq_f32_kernel<NJ><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dq), H, Sq, Sk, D, scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec: 1 when D % 8 == 0 and every bf16
// pointer is 16-byte aligned. Returns a cudaError_t code.
int tdm_flash_bwd_dq(const void* q, const void* k, const void* v, const float* bias,
                     const void* dout, const float* lse, const float* delta, void* dq, int batch,
                     int heads, int sq, int sk, int d, float scale, int dtype, int vec,
                     void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 128 ||
      (sq + kFR - 1) / kFR > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)by_padded_dim_bf16<LaunchBf16>(d, q, k, v, bias, dout, lse, delta, dq, batch,
                                               heads, sq, sk, d, scale, vec, s);
  if (dtype == 0)
    return (int)by_padded_dim_f32<LaunchF32>(d, q, k, v, bias, dout, lse, delta, dq, batch, heads,
                                             sq, sk, d, scale, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
