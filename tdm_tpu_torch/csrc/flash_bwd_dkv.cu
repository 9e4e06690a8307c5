// Flash-attention backward, the dK/dV pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel`
// (tdm_tpu/ops/attention.py:635-675, `pallas_call` :767 in `_bwd_core`).
// Same function, per (b,h) and key row j:
//   P[i,j]  = exp(q_scaled[i] . k[j] + bias[j] - lse[i])
//   dV[j]   = sum_i P[i,j] dO[i]
//   dK[j]   = sum_i P[i,j] (dO[i] . v[j] - delta[i]) q_scaled[i]
// with q the forward's PRE-SCALED q, so dK = dS^T (scale Q) needs no further
// scale; lse and delta = rowsum(dO * O) as in flash_bwd_dq.cu. P is rounded
// to dO's dtype before dV and dS to q's dtype before dK, with fp32 sums, as
// the TPU kernel rounds them. Query rows past Sq read lse = +1e30 (the
// sentinel the TPU re-pads with, `:709-716`), so they contribute nothing.
// The key bias gets no gradient.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//   * PixArt self-attention, B=4 H=16 S=1024 D=72: four products per
//     (query, key) pair (S, dV, dP, dK) = 8*B*H*Sq*Sk*D = 38.7 GFLOP ->
//     0.0391 ms, operations-bound.
//   * cross-attention, Sk = 120 masked T5 tokens: 4.6 GFLOP against q and dO
//     read (9.4 MB each in bf16) -> bytes-bound.
// Design: the TPU kernel's grid (b·h, k-block, q-block) with dK/dV
// accumulators carried across the sequential q axis becomes one block per
// 64 key rows (16 per warp) that loops over 32-query tiles with both
// accumulators in registers. Each block writes only its own key rows: no
// atomics, deterministic. K and V stay in registers as A fragments; per
// query tile, Q and dO are staged row-major (the B operands of S^T = K Q^T and
// dP^T = V dO^T) and transposed (the B operands of dK += dS^T Q and
// dV += P^T dO); all four products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate). The query tile is 32 rows, not 64, to
// keep the two [16 x 80] fp32 accumulators plus the score tiles inside the
// register file. Simple first version: one stage, no cp.async/TMA, no wgmma.
//
// Layout: q/dO [B,H,Sq,D], k/v/dK/dV [B,H,Sk,D], contiguous; bias [B,Sk] fp32
// or null. bf16 through the tensor-core kernel, fp32 through a scalar-FMA
// kernel. C interface (ctypes): tdm_flash_bwd_dkv returns a cudaError_t code.

#include "flash_common.cuh"

namespace {

constexpr int kBK = 64;       // key rows per block
constexpr int kBQ = 32;       // query rows per tile
constexpr int kQT = kBQ + 8;  // row stride of the transposed Q and dO tiles

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int H, int Sq, int Sk, int D, int vec) {
  constexpr int RS = DP + 8;
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = kBQ / 8;
  constexpr int ND = DP / 8;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const bf16* qg = q + (size_t)bh * Sq * D;
  const bf16* dg = dout + (size_t)bh * Sq * D;
  const bf16* kg = k + (size_t)bh * Sk * D;
  const bf16* vg = v + (size_t)bh * Sk * D;
  const float* lg = lse + (size_t)bh * Sq;
  const float* dlg = delta + (size_t)bh * Sq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kvs = reinterpret_cast<bf16*>(smem_raw);  // [K | V] tiles, read once
  bf16* qs = kvs + 2 * kBK * RS;
  bf16* ds_ = qs + kBQ * RS;
  bf16* qt = ds_ + kBQ * RS;
  bf16* dt = qt + DP * kQT;
  float* ls = reinterpret_cast<float*>(dt + DP * kQT);
  float* dls = ls + kBQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_rows<DP, kBK>(kvs, kg, k0, Sk, D, vec);
  load_rows<DP, kBK>(kvs + kBK * RS, vg, k0, Sk, D, vec);
  __syncthreads();
  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  load_a_frags<DP>(kf, kvs + warp * 16 * RS, g, t);
  load_a_frags<DP>(vf, kvs + (kBK + warp * 16) * RS, g, t);

  const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;
  const float* bg = bias ? bias + (size_t)(bh / H) * Sk : nullptr;
  const float bj0 = j0 < Sk ? (bg ? bg[j0] : 0.f) : kNegInf;
  const float bj1 = j1 < Sk ? (bg ? bg[j1] : 0.f) : kNegInf;

  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    adk[n][0] = adk[n][1] = adk[n][2] = adk[n][3] = 0.f;
    adv[n][0] = adv[n][1] = adv[n][2] = adv[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < Sq; q0 += kBQ) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<DP, kBQ>(qs, qg, q0, Sq, D, vec);
    load_rows<DP, kBQ>(ds_, dg, q0, Sq, D, vec);
    load_transposed<DP, kBQ>(qt, qg, q0, Sq, D, vec);
    load_transposed<DP, kBQ>(dt, dg, q0, Sq, D, vec);
    if (threadIdx.x < kBQ) {
      const int i = q0 + threadIdx.x;
      ls[threadIdx.x] = i < Sq ? lg[i] : kLseMasked;
      dls[threadIdx.x] = i < Sq ? dlg[i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries each
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      const bf16* qr = qs + (n * 8 + g) * RS + t * 2;
      const bf16* dr = ds_ + (n * 8 + g) * RS + t * 2;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_16816(s[n], kf[kk], lds32(qr + kk * 16), lds32(qr + kk * 16 + 8));
        mma_16816(dp[n], vf[kk], lds32(dr + kk * 16), lds32(dr + kk * 16 + 8));
      }
    }
    // P^T (kept in s) and dS^T = P^T * (dP^T - delta) (kept in dp); the key
    // bias runs along the rows here, lse and delta along the columns
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + t * 2;
      const float la = ls[c], lb = ls[c + 1], da = dls[c], db = dls[c + 1];
      s[n][0] = __expf(s[n][0] + bj0 - la);
      s[n][1] = __expf(s[n][1] + bj0 - lb);
      s[n][2] = __expf(s[n][2] + bj1 - la);
      s[n][3] = __expf(s[n][3] + bj1 - lb);
      dp[n][0] = s[n][0] * (dp[n][0] - da);
      dp[n][1] = s[n][1] * (dp[n][1] - db);
      dp[n][2] = s[n][2] * (dp[n][2] - da);
      dp[n][3] = s[n][3] * (dp[n][3] - db);
    }
    // dV += P^T dO and dK += dS^T Q_scaled (P, dS rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* dr = dt + (n * 8 + g) * kQT + kk * 16 + t * 2;
        const bf16* qr = qt + (n * 8 + g) * kQT + kk * 16 + t * 2;
        mma_16816(adv[n], pa, lds32(dr), lds32(dr + 8));
        mma_16816(adk[n], sa, lds32(qr), lds32(qr + 8));
      }
    }
  }

  bf16* kog = dk + (size_t)bh * Sk * D;
  bf16* vog = dv + (size_t)bh * Sk * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t * 2;
    if (j0 < Sk) {
      if (c < D) {
        kog[(size_t)j0 * D + c] = __float2bfloat16(adk[n][0]);
        vog[(size_t)j0 * D + c] = __float2bfloat16(adv[n][0]);
      }
      if (c + 1 < D) {
        kog[(size_t)j0 * D + c + 1] = __float2bfloat16(adk[n][1]);
        vog[(size_t)j0 * D + c + 1] = __float2bfloat16(adv[n][1]);
      }
    }
    if (j1 < Sk) {
      if (c < D) {
        kog[(size_t)j1 * D + c] = __float2bfloat16(adk[n][2]);
        vog[(size_t)j1 * D + c] = __float2bfloat16(adv[n][2]);
      }
      if (c + 1 < D) {
        kog[(size_t)j1 * D + c + 1] = __float2bfloat16(adk[n][3]);
        vog[(size_t)j1 * D + c + 1] = __float2bfloat16(adv[n][3]);
      }
    }
  }
}

template <int DP>
struct LaunchBf16 {
  static cudaError_t run(const void* q, const void* k, const void* v, const float* bias,
                         const void* dout, const float* lse, const float* delta, void* dk,
                         void* dv, int B, int H, int Sq, int Sk, int D, int vec,
                         cudaStream_t stream) {
    const size_t smem = (size_t)((2 * kBK + 2 * kBQ) * (DP + 8) + 2 * DP * kQT) * 2 +
                        2 * kBQ * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Sk + kBK - 1) / kBK);
    flash_bwd_dkv_bf16_kernel<DP><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        bias, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, Sq, Sk, D, vec);
    return cudaGetLastError();
  }
};

// fp32: scalar-FMA kernel. Block = 32 key rows of one (b,h), 4 lanes per
// row (lane t owns columns t, t+4, ...); loop over 32-query tiles.
constexpr int kFR = 32;
constexpr int kFQ = 32;

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Sq, int Sk, int D) {
  constexpr int DPAD = NJ * 4;
  __shared__ float qs[kFQ][DPAD];
  __shared__ float dos[kFQ][DPAD];
  __shared__ float ls[kFQ];
  __shared__ float dls[kFQ];

  const int bh = blockIdx.x;
  const int row = blockIdx.y * kFR + threadIdx.x / 4;  // key row
  const int t = threadIdx.x % 4;
  const float* qg = q + (size_t)bh * Sq * D;
  const float* dg = dout + (size_t)bh * Sq * D;
  const float* kg = k + (size_t)bh * Sk * D;
  const float* vg = v + (size_t)bh * Sk * D;
  const float* bg = bias ? bias + (size_t)(bh / H) * Sk : nullptr;

  float kr[NJ], vr[NJ], adk[NJ], adv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = j * 4 + t;
    const bool in = row < Sk && c < D;
    kr[j] = in ? kg[(size_t)row * D + c] : 0.f;
    vr[j] = in ? vg[(size_t)row * D + c] : 0.f;
    adk[j] = adv[j] = 0.f;
  }
  const float bj = row < Sk ? (bg ? bg[row] : 0.f) : kNegInf;

  for (int q0 = 0; q0 < Sq; q0 += kFQ) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFQ * DPAD; i += kThreads) {
      const int r = i / DPAD, c = i % DPAD;
      const bool in = q0 + r < Sq && c < D;
      qs[r][c] = in ? qg[(size_t)(q0 + r) * D + c] : 0.f;
      dos[r][c] = in ? dg[(size_t)(q0 + r) * D + c] : 0.f;
    }
    if (threadIdx.x < kFQ) {
      const int i = q0 + threadIdx.x;
      ls[threadIdx.x] = i < Sq ? lse[(size_t)bh * Sq + i] : kLseMasked;
      dls[threadIdx.x] = i < Sq ? delta[(size_t)bh * Sq + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kFQ; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        s = fmaf(kr[c], qs[i][c * 4 + t], s);
        dp = fmaf(vr[c], dos[i][c * 4 + t], dp);
      }
      const float p = expf(quad_sum(s) + bj - ls[i]);
      const float ds = p * (quad_sum(dp) - dls[i]);
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        adv[c] = fmaf(p, dos[i][c * 4 + t], adv[c]);
        adk[c] = fmaf(ds, qs[i][c * 4 + t], adk[c]);
      }
    }
  }
  if (row < Sk) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = j * 4 + t;
      if (c < D) {
        dk[(size_t)bh * Sk * D + (size_t)row * D + c] = adk[j];
        dv[(size_t)bh * Sk * D + (size_t)row * D + c] = adv[j];
      }
    }
  }
}

template <int NJ>
struct LaunchF32 {
  static cudaError_t run(const void* q, const void* k, const void* v, const float* bias,
                         const void* dout, const float* lse, const float* delta, void* dk,
                         void* dv, int B, int H, int Sq, int Sk, int D, int /*vec*/,
                         cudaStream_t stream) {
    dim3 grid(B * H, (Sk + kFR - 1) / kFR);
    flash_bwd_dkv_f32_kernel<NJ><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk, D);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec: 1 when D % 8 == 0 and every bf16
// pointer is 16-byte aligned. Returns a cudaError_t code.
int tdm_flash_bwd_dkv(const void* q, const void* k, const void* v, const float* bias,
                      const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                      int batch, int heads, int sq, int sk, int d, int dtype, int vec,
                      void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 128 ||
      (sk + kFR - 1) / kFR > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)by_padded_dim_bf16<LaunchBf16>(d, q, k, v, bias, dout, lse, delta, dk, dv, batch,
                                               heads, sq, sk, d, vec, s);
  if (dtype == 0)
    return (int)by_padded_dim_f32<LaunchF32>(d, q, k, v, bias, dout, lse, delta, dk, dv, batch,
                                             heads, sq, sk, d, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
