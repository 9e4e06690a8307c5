// Flash-attention forward for Hopper (sm_90a), with or without the logsumexp.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel` (tdm_tpu/ops/attention.py
// :291-350, driven by `_fwd_core` :437-528): with_lse=False is the inference
// wrapper `_flash_fwd_kernel_nolse` (:399-405), with_lse=True the training
// forward whose lse the backward kernels (flash_bwd_dq.cu, flash_bwd_dkv.cu)
// read. Same function:
//   out[b,h,i,:] = sum_j softmax_j(q_scaled[b,h,i,:] . k[b,h,j,:] + bias[b,j]) v[b,h,j,:]
//   lse[b,h,i]   = m_i + log l_i   (running max and sum of the online softmax)
// where q arrives PRE-SCALED (rounded to its own dtype by the caller), bias is
// 0 for a real key and -1e30 for a masked one, the softmax runs online in fp32
// and a row whose keys are all masked (running max still ~ -1e30) outputs 0
// and stores the lse sentinel +1e30 (`:341-348`), so exp(s - lse) = 0 there
// and no gradient leaks through it. The lse is stored compactly, [B,H,Sq]
// fp32; the TPU kernel's 128-lane broadcast of it is not carried over.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//   * PixArt self-attention, B=4 H=16 S=1024 D=72 bf16: 4*B*H*S*S*D = 19.3
//     GFLOP against 37.7 MB moved -> operations-bound (0.0195 ms vs 0.0113 ms).
//   * PixArt cross-attention, Sq=1024 Sk=120 (masked T5 tokens): 2.3 GFLOP
//     against 21.1 MB moved (q and out dominate) -> bytes-bound (0.0059 ms).
//   * SD1.5 at 512², batch 4, 8 heads: self-attention [4,8,4096,4096,40]
//     is operations-bound (86 GFLOP, 0.087 ms); its cross-attention over
//     77 CLIP tokens, and every call at D = 80 and 160 but the 1024-token
//     self-attention, move more bytes than they compute.
//   The lse adds 4 bytes per query row (0.26 MB at these shapes).
// The bf16 path is the warp-specialised wgmma/TMA mainloop of
// attn_fwd_sm90.cuh (HAS_BIAS, WITH_LSE as a template flag, so the inference
// variant carries no cost for it): 128 query rows per CTA (192 at D <= 64),
// 128-key K/V tiles in a TMA ring, both products on wgmma. The TPU kernel's
// sequential k grid axis is the loop inside the CTA; its D->128 padding
// becomes D = 72 read as a 64-column and a 16-column panel that TMA
// zero-fills to 80, and its D->256 padding of SD1.5's D = 160 three panels
// of 64, 64 and 32 columns (D = 40 reads the 64-column panel alone, zero-
// filled past column 40). The key bias of each tile rides with its K/V
// tile; keys past Sk get -inf there.
//
// Layout: q/out [B,H,Sq,D], k/v [B,H,Sk,D], contiguous; bias [B,Sk] fp32 or
// null (no mask); lse [B,H,Sq] fp32 or null (not wanted). bf16 takes D % 8 ==
// 0, D <= 160 and 16-byte aligned bases (the wrapper zero-pads D to a
// multiple of 8); fp32 goes through a scalar-FMA kernel (fp32 has no
// tensor-core path at full precision) and takes any D in [1,160].
//
// C interface (loaded with ctypes): tdm_flash_fwd returns a cudaError_t code
// (0 on success) after checking cudaGetLastError() right after the launch.

#include "attn_fwd_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: the wgmma/TMA mainloop with the key bias (0 where bias is null)
// ---------------------------------------------------------------------------

template <int DP, bool LSE>
__global__ void __launch_bounds__(sm90::Layout<DP, sm90::kGroups<DP>>::kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ sm90::AttnMaps maps,
                      const float* __restrict__ bias, float* __restrict__ lse, int H, int Sq,
                      int Sk) {
  sm90::attn_fwd_mainloop<DP, sm90::kGroups<DP>, true, LSE>(maps, bias, lse, H, Sq, Sk);
}

template <bool LSE>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* bias,
                        void* o, float* lse, int B, int H, int Sq, int Sk, int D,
                        cudaStream_t s) {
  using sm90::kGroups;
  if (!sm90::operands_ok(q, k, v, o, B * H, D)) return cudaErrorInvalidValue;
  if (D <= 64)
    return sm90::launch<64, kGroups<64>>(flash_fwd_sm90_kernel<64, LSE>, q, k, v, bias, o, lse,
                                         B * H, H, Sq, Sk, D, s);
  if (D <= 80)
    return sm90::launch<80, kGroups<80>>(flash_fwd_sm90_kernel<80, LSE>, q, k, v, bias, o, lse,
                                         B * H, H, Sq, Sk, D, s);
  if (D <= 128)
    return sm90::launch<128, kGroups<128>>(flash_fwd_sm90_kernel<128, LSE>, q, k, v, bias, o,
                                           lse, B * H, H, Sq, Sk, D, s);
  return sm90::launch<160, kGroups<160>>(flash_fwd_sm90_kernel<160, LSE>, q, k, v, bias, o, lse,
                                         B * H, H, Sq, Sk, D, s);
}

// ---------------------------------------------------------------------------
// fp32: scalar-FMA kernel. Block = 32 query rows of one (b,h), 4 lanes per
// row; lane t owns columns t, t+4, t+8, ... Loop over 32-key tiles.
// ---------------------------------------------------------------------------

constexpr int kFR = 32;  // query rows per block
constexpr int kFK = 32;  // keys per tile

template <int NJ, bool LSE>  // columns per lane; D <= 4*NJ
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                     int D) {
  constexpr int DPAD = NJ * 4;
  __shared__ float ks[kFK][DPAD];
  __shared__ float vs[kFK][DPAD];
  __shared__ float bs[kFK];

  const int bh = blockIdx.x;
  const int row = blockIdx.y * kFR + threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const float* qg = q + (size_t)bh * Sq * D;
  const float* kg = k + (size_t)bh * Sk * D;
  const float* vg = v + (size_t)bh * Sk * D;
  float* og = o + (size_t)bh * Sq * D;
  const float* bg = bias ? bias + (size_t)(bh / H) * Sk : nullptr;

  float qr[NJ], acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = j * 4 + t;
    qr[j] = (row < Sq && c < D) ? qg[(size_t)row * D + c] : 0.f;
    acc[j] = 0.f;
  }
  float m = kNegInf, l = 0.f;

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

    float s[kFK];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NJ; ++c) part = fmaf(qr[c], ks[j][c * 4 + t], part);
      s[j] = quad_sum(part) + bs[j];
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      s[j] = expf(s[j] - mn);
      rs += s[j];
    }
    l = alpha * l + rs;
    m = mn;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      float a = acc[c] * alpha;
#pragma unroll
      for (int j = 0; j < kFK; ++j) a = fmaf(s[j], vs[j][c * 4 + t], a);
      acc[c] = a;
    }
  }

  if (row < Sq) {
    const bool ok = m > kValidMax;
    const float inv = ok ? 1.f / (l == 0.f ? 1.f : l) : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = j * 4 + t;
      if (c < D) og[(size_t)row * D + c] = acc[j] * inv;
    }
    if (LSE && t == 0)
      lse[(size_t)bh * Sq + row] = (ok && l > 0.f) ? m + logf(l) : kLseMasked;
  }
}

template <int NJ>
struct LaunchF32 {
  static cudaError_t run(const void* q, const void* k, const void* v, const float* bias, void* o,
                         float* lse, int B, int H, int Sq, int Sk, int D,
                         cudaStream_t stream) {
    dim3 grid(B * H, (Sq + kFR - 1) / kFR);
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    if (lse)
      flash_fwd_f32_kernel<NJ, true><<<grid, kThreads, 0, stream>>>(qf, kf, vf, bias, of, lse, H,
                                                                    Sq, Sk, D);
    else
      flash_fwd_f32_kernel<NJ, false><<<grid, kThreads, 0, stream>>>(qf, kf, vf, bias, of, lse,
                                                                     H, Sq, Sk, D);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse: [B,H,Sq] fp32 output, or null for
// the inference variant. Returns a cudaError_t code.
int tdm_flash_fwd(const void* q, const void* k, const void* v, const float* bias, void* out,
                  float* lse, int batch, int heads, int sq, int sk, int d, int dtype,
                  void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 160 ||
      (sq + kFR - 1) / kFR > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)(lse ? launch_bf16<true>(q, k, v, bias, out, lse, batch, heads, sq, sk, d, s)
                     : launch_bf16<false>(q, k, v, bias, out, lse, batch, heads, sq, sk, d, s));
  if (dtype == 0 && d > 128)  // 40 columns a lane: the fp32 sweep above 128
    return (int)LaunchF32<40>::run(q, k, v, bias, out, lse, batch, heads, sq, sk, d, s);
  if (dtype == 0)
    return (int)by_padded_dim_f32<LaunchF32>(d, q, k, v, bias, out, lse, batch, heads, sq, sk,
                                             d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
