// Unmasked attention forward for Hopper (sm_90a): the counterpart of the
// splash-attention kernel that the JAX package runs for SD3 and CogVideoX
// inference.
//
// Replaces `_splash_kernel` / `_splash_attention` (tdm_tpu/ops/attention.py
// :152-263, jax's bundled Pallas splash MHA, which holds its own
// pallas_call). Same function, without a mask, for head dims 64 and 128:
//   out[bh,i,:] = sum_j softmax_j(q_scaled[bh,i,:] . k[bh,j,:]) v[bh,j,:]
// q arrives PRE-SCALED (rounded to its dtype by the caller); the softmax runs
// online in fp32; p is rounded to v's dtype before the product with v, as in
// the TPU kernel. There is no lse output and no key bias.
//
// Ragged tails are masked exactly, by index, inside the kernel: keys >= Sk
// get a -inf logit in the last tile (TMA zero-fills their K/V rows), query
// rows >= Sq are computed on zero rows and never stored. The TPU path's
// pad-key correction out / (1 - n_pad*exp(-lse)) (:225-229) is NOT carried
// over: it fails when a row's real logits all lie well below 0.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
// SD3-Medium 1024px joint attention, B=4 H=24 S=4096+333=4429 D=64 bf16:
// 4*B*H*S*S*D = 482 GFLOP against 9.1 MB of q, k, v and out moved ->
// operations-bound, 0.487 ms. Only wgmma reaches the tensor cores' rate, so
// the bf16 path is the warp-specialised mainloop of attn_fwd_sm90.cuh without
// bias or lse: 192 query rows per CTA at D = 64 (three consumer warpgroups;
// each K/V tile serves 1.5x the queries of two), 128 at D = 128 (two),
// 128-key K/V tiles through a 3-stage TMA ring (2 at D = 128), S = Q K^T and
// O += P V on wgmma with P in registers and V read MN-major from its
// row-major tile.
// Grid x runs over the query tiles of one (b,h), so the CTAs in flight share
// that head's K/V (1.1 MB at the SD3 shape) in L2. fp32 (tests and tiny
// configs on the card) goes through a scalar-FMA kernel.
//
// Layout: q/out [BH,Sq,D], k/v [BH,Sk,D], contiguous, 16-byte aligned (the
// wrapper checks). C interface (loaded with ctypes): tdm_splash_fwd returns a
// cudaError_t code (0 on success) after cudaGetLastError() right after the
// launch.

#include <math.h>

#include "attn_fwd_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: the wgmma/TMA mainloop without bias or lse
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(sm90::Layout<D, sm90::kGroups<D>>::kThreads, 1)
splash_fwd_sm90_kernel(const __grid_constant__ sm90::AttnMaps maps,
                       const float* __restrict__ bias, float* __restrict__ lse, int H, int Sq,
                       int Sk) {
  sm90::attn_fwd_mainloop<D, sm90::kGroups<D>, false, false>(maps, bias, lse, H, Sq, Sk);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                        int Sk, cudaStream_t s) {
  if (!sm90::operands_ok(q, k, v, o, BH, D)) return cudaErrorInvalidValue;
  return sm90::launch<D, sm90::kGroups<D>>(splash_fwd_sm90_kernel<D>, q, k, v, nullptr, o,
                                           nullptr, BH, 1, Sq, Sk, D, s);
}

// ---------------------------------------------------------------------------
// fp32: scalar-FMA kernel. Block = 32 query rows of one (b,h), 4 lanes per
// row (lane t owns columns t, t+4, ...); 32-key tiles in shared memory.
// ---------------------------------------------------------------------------

constexpr int kFThreads = 128;
constexpr int kFR = 32;  // query rows per block
constexpr int kFK = 32;  // keys per tile

template <int D>
__global__ void __launch_bounds__(kFThreads)
splash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk) {
  constexpr int NJ = D / 4;
  __shared__ float ks[kFK][D];
  __shared__ float vs[kFK][D];

  const size_t bh = blockIdx.y;
  const int row = blockIdx.x * kFR + threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const float* kg = k + bh * Sk * D;
  const float* vg = v + bh * Sk * D;

  float qr[NJ], acc[NJ];
#pragma unroll
  for (int c = 0; c < NJ; ++c) {
    qr[c] = row < Sq ? q[(bh * Sq + row) * D + c * 4 + t] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kFK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFK * D; i += kFThreads) {
      const int r = i / D, c = i % D;
      const bool live = k0 + r < Sk;
      ks[r][c] = live ? kg[(size_t)(k0 + r) * D + c] : 0.f;
      vs[r][c] = live ? vg[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    float s[kFK];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NJ; ++c) part = fmaf(qr[c], ks[j][c * 4 + t], part);
      const float dot = quad_sum(part);  // every lane shuffles
      s[j] = k0 + j < Sk ? dot : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);  // finite: the first tile holds a live key
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
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < NJ; ++c) o[(bh * Sq + row) * D + c * 4 + t] = acc[c] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                       int Sk, cudaStream_t stream) {
  dim3 grid((Sq + kFR - 1) / kFR, BH);
  splash_fwd_f32_kernel<D><<<grid, kFThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/out [batch_heads, sq, d], k/v [batch_heads, sk, d]; d in {64, 128};
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
int tdm_splash_fwd(const void* q, const void* k, const void* v, void* out, int batch_heads,
                   int sq, int sk, int d, int dtype, void* stream) {
  if (batch_heads <= 0 || batch_heads > 65535 || sq <= 0 || sk <= 0 || (d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)(d == 64 ? launch_bf16<64>(q, k, v, out, batch_heads, sq, sk, s)
                         : launch_bf16<128>(q, k, v, out, batch_heads, sq, sk, s));
  if (dtype == 0)
    return (int)(d == 64 ? launch_f32<64>(q, k, v, out, batch_heads, sq, sk, s)
                         : launch_f32<128>(q, k, v, out, batch_heads, sq, sk, s));
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
