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
//     against 21.1 MB moved (q and out dominate) -> bytes-bound (0.0063 ms).
//   The lse adds 4 bytes per query row (0.26 MB at these shapes).
// The design keeps the Sq x Sk score matrix out of device memory (each q/k/v
// element is read from HBM once per q-tile, the output written once) and runs
// both products of the bf16 path on the tensor cores with mma.sync
// m16n8k16 (fp32 accumulate). The TPU kernel's sequential k grid axis becomes
// a loop inside the block; its (8,128) tiling and D->128 padding become a
// 64x64 tile with D zero-padded to a multiple of 16 in shared memory only
// (72 -> 80). The lse output is a template flag of the same kernel, so the
// inference variant carries no cost for it. This is the simple first
// version: one stage, no cp.async/TMA, no wgmma, no warp specialisation.
//
// Layout: q/out [B,H,Sq,D], k/v [B,H,Sk,D], contiguous; bias [B,Sk] fp32 or
// null (no mask); lse [B,H,Sq] fp32 or null (not wanted). Any D in [1,128].
// bf16 goes through the tensor-core kernel; fp32 through a scalar-FMA kernel
// (fp32 has no tensor-core path at full precision).
//
// C interface (loaded with ctypes): tdm_flash_fwd returns a cudaError_t code
// (0 on success) after checking cudaGetLastError() right after the launch.

#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel. Block = 64 query rows (16 per warp) of one (b,h);
// loop over 64-key tiles staged in shared memory.
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kVS = kBK + 8;  // row stride (elements) of the transposed V tile

template <int DP, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      bf16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                      int D, int vec) {
  constexpr int QS = DP + 8;  // row stride of the Q and K tiles (bank-conflict-free fragments)
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = kBK / 8;  // score n-tiles per key tile
  constexpr int ND = DP / 8;   // output n-tiles

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const bf16* qg = q + (size_t)bh * Sq * D;
  const bf16* kg = k + (size_t)bh * Sk * D;
  const bf16* vg = v + (size_t)bh * Sk * D;
  bf16* og = o + (size_t)bh * Sq * D;
  const float* bg = bias ? bias + (size_t)(bh / H) * Sk : nullptr;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBQ * QS;
  bf16* vt = ks + kBK * QS;
  float* bs = reinterpret_cast<float*>(vt + DP * kVS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_rows<DP, kBQ>(qs, qg, q0, Sq, D, vec);
  __syncthreads();

  // this warp's 16 query rows as A fragments, kept in registers
  uint32_t qf[KSTEPS][4];
  load_a_frags<DP>(qf, qs + warp * 16 * QS, g, t);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows g and g+8
  float l0 = 0.f, l1 = 0.f;          // running sum

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<DP, kBK>(ks, kg, k0, Sk, D, vec);
    load_transposed<DP, kBK>(vt, vg, k0, Sk, D, vec);
    if (threadIdx.x < kBK) {
      const int j = k0 + threadIdx.x;
      bs[threadIdx.x] = j < Sk ? (bg ? bg[j] : 0.f) : kNegInf;  // ragged tail masked exactly
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* kr = ks + (n * 8 + g) * QS + t * 2;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_16816(s[n], qf[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
    }

    // key bias, then the online-softmax update
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = bs[n * 8 + t * 2], b1 = bs[n * 8 + t * 2 + 1];
      s[n][0] += b0; s[n][1] += b1; s[n][2] += b0; s[n][3] += b1;
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = __expf(s[n][0] - mn0); s[n][1] = __expf(s[n][1] - mn0);
      s[n][2] = __expf(s[n][2] - mn1); s[n][3] = __expf(s[n][3] - mn1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = al0 * l0 + quad_sum(rs0);
    l1 = al1 * l1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0; acc[n][1] *= al0; acc[n][2] *= al1; acc[n][3] *= al1;
    }

    // O += P V, P rounded to bf16 as the TPU kernel rounds p to v's dtype
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* vr = vt + (n * 8 + g) * kVS + kk * 16 + t * 2;
        mma_16816(acc[n], pa, lds32(vr), lds32(vr + 8));
      }
    }
  }

  // rows that never saw an unmasked key output 0
  const bool ok0 = m0 > kValidMax, ok1 = m1 > kValidMax;
  const float inv0 = ok0 ? 1.f / (l0 == 0.f ? 1.f : l0) : 0.f;
  const float inv1 = ok1 ? 1.f / (l1 == 0.f ? 1.f : l1) : 0.f;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t * 2;
    if (r0 < Sq) {
      if (c < D) og[(size_t)r0 * D + c] = __float2bfloat16(acc[n][0] * inv0);
      if (c + 1 < D) og[(size_t)r0 * D + c + 1] = __float2bfloat16(acc[n][1] * inv0);
    }
    if (r1 < Sq) {
      if (c < D) og[(size_t)r1 * D + c] = __float2bfloat16(acc[n][2] * inv1);
      if (c + 1 < D) og[(size_t)r1 * D + c + 1] = __float2bfloat16(acc[n][3] * inv1);
    }
  }
  if (LSE && t == 0) {  // the four lanes of a row hold the same m and l
    float* lg = lse + (size_t)bh * Sq;
    if (r0 < Sq) lg[r0] = (ok0 && l0 > 0.f) ? m0 + logf(l0) : kLseMasked;
    if (r1 < Sq) lg[r1] = (ok1 && l1 > 0.f) ? m1 + logf(l1) : kLseMasked;
  }
}

template <int DP, bool LSE>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* o,
                        float* lse, int B, int H, int Sq, int Sk, int D, int vec,
                        cudaStream_t stream) {
  const size_t smem =
      (size_t)(kBQ * (DP + 8) + kBK * (DP + 8) + DP * kVS) * 2 + kBK * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DP, LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_bf16_kernel<DP, LSE><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      static_cast<bf16*>(o), lse, H, Sq, Sk, D, vec);
  return cudaGetLastError();
}

template <int DP>
struct LaunchBf16 {
  static cudaError_t run(const void* q, const void* k, const void* v, const float* bias, void* o,
                         float* lse, int B, int H, int Sq, int Sk, int D, int vec,
                         cudaStream_t s) {
    return lse ? launch_bf16<DP, true>(q, k, v, bias, o, lse, B, H, Sq, Sk, D, vec, s)
               : launch_bf16<DP, false>(q, k, v, bias, o, lse, B, H, Sq, Sk, D, vec, s);
  }
};

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
                         float* lse, int B, int H, int Sq, int Sk, int D, int /*vec*/,
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

// dtype: 0 = float32, 1 = bfloat16. vec: 1 when D % 8 == 0 and every pointer
// is 16-byte aligned (bf16 path only). lse: [B,H,Sq] fp32 output, or null for
// the inference variant. Returns a cudaError_t code.
int tdm_flash_fwd(const void* q, const void* k, const void* v, const float* bias, void* out,
                  float* lse, int batch, int heads, int sq, int sk, int d, int dtype, int vec,
                  void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 128 ||
      (sq + kFR - 1) / kFR > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)by_padded_dim_bf16<LaunchBf16>(d, q, k, v, bias, out, lse, batch, heads, sq, sk,
                                               d, vec, s);
  if (dtype == 0)
    return (int)by_padded_dim_f32<LaunchF32>(d, q, k, v, bias, out, lse, batch, heads, sq, sk, d,
                                             vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
