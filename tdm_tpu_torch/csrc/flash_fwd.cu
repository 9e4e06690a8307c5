// Flash-attention forward for Hopper (sm_90a), inference variant (no logsumexp).
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel` with with_lse=False
// (tdm_tpu/ops/attention.py:291-350, driven by `_fwd_core` :437-528 through
// `_flash_fwd_kernel_nolse` :399-405). Same function:
//   out[b,h,i,:] = sum_j softmax_j(q_scaled[b,h,i,:] . k[b,h,j,:] + bias[b,j]) v[b,h,j,:]
// where q arrives PRE-SCALED (rounded to its own dtype by the caller), bias is
// 0 for a real key and -1e30 for a masked one, the softmax runs online in fp32
// and a row whose keys are all masked (running max still ~ -1e30) outputs 0.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//   * PixArt self-attention, B=4 H=16 S=1024 D=72 bf16: 4*B*H*S*S*D = 19.3
//     GFLOP against 37.7 MB moved -> operations-bound (0.0195 ms vs 0.0113 ms).
//   * PixArt cross-attention, Sq=1024 Sk=120 (masked T5 tokens): 2.3 GFLOP
//     against 21.1 MB moved (q and out dominate) -> bytes-bound (0.0063 ms).
// The design keeps the Sq x Sk score matrix out of device memory (each q/k/v
// element is read from HBM once per q-tile, the output written once) and runs
// both products of the bf16 path on the tensor cores with mma.sync
// m16n8k16 (fp32 accumulate). The TPU kernel's sequential k grid axis becomes
// a loop inside the block; its (8,128) tiling and D->128 padding become a
// 64x64 tile with D zero-padded to a multiple of 16 in shared memory only
// (72 -> 80). This is the simple first version: one stage, no cp.async/TMA,
// no wgmma, no warp specialisation.
//
// Layout: q/out [B,H,Sq,D], k/v [B,H,Sk,D], contiguous; bias [B,Sk] fp32 or
// null (no mask). Any D in [1,128]. bf16 goes through the tensor-core kernel;
// fp32 through a scalar-FMA kernel (fp32 has no tensor-core path at full
// precision).
//
// C interface (loaded with ctypes): tdm_flash_fwd returns a cudaError_t code
// (0 on success) after checking cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's _NEG_INF
constexpr float kValidMax = -1e29f; // rows whose running max stayed below are all-masked
constexpr int kThreads = 128;       // 4 warps

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel. Block = 64 query rows (16 per warp) of one (b,h);
// loop over 64-key tiles staged in shared memory.
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kVS = kBK + 8;  // row stride (elements) of the transposed V tile

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0+64) of a [S, D] matrix into smem [64][DP+8], zero outside.
template <int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* sm, const __nv_bfloat16* g,
                                          int row0, int S, int D, bool vec) {
  constexpr int QS = DP + 8;
  if (vec) {  // D % 8 == 0 and 16-byte aligned: one uint4 = 8 elements
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < 64 * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < S && c < D)
        val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + c);
      *reinterpret_cast<uint4*>(sm + r * QS + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < 64 * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (row0 + r < S && c < D) val = g[(size_t)(row0 + r) * D + c];
      sm[r * QS + c] = val;
    }
  }
}

// keys [k0, k0+64) of V [Sk, D] into smem transposed: vt[d][key], zero outside.
template <int DP>
__device__ __forceinline__ void load_v_transposed(__nv_bfloat16* vt, const __nv_bfloat16* g,
                                                  int k0, int S, int D, bool vec) {
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S && c < D)
        val = *reinterpret_cast<const uint4*>(g + (size_t)(k0 + r) * D + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * kVS + r] = e[j];
    }
  } else {
    for (int i = threadIdx.x; i < kBK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (k0 + r < S && c < D) val = g[(size_t)(k0 + r) * D + c];
      vt[c * kVS + r] = val;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ o, int H, int Sq, int Sk, int D, int vec) {
  constexpr int QS = DP + 8;  // row stride of the Q and K tiles (bank-conflict-free fragments)
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = kBK / 8;  // score n-tiles per key tile
  constexpr int ND = DP / 8;   // output n-tiles

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const __nv_bfloat16* qg = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kg = k + (size_t)bh * Sk * D;
  const __nv_bfloat16* vg = v + (size_t)bh * Sk * D;
  __nv_bfloat16* og = o + (size_t)bh * Sq * D;
  const float* bg = bias ? bias + (size_t)(bh / H) * Sk : nullptr;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * QS;
  __nv_bfloat16* vt = ks + kBK * QS;
  float* bs = reinterpret_cast<float*>(vt + DP * kVS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_rows<DP>(qs, qg, q0, Sq, D, vec);
  __syncthreads();

  // this warp's 16 query rows as A fragments, kept in registers
  uint32_t qf[KSTEPS][4];
  const __nv_bfloat16* qw = qs + warp * 16 * QS;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qf[kk][0] = lds32(qw + g * QS + kk * 16 + t * 2);
    qf[kk][1] = lds32(qw + (g + 8) * QS + kk * 16 + t * 2);
    qf[kk][2] = lds32(qw + g * QS + kk * 16 + 8 + t * 2);
    qf[kk][3] = lds32(qw + (g + 8) * QS + kk * 16 + 8 + t * 2);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows g and g+8
  float l0 = 0.f, l1 = 0.f;          // running sum

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<DP>(ks, kg, k0, Sk, D, vec);
    load_v_transposed<DP>(vt, vg, k0, Sk, D, vec);
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
      const __nv_bfloat16* kr = ks + (n * 8 + g) * QS + t * 2;
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
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
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
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = al0 * l0 + rs0;
    l1 = al1 * l1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0; acc[n][1] *= al0; acc[n][2] *= al1; acc[n][3] *= al1;
    }

    // O += P V: the score accumulators of two adjacent n-tiles are exactly
    // the A fragment of one 16-key step (P rounded to bf16, as the TPU
    // kernel rounds p to v's dtype)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = vt + (n * 8 + g) * kVS + kk * 16 + t * 2;
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
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* o,
                        int B, int H, int Sq, int Sk, int D, int vec, cudaStream_t stream) {
  const size_t smem = (size_t)(kBQ * (DP + 8) + kBK * (DP + 8) + DP * kVS) * 2 + kBK * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_bf16_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(o), H, Sq, Sk, D,
      vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: scalar-FMA kernel. Block = 32 query rows of one (b,h), 4 lanes per
// row; lane t owns columns t, t+4, t+8, ... Loop over 32-key tiles.
// ---------------------------------------------------------------------------

constexpr int kFR = 32;  // query rows per block
constexpr int kFK = 32;  // keys per tile

template <int NJ>  // columns per lane; D <= 4*NJ
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ o, int H, int Sq, int Sk, int D) {
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
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = part + bs[j];
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
    const float inv = m > kValidMax ? 1.f / (l == 0.f ? 1.f : l) : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = j * 4 + t;
      if (c < D) og[(size_t)row * D + c] = acc[j] * inv;
    }
  }
}

template <int NJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* bias, void* o,
                       int B, int H, int Sq, int Sk, int D, cudaStream_t stream) {
  dim3 grid(B * H, (Sq + kFR - 1) / kFR);
  flash_fwd_f32_kernel<NJ><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(o), H, Sq, Sk, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec: 1 when D % 8 == 0 and every pointer
// is 16-byte aligned (bf16 path only). Returns a cudaError_t code.
int tdm_flash_fwd(const void* q, const void* k, const void* v, const float* bias, void* out,
                  int batch, int heads, int sq, int sk, int d, int dtype, int vec, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 128 ||
      (sq + kFR - 1) / kFR > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch ((d + 15) / 16) {
      case 1: return (int)launch_bf16<16>(q, k, v, bias, out, batch, heads, sq, sk, d, vec, s);
      case 2: return (int)launch_bf16<32>(q, k, v, bias, out, batch, heads, sq, sk, d, vec, s);
      case 3: return (int)launch_bf16<48>(q, k, v, bias, out, batch, heads, sq, sk, d, vec, s);
      case 4: return (int)launch_bf16<64>(q, k, v, bias, out, batch, heads, sq, sk, d, vec, s);
      case 5: return (int)launch_bf16<80>(q, k, v, bias, out, batch, heads, sq, sk, d, vec, s);
      case 6: return (int)launch_bf16<96>(q, k, v, bias, out, batch, heads, sq, sk, d, vec, s);
      case 7: return (int)launch_bf16<112>(q, k, v, bias, out, batch, heads, sq, sk, d, vec, s);
      default: return (int)launch_bf16<128>(q, k, v, bias, out, batch, heads, sq, sk, d, vec, s);
    }
  }
  if (dtype == 0) {
    switch ((d + 31) / 32) {
      case 1: return (int)launch_f32<8>(q, k, v, bias, out, batch, heads, sq, sk, d, s);
      case 2: return (int)launch_f32<16>(q, k, v, bias, out, batch, heads, sq, sk, d, s);
      case 3: return (int)launch_f32<24>(q, k, v, bias, out, batch, heads, sq, sk, d, s);
      default: return (int)launch_f32<32>(q, k, v, bias, out, batch, heads, sq, sk, d, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* tdm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
