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
// get a -inf logit and zero K/V rows in shared memory (cp.async zero-fill),
// query rows >= Sq are computed on zero rows and never stored. The TPU
// path's pad-key correction out / (1 - n_pad*exp(-lse)) (:225-229) is NOT
// carried over: it fails when a row's real logits all lie well below 0.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
// SD3-Medium 1024px joint attention, B=4 H=24 S=4096+333=4429 D=64 bf16:
// 4*B*H*S*S*D = 482 GFLOP against 9.1 MB of q, k, v and out moved ->
// operations-bound, 0.487 ms. So the design feeds the tensor cores and keeps
// the S x S scores out of device memory:
//   * a block owns 128 query rows of one (b,h) (8 warps x 16 rows); its Q
//     tile stays in registers as mma A fragments; it walks the keys in
//     64-key tiles, so each K/V tile is read from shared memory once for
//     128 queries;
//   * K/V tiles are double-buffered with cp.async: tile j+1 streams in
//     while tile j is multiplied;
//   * fragments come from shared memory with ldmatrix (V with .trans, so V
//     stays row-major and needs no transposing pass); the row stride is
//     D+8 elements, which keeps the 8 rows of each 8x8 matrix on distinct
//     banks;
//   * D = 64 and 128 are native mma widths (no zero-padding of D), and
//     S = 4429 = 69*64 + 13 leaves 13 live keys in the last tile, masked by
//     index only there;
//   * grid x runs over the query tiles of one (b,h), so the blocks in flight
//     share that head's K/V (1.1 MB at the SD3 shape) in L2.
// This is the simple first version: mma.sync m16n8k16 (fp32 accumulate), no
// wgmma/TMA, no warp specialisation. fp32 (tests and tiny configs on the
// card) goes through a scalar-FMA kernel.
//
// Layout: q/out [BH,Sq,D], k/v [BH,Sk,D], contiguous, 16-byte aligned (the
// wrapper checks). C interface (loaded with ctypes): tdm_splash_fwd returns a
// cudaError_t code (0 on success) after cudaGetLastError() right after the
// launch.

#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int kSplashThreads = 256;  // 8 warps
constexpr int kSBQ = 128;            // query rows per block (16 per warp)
constexpr int kSBK = 64;             // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes instead.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0+ROWS) of a [S, D] matrix into smem [ROWS][D+8] with
// cp.async; rows past S are zero-filled (their source address is row 0's,
// never read).
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* sm, const bf16* g, int row0, int S) {
  constexpr int RS = D + 8, CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kSplashThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool live = row0 + r < S;
    cp_async_16(sm + r * RS + c, g + (size_t)(live ? row0 + r : 0) * D + c, live ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kSplashThreads)
splash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk) {
  constexpr int RS = D + 8;     // smem row stride (elements)
  constexpr int KSTEPS = D / 16;  // 16-deep k steps of Q.K^T
  constexpr int NT = kSBK / 8;    // score n-tiles per key tile
  constexpr int ND = D / 8;       // output n-tiles

  const int q0 = blockIdx.x * kSBQ;
  const size_t bh = blockIdx.y;
  const bf16* qg = q + bh * Sq * D;
  const bf16* kg = k + bh * Sk * D;
  const bf16* vg = v + bh * Sk * D;
  bf16* og = o + bh * Sq * D;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kSBQ][RS]
  bf16* ks = qs + kSBQ * RS;                      // [2][kSBK][RS]
  bf16* vs = ks + 2 * kSBK * RS;                  // [2][kSBK][RS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row in matrix, matrix

  const int n_tiles = (Sk + kSBK - 1) / kSBK;
  stage_rows<D, kSBQ>(qs, qg, q0, Sq);
  stage_rows<D, kSBK>(ks, kg, 0, Sk);
  stage_rows<D, kSBK>(vs, vg, 0, Sk);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows as A fragments: matrices (rows 0-7 | 8-15) x
  // (cols 0-7 | 8-15) of each 16-deep step are a0..a3
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + (lm & 1) * 8 + lr) * RS + kk * 16 + (lm >> 1) * 8);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units) of rows g, g+8
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the running sum

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kSBK;
    const bf16* kt = ks + (j & 1) * kSBK * RS;
    const bf16* vt = vs + (j & 1) * kSBK * RS;
    if (j + 1 < n_tiles) {  // the other buffer was released by the last sync
      stage_rows<D, kSBK>(ks + ((j + 1) & 1) * kSBK * RS, kg, k0 + kSBK, Sk);
      stage_rows<D, kSBK>(vs + ((j + 1) & 1) * kSBK * RS, vg, k0 + kSBK, Sk);
      cp_async_commit();
    }

    // S = Q K^T, 16 rows x 64 keys. One ldmatrix.x4 over 8 keys x 32 dims
    // gives the B fragments of two k steps.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t b[4];
        ldsm_x4(b, kt + (n * 8 + lr) * RS + kk * 16 + lm * 8);
        mma_16816(s[n], qf[kk], b[0], b[1]);
        mma_16816(s[n], qf[kk + 1], b[2], b[3]);
      }
    }

    // log2 units; keys past Sk (the last tile only) get -inf
    const bool tail = k0 + kSBK > Sk;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= kLog2e;
      if (tail) {
        const int c = k0 + n * 8 + t * 2;
        if (c >= Sk) s[n][0] = s[n][2] = -INFINITY;
        if (c + 1 >= Sk) s[n][1] = s[n][3] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // the first tile always holds a live key, so the new max is finite
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = fast_exp2(s[n][0] - mn0);
      s[n][1] = fast_exp2(s[n][1] - mn0);
      s[n][2] = fast_exp2(s[n][2] - mn1);
      s[n][3] = fast_exp2(s[n][3] - mn1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = al0 * l0 + rs0;  // summed over the quad once, at the end
    l1 = al1 * l1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0; acc[n][1] *= al0; acc[n][2] *= al1; acc[n][3] *= al1;
    }

    // O += P V with P rounded to bf16. One ldmatrix.x4.trans over 16 keys x
    // 16 dims of row-major V gives the B fragments of two output n-tiles.
#pragma unroll
    for (int kk = 0; kk < kSBK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vt + (kk * 16 + (lm & 1) * 8 + lr) * RS + (n + (lm >> 1)) * 8);
        mma_16816(acc[n], pa, b[0], b[1]);
        mma_16816(acc[n + 1], pa, b[2], b[3]);
      }
    }

    cp_async_wait_all();  // tile j+1 has landed ...
    __syncthreads();      // ... for every thread, and tile j's readers are done
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t * 2;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(og + (size_t)r0 * D + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(og + (size_t)r1 * D + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                        int Sk, cudaStream_t stream) {
  const size_t smem = (size_t)(kSBQ + 4 * kSBK) * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(splash_fwd_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kSBQ - 1) / kSBQ, BH);
  splash_fwd_bf16_kernel<D><<<grid, kSplashThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk);
  return cudaGetLastError();
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
