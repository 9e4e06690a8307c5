// Pieces shared by the attention kernels of this directory: the constants
// of the TPU kernels' masking arithmetic, quad reductions and bf16 packing
// (all of them, and attn_fwd_sm90.cuh); the bf16 tensor-core instruction of
// the backward kernels (mma.sync m16n8k16, fp32 accumulate) and their
// shared-memory staging of [rows, D] tiles with D zero-padded to a multiple
// of 16; the head-dim dispatch of the fp32 scalar kernels.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4*g + t):
//   A [16 x 16]: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B [16 x 8] : b0 = B[2t..2t+1][g],  b1 = B[2t+8..2t+9][g]
//   C [16 x 8] : c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// So B is read from a tile stored [n][k] (two k-adjacent elements = one
// 32-bit load), and the accumulators of two adjacent n-tiles are exactly the
// A fragment of one 16-deep k step (how P or dS feeds the next product).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;    // the TPU kernels' _NEG_INF: key bias of a masked key
constexpr float kValidMax = -1e29f;  // rows whose running max stayed below are all-masked
constexpr float kLseMasked = 1e30f;  // lse of an all-masked or padded row: exp(s - lse) = 0
constexpr int kThreads = 128;        // 4 warps: the backward and fp32 kernels

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of one 16-deep k step from the accumulators of two
// adjacent 8-wide n-tiles (rounded to bf16).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// A fragments of 16 rows (row 0 at `rows`) of a [*, DP+8] shared tile.
template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DP / 16][4], const bf16* rows,
                                             int g, int t) {
  constexpr int RS = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    f[kk][0] = lds32(rows + g * RS + kk * 16 + t * 2);
    f[kk][1] = lds32(rows + (g + 8) * RS + kk * 16 + t * 2);
    f[kk][2] = lds32(rows + g * RS + kk * 16 + 8 + t * 2);
    f[kk][3] = lds32(rows + (g + 8) * RS + kk * 16 + 8 + t * 2);
  }
}

// rows [row0, row0+ROWS) of a [S, D] matrix into smem [ROWS][DP+8], zero
// outside the matrix (past S, and columns D..DP).
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g, int row0, int S, int D,
                                          bool vec) {
  constexpr int RS = DP + 8;
  if (vec) {  // D % 8 == 0 and 16-byte aligned: one uint4 = 8 elements
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < S && c < D)
        val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + c);
      *reinterpret_cast<uint4*>(sm + r * RS + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      bf16 val = __float2bfloat16(0.f);
      if (row0 + r < S && c < D) val = g[(size_t)(row0 + r) * D + c];
      sm[r * RS + c] = val;
    }
  }
}

// The same rows stored transposed, smem [DP][ROWS+8] (column d of the tile
// is one contiguous row): the [n][k] layout of a B operand whose k runs
// over the rows.
template <int DP, int ROWS>
__device__ __forceinline__ void load_transposed(bf16* sm, const bf16* g, int row0, int S, int D,
                                                bool vec) {
  constexpr int TS = ROWS + 8;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < S && c < D)
        val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) sm[(c + j) * TS + r] = e[j];
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      bf16 val = __float2bfloat16(0.f);
      if (row0 + r < S && c < D) val = g[(size_t)(row0 + r) * D + c];
      sm[c * TS + r] = val;
    }
  }
}

// Sum over the four lanes (t = 0..3) that share a row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// Dispatch on the padded head dim: F<DP>() for DP = 16·ceil(d/16) (bf16
// tensor-core kernels) ...
template <template <int> class F, typename... Args>
cudaError_t by_padded_dim_bf16(int d, Args... args) {
  switch ((d + 15) / 16) {
    case 1: return F<16>::run(args...);
    case 2: return F<32>::run(args...);
    case 3: return F<48>::run(args...);
    case 4: return F<64>::run(args...);
    case 5: return F<80>::run(args...);
    case 6: return F<96>::run(args...);
    case 7: return F<112>::run(args...);
    default: return F<128>::run(args...);
  }
}

// ... and F<NJ>() with NJ = 8·ceil(d/32) columns per lane (fp32 scalar
// kernels, four lanes per row).
template <template <int> class F, typename... Args>
cudaError_t by_padded_dim_f32(int d, Args... args) {
  switch ((d + 31) / 32) {
    case 1: return F<8>::run(args...);
    case 2: return F<16>::run(args...);
    case 3: return F<24>::run(args...);
    default: return F<32>::run(args...);
  }
}

}  // namespace

extern "C" const char* tdm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
