// Pieces shared by the attention kernels of this directory: the constants
// of the TPU kernels' masking arithmetic, quad reductions and bf16 packing
// (all of them, with sm90_common.cuh for the Hopper kernels), and the
// block size and head-dim dispatch of the fp32 scalar kernels.
//
// A quad is the four lanes (t = lane % 4 = 0..3) that share row g = lane / 4
// of a warp's 8-row slice of a wgmma accumulator, or one row of an fp32
// scalar kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;    // the TPU kernels' _NEG_INF: key bias of a masked key
constexpr float kValidMax = -1e29f;  // rows whose running max stayed below are all-masked
constexpr float kLseMasked = 1e30f;  // lse of an all-masked or padded row: exp(s - lse) = 0
constexpr int kThreads = 128;        // 4 warps: the fp32 kernels

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
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

// Dispatch on the head dim of the fp32 scalar kernels: F<NJ>() with NJ =
// 8·ceil(d/32) columns per lane (four lanes per row).
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
