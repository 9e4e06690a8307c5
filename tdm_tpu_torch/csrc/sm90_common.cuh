// Hopper (sm_90a) primitives shared by the attention kernels of this
// directory: the forward mainloop (attn_fwd_sm90.cuh) and the backward
// kernels (flash_bwd_dq.cu, flash_bwd_dkv.cu).
//   * mbarriers, TMA loads and stores of 3-D tiles (cp.async.bulk.tensor);
//   * wgmma (bf16 in, fp32 accumulate): SS with N = 128 or 64 (both operands
//     K-major in swizzled shared memory), RS with N = 64, 32 or 16 (A in
//     registers, B MN-major through the descriptor's transpose bit), and
//     product_abt, A B^T of 64 by 64 rows over a padded head dim of 64, 80,
//     128 or 160;
//   * shared-memory matrix descriptors for 64-column panels (128-byte
//     swizzle), 32-column panels (64-byte swizzle) and 16-column panels
//     (32-byte swizzle), and the byte offset that swizzle gives an element
//     pair;
//   * the host side: binding the current device's context to the calling
//     thread, the 16-byte alignment check, cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint (no driver stub is linked), and the
//     map of one head-dim panel of a bf16 [B*H, S, D] tensor.
// A tile of W columns is stored as TMA writes it: rows of W*2 bytes, the
// 16-byte chunks of row r XORed with r's bits (r % 8 for W = 64, (r / 2) % 4
// for W = 32, (r / 4) % 2 for W = 16). Every panel starts on a 1024-byte
// boundary.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {
namespace sm90 {

constexpr int kWgRows = 64;  // rows per consumer warpgroup (wgmma's M)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of the given parity has completed. A wait
// that never ends (a fault in the pipeline) traps after ~4M polls instead of
// holding the card: the launch then fails with an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of a register that an
// asynchronous wgmma owns across the fence.
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

// A panel of W columns (64, 32 or 16), rows of W*2 bytes written by TMA with
// the matching swizzle. K-major: 8-row groups SBO apart (8 rows x W*2
// bytes); MN-major (V read transposed): 8-row groups along K the same
// distance apart; one MN block per panel, so LBO is never stepped.
template <int W>
__device__ __forceinline__ uint64_t panel_desc(uint32_t addr) {
  static_assert(W == 64 || W == 32 || W == 16, "panel width");
  return make_desc(addr, 16, 8 * W * 2, W == 64 ? 1 : W == 32 ? 2 : 3);
}

// The byte offset TMA's swizzle gives element pair (row r, column c) of a
// W-column panel: the 16-byte chunk index XOR the row's bits above it.
template <int W>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  const uint32_t off = r * W * 2 + c * 2;
  return off ^ (((off >> 7) & (W == 64 ? 7u : W == 32 ? 3u : 1u)) << 4);
}

__device__ __forceinline__ float exp2_approx(float x) {  // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma (bf16 in, fp32 accumulate)
// ---------------------------------------------------------------------------

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 16] += A[64 x 16] * B[16 x 16], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d = A B^T over the padded head dim DP (64, 80, 128 or 160): A is 64 rows
// whose panels start at a0, a1 and a2, B a tile of 64 rows at b, both in
// the panel layout (panel 0 of 64 columns, then panel 1 of DP - 64 columns,
// or at DP = 160 panel 1 of 64 and panel 2 of 32 with the 64-byte swizzle).
template <int DP>
__device__ __forceinline__ void product_abt(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t b,
                                            uint32_t a2 = 0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(d, panel_desc<64>(a0 + kk * 32), panel_desc<64>(b + kk * 32), kk > 0);
  if constexpr (DP == 80) {
    wgmma_ss_n64(d, panel_desc<16>(a1), panel_desc<16>(b + 64 * 128), 1);
  } else if constexpr (DP == 128 || DP == 160) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(d, panel_desc<64>(a1 + kk * 32), panel_desc<64>(b + 64 * 128 + kk * 32), 1);
  }
  if constexpr (DP == 160) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss_n64(d, panel_desc<32>(a2 + kk * 32), panel_desc<32>(b + 64 * 256 + kk * 32), 1);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Makes the current device's primary context current on the calling host
// thread. A thread that never selected a device has none (autograd runs the
// backward on such a worker thread), and cuTensorMapEncodeTiled, a driver
// call, then fails (the launch returns cudaErrorInvalidValue) until a
// runtime call binds one. Call it before encoding the maps.
inline cudaError_t bind_current_device() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

// True when every pointer is 16-byte aligned, as TMA needs a tensor's base.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a head-dim panel of a bf16 [B*H, S, D] tensor: boxes of
// `width` columns (64, 32 or 16, with the 128-, 64- or 32-byte swizzle) and
// box_rows rows; the panel's first column is given at each load or store.
// Elements past D or S are read as zeros and never written.
inline bool encode_panel(CUtensorMap* map, const void* ptr, int D, int S, int BH, int width,
                         int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)width, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
            : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace
