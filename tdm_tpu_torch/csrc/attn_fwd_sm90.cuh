// The Hopper (sm_90a) attention forward shared by kernel 1 (flash_fwd.cu,
// with a key bias and optionally the logsumexp) and kernel 4 (splash_fwd.cu,
// no bias, no lse). One mainloop, templated on the padded head dim DP
// (64, 80 or 128), the number of consumer warpgroups, HAS_BIAS and WITH_LSE.
//
// Function (bf16 in and out, fp32 softmax):
//   out[bh,i,:] = sum_j softmax_j(q_scaled[bh,i,:] . k[bh,j,:] + bias[b,j]) v[bh,j,:]
//   lse[bh,i]   = log sum_j exp(q_scaled[bh,i,:] . k[bh,j,:] + bias[b,j])
// q arrives pre-scaled; p is rounded to bf16 before the product with v, as
// the TPU kernels round p to v's dtype. Keys >= Sk get -inf by index; with
// HAS_BIAS a batch row whose keys are all masked (bias -1e30) outputs 0 and
// stores the lse sentinel +1e30. Query rows >= Sq are never stored.
//
// What bounds it on an H100 SXM: at the main path's shapes, operations
// (4*Sq*Sk*D flops per head against (2*Sq + 2*Sk)*D*2 bytes), except the
// PixArt cross call (Sk = 120), which moves more bytes than it computes.
// The design is the one Hopper needs to reach its tensor-core rate:
//   * a CTA owns 128 query rows of one (b,h), two consumer warpgroups of 64
//     rows (wgmma's M), or at D = 64 192 rows in three (kGroups), and one
//     producer warpgroup, of which one warp issues the loads; setmaxnreg
//     moves registers from the producer (24) to the consumers (240, or 160
//     for three);
//   * TMA (cp.async.bulk.tensor, 3-D maps [D, S, B*H] built on the host)
//     brings the Q tile once and 128-key K/V tiles through a ring of 2-3
//     stages with full/empty mbarriers; the zero fill past S and past D is
//     the hardware's, so the ragged tails need no copies;
//   * the head dim lives in panels: 64 columns with the 128-byte swizzle,
//     and for DP = 80 a 16-column panel with the 32-byte swizzle (D = 72 is
//     zero-filled to 80 by TMA, not padded in memory), for DP = 128 a second
//     64-column panel;
//   * S = Q K^T is wgmma SS (both operands K-major in swizzled shared
//     memory, fp32 accumulate); P stays in registers, rounded to bf16, as
//     the A operand of O += P V (wgmma RS); V stays row-major and is read
//     MN-major through the descriptor's transpose bit, so no transposing
//     pass is needed;
//   * the softmax runs online in fp32 in log2 units (exp2, log2(e) folded
//     into one multiply);
//   * the epilogue normalises in registers, writes bf16 O into the (by then
//     unused) Q tile in the swizzled layout and stores it with TMA, which
//     clips rows >= Sq and columns >= D.
// Kernel 1's key bias ([Sk] fp32 of the tile's batch row, -inf past Sk) is
// written by the producer warp into a per-stage slot beside its K/V tile.
//
// Requirements (the wrappers see to them): bf16, contiguous, D % 8 == 0
// (TMA's 16-byte row stride), 16-byte aligned bases, B*H <= 65535.
//
// The tensor maps are encoded with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links no driver stub.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"  // pack_bf16, quad_max/sum, kValidMax, kLseMasked

namespace {
namespace sm90 {

constexpr int kWgRows = 64;  // query rows per consumer warpgroup (wgmma's M)
constexpr int kBN = 128;     // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The CTA for padded head dim DP and NWG consumer warpgroups (warpgroup
// NWG produces), and its shared-memory layout in bytes from a 1024-aligned
// base: Q [kBM rows] then, per stage, K and V [kBN rows], each as panel 0
// (64 columns, 128 B per row) followed by panel 1 (W1 columns); then the
// bias slots and the mbarriers.
template <int DP, int NWG>
struct Layout {
  static_assert(DP == 64 || DP == 80 || DP == 128, "padded head dim is 64, 80 or 128");
  static_assert(NWG == 2 || NWG == 3, "two or three consumer warpgroups");
  static constexpr int kBM = NWG * kWgRows;      // query rows per CTA
  static constexpr int kThreads = (NWG + 1) * 128;
  static constexpr int W1 = DP - 64;          // second panel's width (0: none)
  static constexpr int kStages = DP == 128 ? 2 : 3;
  static constexpr int kQ = 0;
  static constexpr int kQ1 = kBM * 64 * 2;   // Q panel 1
  static constexpr int kTile = kBN * DP * 2;  // one K or V tile
  static constexpr int kStage0 = kBM * DP * 2;
  static constexpr int kBias = kStage0 + kStages * 2 * kTile;
  static constexpr int kBars = kBias + kStages * kBN * 4;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

// Consumer warpgroups per CTA at padded head dim DP. Three (192 query rows,
// 160 registers a consumer thread) read each K/V tile for 1.5x the queries
// and give the tensor cores three instruction streams, which runs SD3's
// shape (D = 64) faster than two. At D = 80 and 128 the O accumulators do
// not fit 160 registers (ptxas then serialises the wgmmas, and PixArt's
// shape runs slower), so those keep two warpgroups of 240 registers.
template <int DP>
constexpr int kGroups = DP == 64 ? 3 : 2;

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
// byte offsets (16-byte units), swizzle (1 = 128 B, 3 = 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

// A panel of W columns (64 or 16), rows of W*2 bytes written by TMA with the
// matching swizzle. K-major: 8-row groups SBO apart (8 rows x W*2 bytes);
// MN-major (V read transposed): 8-row groups along K the same distance
// apart; one MN block per panel, so LBO is never stepped.
template <int W>
__device__ __forceinline__ uint64_t panel_desc(uint32_t addr) {
  static_assert(W == 64 || W == 16, "panel width");
  return make_desc(addr, 16, 8 * W * 2, W == 64 ? 1 : 3);
}

// The byte offset TMA's swizzle gives element pair (row r, column c) of a
// W-column panel: the 16-byte chunk index XOR the row's bits above it.
template <int W>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  const uint32_t off = r * W * 2 + c * 2;
  return off ^ (((off >> 7) & (W == 64 ? 7u : 1u)) << 4);
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

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// q, k, v and out as 3-D tensor maps [D, S, B*H], one per head-dim panel:
// box [64 or W1 columns, kWgRows rows] for q and out (one box per consumer
// warpgroup), [.., kBN rows] for k and v.
struct AttnMaps {
  CUtensorMap q[2], k[2], v[2], o[2];
};

// The whole kernel, for a __global__ wrapper of Layout::kThreads threads (one CTA
// per SM) that passes its __grid_constant__ maps by reference: each .cu
// file names its own kernel, so a profile tells kernel 1 from kernel 4.
template <int DP, int NWG, bool HAS_BIAS, bool WITH_LSE>
__device__ __forceinline__ void attn_fwd_mainloop(const AttnMaps& maps,
                                                  const float* __restrict__ bias,
                                                  float* __restrict__ lse, int H, int Sq,
                                                  int Sk) {
  using L = Layout<DP, NWG>;
  constexpr int W1 = L::W1;
  constexpr int NST = L::kStages;
  constexpr int kBM = L::kBM;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + NST;
  uint64_t* q_full = empty + NST;
  float* bias_s = reinterpret_cast<float*>(smem + L::kBias);
  const uint32_t base = smem_u32(smem);

  const int q0 = blockIdx.x * kBM;
  const int bh = blockIdx.y;
  const int n_tiles = (Sk + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], HAS_BIAS ? 32 : 1);  // HAS_BIAS: the whole producer warp arrives
      mbar_init(&empty[s], 4 * NWG);  // every consumer warp arrives
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp != 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, kBM * DP * 2);
      for (int w = 0; w < NWG; ++w) {
        const int row = q0 + w * kWgRows;
        tma_load_3d(base + L::kQ + w * kWgRows * 128, &maps.q[0], q_full, 0, row, bh);
        if (W1)
          tma_load_3d(base + L::kQ1 + w * kWgRows * W1 * 2, &maps.q[1], q_full, 64, row, bh);
      }
    }
    const float* brow = (HAS_BIAS && bias) ? bias + (size_t)(bh / H) * Sk : nullptr;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % NST;
      if (j >= NST) mbar_wait(&empty[s], ((j / NST) & 1) ^ 1);
      const int k0 = j * kBN;
      if (lane == 0) {
        if (HAS_BIAS)
          mbar_expect_tx(&full[s], 2 * L::kTile);
        else
          mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        const uint32_t kt = base + L::kStage0 + s * 2 * L::kTile, vt = kt + L::kTile;
        tma_load_3d(kt, &maps.k[0], &full[s], 0, k0, bh);
        tma_load_3d(vt, &maps.v[0], &full[s], 0, k0, bh);
        if (W1) {
          tma_load_3d(kt + kBN * 128, &maps.k[1], &full[s], 64, k0, bh);
          tma_load_3d(vt + kBN * 128, &maps.v[1], &full[s], 64, k0, bh);
        }
      }
      if (HAS_BIAS) {
        for (int i = lane; i < kBN; i += 32) {
          const int key = k0 + i;
          bias_s[s * kBN + i] = key < Sk ? (brow ? brow[key] : 0.f) : -INFINITY;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---------------- consumers: 64 query rows per warpgroup ----------------
  if constexpr (NWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
  const int g = lane >> 2, t = lane & 3;
  const uint32_t q_p0 = base + L::kQ + wg * kWgRows * 128;
  const uint32_t q_p1 = base + L::kQ1 + wg * kWgRows * W1 * 2;

  float o0[32];
  float o1[W1 ? W1 / 2 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (W1 ? W1 / 2 : 1); ++i) o1[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units) of rows g, g+8
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the running sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NST;
    const int k0 = j * kBN;
    mbar_wait(&full[s], (j / NST) & 1);
    const uint32_t kt = base + L::kStage0 + s * 2 * L::kTile, vt = kt + L::kTile;

    // S = Q K^T: 64 rows x 128 keys, 16 columns of the head dim per step
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n128(sc, panel_desc<64>(q_p0 + kk * 32), panel_desc<64>(kt + kk * 32), kk > 0);
    if constexpr (W1 == 16) {
      wgmma_ss_n128(sc, panel_desc<16>(q_p1), panel_desc<16>(kt + kBN * 128), 1);
    } else if constexpr (W1 == 64) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128(sc, panel_desc<64>(q_p1 + kk * 32),
                      panel_desc<64>(kt + kBN * 128 + kk * 32), 1);
    }
    wgmma_commit_and_wait();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(sc[i]);

    // log2 units; the key bias, or -inf past Sk by index
    float mx0 = -INFINITY, mx1 = -INFINITY;
    const bool tail = k0 + kBN > Sk;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = n * 8 + t * 2;
      if constexpr (HAS_BIAS) {
        const float2 b = *reinterpret_cast<const float2*>(&bias_s[s * kBN + c]);
        sc[4 * n + 0] = (sc[4 * n + 0] + b.x) * kLog2e;
        sc[4 * n + 1] = (sc[4 * n + 1] + b.y) * kLog2e;
        sc[4 * n + 2] = (sc[4 * n + 2] + b.x) * kLog2e;
        sc[4 * n + 3] = (sc[4 * n + 3] + b.y) * kLog2e;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * n + e] *= kLog2e;
        if (tail) {
          if (k0 + c >= Sk) sc[4 * n + 0] = sc[4 * n + 2] = -INFINITY;
          if (k0 + c + 1 >= Sk) sc[4 * n + 1] = sc[4 * n + 3] = -INFINITY;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n + 0], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    // key 0 is live (or carries the finite -1e30 bias), so the max is finite
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2_approx(m0 - mn0), al1 = exp2_approx(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      sc[4 * n + 0] = exp2_approx(sc[4 * n + 0] - mn0);
      sc[4 * n + 1] = exp2_approx(sc[4 * n + 1] - mn0);
      sc[4 * n + 2] = exp2_approx(sc[4 * n + 2] - mn1);
      sc[4 * n + 3] = exp2_approx(sc[4 * n + 3] - mn1);
      rs0 += sc[4 * n + 0] + sc[4 * n + 1];
      rs1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
    l0 = al0 * l0 + rs0;
    l1 = al1 * l1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o0[4 * n + 0] *= al0; o0[4 * n + 1] *= al0;
      o0[4 * n + 2] *= al1; o0[4 * n + 3] *= al1;
    }
    if constexpr (W1 != 0) {
#pragma unroll
      for (int n = 0; n < W1 / 8; ++n) {
        o1[4 * n + 0] *= al0; o1[4 * n + 1] *= al0;
        o1[4 * n + 2] *= al1; o1[4 * n + 3] *= al1;
      }
    }

    // O += P V: P rounded to bf16 in the A-operand layout (the accumulators
    // of two adjacent 8-key column blocks form one 16-key step)
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(o0[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_rs_n64(o0, pa[kk], panel_desc<64>(vt + kk * 16 * 128));
      if constexpr (W1 == 16)
        wgmma_rs_n16(o1, pa[kk], panel_desc<16>(vt + kBN * 128 + kk * 16 * 32));
      else if constexpr (W1 == 64)
        wgmma_rs_n64(o1, pa[kk], panel_desc<64>(vt + kBN * 128 + kk * 16 * 128));
    }
    wgmma_commit_and_wait();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(pa[kk][e]);
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(o0[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  // epilogue: normalise; rows that saw no unmasked key output 0
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool ok0 = !HAS_BIAS || m0 > kValidMax, ok1 = !HAS_BIAS || m1 > kValidMax;
  const float inv0 = ok0 ? 1.f / l0 : 0.f, inv1 = ok1 ? 1.f / l1 : 0.f;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // rows within this warpgroup's 64
  // bf16 O into this warpgroup's Q rows (its last S product has completed),
  // in the swizzled layout of the output maps
  unsigned char* qs0 = smem + L::kQ + wg * kWgRows * 128;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(qs0 + swizzled<64>(r0, c)) =
        pack_bf16(o0[4 * n + 0] * inv0, o0[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(qs0 + swizzled<64>(r1, c)) =
        pack_bf16(o0[4 * n + 2] * inv1, o0[4 * n + 3] * inv1);
  }
  if constexpr (W1 != 0) {
    unsigned char* qs1 = smem + L::kQ1 + wg * kWgRows * W1 * 2;
#pragma unroll
    for (int n = 0; n < W1 / 8; ++n) {
      const int c = n * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(qs1 + swizzled<W1>(r0, c)) =
          pack_bf16(o1[4 * n + 0] * inv0, o1[4 * n + 1] * inv0);
      *reinterpret_cast<uint32_t*>(qs1 + swizzled<W1>(r1, c)) =
          pack_bf16(o1[4 * n + 2] * inv1, o1[4 * n + 3] * inv1);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
  if (warp == 0 && lane == 0) {
    const int row = q0 + wg * kWgRows;
    tma_store_3d(&maps.o[0], q_p0, 0, row, bh);
    if (W1) tma_store_3d(&maps.o[1], q_p1, 64, row, bh);
    tma_store_commit_and_wait();
  }
  if (WITH_LSE && t == 0) {
    const int row0 = q0 + wg * kWgRows + r0, row1 = row0 + 8;
    float* lrow = lse + (size_t)bh * Sq;
    if (row0 < Sq) lrow[row0] = ok0 ? (m0 + __log2f(l0)) * kLn2 : kLseMasked;
    if (row1 < Sq) lrow[row1] = ok1 ? (m1 + __log2f(l1)) * kLn2 : kLseMasked;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// The map of panel `panel` (columns 0-63, or 64 onwards with width w1) of a
// bf16 [B*H, S, D] tensor, box_rows rows per box. Elements past D or S are
// read as zeros and never written.
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
            width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The checks every bf16 launch makes (the wrappers see to them first).
inline bool operands_ok(const void* q, const void* k, const void* v, const void* o, int BH,
                        int D) {
  return D > 0 && D <= 128 && D % 8 == 0 && BH <= 65535 &&
         (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 == 0;
}

// Encodes the maps of bf16 q/out [BH,Sq,D], k/v [BH,Sk,D] (D % 8 == 0,
// D <= DP) and launches `kernel`, an instantiation for (DP, NWG), on the
// stream.
template <int DP, int NWG, typename Kernel>
cudaError_t launch(Kernel kernel, const void* q, const void* k, const void* v,
                   const float* bias, void* o, float* lse, int BH, int H, int Sq, int Sk,
                   int D, cudaStream_t stream) {
  using L = Layout<DP, NWG>;
  AttnMaps maps;
  bool ok = true;
  for (int p = 0; p < (L::W1 ? 2 : 1); ++p) {
    const int w = p == 0 ? 64 : L::W1;
    ok = ok && encode_panel(&maps.q[p], q, D, Sq, BH, w, kWgRows) &&
         encode_panel(&maps.k[p], k, D, Sk, BH, w, kBN) &&
         encode_panel(&maps.v[p], v, D, Sk, BH, w, kBN) &&
         encode_panel(&maps.o[p], o, D, Sq, BH, w, kWgRows);
  }
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + L::kBM - 1) / L::kBM, BH);
  kernel<<<grid, L::kThreads, L::kAlloc, stream>>>(maps, bias, lse, H, Sq, Sk);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace

// Dynamic shared memory of one CTA at head dim d (the -Xptxas -v report
// counts static shared memory only).
extern "C" int tdm_attn_fwd_smem_bytes(int d) {
  using sm90::Layout, sm90::kGroups;
  return d <= 64   ? Layout<64, kGroups<64>>::kAlloc
         : d <= 80 ? Layout<80, kGroups<80>>::kAlloc
                   : Layout<128, kGroups<128>>::kAlloc;
}
