// The Hopper (sm_90a) attention forward shared by kernel 1 (flash_fwd.cu,
// with a key bias and optionally the logsumexp) and kernel 4 (splash_fwd.cu,
// no bias, no lse). One mainloop, templated on the padded head dim DP
// (64, 80, 128 or 160), the number of consumer warpgroups, HAS_BIAS and
// WITH_LSE.
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
//     brings the Q tile once and 128-key K/V tiles (64-key at DP = 160)
//     through a ring of 2-3 stages with full/empty mbarriers; the zero fill past S and past D is
//     the hardware's, so the ragged tails need no copies;
//   * the head dim lives in panels: 64 columns with the 128-byte swizzle,
//     and for DP = 80 a 16-column panel with the 32-byte swizzle (D = 72 is
//     zero-filled to 80 by TMA, not padded in memory), for DP = 128 a second
//     64-column panel, for DP = 160 (SD1.5's 1280-wide blocks, 8 heads) a
//     second 64-column panel and a third of 32 columns with the 64-byte
//     swizzle (D = 136 is zero-filled to 160 the same way). At DP = 160 O
//     takes 80 fp32 registers a thread: beside a 128-key S (64 more) ptxas
//     spilled 152 bytes, so DP = 160 reads 64-key K/V tiles (S 32
//     registers, P 16), three stages of 2 x 20 KiB beside the 40 KiB Q tile;
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
// (TMA's 16-byte row stride), D <= 160, 16-byte aligned bases,
// B*H <= 65535.
//
// The PTX wrappers, descriptors and tensor-map encoding live in
// sm90_common.cuh, shared with the backward kernels.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"  // pack_bf16, quad_max/sum, kValidMax, kLseMasked
#include "sm90_common.cuh"

namespace {
namespace sm90 {

// The CTA for padded head dim DP and NWG consumer warpgroups (warpgroup
// NWG produces), and its shared-memory layout in bytes from a 1024-aligned
// base: Q [kBM rows] then, per stage, K and V [kBN keys], each as panel 0
// (64 columns, 128 B per row) followed by panel 1 (W1 columns) and panel 2
// (W2 columns); then the bias slots and the mbarriers.
template <int DP, int NWG>
struct Layout {
  static_assert(DP == 64 || DP == 80 || DP == 128 || DP == 160,
                "padded head dim is 64, 80, 128 or 160");
  static_assert(NWG == 2 || NWG == 3, "two or three consumer warpgroups");
  static constexpr int kBM = NWG * kWgRows;      // query rows per CTA
  static constexpr int kThreads = (NWG + 1) * 128;
  static constexpr int W1 = DP == 160 ? 64 : DP - 64;  // second panel's width (0: none)
  static constexpr int W2 = DP - 64 - W1;              // third panel's width (0: none)
  static constexpr int kPanels = 1 + (W1 > 0) + (W2 > 0);
  static constexpr int kBN = DP == 160 ? 64 : 128;  // keys per K/V tile
  static constexpr int kStages = DP == 128 ? 2 : 3;
  static constexpr int kQ = 0;
  static constexpr int kQ1 = kBM * 64 * 2;   // Q panel 1
  static constexpr int kQ2 = kQ1 + kBM * W1 * 2;  // Q panel 2
  static constexpr int kP2 = kBN * (64 + W1) * 2;  // panel 2 within a K or V tile
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
// shape (D = 64) faster than two. At D = 80, 128 and 160 the O
// accumulators do not fit 160 registers (ptxas then serialises the wgmmas,
// and PixArt's shape runs slower), so those keep two warpgroups of 240
// registers.
template <int DP>
constexpr int kGroups = DP == 64 ? 3 : 2;

// S (+)= Q K^T over one 16-column step of the head dim for a tile of BN
// keys (128, or 64 at DP = 160).
template <int BN>
__device__ __forceinline__ void wgmma_ss_keys(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                              int accumulate) {
  if constexpr (BN == 128)
    wgmma_ss_n128(d, da, db, accumulate);
  else
    wgmma_ss_n64(d, da, db, accumulate);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// q, k, v and out as 3-D tensor maps [D, S, B*H], one per head-dim panel:
// box [64, W1 or W2 columns, kWgRows rows] for q and out (one box per
// consumer warpgroup), [.., Layout::kBN rows] for k and v.
struct AttnMaps {
  CUtensorMap q[3], k[3], v[3], o[3];
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
  constexpr int W2 = L::W2;
  constexpr int NST = L::kStages;
  constexpr int kBM = L::kBM;
  constexpr int kBN = L::kBN;

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
        if (W2)
          tma_load_3d(base + L::kQ2 + w * kWgRows * W2 * 2, &maps.q[2], q_full, 64 + W1, row,
                      bh);
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
        if (W2) {
          tma_load_3d(kt + L::kP2, &maps.k[2], &full[s], 64 + W1, k0, bh);
          tma_load_3d(vt + L::kP2, &maps.v[2], &full[s], 64 + W1, k0, bh);
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
  const uint32_t q_p2 = base + L::kQ2 + wg * kWgRows * W2 * 2;

  float o0[32];
  float o1[W1 ? W1 / 2 : 1];
  float o2[W2 ? W2 / 2 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (W1 ? W1 / 2 : 1); ++i) o1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (W2 ? W2 / 2 : 1); ++i) o2[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units) of rows g, g+8
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the running sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NST;
    const int k0 = j * kBN;
    mbar_wait(&full[s], (j / NST) & 1);
    const uint32_t kt = base + L::kStage0 + s * 2 * L::kTile, vt = kt + L::kTile;

    // S = Q K^T: 64 rows x 128 keys, 16 columns of the head dim per step
    float sc[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_keys<kBN>(sc, panel_desc<64>(q_p0 + kk * 32), panel_desc<64>(kt + kk * 32), kk > 0);
    if constexpr (W1 == 16) {
      wgmma_ss_keys<kBN>(sc, panel_desc<16>(q_p1), panel_desc<16>(kt + kBN * 128), 1);
    } else if constexpr (W1 == 64) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_keys<kBN>(sc, panel_desc<64>(q_p1 + kk * 32),
                           panel_desc<64>(kt + kBN * 128 + kk * 32), 1);
    }
    if constexpr (W2 == 32) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_ss_keys<kBN>(sc, panel_desc<32>(q_p2 + kk * 32),
                           panel_desc<32>(kt + L::kP2 + kk * 32), 1);
    }
    wgmma_commit_and_wait();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) fence_operand(sc[i]);

    // log2 units; the key bias, or -inf past Sk by index
    float mx0 = -INFINITY, mx1 = -INFINITY;
    const bool tail = k0 + kBN > Sk;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
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
    for (int n = 0; n < kBN / 8; ++n) {
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
    if constexpr (W2 != 0) {
#pragma unroll
      for (int n = 0; n < W2 / 8; ++n) {
        o2[4 * n + 0] *= al0; o2[4 * n + 1] *= al0;
        o2[4 * n + 2] *= al1; o2[4 * n + 3] *= al1;
      }
    }

    // O += P V: P rounded to bf16 in the A-operand layout (the accumulators
    // of two adjacent 8-key column blocks form one 16-key step)
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(o0[i]);
    if constexpr (W2 != 0) {
#pragma unroll
      for (int i = 0; i < W1 / 2; ++i) fence_operand(o1[i]);
#pragma unroll
      for (int i = 0; i < W2 / 2; ++i) fence_operand(o2[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wgmma_rs_n64(o0, pa[kk], panel_desc<64>(vt + kk * 16 * 128));
      if constexpr (W1 == 16)
        wgmma_rs_n16(o1, pa[kk], panel_desc<16>(vt + kBN * 128 + kk * 16 * 32));
      else if constexpr (W1 == 64)
        wgmma_rs_n64(o1, pa[kk], panel_desc<64>(vt + kBN * 128 + kk * 16 * 128));
      if constexpr (W2 == 32)
        wgmma_rs_n32(o2, pa[kk], panel_desc<32>(vt + L::kP2 + kk * 16 * 64));
    }
    wgmma_commit_and_wait();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(pa[kk][e]);
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(o0[i]);
    if constexpr (W2 != 0) {
#pragma unroll
      for (int i = 0; i < W1 / 2; ++i) fence_operand(o1[i]);
#pragma unroll
      for (int i = 0; i < W2 / 2; ++i) fence_operand(o2[i]);
    }
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
  if constexpr (W2 != 0) {
    unsigned char* qs2 = smem + L::kQ2 + wg * kWgRows * W2 * 2;
#pragma unroll
    for (int n = 0; n < W2 / 8; ++n) {
      const int c = n * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(qs2 + swizzled<W2>(r0, c)) =
          pack_bf16(o2[4 * n + 0] * inv0, o2[4 * n + 1] * inv0);
      *reinterpret_cast<uint32_t*>(qs2 + swizzled<W2>(r1, c)) =
          pack_bf16(o2[4 * n + 2] * inv1, o2[4 * n + 3] * inv1);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
  if (warp == 0 && lane == 0) {
    const int row = q0 + wg * kWgRows;
    tma_store_3d(&maps.o[0], q_p0, 0, row, bh);
    if (W1) tma_store_3d(&maps.o[1], q_p1, 64, row, bh);
    if (W2) tma_store_3d(&maps.o[2], q_p2, 64 + W1, row, bh);
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

// The checks every bf16 launch makes (the wrappers see to them first).
inline bool operands_ok(const void* q, const void* k, const void* v, const void* o, int BH,
                        int D) {
  return D > 0 && D <= 160 && D % 8 == 0 && BH <= 65535 &&
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
  cudaError_t err = bind_current_device();  // the map encoding needs a current context
  if (err != cudaSuccess) return err;
  AttnMaps maps;
  bool ok = true;
  for (int p = 0; p < L::kPanels; ++p) {
    const int w = p == 0 ? 64 : p == 1 ? L::W1 : L::W2;
    ok = ok && encode_panel(&maps.q[p], q, D, Sq, BH, w, kWgRows) &&
         encode_panel(&maps.k[p], k, D, Sk, BH, w, L::kBN) &&
         encode_panel(&maps.v[p], v, D, Sk, BH, w, L::kBN) &&
         encode_panel(&maps.o[p], o, D, Sq, BH, w, kWgRows);
  }
  if (!ok) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
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
  return d <= 64    ? Layout<64, kGroups<64>>::kAlloc
         : d <= 80  ? Layout<80, kGroups<80>>::kAlloc
         : d <= 128 ? Layout<128, kGroups<128>>::kAlloc
                    : Layout<160, kGroups<160>>::kAlloc;
}
