// Flash-attention backward, the dK/dV pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel`
// (tdm_tpu/ops/attention.py:635-675, `pallas_call` :767 in `_bwd_core`).
// Same function, per (b,h) and key row j:
//   P[i,j]  = exp(q_scaled[i] . k[j] + bias[j] - lse[i])
//   dV[j]   = sum_i P[i,j] dO[i]
//   dK[j]   = sum_i P[i,j] (dO[i] . v[j] - delta[i]) q_scaled[i]
// with q the forward's PRE-SCALED q, so dK = dS^T (scale Q) needs no further
// scale; lse the forward's and delta = rowsum(dO * O) the dQ pass's
// (flash_bwd_dq.cu). P is rounded to dO's dtype before dV and dS to q's
// dtype before dK, with fp32 sums, as the TPU kernel rounds them. Query
// rows past Sq read lse = +1e30 and delta = 0 (the sentinel the TPU
// re-pads with, `:709-716`), so they contribute nothing. The key bias gets
// no gradient.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//   * PixArt self-attention, B=4 H=16 S=1024 D=72: four products per
//     (query, key) pair (S, dV, dP, dK) = 8*B*H*Sq*Sk*D = 38.7 GFLOP ->
//     0.0391 ms, operations-bound (57 MB moved -> 0.017 ms).
//   * cross-attention, Sk = 120 masked T5 tokens (210 live keys over the
//     batch): 2.0 GFLOP against q and dO read (9.4 MB each in bf16), dK and
//     dV written -> bytes-bound, 0.0067 ms.
// Design, the TMA ring and wgmma products of the forward
// (attn_fwd_sm90.cuh) with the roles of queries and keys exchanged:
//   * a CTA owns NWG x 64 key rows of one (b,h), one warpgroup per 64 keys
//     (wgmma's M). The four accumulators (dK, dV, S^T, dP^T) need ~200
//     registers a thread at D = 80 and ~245 at D = 128. A CTA of two
//     consumer warpgroups and a producer (warp or warpgroup) is given
//     registers for three warpgroups, 168 a thread; ptxas kept the consumers
//     to that even after setmaxnreg (producer 40, consumers 232) and they
//     spilled, and 288 threads with more registers each did not launch. So
//     there is no producer warpgroup: warp 0 refills the ring between its
//     own products, and 128 or 256 threads get up to 255 registers. Two
//     warpgroups where the grid of 128-key CTAs fills the card; one where it
//     would not (PixArt's cross shape: 64 pairs x 1 tile), which doubles the
//     CTAs. No atomics: each CTA writes only its own key rows, so dK and dV
//     are the same bits run to run;
//   * TMA brings the K and V tiles once; the key bias of each warpgroup's
//     rows (log2 units, -inf past Sk) is held in registers;
//   * 64-query tiles of Q and dO stream through a ring of up to 6 stages
//     with full/empty mbarriers. At the top of tile j, warp 0 waits until
//     every warp has released tile j - 1 and refills its stage with tile
//     j - 1 + stages: lane 0 issues the TMA loads, and the warp writes those
//     rows' lse (log2 units) and delta, read a tile earlier, into the
//     stage's slot, with lse = +1e30 and delta = 0 past Sq;
//   * the scores are computed transposed, so that every product's A operand
//     is already in registers: S^T = K Q^T and dP^T = V dO^T (SS wgmma, both
//     K-major, issued together); P^T = exp2(S^T log2e + bias_row -
//     lse_col log2e) and dS^T = P^T (dP^T - delta_col), rounded to bf16 in
//     the A-operand layout; dV += P^T dO and dK += dS^T Q (RS wgmma, dO and Q
//     read MN-major through the descriptor's transpose bit). One TMA copy of
//     each Q and dO tile serves both of its products through two
//     descriptors; P and dS never go through shared memory;
//   * the epilogue rounds dK and dV to bf16 into the warpgroup's K and V
//     rows (by then unused) and stores them with TMA, which clips keys >= Sk
//     and columns >= D;
//   * SD1.5's D = 160 reads three head-dim panels (64, 64 and 32 columns, the
//     last with the 64-byte swizzle; D = 136 zero-filled to 160). There dK
//     and dV take 80 fp32 registers a thread each, beside S^T and dP^T (32
//     each): 224 before any fragment or address. So DP = 160 runs two
//     launches over the same grid, a dV pass (S^T, P^T, dV += P^T dO) and a
//     dK pass (S^T and dP^T, dS^T, dK += dS^T Q), each holding one of the
//     two accumulators; S^T is computed in both, and K, Q and dO are read
//     twice.
// The (batch, head) pairs and key tiles share grid x, so B*H has no cap
// below 2^31 / (key tiles).
//
// Layout: q/dO [B,H,Sq,D], k/v/dK/dV [B,H,Sk,D], contiguous; bias [B,Sk] fp32
// or null; lse and delta [B,H,Sq] fp32. bf16 takes D % 8 == 0, D <= 160 and
// 16-byte aligned bases (the wrapper zero-pads D); fp32 goes through a
// scalar-FMA kernel and takes any D in [1,160]. C interface (ctypes):
// tdm_flash_bwd_dkv returns a cudaError_t code.

#include <math.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per Q/dO tile

// What one launch accumulates: dK and dV together, or at DP = 160 one of
// them (a dV pass, then a dK pass)
constexpr int kBoth = 0, kDvPass = 1, kDkPass = 2;

// ---------------------------------------------------------------------------
// bf16: the wgmma/TMA kernel
// ---------------------------------------------------------------------------

// The CTA at padded head dim DP with NWG consumer warpgroups, and its shared
// memory in bytes from a 1024-aligned base: the K and V tiles [kBM rows],
// each as panel 0 (64 columns) then panel 1 (W1 columns) and panel 2 (W2
// columns); per stage a Q and a dO tile [kBQ rows] laid out the same way;
// per stage the lse and delta slots [kBQ each]; the mbarriers.
template <int DP, int NWG>
struct DkvLayout {
  static_assert(DP == 64 || DP == 80 || DP == 128 || DP == 160,
                "padded head dim is 64, 80, 128 or 160");
  static_assert(NWG == 1 || NWG == 2, "one or two consumer warpgroups");
  static constexpr int kBM = NWG * sm90::kWgRows;  // key rows per CTA
  static constexpr int kThreads = NWG * 128;
  static constexpr int W1 = DP == 160 ? 64 : DP - 64;  // second panel's width (0: none)
  static constexpr int W2 = DP - 64 - W1;              // third panel's width (0: none)
  static constexpr int kRows = kBM * DP * 2;  // the K or the V tile
  static constexpr int kP1 = kBM * 64 * 2;    // panel 1 within it
  static constexpr int kP2 = kP1 + kBM * W1 * 2;  // panel 2 within it
  static constexpr int kK = 0, kV = kRows;
  static constexpr int kTile = kBQ * DP * 2;  // one Q or dO tile
  static constexpr int kTP2 = kBQ * (64 + W1) * 2;  // panel 2 within a Q or dO tile
  static constexpr int kStage0 = 2 * kRows;
  // Up to 6 stages with two warpgroups (one CTA an SM either way); up to 4
  // with one, so that two CTAs fit an SM (with one, at 6 stages, the self
  // shape ran 1.6x slower).
  static constexpr int kFit = (232448 - 2048 - kStage0) / (2 * kTile + 2 * kBQ * 4);
  static constexpr int kMaxStages = NWG == 2 ? 6 : 4;
  static constexpr int kStages = kFit > kMaxStages ? kMaxStages : kFit;
  static_assert(kStages >= 2, "two stages fit");
  static constexpr int kSlots = kStage0 + kStages * 2 * kTile;
  static constexpr int kBars = kSlots + kStages * 2 * kBQ * 4;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

// One 3-D map [D, S, B*H] per head-dim panel, box [64, W1 or W2 columns,
// kWgRows rows] (kBQ = kWgRows).
struct DkvMaps {
  CUtensorMap q[3], dout[3], k[3], v[3], dk[3], dv[3];
};

template <int DP, int NWG, int PASS>
__global__ void __launch_bounds__(DkvLayout<DP, NWG>::kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ DkvMaps maps, const float* __restrict__ bias,
                          const float* __restrict__ lse, const float* __restrict__ delta, int H,
                          int Sq, int Sk, int k_tiles) {
  using namespace sm90;
  using L = DkvLayout<DP, NWG>;
  constexpr int W1 = L::W1;
  constexpr int W2 = L::W2;
  constexpr int NST = L::kStages;
  constexpr bool kDV = PASS != kDkPass, kDK = PASS != kDvPass;
  static_assert(kBQ == kWgRows, "Q/dO tiles and K/V rows share the box height");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + NST;
  uint64_t* kv_full = empty + NST;
  float* slots = reinterpret_cast<float*>(smem + L::kSlots);  // per stage: lse, delta
  const uint32_t base = smem_u32(smem);

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * L::kBM;
  const int n_tiles = (Sq + kBQ - 1) / kBQ;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 32);        // warp 0, after the slot
      mbar_init(&empty[s], 4 * NWG);  // every warp
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0 reads the lse (log2 units) and delta of query tile j's rows,
  // lane and lane + 32, into registers, and fills the tile's stage: the TMA
  // loads of its Q and dO rows (lane 0) and the slot from those registers
  static_assert(kBQ == 64, "two rows a lane");
  const float* lrow = lse + (size_t)bh * Sq;
  const float* drow = delta + (size_t)bh * Sq;
  auto read_rows = [&](int j, float (&r)[4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = j * kBQ + lane + 32 * i;
      r[i] = (row < Sq ? lrow[row] : kLseMasked) * kLog2e;
      r[2 + i] = row < Sq ? drow[row] : 0.f;
    }
  };
  auto fill = [&](int j, const float (&r)[4]) {
    const int s = j % NST, q0 = j * kBQ;
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * L::kTile);
      const uint32_t qt = base + L::kStage0 + s * 2 * L::kTile, dt = qt + L::kTile;
      tma_load_3d(qt, &maps.q[0], &full[s], 0, q0, bh);
      tma_load_3d(dt, &maps.dout[0], &full[s], 0, q0, bh);
      if (W1) {
        tma_load_3d(qt + kBQ * 128, &maps.q[1], &full[s], 64, q0, bh);
        tma_load_3d(dt + kBQ * 128, &maps.dout[1], &full[s], 64, q0, bh);
      }
      if (W2) {
        tma_load_3d(qt + L::kTP2, &maps.q[2], &full[s], 64 + W1, q0, bh);
        tma_load_3d(dt + L::kTP2, &maps.dout[2], &full[s], 64 + W1, q0, bh);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      slots[s * 2 * kBQ + lane + 32 * i] = r[i];
      slots[s * 2 * kBQ + kBQ + lane + 32 * i] = r[2 + i];
    }
    mbar_arrive(&full[s]);
  };
  float ahead[4];  // warp 0: the rows of the next tile it refills, read a tile early
  if (threadIdx.x < 32) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kRows);
      for (int w = 0; w < NWG; ++w) {
        const int row = k0 + w * kWgRows;
        tma_load_3d(base + L::kK + w * kWgRows * 128, &maps.k[0], kv_full, 0, row, bh);
        tma_load_3d(base + L::kV + w * kWgRows * 128, &maps.v[0], kv_full, 0, row, bh);
        if (W1) {
          tma_load_3d(base + L::kK + L::kP1 + w * kWgRows * W1 * 2, &maps.k[1], kv_full, 64,
                      row, bh);
          tma_load_3d(base + L::kV + L::kP1 + w * kWgRows * W1 * 2, &maps.v[1], kv_full, 64,
                      row, bh);
        }
        if (W2) {
          tma_load_3d(base + L::kK + L::kP2 + w * kWgRows * W2 * 2, &maps.k[2], kv_full,
                      64 + W1, row, bh);
          tma_load_3d(base + L::kV + L::kP2 + w * kWgRows * W2 * 2, &maps.v[2], kv_full,
                      64 + W1, row, bh);
        }
      }
    }
    for (int j = 0; j < NST && j < n_tiles; ++j) {
      read_rows(j, ahead);
      fill(j, ahead);
    }
    if (NST < n_tiles) read_rows(NST, ahead);
  }

  // ---------------- consumers: 64 key rows per warpgroup ----------------
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // rows within this warpgroup's 64
  const int key0 = k0 + wg * kWgRows + r0, key1 = key0 + 8;
  const float* brow = bias ? bias + (size_t)(bh / H) * Sk : nullptr;
  const float b2_0 = key0 < Sk ? (brow ? brow[key0] * kLog2e : 0.f) : -INFINITY;
  const float b2_1 = key1 < Sk ? (brow ? brow[key1] * kLog2e : 0.f) : -INFINITY;
  const uint32_t k_p0 = base + L::kK + wg * kWgRows * 128;
  const uint32_t k_p1 = base + L::kK + L::kP1 + wg * kWgRows * W1 * 2;
  const uint32_t v_p0 = base + L::kV + wg * kWgRows * 128;
  const uint32_t v_p1 = base + L::kV + L::kP1 + wg * kWgRows * W1 * 2;
  const uint32_t k_p2 = base + L::kK + L::kP2 + wg * kWgRows * W2 * 2;
  const uint32_t v_p2 = base + L::kV + L::kP2 + wg * kWgRows * W2 * 2;

  float dk0[32], dv0[32];
  float dk1[W1 ? W1 / 2 : 1], dv1[W1 ? W1 / 2 : 1];
  float dk2[W2 ? W2 / 2 : 1], dv2[W2 ? W2 / 2 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk0[i] = dv0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (W1 ? W1 / 2 : 1); ++i) dk1[i] = dv1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (W2 ? W2 / 2 : 1); ++i) dk2[i] = dv2[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    if (threadIdx.x < 32 && j >= 1 && j - 1 + NST < n_tiles) {
      // every warp has released tile j - 1: its stage takes tile j - 1 + NST
      mbar_wait(&empty[(j - 1) % NST], ((j - 1) / NST) & 1);
      fill(j - 1 + NST, ahead);
      if (j + NST < n_tiles) read_rows(j + NST, ahead);
    }
    __syncwarp();
    const int s = j % NST;
    mbar_wait(&full[s], (j / NST) & 1);
    const uint32_t qt = base + L::kStage0 + s * 2 * L::kTile, dt = qt + L::kTile;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, one commit
    // group (the dV pass needs no dP^T)
    float st[32], dpt[32];
    wgmma_fence();
    product_abt<DP>(st, k_p0, k_p1, qt, k_p2);
    if constexpr (kDK) product_abt<DP>(dpt, v_p0, v_p1, dt, v_p2);
    wgmma_commit_and_wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_operand(st[i]);
      if constexpr (kDK) fence_operand(dpt[i]);
    }

    // P^T (kept in st) and dS^T = P^T (dP^T - delta) (kept in dpt): the key
    // bias runs along the rows here, lse and delta along the columns
    const float* l2 = slots + s * 2 * kBQ;
    const float* dl = l2 + kBQ;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + t * 2;
      const float2 la = *reinterpret_cast<const float2*>(&l2[c]);
      st[4 * n + 0] = exp2_approx(fmaf(st[4 * n + 0], kLog2e, b2_0 - la.x));
      st[4 * n + 1] = exp2_approx(fmaf(st[4 * n + 1], kLog2e, b2_0 - la.y));
      st[4 * n + 2] = exp2_approx(fmaf(st[4 * n + 2], kLog2e, b2_1 - la.x));
      st[4 * n + 3] = exp2_approx(fmaf(st[4 * n + 3], kLog2e, b2_1 - la.y));
      if constexpr (kDK) {
        const float2 da = *reinterpret_cast<const float2*>(&dl[c]);
        dpt[4 * n + 0] = st[4 * n + 0] * (dpt[4 * n + 0] - da.x);
        dpt[4 * n + 1] = st[4 * n + 1] * (dpt[4 * n + 1] - da.y);
        dpt[4 * n + 2] = st[4 * n + 2] * (dpt[4 * n + 2] - da.x);
        dpt[4 * n + 3] = st[4 * n + 3] * (dpt[4 * n + 3] - da.y);
      }
    }
    // P^T and dS^T rounded to bf16 in the A-operand layout (two adjacent
    // 8-query column blocks form one 16-query step)
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kDV) pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
        if constexpr (kDK) sa[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
      }
    }
    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if constexpr (kDK) fence_operand(dk0[i]);
      if constexpr (kDV) fence_operand(dv0[i]);
    }
    if constexpr (W2 != 0) {
#pragma unroll
      for (int i = 0; i < W1 / 2; ++i) {
        if constexpr (kDK) fence_operand(dk1[i]);
        if constexpr (kDV) fence_operand(dv1[i]);
      }
#pragma unroll
      for (int i = 0; i < W2 / 2; ++i) {
        if constexpr (kDK) fence_operand(dk2[i]);
        if constexpr (kDV) fence_operand(dv2[i]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (kDV) wgmma_rs_n64(dv0, pa[kk], panel_desc<64>(dt + kk * 16 * 128));
      if constexpr (kDK) wgmma_rs_n64(dk0, sa[kk], panel_desc<64>(qt + kk * 16 * 128));
      if constexpr (W1 == 16) {
        wgmma_rs_n16(dv1, pa[kk], panel_desc<16>(dt + kBQ * 128 + kk * 16 * 32));
        wgmma_rs_n16(dk1, sa[kk], panel_desc<16>(qt + kBQ * 128 + kk * 16 * 32));
      } else if constexpr (W1 == 64) {
        if constexpr (kDV)
          wgmma_rs_n64(dv1, pa[kk], panel_desc<64>(dt + kBQ * 128 + kk * 16 * 128));
        if constexpr (kDK)
          wgmma_rs_n64(dk1, sa[kk], panel_desc<64>(qt + kBQ * 128 + kk * 16 * 128));
      }
      if constexpr (W2 == 32) {
        if constexpr (kDV) wgmma_rs_n32(dv2, pa[kk], panel_desc<32>(dt + L::kTP2 + kk * 16 * 64));
        if constexpr (kDK) wgmma_rs_n32(dk2, sa[kk], panel_desc<32>(qt + L::kTP2 + kk * 16 * 64));
      }
    }
    wgmma_commit_and_wait();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kDV) fence_operand(pa[kk][e]);
        if constexpr (kDK) fence_operand(sa[kk][e]);
      }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if constexpr (kDK) fence_operand(dk0[i]);
      if constexpr (kDV) fence_operand(dv0[i]);
    }
    if constexpr (W2 != 0) {
#pragma unroll
      for (int i = 0; i < W1 / 2; ++i) {
        if constexpr (kDK) fence_operand(dk1[i]);
        if constexpr (kDV) fence_operand(dv1[i]);
      }
#pragma unroll
      for (int i = 0; i < W2 / 2; ++i) {
        if constexpr (kDK) fence_operand(dk2[i]);
        if constexpr (kDV) fence_operand(dv2[i]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  // epilogue: bf16 dK and dV into this warpgroup's K and V rows (its last
  // products have completed) in the swizzled layout of the output maps
  unsigned char* ks0 = smem + L::kK + wg * kWgRows * 128;
  unsigned char* vs0 = smem + L::kV + wg * kWgRows * 128;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + t * 2;
    if constexpr (kDK) {
      *reinterpret_cast<uint32_t*>(ks0 + swizzled<64>(r0, c)) =
          pack_bf16(dk0[4 * n], dk0[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(ks0 + swizzled<64>(r1, c)) =
          pack_bf16(dk0[4 * n + 2], dk0[4 * n + 3]);
    }
    if constexpr (kDV) {
      *reinterpret_cast<uint32_t*>(vs0 + swizzled<64>(r0, c)) =
          pack_bf16(dv0[4 * n], dv0[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(vs0 + swizzled<64>(r1, c)) =
          pack_bf16(dv0[4 * n + 2], dv0[4 * n + 3]);
    }
  }
  if constexpr (W1 != 0) {
    unsigned char* ks1 = smem + L::kK + L::kP1 + wg * kWgRows * W1 * 2;
    unsigned char* vs1 = smem + L::kV + L::kP1 + wg * kWgRows * W1 * 2;
#pragma unroll
    for (int n = 0; n < W1 / 8; ++n) {
      const int c = n * 8 + t * 2;
      if constexpr (kDK) {
        *reinterpret_cast<uint32_t*>(ks1 + swizzled<W1>(r0, c)) =
            pack_bf16(dk1[4 * n], dk1[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(ks1 + swizzled<W1>(r1, c)) =
            pack_bf16(dk1[4 * n + 2], dk1[4 * n + 3]);
      }
      if constexpr (kDV) {
        *reinterpret_cast<uint32_t*>(vs1 + swizzled<W1>(r0, c)) =
            pack_bf16(dv1[4 * n], dv1[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(vs1 + swizzled<W1>(r1, c)) =
            pack_bf16(dv1[4 * n + 2], dv1[4 * n + 3]);
      }
    }
  }
  if constexpr (W2 != 0) {
    unsigned char* ks2 = smem + L::kK + L::kP2 + wg * kWgRows * W2 * 2;
    unsigned char* vs2 = smem + L::kV + L::kP2 + wg * kWgRows * W2 * 2;
#pragma unroll
    for (int n = 0; n < W2 / 8; ++n) {
      const int c = n * 8 + t * 2;
      if constexpr (kDK) {
        *reinterpret_cast<uint32_t*>(ks2 + swizzled<W2>(r0, c)) =
            pack_bf16(dk2[4 * n], dk2[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(ks2 + swizzled<W2>(r1, c)) =
            pack_bf16(dk2[4 * n + 2], dk2[4 * n + 3]);
      }
      if constexpr (kDV) {
        *reinterpret_cast<uint32_t*>(vs2 + swizzled<W2>(r0, c)) =
            pack_bf16(dv2[4 * n], dv2[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(vs2 + swizzled<W2>(r1, c)) =
            pack_bf16(dv2[4 * n + 2], dv2[4 * n + 3]);
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
  if (warp == 0 && lane == 0) {
    const int row = k0 + wg * kWgRows;
    if (kDK) tma_store_3d(&maps.dk[0], k_p0, 0, row, bh);
    if (kDV) tma_store_3d(&maps.dv[0], v_p0, 0, row, bh);
    if (W1) {
      if (kDK) tma_store_3d(&maps.dk[1], k_p1, 64, row, bh);
      if (kDV) tma_store_3d(&maps.dv[1], v_p1, 64, row, bh);
    }
    if (W2) {
      if (kDK) tma_store_3d(&maps.dk[2], k_p2, 64 + W1, row, bh);
      if (kDV) tma_store_3d(&maps.dv[2], v_p2, 64 + W1, row, bh);
    }
    tma_store_commit_and_wait();
  }
}

template <int DP, int NWG, int PASS>
cudaError_t launch_pass(const DkvMaps& maps, const float* bias, const float* lse,
                        const float* delta, int BH, int H, int Sq, int Sk, int k_tiles,
                        cudaStream_t stream) {
  using L = DkvLayout<DP, NWG>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel<DP, NWG, PASS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_sm90_kernel<DP, NWG, PASS><<<BH * k_tiles, L::kThreads, L::kAlloc, stream>>>(
      maps, bias, lse, delta, H, Sq, Sk, k_tiles);
  return cudaGetLastError();
}

template <int DP, int NWG>
cudaError_t launch_bf16_groups(const void* q, const void* k, const void* v, const float* bias,
                               const void* dout, const float* lse, const float* delta, void* dk,
                               void* dv, int BH, int H, int Sq, int Sk, int D,
                               cudaStream_t stream) {
  using L = DkvLayout<DP, NWG>;
  using sm90::encode_panel, sm90::kWgRows;
  const int k_tiles = (Sk + L::kBM - 1) / L::kBM;
  if ((long long)BH * k_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = sm90::bind_current_device();
  if (err != cudaSuccess) return err;
  DkvMaps maps;
  bool ok = true;
  for (int p = 0; p < 1 + (L::W1 > 0) + (L::W2 > 0); ++p) {
    const int w = p == 0 ? 64 : p == 1 ? L::W1 : L::W2;
    ok = ok && encode_panel(&maps.q[p], q, D, Sq, BH, w, kWgRows) &&
         encode_panel(&maps.dout[p], dout, D, Sq, BH, w, kWgRows) &&
         encode_panel(&maps.k[p], k, D, Sk, BH, w, kWgRows) &&
         encode_panel(&maps.v[p], v, D, Sk, BH, w, kWgRows) &&
         encode_panel(&maps.dk[p], dk, D, Sk, BH, w, kWgRows) &&
         encode_panel(&maps.dv[p], dv, D, Sk, BH, w, kWgRows);
  }
  if (!ok) return cudaErrorInvalidValue;
  if constexpr (DP == 160) {  // a dV pass, then a dK pass
    err = launch_pass<DP, NWG, kDvPass>(maps, bias, lse, delta, BH, H, Sq, Sk, k_tiles, stream);
    if (err != cudaSuccess) return err;
    return launch_pass<DP, NWG, kDkPass>(maps, bias, lse, delta, BH, H, Sq, Sk, k_tiles, stream);
  } else {
    return launch_pass<DP, NWG, kBoth>(maps, bias, lse, delta, BH, H, Sq, Sk, k_tiles, stream);
  }
}

// Two warpgroups when the grid of 128-key CTAs covers the card's SMs, else
// one (twice the CTAs, each with half the keys).
template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* bias,
                        const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                        int BH, int H, int Sq, int Sk, int D, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((long long)BH * ((Sk + 127) / 128) >= sms)
    return launch_bf16_groups<DP, 2>(q, k, v, bias, dout, lse, delta, dk, dv, BH, H, Sq, Sk, D,
                                     stream);
  return launch_bf16_groups<DP, 1>(q, k, v, bias, dout, lse, delta, dk, dv, BH, H, Sq, Sk, D,
                                   stream);
}

// ---------------------------------------------------------------------------
// fp32: scalar-FMA kernel. Block = 32 key rows of one (b,h), 4 lanes per
// row (lane t owns columns t, t+4, ...); loop over 32-query tiles.
// ---------------------------------------------------------------------------

constexpr int kFR = 32;
constexpr int kFQ = 32;

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Sq, int Sk, int D) {
  constexpr int DPAD = NJ * 4;
  __shared__ float qs[kFQ][DPAD];
  __shared__ float dos[kFQ][DPAD];
  __shared__ float ls[kFQ];
  __shared__ float dls[kFQ];

  const int bh = blockIdx.x;
  const int row = blockIdx.y * kFR + threadIdx.x / 4;  // key row
  const int t = threadIdx.x % 4;
  const float* qg = q + (size_t)bh * Sq * D;
  const float* dg = dout + (size_t)bh * Sq * D;
  const float* kg = k + (size_t)bh * Sk * D;
  const float* vg = v + (size_t)bh * Sk * D;
  const float* bg = bias ? bias + (size_t)(bh / H) * Sk : nullptr;

  float kr[NJ], vr[NJ], adk[NJ], adv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = j * 4 + t;
    const bool in = row < Sk && c < D;
    kr[j] = in ? kg[(size_t)row * D + c] : 0.f;
    vr[j] = in ? vg[(size_t)row * D + c] : 0.f;
    adk[j] = adv[j] = 0.f;
  }
  const float bj = row < Sk ? (bg ? bg[row] : 0.f) : kNegInf;

  for (int q0 = 0; q0 < Sq; q0 += kFQ) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFQ * DPAD; i += kThreads) {
      const int r = i / DPAD, c = i % DPAD;
      const bool in = q0 + r < Sq && c < D;
      qs[r][c] = in ? qg[(size_t)(q0 + r) * D + c] : 0.f;
      dos[r][c] = in ? dg[(size_t)(q0 + r) * D + c] : 0.f;
    }
    if (threadIdx.x < kFQ) {
      const int i = q0 + threadIdx.x;
      ls[threadIdx.x] = i < Sq ? lse[(size_t)bh * Sq + i] : kLseMasked;
      dls[threadIdx.x] = i < Sq ? delta[(size_t)bh * Sq + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kFQ; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        s = fmaf(kr[c], qs[i][c * 4 + t], s);
        dp = fmaf(vr[c], dos[i][c * 4 + t], dp);
      }
      const float p = expf(quad_sum(s) + bj - ls[i]);
      const float ds = p * (quad_sum(dp) - dls[i]);
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        adv[c] = fmaf(p, dos[i][c * 4 + t], adv[c]);
        adk[c] = fmaf(ds, qs[i][c * 4 + t], adk[c]);
      }
    }
  }
  if (row < Sk) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = j * 4 + t;
      if (c < D) {
        dk[(size_t)bh * Sk * D + (size_t)row * D + c] = adk[j];
        dv[(size_t)bh * Sk * D + (size_t)row * D + c] = adv[j];
      }
    }
  }
}

template <int NJ>
struct LaunchF32 {
  static cudaError_t run(const void* q, const void* k, const void* v, const float* bias,
                         const void* dout, const float* lse, const float* delta, void* dk,
                         void* dv, int B, int H, int Sq, int Sk, int D, cudaStream_t stream) {
    dim3 grid(B * H, (Sk + kFR - 1) / kFR);
    flash_bwd_dkv_f32_kernel<NJ><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk, D);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. delta: the [B,H,Sq] fp32 rowsum(dO * O)
// that tdm_flash_bwd_dq wrote. Returns a cudaError_t code.
int tdm_flash_bwd_dkv(const void* q, const void* k, const void* v, const float* bias,
                      const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                      int batch, int heads, int sq, int sk, int d, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 160 ||
      (long long)batch * heads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (dtype == 1) {
    if (d % 8 != 0 || !sm90::aligned16({q, k, v, dout, dk, dv}))
      return (int)cudaErrorInvalidValue;
    if (d <= 64)
      return (int)launch_bf16<64>(q, k, v, bias, dout, lse, delta, dk, dv, bh, heads, sq, sk, d,
                                  s);
    if (d <= 80)
      return (int)launch_bf16<80>(q, k, v, bias, dout, lse, delta, dk, dv, bh, heads, sq, sk, d,
                                  s);
    if (d <= 128)
      return (int)launch_bf16<128>(q, k, v, bias, dout, lse, delta, dk, dv, bh, heads, sq, sk,
                                   d, s);
    return (int)launch_bf16<160>(q, k, v, bias, dout, lse, delta, dk, dv, bh, heads, sq, sk, d,
                                 s);
  }
  if (dtype == 0) {
    if ((sk + kFR - 1) / kFR > 65535) return (int)cudaErrorInvalidValue;
    if (d > 128)  // 40 columns a lane: the fp32 sweep above 128
      return (int)LaunchF32<40>::run(q, k, v, bias, dout, lse, delta, dk, dv, batch, heads, sq,
                                     sk, d, s);
    return (int)by_padded_dim_f32<LaunchF32>(d, q, k, v, bias, dout, lse, delta, dk, dv, batch,
                                             heads, sq, sk, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Dynamic shared memory of one bf16 CTA at head dim d with `groups` (1 or
// 2) consumer warpgroups (the -Xptxas -v report counts static shared
// memory only).
extern "C" int tdm_flash_bwd_dkv_smem_bytes(int d, int groups) {
  if (groups == 2)
    return d <= 64    ? DkvLayout<64, 2>::kAlloc
           : d <= 80  ? DkvLayout<80, 2>::kAlloc
           : d <= 128 ? DkvLayout<128, 2>::kAlloc
                      : DkvLayout<160, 2>::kAlloc;
  return d <= 64    ? DkvLayout<64, 1>::kAlloc
         : d <= 80  ? DkvLayout<80, 1>::kAlloc
         : d <= 128 ? DkvLayout<128, 1>::kAlloc
                    : DkvLayout<160, 1>::kAlloc;
}
