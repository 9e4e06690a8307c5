// Flash-attention backward, the dQ pass with Δ fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bwd_dq_kernel`
// (tdm_tpu/ops/attention.py:600-632, `pallas_call` :744 in `_bwd_core`) and
// the XLA sum that feeds it, Δ = rowsum(dO ∘ O) (`_bwd_core` :718-724).
// Same function, per (b,h) and query row i:
//   delta[i] = sum_d dO[i,d] O[i,d]                   (fp32, written out)
//   P[i,j]   = exp(q_scaled[i] . k[j] + bias[j] - lse[i])
//   dS[i,j]  = P[i,j] * (dO[i] . v[j] - delta[i])
//   dQ[i]    = scale * sum_j dS[i,j] k[j]
// with q the forward's PRE-SCALED q (so the logits match the forward's bit
// for bit and P renormalises against its lse), O and lse the forward's
// outputs (lse +1e30 on all-masked rows, so their P and dQ are 0). dS is
// rounded to q's dtype before the product with K and every sum is fp32, as
// on the TPU; `scale` is applied once, here, which makes dQ the gradient
// with respect to the unscaled q. The dK/dV pass (flash_bwd_dkv.cu) reads
// the delta this pass writes.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//   * PixArt self-attention, B=4 H=16 S=1024 D=72: three products per
//     (query, key) pair (S, dP, dQ) = 6*B*H*Sq*Sk*D = 29.0 GFLOP -> 0.0293 ms,
//     operations-bound (q, dO, O, k, v read, dQ written: 57 MB -> 0.017 ms).
//   * cross-attention, Sk = 120 masked T5 tokens (210 live keys over the
//     batch): 1.5 GFLOP against q, dO and O read and dQ written (9.4 MB each
//     in bf16) -> bytes-bound, 0.0117 ms.
// Design, the warp-specialised shape of the forward (attn_fwd_sm90.cuh):
//   * a CTA owns 128 query rows of one (b,h): two consumer warpgroups of 64
//     rows (wgmma's M) and a producer warpgroup, one warp of which issues
//     TMA; setmaxnreg moves registers from the producer (24) to the
//     consumers (240). No atomics: each CTA writes only its own rows, so dQ
//     and delta are the same bits run to run;
//   * TMA brings the Q, dO and O tiles once; the prologue computes delta for
//     the CTA's rows from O and dO in shared memory, stores it and keeps it
//     in registers beside the rows' lse, so no separate pass reads O;
//   * K/V tiles of kBN keys stream through a ring of up to 4 stages with
//     full/empty mbarriers; the producer warp writes each tile's key bias
//     (in log2 units, -inf past Sk) into a per-stage slot;
//   * per tile, S = Q K^T and dP = dO V^T are SS wgmma (both operands
//     K-major), issued together; P = exp2(S log2e + bias - lse log2e) and
//     dS = P (dP - delta) are formed in registers and rounded to bf16 in the
//     A-operand layout of dQ += dS K, an RS wgmma that reads the same K tile
//     MN-major through the descriptor's transpose bit (the forward reads V
//     so): K is staged once;
//   * the head dim lives in panels (64 columns with the 128-byte swizzle, 16
//     with the 32-byte swizzle for D = 72 -> 80, or a second 64, or for
//     SD1.5's D = 160 a second 64 and a third of 32 with the 64-byte
//     swizzle, D = 136 zero-filled to 160); TMA zero-fills past D and past S;
//   * at DP = 160 dQ alone takes 80 fp32 registers a thread beside S and dP
//     (32 each). Under two consumer warpgroups and a producer (384 threads)
//     ptxas caps a thread at 168 registers, so DP = 160 runs one consumer
//     warpgroup of 64 query rows beside the producer (256 threads, up to 255
//     registers, no setmaxnreg); the smaller row tiles leave room for four
//     stages of the ring;
//   * the epilogue scales dQ, rounds it to bf16 into the warpgroup's Q rows
//     (by then unused) and stores it with TMA, which clips rows >= Sq and
//     columns >= D.
// The (batch, head) pairs and query tiles share grid x, so B*H has no cap
// below 2^31 / (query tiles).
//
// Layout: q/dO/O/dQ [B,H,Sq,D], k/v [B,H,Sk,D], contiguous; bias [B,Sk] fp32
// or null; lse and delta [B,H,Sq] fp32. bf16 takes D % 8 == 0, D <= 160 and
// 16-byte aligned bases (the wrapper zero-pads D); fp32 goes through a
// scalar-FMA kernel that fuses delta the same way and takes any D in
// [1,160]. C interface (ctypes): tdm_flash_bwd_dq returns a cudaError_t code.

#include <math.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

// Keys per K/V tile of the bf16 kernel. With 128 keys, S and dP take 64
// fp32 registers a thread each beside dQ's 40 at D = 80; such a build
// spilled 388 B and took 1.39x as long at the PixArt self shape on an H100.
constexpr int kBN = 64;

// ---------------------------------------------------------------------------
// bf16: the wgmma/TMA kernel
// ---------------------------------------------------------------------------

// The CTA at padded head dim DP, and its shared memory in bytes from a
// 1024-aligned base: the Q, dO and O tiles [kBM rows], each as panel 0 (64
// columns) then panel 1 (W1 columns) and panel 2 (W2 columns); per stage a
// K and a V tile [kBN rows] laid out the same way; the bias slots; the
// mbarriers.
template <int DP>
struct DqLayout {
  static_assert(DP == 64 || DP == 80 || DP == 128 || DP == 160,
                "padded head dim is 64, 80, 128 or 160");
  static constexpr int kGroups = DP == 160 ? 1 : 2;    // consumer warpgroups
  static constexpr int kBM = kGroups * sm90::kWgRows;  // query rows per CTA
  static constexpr int kThreads = (kGroups + 1) * 128;
  static constexpr int W1 = DP == 160 ? 64 : DP - 64;  // second panel's width (0: none)
  static constexpr int W2 = DP - 64 - W1;              // third panel's width (0: none)
  static constexpr int kRows = kBM * DP * 2;  // one row tile
  static constexpr int kP1 = kBM * 64 * 2;    // panel 1 within a row tile
  static constexpr int kP2 = kP1 + kBM * W1 * 2;  // panel 2 within a row tile
  static constexpr int kQ = 0, kDO = kRows, kO = 2 * kRows;
  static constexpr int kTile = kBN * DP * 2;  // one K or V tile
  static constexpr int kTP2 = kBN * (64 + W1) * 2;  // panel 2 within a K or V tile
  static constexpr int kStage0 = 3 * kRows;
  static constexpr int kFit = (232448 - 2048 - kStage0) / (2 * kTile + kBN * 4);
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static_assert(kStages >= 2, "two stages fit");
  static constexpr int kBias = kStage0 + kStages * 2 * kTile;
  static constexpr int kBars = kBias + kStages * kBN * 4;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

// One 3-D map [D, S, B*H] per head-dim panel: box [64, W1 or W2 columns,
// kWgRows rows] for the row tensors, [.., kBN rows] for k and v.
struct DqMaps {
  CUtensorMap q[3], dout[3], out[3], dq[3], k[3], v[3];
};

// The sum over this lane's column pairs (c = 8n + 2t) of row r of two bf16
// row tiles in the panel layout (dO and O): the lane's part of delta.
template <int DP>
__device__ __forceinline__ float row_dot(const unsigned char* a, const unsigned char* b, int r,
                                         int t) {
  using sm90::swizzled;
  constexpr int W1 = DqLayout<DP>::W1;
  constexpr int W2 = DqLayout<DP>::W2;
  constexpr int kP1 = DqLayout<DP>::kP1;
  constexpr int kP2 = DqLayout<DP>::kP2;
  float acc = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint32_t off = swizzled<64>(r, n * 8 + t * 2);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + off));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + off));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  if constexpr (W1 != 0) {
#pragma unroll
    for (int n = 0; n < W1 / 8; ++n) {
      const uint32_t off = kP1 + swizzled<W1>(r, n * 8 + t * 2);
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + off));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + off));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  if constexpr (W2 != 0) {
#pragma unroll
    for (int n = 0; n < W2 / 8; ++n) {
      const uint32_t off = kP2 + swizzled<W2>(r, n * 8 + t * 2);
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + off));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + off));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  return acc;
}

template <int DP>
__global__ void __launch_bounds__(DqLayout<DP>::kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ DqMaps maps, const float* __restrict__ bias,
                         const float* __restrict__ lse, float* __restrict__ delta, int H, int Sq,
                         int Sk, int q_tiles, float scale) {
  using namespace sm90;
  using L = DqLayout<DP>;
  constexpr int W1 = L::W1;
  constexpr int W2 = L::W2;
  constexpr int NST = L::kStages;
  constexpr int NWG = L::kGroups;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + NST;
  uint64_t* rows_full = empty + NST;
  float* bias_s = reinterpret_cast<float*>(smem + L::kBias);
  const uint32_t base = smem_u32(smem);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * L::kBM;
  const int n_tiles = (Sk + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 32);        // the producer warp, after the bias slot
      mbar_init(&empty[s], 4 * NWG);  // every consumer warp
    }
    mbar_init(rows_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---------------- producer ----------------
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp != 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(rows_full, 3 * L::kRows);
      const CUtensorMap* srcs[3][3] = {{&maps.q[0], &maps.q[1], &maps.q[2]},
                                       {&maps.dout[0], &maps.dout[1], &maps.dout[2]},
                                       {&maps.out[0], &maps.out[1], &maps.out[2]}};
      for (int x = 0; x < 3; ++x) {
        const uint32_t tile = base + x * L::kRows;
        for (int w = 0; w < NWG; ++w) {
          const int row = q0 + w * kWgRows;
          tma_load_3d(tile + w * kWgRows * 128, srcs[x][0], rows_full, 0, row, bh);
          if (W1)
            tma_load_3d(tile + L::kP1 + w * kWgRows * W1 * 2, srcs[x][1], rows_full, 64, row,
                        bh);
          if (W2)
            tma_load_3d(tile + L::kP2 + w * kWgRows * W2 * 2, srcs[x][2], rows_full, 64 + W1,
                        row, bh);
        }
      }
    }
    const float* brow = bias ? bias + (size_t)(bh / H) * Sk : nullptr;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % NST;
      if (j >= NST) mbar_wait(&empty[s], ((j / NST) & 1) ^ 1);
      const int k0 = j * kBN;
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::kTile);
        const uint32_t kt = base + L::kStage0 + s * 2 * L::kTile, vt = kt + L::kTile;
        tma_load_3d(kt, &maps.k[0], &full[s], 0, k0, bh);
        tma_load_3d(vt, &maps.v[0], &full[s], 0, k0, bh);
        if (W1) {
          tma_load_3d(kt + kBN * 128, &maps.k[1], &full[s], 64, k0, bh);
          tma_load_3d(vt + kBN * 128, &maps.v[1], &full[s], 64, k0, bh);
        }
        if (W2) {
          tma_load_3d(kt + L::kTP2, &maps.k[2], &full[s], 64 + W1, k0, bh);
          tma_load_3d(vt + L::kTP2, &maps.v[2], &full[s], 64 + W1, k0, bh);
        }
      }
      for (int i = lane; i < kBN; i += 32) {
        const int key = k0 + i;
        bias_s[s * kBN + i] = key < Sk ? (brow ? brow[key] * kLog2e : 0.f) : -INFINITY;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---------------- consumers: 64 query rows per warpgroup ----------------
  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // rows within this warpgroup's 64
  const int row0 = q0 + wg * kWgRows + r0, row1 = row0 + 8;
  const uint32_t q_p0 = base + L::kQ + wg * kWgRows * 128;
  const uint32_t q_p1 = base + L::kQ + L::kP1 + wg * kWgRows * W1 * 2;
  const uint32_t do_p0 = base + L::kDO + wg * kWgRows * 128;
  const uint32_t do_p1 = base + L::kDO + L::kP1 + wg * kWgRows * W1 * 2;
  const uint32_t q_p2 = base + L::kQ + L::kP2 + wg * kWgRows * W2 * 2;
  const uint32_t do_p2 = base + L::kDO + L::kP2 + wg * kWgRows * W2 * 2;
  // the rows' lse in log2 units; +1e30 past Sq, so P = 0 there
  const float* lrow = lse + (size_t)bh * Sq;
  const float l2_0 = (row0 < Sq ? lrow[row0] : kLseMasked) * kLog2e;
  const float l2_1 = (row1 < Sq ? lrow[row1] : kLseMasked) * kLog2e;

  mbar_wait(rows_full, 0);
  // delta of rows r0, r1: this lane's column pairs, then the quad's sum
  float dl0, dl1;
  {
    const unsigned char* dos = smem + L::kDO;
    const unsigned char* os = smem + L::kO;
    const int wr = wg * kWgRows;  // the warpgroup's first row within the tile
    dl0 = quad_sum(row_dot<DP>(dos, os, wr + r0, t));
    dl1 = quad_sum(row_dot<DP>(dos, os, wr + r1, t));
  }
  if (t == 0) {
    float* drow = delta + (size_t)bh * Sq;
    if (row0 < Sq) drow[row0] = dl0;
    if (row1 < Sq) drow[row1] = dl1;
  }

  float dq0[32];
  float dq1[W1 ? W1 / 2 : 1];
  float dq2[W2 ? W2 / 2 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (W1 ? W1 / 2 : 1); ++i) dq1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (W2 ? W2 / 2 : 1); ++i) dq2[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NST;
    mbar_wait(&full[s], (j / NST) & 1);
    const uint32_t kt = base + L::kStage0 + s * 2 * L::kTile, vt = kt + L::kTile;

    // S = Q K^T and dP = dO V^T: 64 rows x kBN keys each, one commit group
    float sc[kBN / 2], dp[kBN / 2];
    wgmma_fence();
    product_abt<DP>(sc, q_p0, q_p1, kt, q_p2);
    product_abt<DP>(dp, do_p0, do_p1, vt, do_p2);
    wgmma_commit_and_wait();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      fence_operand(sc[i]);
      fence_operand(dp[i]);
    }

    // dS = P (dP - delta), P = exp2(S log2e + bias - lse log2e), kept in sc
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(&bias_s[s * kBN + n * 8 + t * 2]);
      sc[4 * n + 0] = exp2_approx(fmaf(sc[4 * n + 0], kLog2e, b.x - l2_0)) * (dp[4 * n + 0] - dl0);
      sc[4 * n + 1] = exp2_approx(fmaf(sc[4 * n + 1], kLog2e, b.y - l2_0)) * (dp[4 * n + 1] - dl0);
      sc[4 * n + 2] = exp2_approx(fmaf(sc[4 * n + 2], kLog2e, b.x - l2_1)) * (dp[4 * n + 2] - dl1);
      sc[4 * n + 3] = exp2_approx(fmaf(sc[4 * n + 3], kLog2e, b.y - l2_1)) * (dp[4 * n + 3] - dl1);
    }
    // dQ += dS K: dS rounded to bf16 in the A-operand layout (the
    // accumulators of two adjacent 8-key column blocks form one 16-key
    // step); K read MN-major, as the forward reads V
    uint32_t da[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      da[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      da[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      da[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      da[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(dq0[i]);
    if constexpr (W2 != 0) {
#pragma unroll
      for (int i = 0; i < W1 / 2; ++i) fence_operand(dq1[i]);
#pragma unroll
      for (int i = 0; i < W2 / 2; ++i) fence_operand(dq2[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wgmma_rs_n64(dq0, da[kk], panel_desc<64>(kt + kk * 16 * 128));
      if constexpr (W1 == 16)
        wgmma_rs_n16(dq1, da[kk], panel_desc<16>(kt + kBN * 128 + kk * 16 * 32));
      else if constexpr (W1 == 64)
        wgmma_rs_n64(dq1, da[kk], panel_desc<64>(kt + kBN * 128 + kk * 16 * 128));
      if constexpr (W2 == 32)
        wgmma_rs_n32(dq2, da[kk], panel_desc<32>(kt + L::kTP2 + kk * 16 * 64));
    }
    wgmma_commit_and_wait();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(da[kk][e]);
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(dq0[i]);
    if constexpr (W2 != 0) {
#pragma unroll
      for (int i = 0; i < W1 / 2; ++i) fence_operand(dq1[i]);
#pragma unroll
      for (int i = 0; i < W2 / 2; ++i) fence_operand(dq2[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  // epilogue: scale dQ, bf16 into this warpgroup's Q rows (its last S
  // product has completed) in the swizzled layout of the output maps
  unsigned char* qs0 = smem + L::kQ + wg * kWgRows * 128;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(qs0 + swizzled<64>(r0, c)) =
        pack_bf16(dq0[4 * n + 0] * scale, dq0[4 * n + 1] * scale);
    *reinterpret_cast<uint32_t*>(qs0 + swizzled<64>(r1, c)) =
        pack_bf16(dq0[4 * n + 2] * scale, dq0[4 * n + 3] * scale);
  }
  if constexpr (W1 != 0) {
    unsigned char* qs1 = smem + L::kQ + L::kP1 + wg * kWgRows * W1 * 2;
#pragma unroll
    for (int n = 0; n < W1 / 8; ++n) {
      const int c = n * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(qs1 + swizzled<W1>(r0, c)) =
          pack_bf16(dq1[4 * n + 0] * scale, dq1[4 * n + 1] * scale);
      *reinterpret_cast<uint32_t*>(qs1 + swizzled<W1>(r1, c)) =
          pack_bf16(dq1[4 * n + 2] * scale, dq1[4 * n + 3] * scale);
    }
  }
  if constexpr (W2 != 0) {
    unsigned char* qs2 = smem + L::kQ + L::kP2 + wg * kWgRows * W2 * 2;
#pragma unroll
    for (int n = 0; n < W2 / 8; ++n) {
      const int c = n * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(qs2 + swizzled<W2>(r0, c)) =
          pack_bf16(dq2[4 * n + 0] * scale, dq2[4 * n + 1] * scale);
      *reinterpret_cast<uint32_t*>(qs2 + swizzled<W2>(r1, c)) =
          pack_bf16(dq2[4 * n + 2] * scale, dq2[4 * n + 3] * scale);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
  if (warp == 0 && lane == 0) {
    const int row = q0 + wg * kWgRows;
    tma_store_3d(&maps.dq[0], q_p0, 0, row, bh);
    if (W1) tma_store_3d(&maps.dq[1], q_p1, 64, row, bh);
    if (W2) tma_store_3d(&maps.dq[2], q_p2, 64 + W1, row, bh);
    tma_store_commit_and_wait();
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* bias,
                        const void* dout, const void* out, const float* lse, float* delta,
                        void* dq, int BH, int H, int Sq, int Sk, int D, float scale,
                        cudaStream_t stream) {
  using L = DqLayout<DP>;
  using sm90::encode_panel, sm90::kWgRows;
  const int q_tiles = (Sq + L::kBM - 1) / L::kBM;
  if ((long long)BH * q_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = sm90::bind_current_device();
  if (err != cudaSuccess) return err;
  DqMaps maps;
  bool ok = true;
  for (int p = 0; p < 1 + (L::W1 > 0) + (L::W2 > 0); ++p) {
    const int w = p == 0 ? 64 : p == 1 ? L::W1 : L::W2;
    ok = ok && encode_panel(&maps.q[p], q, D, Sq, BH, w, kWgRows) &&
         encode_panel(&maps.dout[p], dout, D, Sq, BH, w, kWgRows) &&
         encode_panel(&maps.out[p], out, D, Sq, BH, w, kWgRows) &&
         encode_panel(&maps.dq[p], dq, D, Sq, BH, w, kWgRows) &&
         encode_panel(&maps.k[p], k, D, Sk, BH, w, kBN) &&
         encode_panel(&maps.v[p], v, D, Sk, BH, w, kBN);
  }
  if (!ok) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_sm90_kernel<DP><<<BH * q_tiles, L::kThreads, L::kAlloc, stream>>>(
      maps, bias, lse, delta, H, Sq, Sk, q_tiles, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: scalar-FMA kernel. Block = 32 query rows of one (b,h), 4 lanes per
// row (lane t owns columns t, t+4, ...); delta from the rows of dO and O,
// then a loop over 32-key tiles.
// ---------------------------------------------------------------------------

constexpr int kFR = 32;
constexpr int kFK = 32;

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ dout, const float* __restrict__ out,
                        const float* __restrict__ lse, float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Sq, int Sk, int D, float scale) {
  constexpr int DPAD = NJ * 4;
  __shared__ float ks[kFK][DPAD];
  __shared__ float vs[kFK][DPAD];
  __shared__ float bs[kFK];

  const int bh = blockIdx.x;
  const int row = blockIdx.y * kFR + threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const float* qg = q + (size_t)bh * Sq * D;
  const float* dg = dout + (size_t)bh * Sq * D;
  const float* og = out + (size_t)bh * Sq * D;
  const float* kg = k + (size_t)bh * Sk * D;
  const float* vg = v + (size_t)bh * Sk * D;
  const float* bg = bias ? bias + (size_t)(bh / H) * Sk : nullptr;

  float qr[NJ], dr[NJ], acc[NJ];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = j * 4 + t;
    const bool in = row < Sq && c < D;
    qr[j] = in ? qg[(size_t)row * D + c] : 0.f;
    dr[j] = in ? dg[(size_t)row * D + c] : 0.f;
    part = fmaf(dr[j], in ? og[(size_t)row * D + c] : 0.f, part);
    acc[j] = 0.f;
  }
  const float dl = quad_sum(part);
  if (row < Sq && t == 0) delta[(size_t)bh * Sq + row] = dl;
  const float lr = row < Sq ? lse[(size_t)bh * Sq + row] : kLseMasked;

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
#pragma unroll 4
    for (int j = 0; j < kFK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        s = fmaf(qr[c], ks[j][c * 4 + t], s);
        dp = fmaf(dr[c], vs[j][c * 4 + t], dp);
      }
      const float ds = expf(quad_sum(s) + bs[j] - lr) * (quad_sum(dp) - dl);
#pragma unroll
      for (int c = 0; c < NJ; ++c) acc[c] = fmaf(ds, ks[j][c * 4 + t], acc[c]);
    }
  }
  if (row < Sq) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = j * 4 + t;
      if (c < D) dq[(size_t)bh * Sq * D + (size_t)row * D + c] = acc[j] * scale;
    }
  }
}

template <int NJ>
struct LaunchF32 {
  static cudaError_t run(const void* q, const void* k, const void* v, const float* bias,
                         const void* dout, const void* out, const float* lse, float* delta,
                         void* dq, int B, int H, int Sq, int Sk, int D, float scale,
                         cudaStream_t stream) {
    dim3 grid(B * H, (Sq + kFR - 1) / kFR);
    flash_bwd_dq_f32_kernel<NJ><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<const float*>(dout),
        static_cast<const float*>(out), lse, delta, static_cast<float*>(dq), H, Sq, Sk, D,
        scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. out: the forward's output; delta: the
// [B,H,Sq] fp32 output that receives rowsum(dO * O). Returns a cudaError_t
// code.
int tdm_flash_bwd_dq(const void* q, const void* k, const void* v, const float* bias,
                     const void* dout, const void* out, const float* lse, float* delta, void* dq,
                     int batch, int heads, int sq, int sk, int d, float scale, int dtype,
                     void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 160 ||
      (long long)batch * heads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (dtype == 1) {
    if (d % 8 != 0 || !sm90::aligned16({q, k, v, dout, out, dq}))
      return (int)cudaErrorInvalidValue;
    if (d <= 64)
      return (int)launch_bf16<64>(q, k, v, bias, dout, out, lse, delta, dq, bh, heads, sq, sk, d,
                                  scale, s);
    if (d <= 80)
      return (int)launch_bf16<80>(q, k, v, bias, dout, out, lse, delta, dq, bh, heads, sq, sk, d,
                                  scale, s);
    if (d <= 128)
      return (int)launch_bf16<128>(q, k, v, bias, dout, out, lse, delta, dq, bh, heads, sq, sk,
                                   d, scale, s);
    return (int)launch_bf16<160>(q, k, v, bias, dout, out, lse, delta, dq, bh, heads, sq, sk, d,
                                 scale, s);
  }
  if (dtype == 0) {
    if ((sq + kFR - 1) / kFR > 65535) return (int)cudaErrorInvalidValue;
    if (d > 128)  // 40 columns a lane: the fp32 sweep above 128
      return (int)LaunchF32<40>::run(q, k, v, bias, dout, out, lse, delta, dq, batch, heads, sq,
                                     sk, d, scale, s);
    return (int)by_padded_dim_f32<LaunchF32>(d, q, k, v, bias, dout, out, lse, delta, dq, batch,
                                             heads, sq, sk, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Dynamic shared memory of one bf16 CTA at head dim d (the -Xptxas -v
// report counts static shared memory only).
extern "C" int tdm_flash_bwd_dq_smem_bytes(int d) {
  return d <= 64    ? DqLayout<64>::kAlloc
         : d <= 80  ? DqLayout<80>::kAlloc
         : d <= 128 ? DqLayout<128>::kAlloc
                    : DqLayout<160>::kAlloc;
}
