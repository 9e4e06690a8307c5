"""Ring attention: attention over a sequence sharded along the 'sp' ring.

Port of `tdm_tpu/ops/ring_attention.py`'s flash-hop ring (`_hop_flash`,
`_ring_flash_fwd`/`_ring_flash_bwd`, `:223-371`). Each rank holds a
contiguous shard of Q/K/V; the K/V shards travel around the ring
(`parallel/mesh.ppermute`, to the next rank, from the previous one) and
every hop runs the flash kernels of `ops/attention.py` on the local queries
against the K/V shard at hand:

  * forward: the query is pre-scaled once and rounded back to its dtype
    (`:258`), and every hop calls `flash_attention_fwd_lse` (kernel 1 with
    its lse, also under `torch.no_grad()`: the merge needs it). A hop's
    +1e30 all-masked sentinel becomes −1e30, so a hop whose keys are all
    masked merges with weight 0 (`:233`). The hops' outputs and lse merge
    in fp32 (`:279-288`):

        out = Σ_i o_i e^{lse_i − M} / Σ_i e^{lse_i − M},
        lse = M + log Σ_i e^{lse_i − M},   M = max_i lse_i.

    A row that is valid on no hop outputs 0 and keeps lse +1e30
    (`:293-298`), so the backward's P = exp(s − lse) is 0 there.
  * backward (`RingFlashAttention`, a `torch.autograd.Function`, the
    custom VJP of `:302-371`): each hop runs `flash_attention_bwd_dq`
    (kernel 2; Δ = rowsum(dO∘O) from the MERGED output) and
    `flash_attention_bwd_dkv` (kernel 3), both driven by the merged lse,
    so every hop's keys see the global P and the hops' partials sum to the
    monolithic gradients. dQ accumulates in fp32; the fp32 dK/dV
    accumulators ride the ring with their shard and come home after the
    full cycle (the last permute carries the accumulators alone).

`prefix_kv=(k_p, v_p)` is a K/V block that every rank holds whole (the
T5 rows of CogVideoX's joint attention): its hop seeds the merge and is
attended exactly once; without a prefix the local hop seeds it. The
prefix's dK/dV stay local. The hops, the merge and the permutes run in the
same order on every rank, which the remat recompute of a block repeats.

The merge and the permutes are PyTorch, as the JAX package leaves them to
XLA. On a CPU tensor the kernels' wrappers take their plain versions, so
the same code is the CPU ring; `plain_ring_attention` calls the plain
versions on any device (the card's check of the ring against itself).
There is one route: 'auto', 'pallas' and 'xla' all take the flash hops
(the port's attention routes), and 'splash' raises the JAX ValueError.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from tdm_tpu_torch.ops import attention as A
from tdm_tpu_torch.parallel import mesh as pmesh

IMPLS = ("auto", "pallas", "xla")
_SENTINEL = 1e29  # an lse at or above it is the kernels' all-masked +1e30


class HopOps(NamedTuple):
    """The three per-hop functions: the lse forward, dQ with Δ, dK/dV."""

    fwd_lse: object
    bwd_dq: object
    bwd_dkv: object


KERNELS = HopOps(A.flash_attention_fwd_lse, A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv)
PLAIN = HopOps(A.plain_attention_lse, A.plain_attention_bwd_dq, A.plain_attention_bwd_dkv)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: pmesh.AxisGroup,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    prefix_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    prefix_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention of the local query shard q [B, H, S_loc, D] over the K/V
    shards of every rank of `group` (k, v [B, H, S_loc_k, D] here; each
    rank's key_mask [B, S_loc_k] travels with its shard), plus the
    `prefix_kv` block every rank holds whole (with `prefix_mask`), attended
    once. Returns the local output shard [B, H, S_loc, D] in q's dtype;
    differentiable in q, k, v and the prefix."""
    if impl not in IMPLS:
        raise ValueError(f"unknown ring attention impl {impl!r}")
    return _apply(KERNELS, q, k, v, group, key_mask, scale, prefix_kv, prefix_mask)


def plain_ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: pmesh.AxisGroup,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    prefix_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    prefix_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`ring_attention` with the kernels' plain versions on every hop, on
    any device."""
    return _apply(PLAIN, q, k, v, group, key_mask, scale, prefix_kv, prefix_mask)


def _apply(ops, q, k, v, group, key_mask, scale, prefix_kv, prefix_mask):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    bias = None if key_mask is None else A.key_bias(key_mask)
    k_p = v_p = bias_p = None
    if prefix_kv is not None:
        k_p, v_p = (t.contiguous() for t in prefix_kv)
        bias_p = None if prefix_mask is None else A.key_bias(prefix_mask)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    tensors = (q, k, v) if k_p is None else (q, k, v, k_p, v_p)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return RingFlashAttention.apply(q, k, v, k_p, v_p, bias, bias_p, group, float(scale),
                                        ops)
    qs = (q.to(A._acc(q)) * scale).to(q.dtype)
    return ring_forward(ops, qs, k, v, bias, k_p, v_p, bias_p, group)[0]


def _hop(ops, qs, k, v, bias):
    """One hop: its normalised output in fp32 and its lse [B, H, Sq], the
    all-masked sentinel mapped to −1e30."""
    out, lse = ops.fwd_lse(qs, k, v, bias)
    lse = torch.where(lse >= _SENTINEL, torch.full_like(lse, -1e30), lse)
    return out.float(), lse


def _shard(k, v, bias) -> list:
    return [k, v] if bias is None else [k, v, bias]


def _unshard(parts: list):
    return parts[0], parts[1], (parts[2] if len(parts) == 3 else None)


def ring_forward(ops, qs, k, v, bias, k_p, v_p, bias_p, group):
    """The merged output (q's dtype) and lse (fp32, +1e30 on rows valid on
    no hop) of the pre-scaled query over the ring and the prefix."""
    n = group.n
    if k_p is not None:
        num, m_run = _hop(ops, qs, k_p, v_p, bias_p)
        shard, left = (k, v, bias), n
    else:
        num, m_run = _hop(ops, qs, k, v, bias)
        shard, left = None, n - 1
        if left:
            shard = _unshard(pmesh.ppermute(_shard(k, v, bias), group))
    den = torch.ones_like(m_run)
    for i in range(left):
        o_i, lse_i = _hop(ops, qs, *shard)
        m_new = torch.maximum(m_run, lse_i)
        w_run, w_i = torch.exp(m_run - m_new), torch.exp(lse_i - m_new)
        num = num * w_run[..., None] + o_i * w_i[..., None]
        den = den * w_run + w_i
        m_run = m_new
        if i < left - 1:
            shard = _unshard(pmesh.ppermute(_shard(*shard), group))
    valid = m_run > -_SENTINEL
    out = torch.where(valid[..., None], num / den[..., None], 0.0).to(qs.dtype)
    lse = torch.where(valid, m_run + torch.log(den), torch.full_like(m_run, 1e30))
    return out.contiguous(), lse.contiguous()


class RingFlashAttention(torch.autograd.Function):
    """forward(q, k, v, k_p, v_p, bias, bias_p, group, scale, ops) → the
    local output; the biases, the group and the ops get no gradient, and
    without a prefix k_p/v_p are None and get none."""

    @staticmethod
    def forward(ctx, q, k, v, k_p, v_p, bias, bias_p, group, scale, ops):
        qs = (q.to(A._acc(q)) * scale).to(q.dtype)
        out, lse = ring_forward(ops, qs, k, v, bias, k_p, v_p, bias_p, group)
        ctx.save_for_backward(qs, k, v, k_p, v_p, bias, bias_p, out, lse)
        ctx.group, ctx.scale, ctx.ops = group, scale, ops
        return out

    @staticmethod
    def backward(ctx, dout):
        qs, k, v, k_p, v_p, bias, bias_p, out, lse = ctx.saved_tensors
        group, scale, ops = ctx.group, ctx.scale, ctx.ops
        n = group.n
        g = dout.to(qs.dtype).contiguous()

        def hop_bwd(k_i, v_i, b_i):
            dq, delta = ops.bwd_dq(qs, k_i, v_i, b_i, g, out, lse, scale)
            dk, dv = ops.bwd_dkv(qs, k_i, v_i, b_i, g, lse, delta)
            return dq, dk, dv

        dk_p = dv_p = None
        if k_p is not None:  # the prefix's dK/dV stay local
            dq, dk_p, dv_p = hop_bwd(k_p, v_p, bias_p)
            dq_acc = dq.float()
            dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            dv_acc = torch.zeros_like(dk_acc)
            shard, left = (k, v, bias), n
        else:  # the local hop seeds the accumulators, which then travel
            dq, dk0, dv0 = hop_bwd(k, v, bias)
            dq_acc, dk_acc, dv_acc = dq.float(), dk0.float(), dv0.float()
            shard, left = (k, v, bias), n - 1
            if left:
                *kvb, dk_acc, dv_acc = pmesh.ppermute([*_shard(k, v, bias), dk_acc, dv_acc],
                                                      group)
                shard = _unshard(kvb)
        for i in range(left):
            dq_h, dk_h, dv_h = hop_bwd(*shard)
            dq_acc += dq_h.float()
            dk_acc = dk_acc + dk_h.float()
            dv_acc = dv_acc + dv_h.float()
            if n == 1:
                break
            if i < left - 1:
                *kvb, dk_acc, dv_acc = pmesh.ppermute([*_shard(*shard), dk_acc, dv_acc],
                                                      group)
                shard = _unshard(kvb)
            else:  # the return hop: the accumulators alone come home
                dk_acc, dv_acc = pmesh.ppermute([dk_acc, dv_acc], group)
        return (dq_acc.to(qs.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype),
                dk_p, dv_p, None, None, None, None, None)
