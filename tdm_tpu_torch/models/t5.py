"""The T5 v1.1 encoder, the text backbone of PixArt, CogVideoX and SD3.

Port of `tdm_tpu/models/t5.py` (the JAX package's rebuild of
`transformers.T5EncoderModel`): a shared token embedding and no absolute
positions, a learned *relative* position bias (bucketed log distance, 32
buckets up to distance 128) computed in block 0 and shared by every block;
each block is [RMSNorm → self-attention (no biases, an UNSCALED q·kᵀ) →
residual], then [RMSNorm → gated-GELU feed-forward (gelu_tanh(wi_0) ⊙
wi_1 → wo) → residual]; a final RMSNorm. Padded keys get an additive −1e9.

Module and parameter names are the JAX tree's (`shared_embedding`,
`block_{i}/SelfAttention/{q,k,v,o}`, `relative_attention_bias` in block 0,
`ln_attn`, `ln_ff`, `wi_0`, `wi_1`, `wo`, `final_layer_norm`), so the
weight carry (`io/from_jax.py`) moves a tree in by name. Dense weights and
the token embedding are held in the compute dtype (the JAX package casts
its fp32 params to it at use, which gives the same values); the relative
bias and the RMSNorm scales stay fp32, and the logits, the bias, the mask
and the softmax are fp32, as in JAX.

The attention is two plain products around an fp32 softmax, as the JAX
package computes it: the flash kernel takes a key mask but no per-head
[H, Sq, Sk] bias (and S ≤ 256 for text).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import layers as L


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096  # t5-v1_1-xxl
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(
            vocab_size=128, d_model=32, d_kv=8, num_heads=4, d_ff=64,
            num_layers=2, dtype=torch.float32,
        )


def relative_position_bucket(
    relative_position: np.ndarray, num_buckets: int, max_distance: int
) -> np.ndarray:
    """Bidirectional bucketed relative positions (HF `_relative_position_bucket`
    with bidirectional=True): half the buckets for each sign, small offsets
    exact, large offsets log-spaced. The port's own numpy copy of the JAX
    package's function."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, n, large)


def _dense(in_dim: int, out_dim: int, cfg: T5Config, device) -> L.Dense:
    return L.Dense(in_dim, out_dim, bias=False, dtype=cfg.dtype, device=device)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_rel_bias: bool = False, *, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = _dense(cfg.d_model, inner, cfg, device)
        self.k = _dense(cfg.d_model, inner, cfg, device)
        self.v = _dense(cfg.d_model, inner, cfg, device)
        self.o = _dense(inner, cfg.d_model, cfg, device)
        self.relative_attention_bias = (
            nn.Parameter(torch.zeros(cfg.rel_buckets, cfg.num_heads, device=device))
            if has_rel_bias else None
        )

    def position_bias(self, s: int) -> torch.Tensor:
        """The shared fp32 bias [1, H, S, S] from the bucket table."""
        c = self.cfg
        ctx = np.arange(s)
        buckets = relative_position_bucket(ctx[None, :] - ctx[:, None], c.rel_buckets,
                                           c.rel_max_distance)  # [Sq, Sk]
        idx = torch.from_numpy(buckets).to(self.relative_attention_bias.device)
        return self.relative_attention_bias[idx].permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                pos_bias: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        b, s, _ = x.shape
        if self.relative_attention_bias is not None:
            pos_bias = self.position_bias(s)

        def split(t):
            return t.reshape(b, s, c.num_heads, c.d_kv).transpose(1, 2)

        qh, kh, vh = split(self.q(x)), split(self.k(x)), split(self.v(x))
        # unscaled q·kᵀ accumulated and kept in fp32 (JAX's
        # preferred_element_type=float32), plus the fp32 bias and key mask
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        logits = logits + pos_bias.float()
        if mask is not None:
            keep = mask[:, None, None, :].bool()
            logits = logits + torch.where(keep, 0.0, -1e9)
        probs = torch.softmax(logits, dim=-1).to(vh.dtype)
        out = torch.matmul(probs.float(), vh.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, s, c.num_heads * c.d_kv)
        return self.o(out), pos_bias


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_rel_bias: bool = False, *, device=None):
        super().__init__()
        self.ln_attn = L.RMSNorm(cfg.d_model, cfg.layer_norm_eps, dtype=cfg.dtype, device=device)
        self.SelfAttention = T5Attention(cfg, has_rel_bias, device=device)
        self.ln_ff = L.RMSNorm(cfg.d_model, cfg.layer_norm_eps, dtype=cfg.dtype, device=device)
        self.wi_0 = _dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.wi_1 = _dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.wo = _dense(cfg.d_ff, cfg.d_model, cfg, device)

    def forward(self, x, mask, pos_bias):
        attn_out, pos_bias = self.SelfAttention(self.ln_attn(x), mask, pos_bias)
        x = x + attn_out
        h = self.ln_ff(x)
        h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        return x + self.wo(h), pos_bias


class T5Encoder(nn.Module):
    """forward(input_ids [B, S], attention_mask [B, S] or None) →
    [B, S, d_model] in the compute dtype (the frozen `T5EncoderModel`
    forward, `text_encoder(input_ids, attention_mask)[0]`). Built on `device`
    (CUDA unless the caller passes 'cpu')."""

    def __init__(self, cfg: Optional[T5Config] = None, *, device=None):
        super().__init__()
        cfg = cfg or T5Config()
        self.cfg = cfg
        dev = resolve_device(device)
        self.shared_embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype, device=dev))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", T5Block(cfg, has_rel_bias=(i == 0), device=dev))
        self.final_layer_norm = L.RMSNorm(cfg.d_model, cfg.layer_norm_eps, dtype=cfg.dtype,
                                          device=dev)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = self.shared_embedding.device
        input_ids = torch.as_tensor(input_ids, device=dev).long()
        if attention_mask is not None:
            attention_mask = torch.as_tensor(attention_mask, device=dev)
        x = self.shared_embedding[input_ids].to(self.cfg.dtype)
        pos_bias = None
        for i in range(self.cfg.num_layers):
            x, pos_bias = getattr(self, f"block_{i}")(x, attention_mask, pos_bias)
        return self.final_layer_norm(x)
