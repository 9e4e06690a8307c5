"""SD3 MMDiT denoiser in PyTorch (serving and training).

Port of `tdm_tpu/models/mmdit_sd3.py`, the SD3-Medium transformer of the
reference's headline recipe (TDM-SD3-LoRA, 4 steps, 1024²): latent
16×128×128, patch 2 → 4096 image tokens; 24 dual-stream joint blocks of
24 heads × 64 (hidden 1536); conditioning = sinusoidal timestep MLP +
pooled CLIP (2048) MLP, summed into adaLN-Zero modulation; context
(CLIP + T5, 4096 wide) projected to the hidden width. Image and text tokens
project separately and attend as one sequence (4096 + 333 = 4429 tokens at
1024²); the last block drops the text stream (`context_pre_only`). The
position table is the fixed sin-cos one at `pos_embed_max_size`, centre
cropped to the grid. The output is the flow velocity v = ε − x₀.

SD3.5 variants: RMS qk norm (`qk_norm='rms'`, one norm over the joint
q/k) and `dual_attention_layers`, blocks with an extra image-stream
self-attention (`attn2`) gated by three more modulation vectors.

Attention goes through `ops.attention` with `cfg.attn_impl`: 'splash' takes
the splash kernel (`csrc/splash_fwd.cu`) for the unmasked joint attention
at head dim 64/128; the JAX package's 'auto', 'pallas' and 'xla' all
compute one function and take the flash route (under autograd, the flash
forward with its lse and the backward kernels). Training holds fp32 master
weights (`param_dtype=torch.float32`) and `cfg.remat` checkpoints each
joint block when autograd records the forward (`layers.checkpoint_block`,
full recomputation, as the JAX package's `nn.remat`). The blocks are one
ModuleList; the weight carry (`io/from_jax.py`) reads the JAX package's
scanned tree (`blocks_dual`/`blocks` stacks plus the unrolled last block
`blocks_{N-1}`) and its unrolled `blocks_{i}` tree alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import layers as L
from tdm_tpu_torch.parallel import tp as tp_lib

@dataclass(frozen=True)
class MMDiTConfig:
    sample_size: int = 128  # latent H = W at 1024px
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    num_heads: int = 24
    head_dim: int = 64
    context_dim: int = 4096  # joint_attention_dim (T5 / padded CLIP)
    pooled_dim: int = 2048  # pooled CLIP-L+G
    pos_embed_max_size: int = 192
    qk_norm: Optional[str] = None  # 'rms' for the SD3.5 family
    # blocks with SD3.5's extra image-stream self-attention; a prefix
    # 0..d-1 under scan_layers (the JAX package's 'blocks_dual' stack)
    dual_attention_layers: tuple = ()
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"
    # the JAX package's layer layout: True = stacked 'blocks_dual'/'blocks'
    # trees plus an unrolled last block; the port always holds a ModuleList
    scan_layers: bool = True
    # per-block activation checkpointing (--gradient_checkpointing): each
    # joint block recomputed in the backward
    remat: bool = False

    @property
    def hidden(self) -> int:
        return self.num_heads * self.head_dim

    @staticmethod
    def sd35_medium() -> "MMDiTConfig":
        """SD3.5-Medium: 23 layers, RMS qk norm, dual attention on blocks
        0-12, pos_embed_max_size 384."""
        return MMDiTConfig(
            num_layers=23, qk_norm="rms",
            dual_attention_layers=tuple(range(13)), pos_embed_max_size=384,
        )

    @staticmethod
    def sd35_large() -> "MMDiTConfig":
        """SD3.5-Large: 38 layers, 38 heads × 64 (hidden 2432), RMS qk norm."""
        return MMDiTConfig(num_layers=38, num_heads=38, head_dim=64, qk_norm="rms")

    @staticmethod
    def tiny() -> "MMDiTConfig":
        """Small config for tests (the real topology at tiny widths)."""
        return MMDiTConfig(
            sample_size=8, num_layers=2, num_heads=2, head_dim=16,
            context_dim=48, pooled_dim=24, pos_embed_max_size=16,
            dtype=torch.float32, attn_impl="xla",
        )


class AdaLNZero(nn.Module):
    """silu(temb) → linear → n modulation vectors [B, n, dim] (diffusers
    AdaLayerNormZero emits 6, AdaLayerNormZeroX 9, AdaLayerNormContinuous
    2)."""

    def __init__(self, n: int, dim: int, **kw):
        super().__init__()
        self.n, self.dim = n, dim
        self.linear = L.Dense(dim, n * dim, **kw)

    def forward(self, temb: torch.Tensor) -> torch.Tensor:
        return self.linear(F.silu(temb)).reshape(temb.shape[0], self.n, self.dim)


class JointBlock(nn.Module):
    """One MMDiT joint block. Under 'tp' (`parallel/tp.py`) a rank runs
    heads/n of the joint attention's heads: the six q/k/v projections
    column-parallel behind f, to_out and to_add_out row-parallel; the RMS
    qk norm is per head and stays local."""

    tp = None
    _COLUMNS = ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj")

    def __init__(self, cfg: MMDiTConfig, *, context_pre_only: bool = False,
                 dual_attention: bool = False, device=None, param_dtype=None):
        super().__init__()
        c = cfg
        inner = c.hidden
        kw = dict(dtype=c.dtype, param_dtype=param_dtype, device=device)
        self.cfg, self.impl = c, L.attn_route(c.attn_impl)
        self.context_pre_only, self.dual_attention = context_pre_only, dual_attention
        self.norm1 = AdaLNZero(9 if dual_attention else 6, inner, **kw)
        self.norm1_context = AdaLNZero(2 if context_pre_only else 6, inner, **kw)
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            self.add_module(name, L.Dense(inner, inner, **kw))
        if c.qk_norm == "rms":
            self.norm_q = L.RMSNorm(c.head_dim, dtype=c.dtype, device=device)
            self.norm_k = L.RMSNorm(c.head_dim, dtype=c.dtype, device=device)
        elif c.qk_norm is not None:
            raise ValueError(f"unknown qk_norm {c.qk_norm!r} (None or 'rms')")
        self.to_out = L.Dense(inner, inner, **kw)
        if dual_attention:
            self.attn2 = L.Attention(inner, c.num_heads, c.head_dim,
                                     qk_norm=c.qk_norm, impl=self.impl, **kw)
        self.ff = L.FeedForward(inner, 4, **kw)
        if not context_pre_only:
            self.to_add_out = L.Dense(inner, inner, **kw)
            self.ff_context = L.FeedForward(inner, 4, **kw)

    def _rows(self) -> tuple:
        return ("to_out",) if self.context_pre_only else ("to_out", "to_add_out")

    def tp_cuts(self, n: int) -> dict:
        return L.tp_cuts(self, n, self.cfg.num_heads % n == 0, self._COLUMNS, self._rows())

    def set_tp(self, tp) -> None:
        L.set_tp(self, tp, self._COLUMNS, self._rows(), ("norm_q", "norm_k"))

    def forward(self, x, ctx, temb):
        """x [B,S,D] image tokens, ctx [B,L,D] text tokens, temb [B,D] →
        (x, ctx), ctx None after the context_pre_only block."""
        c = self.cfg
        b, s, inner = x.shape
        mod_x = self.norm1(temb)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = (
            mod_x[:, i : i + 1] for i in range(6))
        mod_c = self.norm1_context(temb)
        if self.context_pre_only:  # AdaLayerNormContinuous order: (scale, shift)
            csc, csh = mod_c[:, 0:1], mod_c[:, 1:2]
        else:
            csh, csc, c_g_msa, c_sh_mlp, c_sc_mlp, c_g_mlp = (
                mod_c[:, i : i + 1] for i in range(6))

        hx = L.layer_norm(x) * (1 + sc_msa) + sh_msa
        hc = L.layer_norm(ctx) * (1 + csc) + csh
        heads = c.num_heads
        if self.tp is not None:
            heads //= self.tp.n
            hx, hc = tp_lib.copy_to_tp(hx, self.tp), tp_lib.copy_to_tp(hc, self.tp)

        def split(t):
            return t.reshape(b, -1, heads, c.head_dim).transpose(1, 2).contiguous()

        q = split(torch.cat([self.to_q(hx), self.add_q_proj(hc)], dim=1))
        k = split(torch.cat([self.to_k(hx), self.add_k_proj(hc)], dim=1))
        v = split(torch.cat([self.to_v(hx), self.add_v_proj(hc)], dim=1))
        if c.qk_norm == "rms":
            q, k = self.norm_q(q), self.norm_k(k)
        out = L.fused_attention(q, k, v, impl=self.impl)
        out = out.transpose(1, 2).reshape(b, -1, heads * c.head_dim)
        out_x, out_c = out[:, :s], out[:, s:]

        x_in = x
        x = x_in + g_msa * self.to_out(out_x)
        if self.dual_attention:
            # the parallel branch reads the block's input, as the HF block does
            sh_msa2, sc_msa2, g_msa2 = (mod_x[:, i : i + 1] for i in range(6, 9))
            hx2 = L.layer_norm(x_in) * (1 + sc_msa2) + sh_msa2
            x = x + g_msa2 * self.attn2(hx2)
        hx = L.layer_norm(x) * (1 + sc_mlp) + sh_mlp
        x = x + g_mlp * self.ff(hx)
        if self.context_pre_only:
            return x, None
        ctx = ctx + c_g_msa * self.to_add_out(out_c)
        hc = L.layer_norm(ctx) * (1 + c_sc_mlp) + c_sh_mlp
        ctx = ctx + c_g_mlp * self.ff_context(hc)
        return x, ctx


def block_kinds(cfg: MMDiTConfig) -> list[tuple[bool, bool]]:
    """(context_pre_only, dual_attention) of each block, as the JAX package
    builds them: under scan_layers the dual set must be a prefix, and the
    last block (unrolled, context_pre_only) has no dual attention even when
    the prefix reaches it; unrolled, block i is dual when i is listed."""
    n, dual = cfg.num_layers, set(cfg.dual_attention_layers)
    if cfg.scan_layers and n > 1:
        if dual and dual != set(range(len(dual))):
            raise ValueError(
                "scan_layers requires dual_attention_layers to be a contiguous "
                f"prefix 0..{len(dual) - 1}, got {sorted(dual)} (use "
                "scan_layers=False otherwise)"
            )
        return [(i == n - 1, i in dual and i < n - 1) for i in range(n)]
    return [(i == n - 1, i in dual) for i in range(n)]


class SD3Transformer2D(nn.Module):
    """forward(latent [B,16,H,W], t [B] (∈ [0, 1000], the flow σ·1000),
    context [B,L,context_dim], pooled [B,pooled_dim]) → velocity
    [B,16,H,W] in latent's dtype."""

    def __init__(
        self,
        cfg: Optional[MMDiTConfig] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
        param_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else MMDiTConfig()
        dev = resolve_device(device)
        kw = dict(dtype=c.dtype, param_dtype=param_dtype, device=dev)
        self.pos_embed = L.PatchEmbed(c.patch_size, c.in_channels, c.hidden,
                                      add_pos_embed=False, **kw)
        self.timestep_embedder = L.TimestepEmbedding(256, c.hidden, **kw)
        self.text_embedder = L.TimestepEmbedding(c.pooled_dim, c.hidden, **kw)
        self.context_embedder = L.Dense(c.context_dim, c.hidden, **kw)
        self.blocks = nn.ModuleList(
            JointBlock(c, context_pre_only=pre, dual_attention=dual, device=dev,
                       param_dtype=param_dtype)
            for pre, dual in block_kinds(c)
        )
        self.norm_out = AdaLNZero(2, c.hidden, **kw)
        self.proj_out = L.Dense(c.hidden, c.patch_size ** 2 * c.out_channels, **kw)
        self._pos: dict = {}  # (gh, gw, device, dtype) → [1, gh*gw, hidden]

    def _pos_table(self, gh: int, gw: int, ref: torch.Tensor) -> torch.Tensor:
        """The cropped sin-cos table on ref's device and dtype, built once
        per grid (25 MB at 1024²: not uploaded at every forward)."""
        key = (gh, gw, ref.device, ref.dtype)
        pos = self._pos.get(key)
        if pos is None:
            c = self.cfg
            table = L.cropped_sincos_pos_embed(
                c.hidden, c.pos_embed_max_size, gh, gw,
                base_size=c.sample_size // c.patch_size)
            pos = self._pos[key] = torch.from_numpy(table).to(ref.device, ref.dtype)[None]
        return pos

    def forward(self, latent, t, context, pooled):
        c = self.cfg
        b, _, h, w = latent.shape
        p = c.patch_size
        gh, gw = h // p, w // p
        t = torch.as_tensor(t, device=latent.device)
        if t.dim() == 0:
            t = t.expand(b)
        x = self.pos_embed(latent.to(c.dtype))
        x = x + self._pos_table(gh, gw, x)
        temb = self.timestep_embedder(
            L.sinusoidal_timestep_embedding(t, 256).to(c.dtype))
        temb = temb + self.text_embedder(pooled.to(c.dtype))
        ctx = self.context_embedder(context.to(c.dtype))
        remat = c.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x, ctx = L.checkpoint_block(block, x, ctx, temb)
            else:
                x, ctx = block(x, ctx, temb)
        mod = self.norm_out(temb)  # AdaLayerNormContinuous: (scale, shift)
        x = L.layer_norm(x) * (1 + mod[:, 0:1]) + mod[:, 1:2]
        x = self.proj_out(x)
        return L.unpatchify(x, gh, gw, p, c.out_channels).to(latent.dtype)


def make_denoise_fn(model: SD3Transformer2D):
    """The solvers' `DenoiseFn`: (x, t, (context, pooled)) → flow velocity;
    t is the grid's continuous model_t."""

    def fn(x, t, cond):
        context, pooled = cond
        return model(x, t, context, pooled)

    return fn
