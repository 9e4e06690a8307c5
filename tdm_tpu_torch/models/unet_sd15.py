"""SD1.5 UNet denoiser in PyTorch: the Dreamshaper recipe's model.

Port of `tdm_tpu/models/unet_sd15.py` (diffusers `UNet2DConditionModel` at
the SD1.5 checkpoint's config):
  * latent 4×64×64 (512²), block widths (320, 640, 1280, 1280), 2 layers
    per block, 8 heads (head dims 40, 80, 160), CLIP-L context 768;
  * down: 3× [ResBlock + SpatialTransformer] pairs, then 2 ResBlocks, a
    stride-2 conv with symmetric padding 1 between stages; mid: ResBlock →
    SpatialTransformer → ResBlock; up: the mirror with 3 ResBlocks a stage,
    each on the channel concatenation of the running tensor and a skip,
    nearest ×2 upsampling then a conv between stages;
  * SpatialTransformer: GroupNorm (eps 1e-6) → proj_in → one
    TransformerBlock (LayerNorm → self-attention → LayerNorm →
    cross-attention to the CLIP tokens → LayerNorm → GEGLU feed-forward,
    each a residual; q/k/v without bias) → proj_out, plus the input;
  * ResBlock: GroupNorm (eps 1e-5) → SiLU → conv → + the projected time
    embedding → GroupNorm → SiLU → conv, plus the input (a 1×1
    conv_shortcut where the width changes);
  * time: sinusoidal 320 (flip_sin_to_cos, shift 0) → a SiLU MLP to 1280;
  * ε-prediction.
GroupNorms and LayerNorms run in fp32 with fp32 `scale`/`bias`; the
convolutions and Dense layers compute in `cfg.dtype` (bf16 serving). The
layout is NCHW at every module boundary (the JAX package computes NHWC and
transposes at the model's edges). Module names are the JAX tree's
(`down_{i}_res_{j}`, `down_{i}_attn_{j}`, `down_{i}_downsample`,
`mid_res_0/1`, `mid_attn`, `up_{i}_res_{j}`, `up_{i}_attn_{j}`,
`up_{i}_upsample`, `transformer_blocks_0`), so the weight carry
(`io/from_jax.py`) and the kohya LoRA keys map one to one. Every attention
call goes through `ops.attention`, the flash kernel on CUDA: at 512², 16
transformers with one self and one cross call each, 32 launches a forward.

The convolutions run without cuDNN (PyTorch's own im2col + cuBLAS GEMM):
on an H100, cuDNN's bf16 engine for them (a warp-specialised implicit GEMM
with a device workspace) gave a row different bits from one call to the
next, also under `cudnn.deterministic`, so a served (prompt, seed) changed
with its batch-mates (7 of 24 rounds of three batches); without cuDNN, 0 of
24, in the same time per round.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import layers as L


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_widths: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_heads: int = 8
    context_dim: int = 768  # CLIP-L hidden
    norm_groups: int = 32
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"
    # the JAX config's --gradient_checkpointing field: accepted so its
    # pipeline.json loads; refused when switched on (sd15 training)
    remat: bool = False

    @staticmethod
    def tiny() -> "UNetConfig":
        return UNetConfig(block_widths=(32, 64), layers_per_block=1, num_heads=2,
                          context_dim=32, norm_groups=8, dtype=torch.float32,
                          attn_impl="xla")


class ResBlock(nn.Module):
    """diffusers ResnetBlock2D: GN → SiLU → conv → + time projection → GN →
    SiLU → conv, plus the (1×1-projected where the width changes) input."""

    def __init__(self, cin: int, width: int, temb_dim: int, groups: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = L.GroupNorm(groups, cin, 1e-5, device=device)
        self.conv1 = L.Conv2d(cin, width, 3, padding=1, **kw)
        self.time_emb_proj = L.Dense(temb_dim, width, **kw)
        self.norm2 = L.GroupNorm(groups, width, 1e-5, device=device)
        self.conv2 = L.Conv2d(width, width, 3, padding=1, **kw)
        self.conv_shortcut = L.Conv2d(cin, width, 1, **kw) if cin != width else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class TransformerBlock(nn.Module):
    """BasicTransformerBlock: pre-LN self-attention, cross-attention to the
    context, GEGLU feed-forward, each a residual."""

    def __init__(self, cfg: UNetConfig, width: int, *, device):
        super().__init__()
        c = cfg
        kw = dict(dtype=c.dtype, device=device)
        heads, head_dim = c.num_heads, width // c.num_heads
        impl = L.attn_route(c.attn_impl)
        self.dtype = c.dtype
        self.norm1 = L.LayerNorm(width, 1e-5, device=device)
        self.attn1 = L.Attention(width, heads, head_dim, qkv_bias=False, impl=impl, **kw)
        self.norm2 = L.LayerNorm(width, 1e-5, device=device)
        self.attn2 = L.Attention(width, heads, head_dim, context_dim=c.context_dim,
                                 qkv_bias=False, impl=impl, **kw)
        self.norm3 = L.LayerNorm(width, 1e-5, device=device)
        self.ff = L.FeedForward(width, 4, activation="geglu", **kw)

    def forward(self, x, context, context_mask):
        dt = self.dtype
        x = x + self.attn1(self.norm1(x).to(dt))
        x = x + self.attn2(self.norm2(x).to(dt), context=context, key_mask=context_mask)
        return x + self.ff(self.norm3(x).to(dt))


class SpatialTransformer(nn.Module):
    """diffusers Transformer2DModel (depth 1): GN → proj_in → one
    TransformerBlock over the h·w tokens → proj_out, plus the input."""

    def __init__(self, cfg: UNetConfig, width: int, *, device):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.norm = L.GroupNorm(cfg.norm_groups, width, 1e-6, device=device)
        self.proj_in = L.Dense(width, width, **kw)
        self.transformer_blocks_0 = TransformerBlock(cfg, width, device=device)
        self.proj_out = L.Dense(width, width, **kw)

    def forward(self, x, context, context_mask):
        b, c, hh, ww = x.shape
        h = self.norm(x).flatten(2).transpose(1, 2)  # [B, h·w, C]
        h = self.transformer_blocks_0(self.proj_in(h), context, context_mask)
        h = self.proj_out(h).transpose(1, 2).reshape(b, c, hh, ww)
        return x + h


class UNet2DCondition(nn.Module):
    """forward(latent [B,4,H,W], t [B], context [B,L,768], mask [B,L]) →
    ε [B,4,H,W] in latent's dtype."""

    def __init__(
        self,
        cfg: Optional[UNetConfig] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else UNetConfig()
        if c.remat:
            raise NotImplementedError(
                "UNet remat (--gradient_checkpointing) is a training option; sd15 "
                "training is not ported yet: ROADMAP.md queue 1, slice 4 (sd15 TDM "
                "training)")
        L.attn_route(c.attn_impl)  # an unknown name raises here
        dev = resolve_device(device)
        kw = dict(dtype=c.dtype, device=dev)
        widths = list(c.block_widths)
        n = len(widths)
        temb = widths[0] * 4
        g = c.norm_groups
        self.time_embedding = L.TimestepEmbedding(widths[0], temb, **kw)
        self.conv_in = L.Conv2d(c.in_channels, widths[0], 3, padding=1, **kw)
        ch = widths[0]
        skips = [ch]
        for i, w in enumerate(widths):
            for j in range(c.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResBlock(ch, w, temb, g, **kw))
                ch = w
                if i < n - 1:
                    self.add_module(f"down_{i}_attn_{j}", SpatialTransformer(c, w, device=dev))
                skips.append(ch)
            if i < n - 1:
                self.add_module(f"down_{i}_downsample",
                                L.Conv2d(w, w, 3, stride=2, padding=1, **kw))
                skips.append(ch)
        self.mid_res_0 = ResBlock(ch, ch, temb, g, **kw)
        self.mid_attn = SpatialTransformer(c, ch, device=dev)
        self.mid_res_1 = ResBlock(ch, ch, temb, g, **kw)
        for i, w in enumerate(reversed(widths)):
            stage = n - 1 - i
            for j in range(c.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResBlock(ch + skips.pop(), w, temb, g, **kw))
                ch = w
                if stage < n - 1:
                    self.add_module(f"up_{i}_attn_{j}", SpatialTransformer(c, w, device=dev))
            if stage > 0:
                self.add_module(f"up_{i}_upsample", L.Conv2d(w, w, 3, padding=1, **kw))
        self.conv_norm_out = L.GroupNorm(g, widths[0], 1e-5, device=dev)
        self.conv_out = L.Conv2d(widths[0], c.out_channels, 3, padding=1, **kw)

    def forward(self, latent, t, context, context_mask=None):
        with _without_cudnn():
            return self._forward(latent, t, context, context_mask)

    def _forward(self, latent, t, context, context_mask):
        c = self.cfg
        n = len(c.block_widths)
        t = torch.as_tensor(t, device=latent.device)
        if t.dim() == 0:
            t = t.expand(latent.shape[0])
        x = latent.to(c.dtype)
        context = context.to(c.dtype)
        t_base = L.sinusoidal_timestep_embedding(t, c.block_widths[0])
        temb = self.time_embedding(t_base.to(c.dtype))
        x = self.conv_in(x)
        skips = [x]
        for i in range(n):
            for j in range(c.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x, temb)
                if i < n - 1:
                    x = getattr(self, f"down_{i}_attn_{j}")(x, context, context_mask)
                skips.append(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                skips.append(x)
        x = self.mid_res_0(x, temb)
        x = self.mid_attn(x, context, context_mask)
        x = self.mid_res_1(x, temb)
        for i in range(n):
            stage = n - 1 - i
            for j in range(c.layers_per_block + 1):
                x = getattr(self, f"up_{i}_res_{j}")(torch.cat([x, skips.pop()], dim=1), temb)
                if stage < n - 1:
                    x = getattr(self, f"up_{i}_attn_{j}")(x, context, context_mask)
            if stage > 0:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = getattr(self, f"up_{i}_upsample")(x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.to(latent.dtype)


@contextlib.contextmanager
def _without_cudnn():
    """cuDNN off for the block (the module docstring says why), restored
    after it."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def make_denoise_fn(model: UNet2DCondition):
    """The sampler's `DenoiseFn`: (x, t, (context, mask)) → ε."""

    def fn(x, t, cond):
        context, mask = cond
        return model(x, t, context, mask)

    return fn
