"""The image VAEs in PyTorch: TAESD (AutoencoderTiny) and AutoencoderKL.

Port of `tdm_tpu/models/vae.py`:
  * `TAESDDecoder`: the tiny decoder (`madebyollin/taesd`), and TAESD3 (16
    latent channels, shift 0) for SD3; z [B, C_lat, h, w] → image
    [B, 3, 8h, 8w] in [0, 1]. Modules conv_in, stage_{s}_block_{b}/
    conv_{0,1,2}, stage_{s}_conv, block_out, conv_out.
  * `KLDecoder`: the decoder of the diffusers checkouts' AutoencoderKL
    (PixArt's 4 channels, SD3's 16); un-scaled z [B, C_lat, h, w] → image
    [B, 3, 8h, 8w] in [-1, 1]. Modules post_quant_conv, conv_in,
    mid_block_{1,2}, mid_attn, up_{i}_res_{j}, up_{i}_conv, norm_out,
    conv_out. Its GroupNorms run in fp32 with eps 1e-6 and the model's dtype
    is fp32 by default, as in JAX; the mid-block's one-head attention at
    D = the last width is its own fp32 matmul and softmax (JAX computes it
    with impl='xla', not a Pallas kernel).
  * `TAESDEncoder`: image [B, 3, H, W] → z [B, C_lat, H/8, W/8]. Modules
    conv_in, block_in, stage_{s}_down (stride 2, no bias),
    stage_{s}_block_{b}, conv_out.
  * `KLEncoder`: image [B, 3, H, W] in [-1, 1] → (mean, logvar), each
    [B, C_lat, H/8, W/8], after diffusers' 1×1 quant_conv. Modules conv_in,
    down_{i}_res_{j}, down_{i}_conv (stride 2, padded on the bottom and
    right only), mid_block_{1,2}, mid_attn, norm_out, conv_out, quant_conv.
  * `unscale_latents` and `tiled_decode` (overlapping tiles, cross-faded).
Layout NCHW throughout; module names follow the JAX tree, so the weight
carry (`io/from_jax.py`) fills them. No served or trained path encodes: the
training is image-free, as in JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models.layers import GroupNorm


@dataclass(frozen=True)
class TAESDConfig:
    latent_channels: int = 4
    image_channels: int = 3
    width: int = 64
    num_stages: int = 3  # 8× spatial factor
    blocks_per_stage: int = 3
    scaling_factor: float = 1.0
    shift_factor: float = 0.0  # the SD3 recipe sets 0.0 for TAESD3
    dtype: torch.dtype = torch.float32

    @staticmethod
    def taesd3() -> "TAESDConfig":
        return TAESDConfig(latent_channels=16)


class _TinyBlock(nn.Module):
    """conv-relu-conv-relu-conv plus the identity skip, then ReLU (TAESD
    Block; in the decoder every block keeps the width, so no skip conv)."""

    def __init__(self, width: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv_0 = nn.Conv2d(width, width, 3, padding=1, **kw)
        self.conv_1 = nn.Conv2d(width, width, 3, padding=1, **kw)
        self.conv_2 = nn.Conv2d(width, width, 3, padding=1, **kw)

    def forward(self, x):
        h = self.conv_2(F.relu(self.conv_1(F.relu(self.conv_0(x)))))
        return F.relu(h + x)


class TAESDDecoder(nn.Module):
    def __init__(
        self,
        cfg: Optional[TAESDConfig] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else TAESDConfig()
        dev = resolve_device(device)
        kw = dict(dtype=c.dtype, device=dev)
        self.conv_in = nn.Conv2d(c.latent_channels, c.width, 3, padding=1, **kw)
        for s in range(c.num_stages):
            for b in range(c.blocks_per_stage):
                self.add_module(f"stage_{s}_block_{b}", _TinyBlock(c.width, **kw))
            self.add_module(
                f"stage_{s}_conv", nn.Conv2d(c.width, c.width, 3, padding=1, bias=False, **kw)
            )
        self.block_out = _TinyBlock(c.width, **kw)
        self.conv_out = nn.Conv2d(c.width, c.image_channels, 3, padding=1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = z.to(c.dtype)
        x = torch.tanh(x / 3.0) * 3.0  # TAESD Clamp
        x = F.relu(self.conv_in(x))
        for s in range(c.num_stages):
            for b in range(c.blocks_per_stage):
                x = getattr(self, f"stage_{s}_block_{b}")(x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"stage_{s}_conv")(x)
        return self.conv_out(self.block_out(x))


class TAESDEncoder(nn.Module):
    def __init__(
        self,
        cfg: Optional[TAESDConfig] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else TAESDConfig()
        dev = resolve_device(device)
        kw = dict(dtype=c.dtype, device=dev)
        self.conv_in = nn.Conv2d(c.image_channels, c.width, 3, padding=1, **kw)
        self.block_in = _TinyBlock(c.width, **kw)
        for s in range(c.num_stages):
            self.add_module(f"stage_{s}_down", nn.Conv2d(c.width, c.width, 3, stride=2,
                                                         padding=1, bias=False, **kw))
            for b in range(c.blocks_per_stage):
                self.add_module(f"stage_{s}_block_{b}", _TinyBlock(c.width, **kw))
        self.conv_out = nn.Conv2d(c.width, c.latent_channels, 3, padding=1, **kw)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """image [B, 3, H, W] → z [B, C_lat, H/8, W/8]."""
        c = self.cfg
        x = self.block_in(self.conv_in(img.to(c.dtype)))
        for s in range(c.num_stages):
            x = getattr(self, f"stage_{s}_down")(x)
            for b in range(c.blocks_per_stage):
                x = getattr(self, f"stage_{s}_block_{b}")(x)
        return self.conv_out(x)


@dataclass(frozen=True)
class KLVAEConfig:
    latent_channels: int = 4
    image_channels: int = 3
    block_widths: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215  # SD1.5 and PixArt; SD3 1.5305 + shift 0.0609
    shift_factor: float = 0.0
    dtype: torch.dtype = torch.float32

    @staticmethod
    def sd3() -> "KLVAEConfig":
        return KLVAEConfig(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609)

    @staticmethod
    def tiny() -> "KLVAEConfig":
        return KLVAEConfig(block_widths=(8, 16), norm_groups=4)


class _ResBlock(nn.Module):
    """norm-silu-conv twice plus the input; a 1×1 `shortcut` only where the
    width changes."""

    def __init__(self, cin: int, width: int, groups: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.norm1 = GroupNorm(groups, cin, 1e-6, device=device)
        self.conv1 = nn.Conv2d(cin, width, 3, padding=1, **kw)
        self.norm2 = GroupNorm(groups, width, 1e-6, device=device)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, **kw)
        self.shortcut = nn.Conv2d(cin, width, 1, **kw) if cin != width else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)).to(self.dtype))
        h = self.conv2(F.silu(self.norm2(h)).to(self.dtype))
        if self.shortcut is not None:
            x = self.shortcut(x.to(self.dtype))
        return x + h


class _MidAttention(nn.Module):
    """One-head self-attention over the h·w positions at D = the width:
    fp32 logits scaled by 1/sqrt(D), fp32 softmax, probabilities cast to the
    model's dtype for the product with v (the JAX package's XLA path)."""

    def __init__(self, width: int, groups: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.norm = GroupNorm(groups, width, 1e-6, device=device)
        self.to_q = nn.Linear(width, width, **kw)
        self.to_k = nn.Linear(width, width, **kw)
        self.to_v = nn.Linear(width, width, **kw)
        self.to_out = nn.Linear(width, width, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x).to(self.dtype).flatten(2).transpose(1, 2)  # [B, h·w, C]
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2))
        probs = torch.softmax(logits.mul_(1.0 / math.sqrt(c)), dim=-1)
        del logits
        out = self.to_out(torch.matmul(probs.to(self.dtype), v).to(self.dtype))
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class KLDecoder(nn.Module):
    def __init__(
        self,
        cfg: Optional[KLVAEConfig] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else KLVAEConfig()
        dev = resolve_device(device)
        kw = dict(dtype=c.dtype, device=dev)
        widths = list(c.block_widths)
        g = c.norm_groups
        # diffusers' 1×1 post_quant_conv before the decoder proper
        self.post_quant_conv = nn.Conv2d(c.latent_channels, c.latent_channels, 1, **kw)
        self.conv_in = nn.Conv2d(c.latent_channels, widths[-1], 3, padding=1, **kw)
        self.mid_block_1 = _ResBlock(widths[-1], widths[-1], g, **kw)
        self.mid_attn = _MidAttention(widths[-1], g, **kw)
        self.mid_block_2 = _ResBlock(widths[-1], widths[-1], g, **kw)
        ch = widths[-1]
        for i, width in enumerate(reversed(widths)):
            for j in range(c.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", _ResBlock(ch, width, g, **kw))
                ch = width
            if i < len(widths) - 1:
                self.add_module(f"up_{i}_conv", nn.Conv2d(ch, ch, 3, padding=1, **kw))
        self.norm_out = GroupNorm(g, widths[0], 1e-6, device=dev)
        self.conv_out = nn.Conv2d(widths[0], c.image_channels, 3, padding=1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, C_lat, h, w] (already un-scaled) → image [B, 3, H, W] in
        [-1, 1], in the config's dtype."""
        c = self.cfg
        n = len(c.block_widths)
        x = self.conv_in(self.post_quant_conv(z.to(c.dtype)))
        x = self.mid_block_2(self.mid_attn(self.mid_block_1(x)))
        for i in range(n):
            for j in range(c.layers_per_block + 1):
                x = getattr(self, f"up_{i}_res_{j}")(x)
            if i < n - 1:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = getattr(self, f"up_{i}_conv")(x)
        return self.conv_out(F.silu(self.norm_out(x)).to(c.dtype))


class KLEncoder(nn.Module):
    def __init__(
        self,
        cfg: Optional[KLVAEConfig] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else KLVAEConfig()
        dev = resolve_device(device)
        kw = dict(dtype=c.dtype, device=dev)
        widths = list(c.block_widths)
        g = c.norm_groups
        self.conv_in = nn.Conv2d(c.image_channels, widths[0], 3, padding=1, **kw)
        ch = widths[0]
        for i, width in enumerate(widths):
            for j in range(c.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", _ResBlock(ch, width, g, **kw))
                ch = width
            if i < len(widths) - 1:
                self.add_module(f"down_{i}_conv", nn.Conv2d(ch, ch, 3, stride=2, **kw))
        self.mid_block_1 = _ResBlock(widths[-1], widths[-1], g, **kw)
        self.mid_attn = _MidAttention(widths[-1], g, **kw)
        self.mid_block_2 = _ResBlock(widths[-1], widths[-1], g, **kw)
        self.norm_out = GroupNorm(g, widths[-1], 1e-6, device=dev)
        self.conv_out = nn.Conv2d(widths[-1], 2 * c.latent_channels, 3, padding=1, **kw)
        # diffusers' 1×1 quant_conv over the (mean, logvar) stack
        self.quant_conv = nn.Conv2d(2 * c.latent_channels, 2 * c.latent_channels, 1, **kw)

    def forward(self, img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """image [B, 3, H, W] in [-1, 1] → (mean, logvar), each [B, C_lat,
        H/8, W/8] for four stages, in the config's dtype."""
        c = self.cfg
        n = len(c.block_widths)
        x = self.conv_in(img.to(c.dtype))
        for i in range(n):
            for j in range(c.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x)
            if i < n - 1:  # stride 2 over the input padded by one on the bottom and right
                x = getattr(self, f"down_{i}_conv")(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block_2(self.mid_attn(self.mid_block_1(x)))
        x = self.conv_out(F.silu(self.norm_out(x)).to(c.dtype))
        mean, logvar = self.quant_conv(x).chunk(2, dim=1)
        return mean, logvar


def unscale_latents(z: torch.Tensor, scaling_factor: float, shift_factor: float = 0.0):
    """Model-space latents → VAE space: z / scale + shift (the reference's
    `latents / vae.config.scaling_factor`, plus SD3's shift_factor)."""
    return z / scaling_factor + shift_factor


def tiled_decode(
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    *,
    tile: int = 64,
    overlap: int = 8,
    spatial_factor: int = 8,
) -> torch.Tensor:
    """Decode [B, C, h, w] latents in overlapping spatial tiles and blend
    them (the diffusers `enable_tiling()` replacement). `tile`/`overlap` are
    in latent pixels; each tile is decoded alone and cross-faded linearly in
    image space. Latents no larger than one tile decode whole."""
    b, _, h, w = z.shape
    if h <= tile and w <= tile:
        return decode_fn(z)
    stride = tile - overlap
    f = spatial_factor
    out = weight = None
    for yi in range(0, max(h - overlap, 1), stride):
        y0 = min(yi, h - tile) if h >= tile else 0
        for xi in range(0, max(w - overlap, 1), stride):
            x0 = min(xi, w - tile) if w >= tile else 0
            img = decode_fn(z[:, :, y0:y0 + min(tile, h), x0:x0 + min(tile, w)])
            if out is None:
                out = img.new_zeros((b, img.shape[1], h * f, w * f))
                weight = img.new_zeros((1, 1, h * f, w * f))
            th, tw = img.shape[2], img.shape[3]
            wmask = (_ramp(th, overlap * f, img.dtype, img.device)[:, None]
                     * _ramp(tw, overlap * f, img.dtype, img.device)[None, :])
            out[:, :, y0 * f:y0 * f + th, x0 * f:x0 * f + tw] += img * wmask
            weight[:, :, y0 * f:y0 * f + th, x0 * f:x0 * f + tw] += wmask
    return out / weight.clamp_min(1e-8)


def _ramp(size: int, fade: int, dtype, device) -> torch.Tensor:
    """1 in the middle, a linear 0→1 fade of width `fade` at both ends."""
    idx = torch.arange(size, dtype=torch.float32, device=device)
    up = ((idx + 1) / max(fade, 1)).clamp(0, 1)
    down = ((size - idx) / max(fade, 1)).clamp(0, 1)
    return torch.minimum(up, down).to(dtype)
