"""The CogVideoX causal 3D VAE in PyTorch: its decoder and its encoder.

Port of `tdm_tpu/models/vae3d.py` (diffusers' `AutoencoderKLCogVideoX` as
the JAX package rebuilds it): 4× temporal and 8× spatial compression, 13
latent frames ↔ 49 video frames by F_out = (F_lat − 1)·4 + 1.
  * Every 3D convolution is causal in time: the front is padded with k_t − 1
    copies of frame 0, so frame i never sees a later frame; the spatial pad
    is ((k−1)//2, k//2).
  * GroupNorm (fp32, eps 1e-6) runs per frame, never across frames.
  * Decoder: conv_in → 2 mid ResBlocks → one stage per width (widths
    reversed, layers_per_block + 1 ResBlocks each), a nearest ×2 spatial
    upsample on the first `log2(spatial_factor)` stages, the temporal
    upsample (frame 0 stays single, every later frame doubles) on stages 1
    .. log2(temporal_factor), and a per-frame (1,3,3) upsampler conv on
    every stage but the last; GroupNorm + SiLU + conv_out. No attention.
  * Encoder (`VAE3DEncoder`): conv_in → one stage per width
    (layers_per_block ResBlocks, then a strided causal conv `down_{i}_conv`
    on the stages whose temporal (the first log2(temporal_factor)) or
    spatial (the first log2(spatial_factor)) stride is 2) → 2 mid
    ResBlocks → GroupNorm + SiLU + conv_out to 2·C_lat channels, split
    into (mean, logvar). A strided conv reads the front-padded frames at
    stride 2: output frame o reads padded frames 2o … 2o+2, so 1+2k frames
    become 1+k and frame 0 stays in place; the spatial stride 2 keeps the
    pad ((k−1)//2, k//2), so H and W halve.
  * `decode_streaming`: temporal chunks with each causal conv's last k_t − 1
    input frames carried to the next chunk: the same convolutions of the
    same frames as the monolithic decode (the library may sum a chunk's
    fewer frames in another order);
    `decode_tiled`: overlapping spatial tiles (full time) blended by a
    linear ramp and divided by the summed weights.

The decoder computes in fp32 (the server sets TF32 off,
`device.set_fp32_precision`). Activations are held frame-major,
[B, F, C, H, W], so each frame is an NCHW image: the GroupNorms, the
upsamples and every convolution act on [B·F, C, H, W]. A causal conv of
k_t temporal taps is the sum of k_t fp32 conv2d calls, one per tap, each
over the frame-shifted stack of the padded input with that tap's [out, in,
kh, kw] slice of the weight: the 2D fp32 convolution engine the KL
decoder runs, on every shape, chosen here and never switched at run time;
the port writes no process-wide cuDNN flag. Module and parameter names
follow the JAX tree (conv_in/conv, mid_block_{1,2}, up_{i}_res_{j}/
norm1/gn, conv1/conv, shortcut, up_{i}_upsampler/conv, norm_out/gn,
conv_out/conv), so the weight carry (`io/from_jax.py`) fills them;
conv weights are torch's [out, in, kt, kh, kw].

The encoder computes as the decoder does (fp32, per-tap conv2d calls, the
same module names: conv_in/conv, down_{i}_res_{j}, down_{i}_conv/conv,
mid_block_{1,2}, norm_out/gn, conv_out/conv). No served or trained path
encodes, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models.layers import GroupNorm

_N_SPATIAL = {2: 1, 4: 2, 8: 3}
_N_TEMPORAL = {1: 0, 2: 1, 4: 2}


@dataclass(frozen=True)
class VAE3DConfig:
    latent_channels: int = 16
    image_channels: int = 3
    block_widths: Sequence[int] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_groups: int = 32
    scaling_factor: float = 1.15258426
    temporal_factor: int = 4
    spatial_factor: int = 8
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "VAE3DConfig":
        return VAE3DConfig(block_widths=(8, 16), layers_per_block=1, norm_groups=4,
                           temporal_factor=2, spatial_factor=2)


Cache = dict  # CausalConv3d → its last k_t − 1 padded input frames


class SpatialGroupNorm(nn.Module):
    """GroupNorm over (H, W, channel group) of each frame of [B, F, C, H, W]
    (a GroupNorm over the frame axis too would couple frames and break
    causality), in fp32, returned in x's dtype."""

    def __init__(self, groups: int, width: int, *, device=None):
        super().__init__()
        self.gn = GroupNorm(groups, width, 1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f = x.shape[:2]
        return self.gn(x.reshape(b * f, *x.shape[2:])).reshape(x.shape).to(x.dtype)


class CausalConv3d(nn.Module):
    """A 3D convolution, causal in time, on [B, F, C, H, W] → [B, F', C',
    H', W']: the front padded with k_t − 1 copies of frame 0 (or, in a
    streamed chunk after the first, the previous chunk's last input frames
    from `cache`), the spatial sides with zeros, ((k−1)//2, k//2) each,
    then `strides` (t, h, w). `conv` holds the weight [out, in, kt, kh, kw]
    and bias."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3), *, strides=(1, 1, 1), dtype,
                 device=None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.dtype = dtype
        self.conv = nn.Conv3d(cin, cout, self.kernel, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                first_chunk: bool = True) -> torch.Tensor:
        kt, kh, kw = self.kernel
        if kt > 1:
            if cache is not None and not first_chunk:
                front = cache[self]
            else:
                front = x[:, :1].expand(-1, kt - 1, *x.shape[2:])
            x = torch.cat([front, x], dim=1)
            if cache is not None:
                cache[self] = x[:, -(kt - 1):].clone()
        return causal_conv3d(x.to(self.dtype), self.conv.weight.to(self.dtype),
                             self.conv.bias.to(self.dtype), kh, kw, self.strides)


def causal_conv3d(xp: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  kh: int, kw: int, strides=(1, 1, 1)) -> torch.Tensor:
    """The valid temporal convolution of the front-padded xp [B, F+kt−1, C,
    H, W] with zero 'same' spatial padding, at `strides` (t, h, w): one
    conv2d a temporal tap over the frames that tap reads (tap dt of output
    frame o reads padded frame st·o + dt), summed in tap order."""
    b, fp, cin, h, w = xp.shape
    kt = weight.shape[2]
    st, sh, sw = strides
    f = (fp - kt) // st + 1
    pad_h, pad_w = (kh - 1) // 2, (kw - 1) // 2
    if kh % 2 == 0 or kw % 2 == 0:  # asymmetric ((k−1)//2, k//2): pad by hand
        xp = F.pad(xp, (pad_w, kw // 2, pad_h, kh // 2))
        pad_h = pad_w = 0
        h, w = xp.shape[-2:]
    out = None
    for dt in range(kt):
        frames = xp[:, dt:dt + st * (f - 1) + 1:st].reshape(b * f, cin, h, w)
        y = F.conv2d(frames, weight[:, :, dt], bias if dt == 0 else None,
                     stride=(sh, sw), padding=(pad_h, pad_w))
        out = y if out is None else out.add_(y)
    return out.reshape(b, f, *out.shape[1:])


class ResBlock3D(nn.Module):
    def __init__(self, cin: int, width: int, groups: int, *, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = SpatialGroupNorm(groups, cin, device=device)
        self.conv1 = CausalConv3d(cin, width, **kw)
        self.norm2 = SpatialGroupNorm(groups, width, device=device)
        self.conv2 = CausalConv3d(width, width, **kw)
        self.shortcut = nn.Conv3d(cin, width, 1, **kw) if cin != width else None

    def forward(self, x, cache: Optional[Cache] = None, first_chunk: bool = True):
        h = self.conv1(F.silu(self.norm1(x)), cache, first_chunk)
        h = self.conv2(F.silu(self.norm2(h)), cache, first_chunk)
        if self.shortcut is not None:
            w = self.shortcut.weight
            x = causal_conv3d(x.to(w.dtype), w, self.shortcut.bias, 1, 1)
        return x + h


def upsample_spatial(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 in H and W of every frame of [B, F, C, H, W]."""
    b, f = x.shape[:2]
    y = F.interpolate(x.reshape(b * f, *x.shape[2:]), scale_factor=2, mode="nearest")
    return y.reshape(b, f, *y.shape[1:])


def upsample_temporal(x: torch.Tensor, first_chunk: bool = True) -> torch.Tensor:
    """(F−1)·2+1 frames: the global frame 0 stays single and every other
    frame doubles; in a streamed chunk after the first every frame
    doubles."""
    if not first_chunk:
        return x.repeat_interleave(2, dim=1)
    return torch.cat([x[:, :1], x[:, 1:].repeat_interleave(2, dim=1)], dim=1)


class VAE3DDecoder(nn.Module):
    """forward(z [B, C_lat, F, h, w], model space divided by
    `scaling_factor`) → video [B, 3, F_out, H, W] in [-1, 1]. With a
    `cache` dict the call is one temporal chunk of `decode_streaming`."""

    def __init__(self, cfg: Optional[VAE3DConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else VAE3DConfig()
        dev = resolve_device(device)
        kw = dict(dtype=c.dtype, device=dev)
        widths = list(c.block_widths)
        self.n_spatial = _N_SPATIAL[c.spatial_factor]
        self.n_temporal = _N_TEMPORAL[c.temporal_factor]
        self.conv_in = CausalConv3d(c.latent_channels, widths[-1], **kw)
        self.mid_block_1 = ResBlock3D(widths[-1], widths[-1], c.norm_groups, **kw)
        self.mid_block_2 = ResBlock3D(widths[-1], widths[-1], c.norm_groups, **kw)
        self.stages = len(widths)
        ch = widths[-1]
        for i, w in enumerate(reversed(widths)):
            for j in range(c.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResBlock3D(ch, w, c.norm_groups, **kw))
                ch = w
            if i < self.stages - 1:
                self.add_module(f"up_{i}_upsampler", CausalConv3d(w, w, (1, 3, 3), **kw))
        self.norm_out = SpatialGroupNorm(c.norm_groups, widths[0], device=dev)
        self.conv_out = CausalConv3d(widths[0], c.image_channels, **kw)

    def forward(self, z: torch.Tensor, cache: Optional[Cache] = None,
                first_chunk: bool = True) -> torch.Tensor:
        c = self.cfg
        kw = dict(cache=cache, first_chunk=first_chunk)
        x = z.to(c.dtype).permute(0, 2, 1, 3, 4).contiguous()  # B, F, C, h, w
        x = self.conv_in(x, **kw)
        x = self.mid_block_2(self.mid_block_1(x, **kw), **kw)
        for i in range(self.stages):
            for j in range(c.layers_per_block + 1):
                x = getattr(self, f"up_{i}_res_{j}")(x, **kw)
            if i < self.n_spatial:
                x = upsample_spatial(x)
            if 0 < i <= self.n_temporal:
                x = upsample_temporal(x, first_chunk)
            if i < self.stages - 1:
                x = getattr(self, f"up_{i}_upsampler")(x, **kw)
        x = self.conv_out(F.silu(self.norm_out(x)), **kw)
        return x.permute(0, 2, 1, 3, 4).contiguous()  # B, 3, F, H, W


class VAE3DEncoder(nn.Module):
    """forward(video [B, 3, F, H, W] in [-1, 1]) → (mean, logvar), each
    [B, C_lat, 1 + (F−1)/tf, H/sf, W/sf]."""

    def __init__(self, cfg: Optional[VAE3DConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else VAE3DConfig()
        dev = resolve_device(device)
        kw = dict(dtype=c.dtype, device=dev)
        widths = list(c.block_widths)
        n_spatial, n_temporal = _N_SPATIAL[c.spatial_factor], _N_TEMPORAL[c.temporal_factor]
        self.conv_in = CausalConv3d(c.image_channels, widths[0], **kw)
        self.stages = len(widths)
        ch = widths[0]
        for i, w in enumerate(widths):
            for j in range(c.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResBlock3D(ch, w, c.norm_groups, **kw))
                ch = w
            strides = (2 if i < n_temporal else 1,) + (2 if i < n_spatial else 1,) * 2
            if strides != (1, 1, 1):
                self.add_module(f"down_{i}_conv", CausalConv3d(w, w, strides=strides, **kw))
        self.mid_block_1 = ResBlock3D(widths[-1], widths[-1], c.norm_groups, **kw)
        self.mid_block_2 = ResBlock3D(widths[-1], widths[-1], c.norm_groups, **kw)
        self.norm_out = SpatialGroupNorm(c.norm_groups, widths[-1], device=dev)
        self.conv_out = CausalConv3d(widths[-1], 2 * c.latent_channels, **kw)

    def forward(self, video: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        x = video.to(c.dtype).permute(0, 2, 1, 3, 4).contiguous()  # B, F, 3, H, W
        x = self.conv_in(x)
        for i in range(self.stages):
            for j in range(c.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x)
            down = getattr(self, f"down_{i}_conv", None)
            if down is not None:
                x = down(x)
        x = self.mid_block_2(self.mid_block_1(x))
        x = self.conv_out(F.silu(self.norm_out(x)))
        mean, logvar = x.permute(0, 2, 1, 3, 4).chunk(2, dim=1)
        return mean.contiguous(), logvar.contiguous()


def decode_streaming(model: VAE3DDecoder, z: torch.Tensor, *, chunk: int = 2) -> torch.Tensor:
    """The decode in temporal chunks of `chunk` latent frames, each causal
    conv's context carried from chunk to chunk: the monolithic decode's
    convolutions of the same frames, with activations bounded by the chunk
    (the reference's `vae.enable_slicing()`). The first chunk carries frame 0, so it gives
    (chunk−1)·tf+1 frames and each later one chunk·tf."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    f = z.shape[2]
    if f <= chunk:
        return model(z)
    cache: Cache = {}
    outs = [model(z[:, :, :chunk], cache=cache, first_chunk=True)]
    for pos in range(chunk, f, chunk):
        outs.append(model(z[:, :, pos:pos + chunk], cache=cache, first_chunk=False))
    return torch.cat(outs, dim=2)


def decode_tiled(decode_fn: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor, *,
                 tile: int = 32, overlap: int = 4, spatial_factor: int = 8) -> torch.Tensor:
    """The decode of overlapping spatial tiles over the full time axis (the
    reference's `enable_tiling()`), each weighted by a linear ramp over the
    overlap and the sum divided by the summed weights. z [B, C, F, h, w].
    Tile origins step by tile − overlap and the last one in each direction
    is clamped to h − tile (w − tile): 60×90 latents at tile 32, overlap 4
    give y₀ ∈ {0, 28} and x₀ ∈ {0, 28, 56, 58}."""
    b, _, _, h, w = z.shape
    if h <= tile and w <= tile:
        return decode_fn(z)
    stride, fac = tile - overlap, spatial_factor
    out = weight = None
    for yi in range(0, max(h - overlap, 1), stride):
        y0 = min(yi, max(h - tile, 0))
        for xi in range(0, max(w - overlap, 1), stride):
            x0 = min(xi, max(w - tile, 0))
            img = decode_fn(z[:, :, :, y0:y0 + tile, x0:x0 + tile])  # [B, 3, F, th, tw]
            if out is None:
                out = img.new_zeros(b, img.shape[1], img.shape[2], h * fac, w * fac)
                weight = img.new_zeros(1, 1, 1, h * fac, w * fac)
            th, tw = img.shape[3], img.shape[4]
            wm = (_ramp(th, overlap * fac, img.dtype, img.device)[:, None]
                  * _ramp(tw, overlap * fac, img.dtype, img.device)[None, :])
            ys, xs = slice(y0 * fac, y0 * fac + th), slice(x0 * fac, x0 * fac + tw)
            out[:, :, :, ys, xs] += img * wm
            weight[:, :, :, ys, xs] += wm
    return out / torch.clamp(weight, min=1e-8)


def _ramp(size: int, fade: int, dtype, device) -> torch.Tensor:
    idx = torch.arange(size, dtype=torch.float32, device=device)
    up = torch.clamp((idx + 1) / max(fade, 1), 0, 1)
    down = torch.clamp((size - idx) / max(fade, 1), 0, 1)
    return torch.minimum(up, down).to(dtype)
