"""CogVideoX 3D-DiT denoiser in PyTorch, the text-to-video family.

Port of `tdm_tpu/models/cogvideox.py` (THUDM/CogVideoX-2b's config):
  * the VAE latent [B, 16, F, H/8, W/8]: 49 frames → F = 13, 480×720 →
    60×90; a 2×2 spatial patchify per frame (no temporal patching) makes
    F·(H/16)·(W/16) video tokens (17,550 at 49×480×720);
  * the T5 tokens (226) go FIRST in the joint sequence [text; video], and
    every block attends over all of it with no key mask (CogVideoX attends
    to the padded T5 tokens too), so one call is [B, 30, 17,776, 17,776, 64]
    and takes kernel 1 (`ops/attention.py`, route 'auto'; kernel 4 under
    attn_impl='splash');
  * CogVideoX's adaLN ("LayerNormZero"): silu(temb) → 6 vectors, (shift,
    scale, gate) for the video tokens and for the text tokens, around one
    shared affine LayerNorm (fp32, eps 1e-5) applied to both streams, the
    modulation in the model dtype; the gated residuals update the text
    stream before the video one;
  * a per-head affine qk LayerNorm (fp32, eps 1e-6, cast back);
  * positions: the 2B's fixed 3D sin-cos table (spatial scale 1.875) added
    to the video tokens only (the checkpoint carries no position weights),
    or the 5B's 3D RoPE (`use_rotary=True`) on the video rows of q and k;
  * the tanh-GELU feed-forward; a final LayerNorm, an AdaLayerNorm head and
    the unpatchify back to [B, 16, F, H, W]; v-prediction (the schedule's
    `prediction_type`).

Patchify is the 2×2 stride-2 convolution of the JAX model as one product:
the latent's 2×2 patches, flattened in the (channel, row, column) order of
the conv weight [D, C, 2, 2], times that weight as [D, C·4]. Module names
follow the JAX tree (patch_proj, text_proj, time_embedding, blocks.{i}/
norm1|norm2/{linear,norm}, to_q/k/v/out, norm_q/norm_k, ff, norm_final,
norm_out_linear, norm_out_norm, proj_out), so the weight carry
(`io/from_jax.py`) fills them from the stacked or the unrolled tree.

Serving holds the parameters in `cfg.dtype`; training builds the model with
`param_dtype=torch.float32` (fp32 master weights, cast to `cfg.dtype` at
every use, as Flax casts its fp32 parameters) and, under `cfg.remat`,
recomputes each block in the backward when autograd records the forward
(`layers.checkpoint_block`, policy 'full', as the JAX package's
`nn.remat(CogVideoXBlock)`).

Sequence parallelism (`sequence_parallel_axis`, ring attention) and
`make_pp_forward` wait for ROADMAP.md queue 1, slice 6, and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import layers as L
from tdm_tpu_torch.parallel import tp as tp_lib

_SLICE6 = "ROADMAP.md queue 1, slice 6 (multi-GPU)"


@dataclass(frozen=True)
class CogVideoXConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    num_layers: int = 30
    num_heads: int = 30
    head_dim: int = 64
    text_dim: int = 4096  # T5-XXL
    time_embed_dim: int = 512
    max_text_len: int = 226
    sample_frames: int = 13  # latent frames for 49 video frames
    sample_h: int = 60
    sample_w: int = 90
    use_rotary: bool = False  # False: 2B (fixed sin-cos); True: 5B (3D RoPE)
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"
    # the JAX package's layer layout (a stacked 'blocks' tree); the port
    # always holds a ModuleList
    scan_layers: bool = True
    remat: bool = False
    # ring attention over a mesh axis: slice 6, refused when set
    sequence_parallel_axis: Optional[str] = None

    @property
    def hidden(self) -> int:
        return self.num_heads * self.head_dim  # 1920 (2B)

    @staticmethod
    def cogvideox_5b() -> "CogVideoXConfig":
        """THUDM/CogVideoX-5b: 42 layers, 48 heads × 64, 3D RoPE."""
        return CogVideoXConfig(num_layers=42, num_heads=48, head_dim=64, use_rotary=True)

    @staticmethod
    def tiny(use_rotary: bool = False) -> "CogVideoXConfig":
        return CogVideoXConfig(
            num_layers=2, num_heads=2, head_dim=16, text_dim=32, time_embed_dim=16,
            max_text_len=8, sample_frames=3, sample_h=8, sample_w=8,
            use_rotary=use_rotary, dtype=torch.float32, attn_impl="xla",
        )


def sincos_3d(dim: int, frames: int, grid_h: int, grid_w: int, *,
              spatial_scale: float = 1.875, temporal_scale: float = 1.0) -> np.ndarray:
    """CogVideoX-2B's fixed 3D sin-cos position table [F·H·W, dim] in
    float64 on the host, returned fp32: a quarter of dim for the frame index,
    three quarters for the 2D grid, the grids divided by their scales."""
    dim_t, dim_s = dim // 4, dim * 3 // 4

    def embed_1d(pos, d):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    hh = np.arange(grid_h, dtype=np.float64) / spatial_scale
    ww = np.arange(grid_w, dtype=np.float64) / spatial_scale
    gw, gh = np.meshgrid(ww, hh)
    spatial = np.concatenate([embed_1d(gh, dim_s // 2), embed_1d(gw, dim_s // 2)], axis=1)
    temporal = embed_1d(np.arange(frames, dtype=np.float64) / temporal_scale, dim_t)
    out = np.concatenate([
        np.broadcast_to(temporal[:, None, :], (frames, grid_h * grid_w, dim_t)),
        np.broadcast_to(spatial[None, :, :], (frames, grid_h * grid_w, dim_s)),
    ], axis=-1)
    return out.reshape(frames * grid_h * grid_w, dim).astype(np.float32)


def rope_3d(dim: int, frames: int, grid_h: int, grid_w: int) -> tuple[np.ndarray, np.ndarray]:
    """CogVideoX-5B's 3D rotary tables (cos, sin) [F·H·W, dim], host numpy:
    dim split (t, h, w) = (dim/4, 3dim/8, the rest), interleaved pairs."""
    dim_t = dim // 4
    dim_h = dim * 3 // 8
    dim_w = dim - dim_t - dim_h

    def freqs(n, d):
        inv = 1.0 / (10000 ** (np.arange(0, d, 2, dtype=np.float64) / d))
        return np.repeat(np.outer(np.arange(n, dtype=np.float64), inv), 2, axis=1)

    full = np.concatenate([
        np.broadcast_to(freqs(frames, dim_t)[:, None, None, :], (frames, grid_h, grid_w, dim_t)),
        np.broadcast_to(freqs(grid_h, dim_h)[None, :, None, :], (frames, grid_h, grid_w, dim_h)),
        np.broadcast_to(freqs(grid_w, dim_w)[None, None, :, :], (frames, grid_h, grid_w, dim_w)),
    ], axis=-1).reshape(frames * grid_h * grid_w, dim)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


class CogLayerNormZero(nn.Module):
    """silu(temb) → (shift, scale, gate) for the video stream and for the
    text stream; one shared affine LayerNorm (fp32, eps 1e-5) on both, the
    modulation in the model dtype."""

    def __init__(self, temb_dim: int, dim: int, *, dtype, param_dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.linear = L.Dense(temb_dim, 6 * dim, dtype=dtype, param_dtype=param_dtype,
                              device=device)
        self.norm = L.LayerNorm(dim, 1e-5, device=device)

    def forward(self, x, ctx, temb):
        mod = self.linear(F.silu(temb)).reshape(temb.shape[0], 6, -1)
        shift, scale, gate, c_shift, c_scale, c_gate = (mod[:, i, None] for i in range(6))
        x = self.norm(x).to(self.dtype) * (1 + scale) + shift
        ctx = self.norm(ctx).to(self.dtype) * (1 + c_scale) + c_shift
        return x, ctx, gate, c_gate


class CogVideoXBlock(nn.Module):
    """One expert-adaLN block. Under 'tp' (`parallel/tp.py`) a rank runs
    heads/n of the heads: to_q/to_k/to_v column-parallel behind f, to_out
    row-parallel; norm_q/norm_k are per head and stay local."""

    tp = None
    _COLUMNS, _ROWS = ("to_q", "to_k", "to_v"), ("to_out",)

    def __init__(self, cfg: CogVideoXConfig, device=None, param_dtype=None):
        super().__init__()
        c = self.cfg = cfg
        inner = c.hidden
        kw = dict(dtype=c.dtype, param_dtype=param_dtype, device=device)
        self.impl = L.attn_route(c.attn_impl)
        self.norm1 = CogLayerNormZero(c.time_embed_dim, inner, **kw)
        self.to_q = L.Dense(inner, inner, **kw)
        self.to_k = L.Dense(inner, inner, **kw)
        self.to_v = L.Dense(inner, inner, **kw)
        self.norm_q = L.LayerNorm(c.head_dim, 1e-6, device=device)
        self.norm_k = L.LayerNorm(c.head_dim, 1e-6, device=device)
        self.to_out = L.Dense(inner, inner, **kw)
        self.norm2 = CogLayerNormZero(c.time_embed_dim, inner, **kw)
        self.ff = L.FeedForward(inner, 4, **kw)

    def tp_cuts(self, n: int) -> dict:
        return L.tp_cuts(self, n, self.cfg.num_heads % n == 0, self._COLUMNS, self._ROWS)

    def set_tp(self, tp) -> None:
        L.set_tp(self, tp, self._COLUMNS, self._ROWS, ("norm_q", "norm_k"))

    def forward(self, x, ctx, temb, rotary=None):
        """x [B, S_vid, D] video tokens, ctx [B, S_txt, D] text tokens;
        rotary: the (cos, sin) tables of the video rows, or None."""
        c = self.cfg
        b, s_vid, inner = x.shape
        s_txt = ctx.shape[1]
        hx, hc, gate, c_gate = self.norm1(x, ctx, temb)
        h = torch.cat([hc, hx], dim=1)  # text first
        heads = c.num_heads
        if self.tp is not None:
            heads //= self.tp.n
            h = tp_lib.copy_to_tp(h, self.tp)

        def split(t):
            return t.reshape(b, -1, heads, c.head_dim).transpose(1, 2)

        q = self.norm_q(split(self.to_q(h))).to(c.dtype)
        k = self.norm_k(split(self.to_k(h))).to(c.dtype)
        v = split(self.to_v(h)).contiguous()
        if rotary is not None:  # the video rows only; text keeps identity
            q = torch.cat([q[:, :, :s_txt], L.apply_rotary(q[:, :, s_txt:], rotary)], dim=2)
            k = torch.cat([k[:, :, :s_txt], L.apply_rotary(k[:, :, s_txt:], rotary)], dim=2)
        out = L.fused_attention(q.contiguous(), k.contiguous(), v, None, impl=self.impl)
        out = self.to_out(out.transpose(1, 2).reshape(b, s_txt + s_vid, heads * c.head_dim))
        ctx = ctx + c_gate * out[:, :s_txt]
        x = x + gate * out[:, s_txt:]

        hx, hc, gate, c_gate = self.norm2(x, ctx, temb)
        h = self.ff(torch.cat([hc, hx], dim=1))
        ctx = ctx + c_gate * h[:, :s_txt]
        x = x + gate * h[:, s_txt:]
        return x, ctx


class CogVideoXTransformer3D(nn.Module):
    """forward(latent [B, 16, F, H, W], t [B], text [B, L, text_dim]) →
    the prediction [B, 16, F, H, W] in latent's dtype (v-prediction for the
    2B checkpoint). `param_dtype` is the parameters' dtype (default
    cfg.dtype, as serving holds them; fp32 masters in training)."""

    def __init__(self, cfg: Optional[CogVideoXConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else CogVideoXConfig()
        if c.sequence_parallel_axis is not None:
            raise NotImplementedError(
                "CogVideoX sequence parallelism (ring attention over "
                f"sequence_parallel_axis) is not ported yet: {_SLICE6}")
        L.attn_route(c.attn_impl)
        dev = resolve_device(device)
        inner, p = c.hidden, c.patch_size
        kw = dict(dtype=c.dtype, param_dtype=param_dtype, device=dev)
        self.patch_proj = L.Conv2d(c.in_channels, inner, p, stride=p, **kw)
        self.text_proj = L.Dense(c.text_dim, inner, **kw)
        self.time_embedding = L.TimestepEmbedding(inner, c.time_embed_dim, **kw)
        self.blocks = nn.ModuleList(CogVideoXBlock(c, dev, param_dtype)
                                    for _ in range(c.num_layers))
        self.norm_final = L.LayerNorm(inner, 1e-5, device=dev)
        self.norm_out_linear = L.Dense(c.time_embed_dim, 2 * inner, **kw)
        self.norm_out_norm = L.LayerNorm(inner, 1e-5, device=dev)
        self.proj_out = L.Dense(inner, p * p * c.out_channels, **kw)
        self._tables: dict = {}  # position tables by (kind, f, gh, gw, device)

    def _table(self, kind: str, f: int, gh: int, gw: int, device):
        """The video rows' sin-cos table (model dtype) or RoPE tables (fp32),
        built once per latent shape and device."""
        key = (kind, f, gh, gw, str(device))
        if key not in self._tables:
            c = self.cfg
            if kind == "sincos":
                val = torch.from_numpy(sincos_3d(c.hidden, f, gh, gw)).to(device, c.dtype)
            else:
                val = tuple(torch.from_numpy(a).to(device)
                            for a in rope_3d(c.head_dim, f, gh, gw))
            self._tables[key] = val
        return self._tables[key]

    def patchify(self, latent: torch.Tensor) -> torch.Tensor:
        """[B, C, F, H, W] → [B, F·(H/p)·(W/p), D]: the stride-p conv of
        each frame as one product over its p×p patches."""
        b, ch, f, h, w = latent.shape
        p = self.cfg.patch_size
        x = latent.to(self.cfg.dtype).reshape(b, ch, f, h // p, p, w // p, p)
        x = x.permute(0, 2, 3, 5, 1, 4, 6).reshape(b, f * (h // p) * (w // p), ch * p * p)
        conv = self.patch_proj
        return F.linear(x, conv.weight.to(self.cfg.dtype).reshape(conv.out_channels, -1),
                        conv.bias.to(self.cfg.dtype))

    def forward(self, latent, t, text):
        c = self.cfg
        b, _, f, h, w = latent.shape
        p = c.patch_size
        gh, gw = h // p, w // p
        t = torch.as_tensor(t, device=latent.device)
        if t.dim() == 0:
            t = t.expand(b)
        x = self.patchify(latent)
        ctx = self.text_proj(text.to(c.dtype))
        rotary = None
        if c.use_rotary:
            rotary = self._table("rope", f, gh, gw, latent.device)
        else:  # the 2B's fixed positions, on the video tokens only
            x = x + self._table("sincos", f, gh, gw, latent.device)[None]
        t_base = L.sinusoidal_timestep_embedding(t, c.hidden)
        temb = self.time_embedding(t_base.to(c.dtype))
        remat = c.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x, ctx = L.checkpoint_block(block, x, ctx, temb, rotary)
            else:
                x, ctx = block(x, ctx, temb, rotary)
        # norm_final of the JAX model runs over [ctx; x] and keeps the video
        # rows; a LayerNorm is per row, so the text rows are left out
        x = self.norm_final(x).to(c.dtype)
        mod = self.norm_out_linear(F.silu(temb)).reshape(b, 2, c.hidden)
        shift, scale = mod[:, 0, None], mod[:, 1, None]
        x = self.norm_out_norm(x).to(c.dtype) * (1 + scale) + shift
        x = self.proj_out(x)
        x = x.reshape(b, f, gh, gw, p, p, c.out_channels)
        x = torch.einsum("bfhwpqc->bcfhpwq", x)
        return x.reshape(b, c.out_channels, f, gh * p, gw * p).to(latent.dtype)


def make_denoise_fn(model: CogVideoXTransformer3D):
    """The sampler's `DenoiseFn`: (x, t, text embeddings [B, L, 4096]) →
    the model output; CogVideoX passes no mask (a fixed 226-token pad)."""

    def fn(x, t, cond):
        return model(x, t, cond)

    return fn


def make_pp_forward(*args, **kwargs):
    raise NotImplementedError(f"pipeline-parallel CogVideoX is not ported yet: {_SLICE6}")


def sequence_parallel_apply(*args, **kwargs):
    raise NotImplementedError(f"CogVideoX sequence parallelism is not ported yet: {_SLICE6}")
