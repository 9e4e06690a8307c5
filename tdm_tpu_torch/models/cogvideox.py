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

Sequence parallelism (`sequence_parallel_apply`, the JAX package's
`:490-531`): the latent's frames are cut over the mesh axis the config
names (`sequence_parallel_axis`, 'sp'), and tokens are frame-major, so a
rank's frames are a contiguous range of video rows. A forward called with
`sp=` (this rank's `parallel.mesh.AxisGroup` on that axis) builds its
position tables for the global frame count and slices them at its first
row, row0 = index·s_vid (`:283-324`); every block's attention is
`ops.ring_attention` over the video K/V shards, the 226 T5 rows of K/V
the prefix attended once (`:226-238`), and each rank keeps its own copy
of the text stream. Everything else in a block is per row. Under 'tp' as
well (the pipeline's ('data', 'sp', 'tp') mesh) each sp shard runs its
heads of the cut blocks. `make_pp_forward` waits for ROADMAP.md queue 1,
slice 6, and raises.
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
from tdm_tpu_torch.ops import ring_attention as ring
from tdm_tpu_torch.parallel import mesh as pmesh, tp as tp_lib

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
    # the mesh axis the frames are cut over under `sequence_parallel_apply`
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

    def forward(self, x, ctx, temb, rotary=None, sp=None):
        """x [B, S_vid, D] video tokens, ctx [B, S_txt, D] text tokens;
        rotary: the (cos, sin) tables of the video rows, or None; sp: the
        'sp' ring when x is this rank's frames (ring attention), or None."""
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
        if sp is not None:  # the video K/V ride the ring; the text block is the prefix
            out = ring.ring_attention(
                q, k[:, :, s_txt:], v[:, :, s_txt:], group=sp,
                prefix_kv=(k[:, :, :s_txt], v[:, :, :s_txt]), impl=c.attn_impl)
        else:
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

    def forward(self, latent, t, text, sp: Optional[pmesh.AxisGroup] = None):
        """`sp`: under sequence parallelism (`sequence_parallel_apply`),
        this rank's place on the ring; latent then holds this rank's F/n
        frames of the video, and so does the output."""
        c = self.cfg
        b, _, f, h, w = latent.shape
        p = c.patch_size
        gh, gw = h // p, w // p
        t = torch.as_tensor(t, device=latent.device)
        if t.dim() == 0:
            t = t.expand(b)
        x = self.patchify(latent)
        ctx = self.text_proj(text.to(c.dtype))
        # under sp the tables are built for the global frame count and cut
        # at this shard's first row (tokens are frame-major)
        s_vid = f * gh * gw
        f_all, rows = f, slice(None)
        if sp is not None:
            f_all, rows = f * sp.n, slice(sp.index * s_vid, (sp.index + 1) * s_vid)
        rotary = None
        if c.use_rotary:
            rotary = tuple(t_[rows] for t_ in self._table("rope", f_all, gh, gw, latent.device))
        else:  # the 2B's fixed positions, on the video tokens only
            x = x + self._table("sincos", f_all, gh, gw, latent.device)[rows][None]
        t_base = L.sinusoidal_timestep_embedding(t, c.hidden)
        temb = self.time_embedding(t_base.to(c.dtype))
        remat = c.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x, ctx = L.checkpoint_block(block, x, ctx, temb, rotary, sp)
            else:
                x, ctx = block(x, ctx, temb, rotary, sp)
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


def _all_gather(x: torch.Tensor, dim: int, axis: pmesh.AxisGroup) -> torch.Tensor:
    """The ranks' slices of `dim` concatenated in rank order (one
    all_gather)."""
    moved = x.movedim(dim, 0).contiguous()
    flat = pmesh.all_gather_flat(moved.reshape(-1), axis.group)
    return flat.view(axis.n * moved.shape[0], *moved.shape[1:]).movedim(0, dim).contiguous()


class _GatherSlices(torch.autograd.Function):
    """`_all_gather`, whose backward keeps this rank's slice of the
    gradient (the loss after the gather is computed alike on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.axis.n, ctx.dim)[ctx.axis.index], None, None


def _gather(x: torch.Tensor, dim: int, axis: pmesh.AxisGroup) -> torch.Tensor:
    if axis.n == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherSlices.apply(x, dim, axis)
    return _all_gather(x, dim, axis)


def sequence_parallel_apply(model: CogVideoXTransformer3D, mesh, *, data_axis=None):
    """Sequence-parallel execution of `model` over `mesh` (a
    `parallel.mesh.Mesh`; every rank of the world calls it, and then the
    returned function, with the same arguments): the latent's frames cut
    over the mesh axis named by the config's `sequence_parallel_axis`
    and, with `data_axis` ('data'), its rows over that axis. Returns
    fn(latent [B, C, F, H, W], t [B], text [B, L, Dt], params=None) → the
    full output [B, C, F, H, W]: this rank's frames (and rows) go in, the
    output's are all-gathered, and in the backward each rank keeps its
    slice of the gradient, so a rank's parameter gradients are its share
    of the sum over 'sp' (the reducers' `sp` rule, `parallel/mesh.py`).
    `params`, when given, is the dict the forward runs on
    (`torch.func.functional_call`, as the training families call their
    module). Raises the JAX ValueErrors: no axis in the config; F not a
    multiple of the axis size (at the call)."""
    from torch.func import functional_call

    ax = model.cfg.sequence_parallel_axis
    if ax is None:
        raise ValueError(
            "model.cfg.sequence_parallel_axis is None — construct the model "
            "with the sp axis name to use sequence_parallel_apply"
        )
    sp = mesh.axis(ax)
    rows_axis = mesh.axis(data_axis) if data_axis is not None else None

    def fn(latent, t, text, params=None):
        t = torch.as_tensor(t, device=latent.device)
        if t.dim() == 0:
            t = t.expand(latent.shape[0])
        if rows_axis is not None and rows_axis.n > 1:
            b = latent.shape[0]
            if b % rows_axis.n:
                raise ValueError(
                    f"batch {b} does not divide the '{data_axis}' axis size {rows_axis.n}")
            per = b // rows_axis.n
            mine = slice(rows_axis.index * per, (rows_axis.index + 1) * per)
            latent, t, text = latent[mine], t[mine], text[mine]
        f = latent.shape[2]
        if f % sp.n:
            raise ValueError(
                f"latent frame count {f} does not divide by the '{ax}' axis size {sp.n}")
        per_f = f // sp.n
        local = latent[:, :, sp.index * per_f:(sp.index + 1) * per_f]
        if params is None:
            out = model(local, t, text, sp=sp)
        else:
            out = functional_call(model, params, (local, t, text), {"sp": sp})
        out = _gather(out, 2, sp)
        if rows_axis is not None:
            out = _gather(out, 0, rows_axis)
        return out

    return fn
