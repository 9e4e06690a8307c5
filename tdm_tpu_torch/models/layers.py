"""Building blocks of the PixArt, SD3, SD1.5 and CogVideoX denoisers, in
PyTorch.

Port of the serving path's part of `tdm_tpu/models/layers.py`. Module and
parameter names follow the JAX package's tree (to_q/to_k/to_v/to_out,
linear_1/linear_2, proj, proj_in/proj_out) so the weight carry
(`io/from_jax.py`) is a mechanical rename. Layouts stay those of the JAX
package at the public functions: tokens [B, S, D], attention [B, H, S, D],
images NCHW. Dense and convolution layers compute in the model's compute
dtype and hold their parameters in `param_dtype`: the compute dtype when
serving, fp32 master weights when training, cast to the compute dtype at
every use as Flax casts its fp32 parameters to `dtype`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils import checkpoint as ckpt

from tdm_tpu_torch.ops import quant
from tdm_tpu_torch.ops.attention import attention as fused_attention
from tdm_tpu_torch.parallel import tp as tp_lib

# the JAX package's remat policies: 'full' recomputes the whole block in the
# backward; 'dots' (jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
# keeps the outputs of the Dense layers' matmuls and recomputes the rest
REMAT_POLICIES = ("full", "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# the JAX package's attn_impl names; every one but 'splash' takes the flash
# kernel's route
ATTN_IMPLS = ("auto", "pallas", "xla", "splash")


def attn_route(attn_impl: str) -> str:
    """The JAX package's attn_impl → the port's attention route."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (one of {ATTN_IMPLS})")
    return "splash" if attn_impl == "splash" else "auto"


def sinusoidal_timestep_embedding(
    t: torch.Tensor,
    dim: int,
    *,
    max_period: float = 10000.0,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """DDPM sinusoidal embedding (diffusers `Timesteps`); t [B] → [B, dim]
    fp32. PixArt uses flip_sin_to_cos=True and a shift of 0."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - downscale_freq_shift)
    )
    args = t.float()[:, None] * freqs[None, :] * scale
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class Dense(nn.Linear):
    """A linear layer computing in `dtype` on parameters held in
    `param_dtype` (default: `dtype`), cast at every use; `bias=False`
    drops the bias (SD1.5's q/k/v projections). Under an int8 scope on the
    calling thread (`ops/quant.quant_scope`) a call that passes the gates
    runs through `quant.int8_dot`, as the JAX interceptor reroutes flax's
    `nn.Dense`; no other layer reroutes.

    Under tensor parallelism (`parallel/tp.py`, `tp_mode` set by its
    module's `set_tp`) the layer holds a local weight: 'column' its slice of
    the output features (the input whole), 'row' its slice of the input
    features, whose partial product, in the layer's dtype as the JAX
    package's sharded dot leaves it, is summed over 'tp' before the bias is
    added once. `in_features`/`out_features` stay the whole layer's, which
    the int8 gates read."""

    tp_mode: Optional[str] = None  # None, 'column' or 'row'
    tp: Optional[tp_lib.TPGroup] = None

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True, dtype,
                 param_dtype=None, device=None):
        super().__init__(in_dim, out_dim, bias=bias, dtype=param_dtype or dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.tp_mode is None:
            y = quant.dense(x, self.weight, self.bias, dt)
        else:  # the gates read the whole layer's N and K
            shape = (self.out_features, self.in_features)
            if self.tp_mode == "row":
                y = quant.dense(x, self.weight, None, dt, shape=shape, tp=self.tp)
                if y is None:
                    y = tp_lib.reduce_from_tp(F.linear(x.to(dt), self.weight.to(dt)), self.tp)
                return y if self.bias is None else y + self.bias.to(dt)
            y = quant.dense(x, self.weight, self.bias, dt, shape=shape)
        if y is not None:
            return y
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def set_tp(module: nn.Module, tp: tp_lib.TPGroup, columns=(), rows=(), norms=()) -> None:
    """A module's tensor-parallel mode (`parallel/tp.parallelize`): its
    `tp`, the named Dense children in column and row mode, and the named
    per-head norms, whose weights pass Megatron's f."""
    module.tp = tp
    for names, mode in ((columns, "column"), (rows, "row")):
        for name in names:
            dense = getattr(module, name)
            dense.tp_mode, dense.tp = mode, tp
    for name in norms:
        norm = getattr(module, name, None)
        if norm is not None:
            norm.tp = tp


def tp_cuts(module: nn.Module, n: int, divides: bool, columns=(), rows=()) -> dict:
    """The `tp_cuts` of a module with these column and row Dense children:
    {} unless n > 1 divides its heads (`divides`); the column layers' weight
    and bias cut over their outputs, the row layers' weight over its
    inputs."""
    if n <= 1 or not divides:
        return {}
    out = {}
    for name in columns:
        out[f"{name}.weight"] = tp_lib.COLUMN
        if getattr(module, name).bias is not None:
            out[f"{name}.bias"] = tp_lib.COLUMN
    for name in rows:
        out[f"{name}.weight"] = tp_lib.ROW
    return out


def tp_param(p: torch.Tensor, tp: Optional[tp_lib.TPGroup]) -> torch.Tensor:
    """A per-head norm's weight as it is used under 'tp': through f, whose
    backward sums the ranks' shares of its gradient."""
    return p if tp is None else tp_lib.copy_to_tp(p, tp)


class Conv2d(nn.Conv2d):
    """A convolution computing in `dtype` on parameters held in
    `param_dtype` (default: `dtype`), cast at every use."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, dtype, param_dtype=None, device=None):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=padding,
                         dtype=param_dtype or dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def conv2d_im2col(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  stride: int, padding: int) -> torch.Tensor:
    """A convolution as an explicit im2col GEMM: `F.unfold` (a 1×1 kernel at
    stride 1 without padding reads x as it is), one batched product with
    the weight as [out, in·k·k], then the reshape. Its backward, by
    autograd, is two batched products, a sum over the batch and `F.fold`
    (col2im, a gather): no cuDNN and no atomics, so the same inputs give the
    same bits, and a row's bits do not depend on its batch-mates."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    if kh == kw == 1 and stride == 1 and padding == 0:
        cols = x.reshape(b, cin, h * w)
    else:
        cols = F.unfold(x, (kh, kw), padding=padding, stride=stride)
    out = torch.bmm(weight.reshape(cout, -1).expand(b, -1, -1), cols)
    if bias is not None:
        out = out + bias[:, None]
    return out.reshape(b, cout, ho, wo)


class GemmConv2d(Conv2d):
    """`Conv2d` through `conv2d_im2col` on every call: the SD1.5 UNet's one
    convolution route, in its forward, a remat block's recompute and the
    backward alike, chosen by the module and not by a process-wide switch
    (the UNet module docstring says why cuDNN is not that route)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return conv2d_im2col(x.to(dt), self.weight.to(dt), bias, self.stride[0],
                             self.padding[0])


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP over the sinusoidal embedding."""

    def __init__(self, in_dim: int, dim: int, *, dtype, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.linear_1 = Dense(in_dim, dim, **kw)
        self.linear_2 = Dense(dim, dim, **kw)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb)))


def get_2d_sincos_pos_embed(
    dim: int, grid_h: int, grid_w: int, *, base_size: Optional[int] = None
) -> np.ndarray:
    """Fixed 2D sin-cos position table [grid_h*grid_w, dim] (PixArt/DiT),
    computed on the host in float64."""
    h = np.arange(grid_h, dtype=np.float64)
    w = np.arange(grid_w, dtype=np.float64)
    if base_size is not None:
        h = h / (grid_h / base_size)
        w = w / (grid_w / base_size)
    gw, gh = np.meshgrid(w, h)

    def embed_1d(pos, d):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb_h = embed_1d(gh, dim // 2)
    emb_w = embed_1d(gw, dim // 2)
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def cropped_sincos_pos_embed(
    dim: int, max_size: int, grid_h: int, grid_w: int, *, base_size: int
) -> np.ndarray:
    """The centre [grid_h, grid_w] crop of the [max_size, max_size] sin-cos
    table (SD3's PatchEmbed at `pos_embed_max_size`), as [grid_h*grid_w,
    dim]: the same float64 positions as `get_2d_sincos_pos_embed(dim,
    max_size, max_size, base_size=base_size)` cut down before the table is
    built, not after."""
    top, left = (max_size - grid_h) // 2, (max_size - grid_w) // 2
    pos = np.arange(max_size, dtype=np.float64) / (max_size / base_size)
    gw, gh = np.meshgrid(pos[left : left + grid_w], pos[top : top + grid_h])

    def embed_1d(p, d):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", p.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([embed_1d(gh, dim // 2), embed_1d(gw, dim // 2)], axis=1)
    return emb.astype(np.float32)


class PatchEmbed(nn.Module):
    """[B, C, H, W] → tokens [B, (H/p)(W/p), dim] by a stride-p conv, plus
    the fixed sin-cos position table unless `add_pos_embed` is False (SD3
    adds its own cropped table)."""

    def __init__(
        self,
        patch_size: int,
        in_channels: int,
        dim: int,
        *,
        pos_embed_base_size: Optional[int] = None,
        add_pos_embed: bool = True,
        dtype,
        param_dtype=None,
        device=None,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.dim = dim
        self.base_size = pos_embed_base_size
        self.add_pos_embed = add_pos_embed
        self.proj = Conv2d(
            in_channels, dim, patch_size, stride=patch_size,
            dtype=dtype, param_dtype=param_dtype, device=device,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        p = self.patch_size
        x = self.proj(x).flatten(2).transpose(1, 2)  # [B, gh*gw, dim]
        if not self.add_pos_embed:
            return x
        pos = get_2d_sincos_pos_embed(self.dim, h // p, w // p, base_size=self.base_size)
        return x + torch.from_numpy(pos).to(device=x.device, dtype=x.dtype)[None]


class RMSNorm(nn.Module):
    """RMS norm over the last axis in fp32 with a learned fp32 `scale`, cast
    to the compute dtype (the qk norm of SD3.5)."""

    tp: Optional[tp_lib.TPGroup] = None  # set on a per-head qk norm under 'tp'

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype, device=None):
        super().__init__()
        self.eps, self.compute_dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        out = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (out * tp_param(self.scale, self.tp)).to(self.compute_dtype)


class Attention(nn.Module):
    """Multi-head self or cross attention over [B, S, D] tokens through
    `ops.attention` (the kernels on CUDA) with the route `impl` ('auto' or
    'splash'), and an optional RMS qk norm ('rms'). `context_dim` is the
    width of the tokens k and v are made from (default `dim`: PixArt's and
    SD3's projected context); `qkv_bias=False` drops the q/k/v biases
    (SD1.5). Under 'tp' (`tp_cuts`, `set_tp`) a rank runs heads/n of the
    heads: q/k/v column-parallel behind f, to_out row-parallel."""

    tp: Optional[tp_lib.TPGroup] = None
    _COLUMNS, _ROWS = ("to_q", "to_k", "to_v"), ("to_out",)

    def __init__(
        self,
        dim: int,
        heads: int,
        head_dim: int,
        *,
        context_dim: Optional[int] = None,
        qkv_bias: bool = True,
        qk_norm: Optional[str] = None,
        impl: str = "auto",
        dtype,
        param_dtype=None,
        device=None,
    ):
        super().__init__()
        inner = heads * head_dim
        ctx_dim = dim if context_dim is None else context_dim
        self.heads, self.head_dim, self.impl = heads, head_dim, impl
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.to_q = Dense(dim, inner, bias=qkv_bias, **kw)
        self.to_k = Dense(ctx_dim, inner, bias=qkv_bias, **kw)
        self.to_v = Dense(ctx_dim, inner, bias=qkv_bias, **kw)
        if qk_norm == "rms":
            self.norm_q = RMSNorm(head_dim, dtype=dtype, device=device)
            self.norm_k = RMSNorm(head_dim, dtype=dtype, device=device)
        elif qk_norm is not None:
            raise ValueError(f"unknown qk_norm {qk_norm!r} (None or 'rms')")
        self.qk_norm = qk_norm
        self.to_out = Dense(inner, dim, **kw)

    def tp_cuts(self, n: int) -> dict:
        return tp_cuts(self, n, self.heads % n == 0, self._COLUMNS, self._ROWS)

    def set_tp(self, tp: tp_lib.TPGroup) -> None:
        set_tp(self, tp, self._COLUMNS, self._ROWS, ("norm_q", "norm_k"))

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        key_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        heads = self.heads
        if self.tp is not None:
            heads //= self.tp.n
            x = tp_lib.copy_to_tp(x, self.tp)
            if context is not None:
                context = tp_lib.copy_to_tp(context, self.tp)
        ctx = x if context is None else context
        b, s, _ = x.shape

        def split(t):
            return t.reshape(b, -1, heads, self.head_dim).transpose(1, 2).contiguous()

        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx))
        if self.qk_norm == "rms":
            q, k = self.norm_q(q), self.norm_k(k)
        out = fused_attention(q, k, v, key_mask, impl=self.impl)
        out = out.transpose(1, 2).reshape(b, s, heads * self.head_dim)
        return self.to_out(out)


class GroupNorm(nn.Module):
    """GroupNorm of NCHW activations in fp32 with fp32 `scale`/`bias` (Flax's
    GroupNorm(dtype=float32) and its parameter names); the output is fp32."""

    def __init__(self, groups: int, width: int, eps: float, *, device=None):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(width, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(width, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.scale, self.bias, eps=self.eps)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in fp32 with fp32 `scale`/`bias` (Flax's
    LayerNorm(dtype=float32)); the output is fp32."""

    tp: Optional[tp_lib.TPGroup] = None  # set on a per-head qk norm under 'tp'

    def __init__(self, width: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(width, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(width, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, tp_param(self.scale, self.tp),
                            tp_param(self.bias, self.tp), eps=self.eps)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm computed in fp32, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)


FF_ACTIVATIONS = ("gelu-approximate", "geglu")


class FeedForward(nn.Module):
    """Transformer MLP, mult× expansion: the tanh-approximated GELU
    ('gelu-approximate', PixArt and SD3) or GEGLU ('geglu', SD1.5: proj_in
    to twice the inner width, h · gelu(gate) with the exact erf GELU). Under
    'tp' a rank holds its slice of the inner width (GEGLU: the matching
    slices of h and gate): proj_in column-parallel behind f, proj_out
    row-parallel."""

    tp: Optional[tp_lib.TPGroup] = None

    def __init__(self, dim: int, mult: int = 4, *, activation: str = "gelu-approximate",
                 dtype, param_dtype=None, device=None):
        super().__init__()
        if activation not in FF_ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r} (one of {FF_ACTIVATIONS})")
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.activation = activation
        inner = dim * mult
        self.proj_in = Dense(dim, 2 * inner if activation == "geglu" else inner, **kw)
        self.proj_out = Dense(inner, dim, **kw)

    def tp_cuts(self, n: int) -> dict:
        if n <= 1 or self.proj_out.in_features % n:
            return {}
        c = tp_lib.Cut(0, 2 if self.activation == "geglu" else 1)
        return {"proj_in.weight": c, "proj_in.bias": c, "proj_out.weight": tp_lib.ROW}

    def set_tp(self, tp: tp_lib.TPGroup) -> None:
        set_tp(self, tp, ("proj_in",), ("proj_out",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = tp_lib.copy_to_tp(x, self.tp)
        h = self.proj_in(x)
        if self.activation == "geglu":
            h, gate = h.chunk(2, dim=-1)
            return self.proj_out(h * F.gelu(gate))
        return self.proj_out(F.gelu(h, approximate="tanh"))


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation x·(1+scale)+shift; shift and scale [B, D] or
    [B, 1, D] (`tdm_tpu/models/layers.py:233-237`)."""
    if shift.dim() == 2:
        shift, scale = shift[:, None], scale[:, None]
    return x * (1 + scale) + shift


def apply_rotary(x: torch.Tensor, rotary: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Rotate the interleaved pairs (x0, x1) of x [B, H, S, D] by the (cos,
    sin) tables [S, D] (CogVideoX-5B's 3D RoPE, `tdm_tpu/models/layers.py:
    240-251`): (x0·c − x1·s, x1·c + x0·s) with c, s from the even columns;
    the result in x's dtype."""
    cos, sin = rotary
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[..., 0::2], sin[..., 0::2]
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def unpatchify(
    tokens: torch.Tensor, grid_h: int, grid_w: int, patch: int, channels: int
) -> torch.Tensor:
    """[B, gh*gw, p·p·C] → [B, C, gh·p, gw·p] (the inverse of PatchEmbed)."""
    b = tokens.shape[0]
    x = tokens.reshape(b, grid_h, grid_w, patch, patch, channels)
    x = torch.einsum("bhwpqc->bchpwq", x)
    return x.reshape(b, channels, grid_h * patch, grid_w * patch)


def _dots_saveable(ctx, op, *args, **kwargs):
    """Save the outputs of the Dense layers' products (F.linear reaches the
    dispatcher as mm or addmm); recompute everything else, the batched
    products of plain attention and the flash kernels included."""
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _run_block(block, params, *args):
    return functional_call(block, params, args)


def checkpoint_block(block: nn.Module, *args, policy: str = "full"):
    """block(*args) with its activations recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant) under the remat `policy`. The
    recompute runs on the parameters in use now, handed over as inputs:
    under torch.func.functional_call the module's own are back in place by
    the time the backward recomputes."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r} (one of {REMAT_POLICIES})")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_saveable)
    params = dict(block.named_parameters())
    return ckpt.checkpoint(_run_block, block, params, *args, use_reentrant=False, **kw)

