"""PixArt-α DiT denoiser in PyTorch (dense blocks).

Port of `tdm_tpu/models/pixart.py`: latent 4×64×64, patch 2 →
1024 tokens, hidden 1152, 28 layers, 16 heads × 72; adaLN-single
conditioning (one timestep MLP emits 6 modulation vectors, each block adds
its learned `scale_shift_table`); per block: modulated LayerNorm →
self-attention → gate, cross-attention to the projected T5 tokens on the
RAW residual (no pre-norm, a PixArt quirk), modulated LayerNorm → gelu-tanh
MLP → gate. The output has 8 channels (ε plus learned variance);
`epsilon()` keeps the first 4. With `moe_experts > 0` each block's MLP is
a top-k mixture of experts (`models/moe.py`), as the JAX config's research
option.

The model computes in `cfg.dtype`. Serving holds its parameters in that
dtype; training builds it with `param_dtype=torch.float32` (fp32 master
weights, cast to the compute dtype inside each layer, as Flax does), and
`cfg.remat` checkpoints each block (`torch.utils.checkpoint`, recomputed in
the backward) when autograd records the forward: the whole block under
`remat_policy='full'`, all but the Dense layers' matmul outputs under
'dots' (`layers.checkpoint_block`). A MoE block is remat'd whole as well;
under 'dots' its router product (an mm) is kept and its expert products
(batched, baddbmm) are recomputed with the routing, as JAX's
`dots_with_no_batch_dims_saveable` keeps the router's dot and not the
batched expert einsums.

The blocks are a ModuleList; the weight carry (`io/from_jax.py`) reads the
JAX package's stacked `blocks/...` tree and its unrolled `blocks_{i}/...`
tree alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import layers as L, moe


@dataclass(frozen=True)
class PixArtConfig:
    sample_size: int = 64  # latent H = W
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 8  # ε + learned variance
    num_layers: int = 28
    num_heads: int = 16
    head_dim: int = 72
    caption_dim: int = 4096  # T5-XXL hidden
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16
    # the JAX package's layer layout: True = one stacked [L, ...] tree under
    # 'blocks' (what `io/from_jax.jax_layout` writes); the port always holds
    # a ModuleList
    scan_layers: bool = True
    # per-block activation checkpointing (the reference's
    # --gradient_checkpointing) under one of layers.REMAT_POLICIES
    remat: bool = False
    remat_policy: str = "full"
    # research option of the JAX config: > 0 swaps each block's MLP for a
    # top-k mixture of experts (models/moe.py)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def hidden(self) -> int:
        return self.num_heads * self.head_dim

    @staticmethod
    def tiny() -> "PixArtConfig":
        """Small config for tests (the real topology at tiny widths)."""
        return PixArtConfig(
            sample_size=16, num_layers=2, num_heads=2, head_dim=16,
            caption_dim=32, dtype=torch.float32,
        )


def _table(rows: int, dim: int, device) -> nn.Parameter:
    """A learned fp32 modulation table, N(0, 0.02) at init."""
    return nn.Parameter(
        nn.init.normal_(torch.empty(rows, dim, dtype=torch.float32, device=device), std=0.02)
    )


class PixArtBlock(nn.Module):
    def __init__(self, cfg: PixArtConfig, device=None, param_dtype=None):
        super().__init__()
        c = cfg
        kw = dict(dtype=c.dtype, param_dtype=param_dtype, device=device)
        self.scale_shift_table = _table(6, c.hidden, device)
        self.attn1 = L.Attention(c.hidden, c.num_heads, c.head_dim, **kw)
        self.attn2 = L.Attention(c.hidden, c.num_heads, c.head_dim, **kw)
        if c.moe_experts > 0:
            self.ff = moe.MoEFeedForward(
                c.hidden, c.moe_experts, c.moe_top_k, mult=c.mlp_ratio,
                capacity_factor=c.moe_capacity_factor, activation="gelu-approximate", **kw)
        else:
            self.ff = L.FeedForward(c.hidden, c.mlp_ratio, **kw)

    def forward(self, x, text, text_mask, t6):
        """x [B,S,D] tokens, text [B,L,D] projected caption, t6 [B,6,D]."""
        # modulation built in fp32, then cast to the activations' dtype
        mod = self.scale_shift_table[None] + t6.float()
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            m.to(x.dtype) for m in mod.chunk(6, dim=1)
        )
        h = L.layer_norm(x) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * self.attn1(h)
        x = x + self.attn2(x, context=text, key_mask=text_mask)
        h = L.layer_norm(x) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.ff(h)


class PixArtTransformer2D(nn.Module):
    """forward(latent [B,4,H,W], t [B], text [B,L,caption_dim],
    text_mask [B,L]) → [B,8,H,W] in latent's dtype. `param_dtype` is the
    dtype the Dense/conv parameters are held in (default: cfg.dtype); the
    modulation tables are fp32 either way."""

    def __init__(
        self,
        cfg: Optional[PixArtConfig] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
        param_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else PixArtConfig()
        if c.remat_policy not in L.REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {c.remat_policy!r} (one of {L.REMAT_POLICIES})")
        dev = resolve_device(device)
        kw = dict(dtype=c.dtype, param_dtype=param_dtype, device=dev)
        self.pos_embed = L.PatchEmbed(
            c.patch_size, c.in_channels, c.hidden,
            pos_embed_base_size=c.sample_size // c.patch_size, **kw,
        )
        self.t_embedder = L.TimestepEmbedding(256, c.hidden, **kw)
        self.t_block = L.Dense(c.hidden, 6 * c.hidden, **kw)
        self.caption_linear_1 = L.Dense(c.caption_dim, c.hidden, **kw)
        self.caption_linear_2 = L.Dense(c.hidden, c.hidden, **kw)
        self.blocks = nn.ModuleList(
            PixArtBlock(c, dev, param_dtype) for _ in range(c.num_layers)
        )
        self.final_scale_shift_table = _table(2, c.hidden, dev)
        self.proj_out = L.Dense(
            c.hidden, c.patch_size * c.patch_size * c.out_channels, **kw
        )

    def forward(self, latent, t, text, text_mask=None):
        c = self.cfg
        b, _, h, w = latent.shape
        gh, gw = h // c.patch_size, w // c.patch_size
        t = torch.as_tensor(t, device=latent.device)
        if t.dim() == 0:
            t = t.expand(b)
        x = self.pos_embed(latent.to(c.dtype))
        t_emb = self.t_embedder(L.sinusoidal_timestep_embedding(t, 256).to(c.dtype))
        t6 = self.t_block(F.silu(t_emb)).reshape(b, 6, c.hidden)
        y = self.caption_linear_1(text.to(c.dtype))
        y = self.caption_linear_2(F.gelu(y, approximate="tanh"))
        remat = c.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = L.checkpoint_block(block, x, y, text_mask, t6, policy=c.remat_policy)
            else:
                x = block(x, y, text_mask, t6)
        mod = self.final_scale_shift_table[None] + t_emb.float()[:, None]
        shift, scale = (m.to(x.dtype) for m in mod.chunk(2, dim=1))
        x = self.proj_out(L.layer_norm(x) * (1 + scale) + shift)
        out = L.unpatchify(x, gh, gw, c.patch_size, c.out_channels)
        return out.to(latent.dtype)


def epsilon(model_out: torch.Tensor) -> torch.Tensor:
    """Drop the learned-variance half (`chunk(2, dim=1)[0]`)."""
    return model_out.chunk(2, dim=1)[0]


def make_denoise_fn(model: PixArtTransformer2D):
    """The sampler's `DenoiseFn`: (x, t, (text, mask)) → ε."""

    def fn(x, t, cond):
        text, mask = cond
        return epsilon(model(x, t, text, mask))

    return fn


def make_pp_forward(*args, **kwargs):
    raise NotImplementedError(
        "pipeline-parallel PixArt is not ported yet: ROADMAP.md queue 1, "
        "slice 6 (multi-GPU, parallel/pp.py)"
    )
