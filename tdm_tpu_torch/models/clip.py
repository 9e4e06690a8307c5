"""The CLIP text encoder: SD1.5's prompt conditioning (CLIP-L) and two of
SD3's three encoders (CLIP-L and OpenCLIP-G, with projections); and the
CLIP vision tower, the image half of the CLIP score (`eval/clip_score.py`).

Port of `tdm_tpu/models/clip.py` (the JAX package's
rebuild of `transformers.CLIPTextModel(WithProjection)`): learned token and
absolute position embeddings (77 positions), added in fp32 and only then
cast to the compute dtype; a pre-LN transformer with CAUSAL self-attention
(a −1e9 bias above the diagonal) and a quick-GELU MLP (CLIP-L; exact GELU
for OpenCLIP-G); a final LayerNorm. The pooled output is the final state at
each row's first EOS token (the legacy `eos_token_id == 2` checkpoints pool
at the highest token id, as HF's compatibility branch does), times
`text_projection` when the config has a `projection_dim`.
`hidden_states` holds the embeddings and every block's output (before the
final LayerNorm): SD3 reads the penultimate, `hidden_states[-2]`.

Module and parameter names are the JAX tree's (`token_embedding`,
`position_embedding`, `layers_{i}/{layer_norm1,q_proj,k_proj,v_proj,
out_proj,layer_norm2,fc1,fc2}`, `final_layer_norm`, `text_projection`), so
the weight carry moves a tree in by name. Dense weights are held in the
compute dtype; the embeddings and the LayerNorms' scale and bias stay fp32,
and the LayerNorms compute in fp32, as in JAX. The attention is two plain
products around an fp32 softmax, as the JAX package computes it (the flash
kernel has no causal mask).

`CLIPVisionEncoder` (ViT-L/14 by default): the class token and the stride-p
patch convolution's tokens, plus the learned positions (held in fp32, cast
to the compute dtype and added there, as the JAX tower adds them),
`pre_layrnorm` (HF's spelling), the same `CLIPBlock`s with no causal bias,
then `post_layernorm` of token 0 times `visual_projection`. Its attention
is the same two plain products, not `ops/attention.py`. Modules
`class_embedding`, `position_embedding`, `patch_embedding`, `pre_layrnorm`,
`layers_{i}`, `post_layernorm`, `visual_projection`, as the JAX tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import layers as L

ACTIVATIONS = ("quick_gelu", "gelu")


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden: int = 768  # CLIP-L; 1280 for OpenCLIP-G
    num_heads: int = 12
    num_layers: int = 12
    mlp_ratio: int = 4
    max_positions: int = 77
    eos_token_id: int = 49407
    activation: str = "quick_gelu"  # 'gelu' for OpenCLIP-G
    projection_dim: Optional[int] = None  # set: the WithProjection variant
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=96, hidden=32, num_heads=4, num_layers=2,
            max_positions=16, eos_token_id=95, dtype=torch.float32,
        )


class CLIPOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # [B, S, D] (after the final LayerNorm)
    pooled: torch.Tensor  # [B, D] or [B, projection_dim]
    hidden_states: tuple  # the embeddings and each block's output


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None):
        super().__init__()
        if cfg.activation not in ACTIVATIONS:
            raise ValueError(f"unknown CLIP activation {cfg.activation!r} (one of "
                             f"{ACTIVATIONS})")
        self.cfg = cfg
        d, kw = cfg.hidden, dict(dtype=cfg.dtype, device=device)
        self.layer_norm1 = L.LayerNorm(d, cfg.layer_norm_eps, device=device)
        self.q_proj = L.Dense(d, d, **kw)
        self.k_proj = L.Dense(d, d, **kw)
        self.v_proj = L.Dense(d, d, **kw)
        self.out_proj = L.Dense(d, d, **kw)
        self.layer_norm2 = L.LayerNorm(d, cfg.layer_norm_eps, device=device)
        self.fc1 = L.Dense(d, d * cfg.mlp_ratio, **kw)
        self.fc2 = L.Dense(d * cfg.mlp_ratio, d, **kw)

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, d = x.shape
        head_dim = d // c.num_heads
        h = self.layer_norm1(x).to(c.dtype)

        def split(t):
            return t.reshape(b, s, c.num_heads, head_dim).transpose(1, 2)

        q, k, v = split(self.q_proj(h)), split(self.k_proj(h)), split(self.v_proj(h))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (head_dim ** -0.5)
        probs = torch.softmax(logits + causal_bias, dim=-1).to(c.dtype)
        attn = torch.matmul(probs.float(), v.float()).to(c.dtype)
        x = x + self.out_proj(attn.transpose(1, 2).reshape(b, s, d))
        h = self.fc1(self.layer_norm2(x).to(c.dtype))
        h = h * torch.sigmoid(1.702 * h) if c.activation == "quick_gelu" else F.gelu(h)
        return x + self.fc2(h)


class CLIPTextEncoder(nn.Module):
    """forward(input_ids [B, S]) → CLIPOutput. Padding needs no mask: pads
    follow the EOS token and the causal mask hides them from every earlier
    token, as in the torch model. Built on `device` (CUDA unless the caller
    passes 'cpu')."""

    def __init__(self, cfg: Optional[CLIPTextConfig] = None, *, device=None):
        super().__init__()
        cfg = cfg or CLIPTextConfig()
        self.cfg = cfg
        dev = resolve_device(device)
        self.token_embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.hidden, device=dev))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_positions, cfg.hidden, device=dev))
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", CLIPBlock(cfg, device=dev))
        self.final_layer_norm = L.LayerNorm(cfg.hidden, cfg.layer_norm_eps, device=dev)
        if cfg.projection_dim is not None:
            self.text_projection = L.Dense(cfg.hidden, cfg.projection_dim, bias=False,
                                           dtype=cfg.dtype, device=dev)

    def forward(self, input_ids: torch.Tensor) -> CLIPOutput:
        c = self.cfg
        dev = self.token_embedding.device
        input_ids = torch.as_tensor(input_ids, device=dev).long()
        s = input_ids.shape[1]
        x = (self.token_embedding[input_ids] + self.position_embedding[None, :s]).to(c.dtype)
        causal = torch.full((s, s), -1e9, device=dev).triu(1)[None, None]
        hidden_states = [x]
        for i in range(c.num_layers):
            x = getattr(self, f"layers_{i}")(x, causal)
            hidden_states.append(x)
        last = self.final_layer_norm(x).to(c.dtype)
        # the first EOS of each row (HF pools on `(ids == eos).argmax(-1)`);
        # the legacy eos_token_id == 2 pools at the highest id of the row
        if c.eos_token_id == 2:
            eos_pos = input_ids.argmax(dim=1)
        else:
            eos_pos = (input_ids == c.eos_token_id).int().argmax(dim=1)
        pooled = last[torch.arange(last.shape[0], device=dev), eos_pos]
        if c.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return CLIPOutput(last_hidden_state=last, pooled=pooled,
                          hidden_states=tuple(hidden_states))


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14  # ViT-L/14, the standard CLIP-score backbone
    hidden: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    mlp_ratio: int = 4
    activation: str = "quick_gelu"
    projection_dim: Optional[int] = 768  # set: the WithProjection variant
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            image_size=16, patch_size=4, hidden=32, num_heads=4,
            num_layers=2, projection_dim=24, dtype=torch.float32,
        )

    def block_view(self) -> CLIPTextConfig:
        """The hyperparameters `CLIPBlock` reads (the vision blocks are the
        text tower's pre-LN block without the causal mask)."""
        return CLIPTextConfig(
            hidden=self.hidden, num_heads=self.num_heads, num_layers=self.num_layers,
            mlp_ratio=self.mlp_ratio, activation=self.activation,
            layer_norm_eps=self.layer_norm_eps, dtype=self.dtype,
        )


class CLIPVisionEncoder(nn.Module):
    """forward(pixel_values [B, 3, H, W], CLIP-normalized) → CLIPOutput:
    `last_hidden_state` without a final LayerNorm (as HF's
    CLIPVisionTransformer), `pooled` = post_layernorm(token 0), projected
    when the config has a `projection_dim`. Built on `device` (CUDA unless
    the caller passes 'cpu')."""

    def __init__(self, cfg: Optional[CLIPVisionConfig] = None, *, device=None):
        super().__init__()
        cfg = cfg or CLIPVisionConfig()
        self.cfg = cfg
        dev = resolve_device(device)
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden, device=dev))
        self.position_embedding = nn.Parameter(torch.zeros(n_pos, cfg.hidden, device=dev))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False, dtype=cfg.dtype, device=dev)
        self.pre_layrnorm = L.LayerNorm(cfg.hidden, cfg.layer_norm_eps, device=dev)
        block_cfg = cfg.block_view()
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", CLIPBlock(block_cfg, device=dev))
        self.post_layernorm = L.LayerNorm(cfg.hidden, cfg.layer_norm_eps, device=dev)
        if cfg.projection_dim is not None:
            self.visual_projection = L.Dense(cfg.hidden, cfg.projection_dim, bias=False,
                                             dtype=cfg.dtype, device=dev)

    def forward(self, pixel_values: torch.Tensor) -> CLIPOutput:
        c = self.cfg
        dev = self.class_embedding.device
        x = torch.as_tensor(pixel_values, device=dev).to(c.dtype)
        patches = self.patch_embedding(x).flatten(2).transpose(1, 2)  # [B, n, D]
        b = patches.shape[0]
        cls = self.class_embedding.to(c.dtype).expand(b, 1, c.hidden)
        x = torch.cat([cls, patches], dim=1)
        x = x + self.position_embedding[None, : x.shape[1]].to(c.dtype)
        x = self.pre_layrnorm(x).to(c.dtype)
        zero_bias = torch.zeros((1, 1, 1, 1), device=dev)
        hidden_states = [x]
        for i in range(c.num_layers):
            x = getattr(self, f"layers_{i}")(x, zero_bias)
            hidden_states.append(x)
        pooled = self.post_layernorm(x[:, 0]).to(c.dtype)
        if c.projection_dim is not None:
            pooled = self.visual_projection(pooled)
        return CLIPOutput(last_hidden_state=x, pooled=pooled,
                          hidden_states=tuple(hidden_states))
