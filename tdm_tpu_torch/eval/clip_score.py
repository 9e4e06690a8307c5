"""CLIP score: text-image alignment of generated images, the port's one
quality gauge.

Port of `tdm_tpu/eval/clip_score.py`. CLIPScore(prompt, image) =
max(0, 100·cos) between the CLIP text and image embeddings (Hessel et al.),
both towers from `models/clip.py` with weights from a stock
`transformers.CLIPModel` folder (config.json and safetensors, e.g.
openai/clip-vit-large-patch14) through the strict `io/convert.
clip_model_params`. With the JAX package's default configs both towers run
in bf16, and the score is computed in the embeddings' dtype, as there.

`preprocess_images` resizes as `jax.image.resize(method="bicubic")` does,
not as `F.interpolate` does: Keys' cubic at a = −0.5, its support widened by
the shrink factor (antialiased) when the image shrinks, the weights of each
output pixel normalised to sum 1 and zeroed where the sample lies outside
the input; built per axis in numpy and applied as two products, then
clipped to [0, 1].

The folder's tokenizer: a `tdm_tokenizer.json` file `{"kind": "hash",
"vocab_size": N, "eos_id": E}` loads the port's `HashTokenizer`; else the
HF tokenizer files load through `HFTokenizer`, which needs `transformers`.
Without either the scorer has no tokenizer (as the JAX scorer drops one it
cannot load), and `score` then needs `input_ids`.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import clip as clip_mod

# OpenAI CLIP preprocessing constants (transformers CLIPImageProcessor)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
HASH_TOKENIZER_FILE = "tdm_tokenizer.json"


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel at a = −0.5 of |distance| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] fp32 weights of jax.image.resize's bicubic along
    one axis (scale out/in, no translation, antialiased), computed in fp32
    as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def resize_bicubic(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] fp32 → [B, size, size, C]: `resize_weights` along H,
    then along W (an axis already at `size` is left as it is, as JAX skips
    it)."""
    b, h, w, c = images.shape
    x = images
    if h != size:
        wh = torch.from_numpy(resize_weights(h, size)).to(x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    if w != size:
        ww = torch.from_numpy(resize_weights(w, size)).to(x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    return x


def preprocess_images(images, image_size: int = 224) -> torch.Tensor:
    """Pipeline output [B, H, W, 3] float in [0, 1] → CLIP input
    [B, 3, S, S] fp32: the square bicubic resize, clipped to [0, 1], then
    the mean/std normalisation. For the square generations this framework
    makes, the HF processor's shortest-side resize and centre crop."""
    x = torch.as_tensor(images).float()
    b, h, w, c = x.shape
    if (h, w) != (image_size, image_size):
        x = resize_bicubic(x, image_size).clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def clip_score(image_embeds: torch.Tensor, text_embeds: torch.Tensor) -> torch.Tensor:
    """max(0, 100·cos) per (image, text) pair, in the embeddings' dtype."""
    img = image_embeds / torch.linalg.vector_norm(image_embeds, dim=-1, keepdim=True)
    txt = text_embeds / torch.linalg.vector_norm(text_embeds, dim=-1, keepdim=True)
    return torch.clamp((img * txt).sum(dim=-1), min=0.0) * 100.0


def _configs_from_hf(cfg: dict) -> tuple[clip_mod.CLIPTextConfig, clip_mod.CLIPVisionConfig]:
    """A CLIPModel config.json → (text config, vision config), with HF's
    defaults for absent fields."""
    t, v = cfg["text_config"], cfg["vision_config"]
    proj = cfg.get("projection_dim", 512)
    text = clip_mod.CLIPTextConfig(
        vocab_size=t.get("vocab_size", 49408),
        hidden=t.get("hidden_size", 512),
        num_heads=t.get("num_attention_heads", 8),
        num_layers=t.get("num_hidden_layers", 12),
        mlp_ratio=t.get("intermediate_size", 2048) // t.get("hidden_size", 512),
        max_positions=t.get("max_position_embeddings", 77),
        eos_token_id=t.get("eos_token_id", 49407),
        activation=t.get("hidden_act", "quick_gelu"),
        projection_dim=proj,
    )
    vision = clip_mod.CLIPVisionConfig(
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 14),
        hidden=v.get("hidden_size", 768),
        num_heads=v.get("num_attention_heads", 12),
        num_layers=v.get("num_hidden_layers", 12),
        mlp_ratio=v.get("intermediate_size", 3072) // v.get("hidden_size", 768),
        activation=v.get("hidden_act", "quick_gelu"),
        projection_dim=proj,
    )
    return text, vision


def load_tokenizer(path: str):
    """The folder's tokenizer: `tdm_tokenizer.json` (a hash bundle), else
    its HF tokenizer files through `HFTokenizer`; None when neither loads."""
    from tdm_tpu_torch.data.tokenizer import HashTokenizer, HFTokenizer

    spec_file = os.path.join(path, HASH_TOKENIZER_FILE)
    if os.path.exists(spec_file):
        with open(spec_file) as f:
            spec = json.load(f)
        if spec.get("kind") != "hash":
            raise ValueError(f"{spec_file}: unknown tokenizer kind {spec.get('kind')!r}")
        return HashTokenizer(vocab_size=spec.get("vocab_size", 30000), eos_id=spec.get("eos_id"))
    try:  # optional, as in JAX: score() also takes raw ids
        return HFTokenizer(path)
    except Exception:
        return None


class CLIPScorer:
    """Both CLIP towers on one device; scores (image, prompt) batches.

    >>> scorer = CLIPScorer.from_pretrained("/ckpts/clip-vit-large-patch14")
    >>> scores = scorer.score(pipe_out.images, prompts)  # [B] in [0, 100]
    """

    def __init__(self, text_cfg: clip_mod.CLIPTextConfig,
                 vision_cfg: clip_mod.CLIPVisionConfig, text_params: dict,
                 vision_params: dict, tokenizer=None, *, device=None):
        """`text_params`/`vision_params`: the converters' trees (nested or
        flat '/'-joined), carried into the towers by `io/from_jax`."""
        from tdm_tpu_torch.io import convert, from_jax

        if text_cfg.projection_dim is None or vision_cfg.projection_dim is None:
            raise ValueError(
                "CLIP score needs projected embeddings — both configs must "
                "set projection_dim (the CLIPModel checkpoint layout)"
            )
        self.device = resolve_device(device)
        self.text_cfg, self.vision_cfg = text_cfg, vision_cfg
        self.text_model = from_jax.load_from_jax(
            convert.flatten(text_params),
            clip_mod.CLIPTextEncoder(text_cfg, device=self.device)).eval()
        self.vision_model = from_jax.load_from_jax(
            convert.flatten(vision_params),
            clip_mod.CLIPVisionEncoder(vision_cfg, device=self.device)).eval()
        self.tokenizer = tokenizer

    @classmethod
    def from_pretrained(cls, path: str, *, device=None) -> "CLIPScorer":
        """A stock HF CLIPModel folder (config.json, safetensors and
        tokenizer files) on `device` (CUDA unless the caller passes 'cpu')."""
        from tdm_tpu_torch.io import convert

        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        text_cfg, vision_cfg = _configs_from_hf(cfg)
        text_params, vision_params, _ = convert.clip_model_params(
            convert.load_torch_state_dict(path))
        return cls(text_cfg, vision_cfg, text_params, vision_params,
                   tokenizer=load_tokenizer(path), device=device)

    def tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        if self.tokenizer is None:
            raise ValueError(
                "no tokenizer attached — pass input_ids to score(), or load "
                "via from_pretrained() on a directory with tokenizer files"
            )
        ids, _ = self.tokenizer(list(prompts), max_length=self.text_cfg.max_positions)
        return torch.from_numpy(np.asarray(ids))

    @torch.inference_mode()
    def embed_images(self, images) -> torch.Tensor:
        """images: [B, H, W, 3] float in [0, 1] (pipeline output)."""
        px = preprocess_images(torch.as_tensor(images).to(self.device),
                               self.vision_cfg.image_size)
        return self.vision_model(px).pooled

    @torch.inference_mode()
    def embed_texts(self, prompts: Optional[Sequence[str]] = None,
                    input_ids=None) -> torch.Tensor:
        if input_ids is None:
            input_ids = self.tokenize(prompts)
        return self.text_model(torch.as_tensor(input_ids, device=self.device)).pooled

    def score(self, images, prompts: Optional[Sequence[str]] = None,
              input_ids=None) -> np.ndarray:
        """[B] CLIP scores of the (images[i], prompts[i]) pairs."""
        img = self.embed_images(images)
        txt = self.embed_texts(prompts, input_ids)
        return clip_score(img, txt).float().cpu().numpy()
