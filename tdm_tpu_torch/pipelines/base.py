"""Pipeline helpers shared by the families: the output record, the LoRA
verbs and the diffusers call-convention pieces of
`tdm_tpu/pipelines/base.py`.

LoRA (`load_lora_weights`, `set_adapters`): adapters merge into the
denoiser's weights in place (the transformer, or SD1.5's UNet). The
pipeline keeps a pristine copy of every weight an adapter touches, and
`set_adapters` re-merges the named adapters from it, so scale 0 gives back
the base (the recipe's teacher baseline).

Noise: with no `latents=`, a pipeline draws its initial noise from a
`torch.Generator` seeded with `seed` (on the CPU, so a seed gives the same
noise on every device). JAX's `PRNGKey(seed)` draws different numbers by
construction: the same seed gives different images in the two packages;
pass `latents=` to feed both the same noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.lora import adapter as lora_lib, io as lora_io


VALUE_RANGES = ("unit", "pm1")


@dataclass
class PipelineOutput:
    """images: [B, H, W, 3] float32 in [0, 1] (None with output_type='latent');
    latents: the sampler's final x₀ estimate [B, C, h, w]."""

    images: Any
    latents: Any = None


def denoiser_of(pipe) -> torch.nn.Module:
    """A pipeline's denoiser: its `transformer`, or SD1.5's `unet`."""
    model = getattr(pipe, "transformer", None)
    return model if model is not None else pipe.unet


class DiffusionPipelineBase:
    """The LoRA verbs over the pipeline's denoiser (a model with a `cfg`):
    `self.transformer`, or `self.unet` where there is none (SD1.5, as
    `tdm_tpu/pipelines/base.py:285` picks it)."""

    family: str = ""

    def __init__(self):
        self._loras: dict[str, lora_lib.LoRA] = {}
        self._base: dict[str, torch.Tensor] = {}  # pristine adapted weights
        self._active: tuple = ()  # ((name, scale), ...)

    @property
    def denoiser(self) -> torch.nn.Module:
        return denoiser_of(self)

    def load_lora_weights(self, path: str, adapter_name: str = "default") -> None:
        """Read a kohya or peft safetensors LoRA and make it the one active
        adapter at scale 1.0."""
        model = self.denoiser
        lora = lora_io.load_lora(path, model=model)
        stacks = from_jax.layer_stacks(model.cfg)
        weights = dict(model.named_parameters())
        for key in lora_lib.adapted_keys(lora, stacks):
            if key not in weights:
                raise KeyError(f"LoRA {path}: the {type(model).__name__} has no weight {key}")
            if key not in self._base:  # untouched by any adapter so far
                self._base[key] = weights[key].detach().clone()
        self._loras[adapter_name] = lora
        self.set_adapters([adapter_name], [1.0])

    @torch.no_grad()
    def set_adapters(
        self, names: Sequence[str], scales: Optional[Sequence[float]] = None
    ) -> None:
        """Merge the named adapters at the given scales into the pristine
        weights; scale 0 leaves an adapter out."""
        scales = list(scales) if scales is not None else [1.0] * len(names)
        model = self.denoiser
        stacks = from_jax.layer_stacks(model.cfg)
        merged = dict(self._base)
        for name, scale in zip(names, scales):
            if scale != 0.0:
                merged = lora_lib.merge(merged, self._loras[name], scale, stacks)
        weights = dict(model.named_parameters())
        for key, value in merged.items():
            weights[key].copy_(value)
        self._active = tuple(zip(names, scales))


def check_negative_prompt(
    negative_prompt: Optional[Sequence[str]], batch_size: int
) -> Optional[Sequence[str]]:
    """diffusers' check: a str broadcasts to every prompt; a list must have
    one entry per prompt."""
    if negative_prompt is None:
        return None
    if isinstance(negative_prompt, str):
        return [negative_prompt] * batch_size
    if len(negative_prompt) != batch_size:
        raise ValueError(
            f"negative_prompt has {len(negative_prompt)} entries but the "
            f"prompt batch is {batch_size}; pass one negative prompt per "
            "prompt (or a single str for all)"
        )
    return negative_prompt


def repeat_per_prompt(tree: Any, n: int) -> Any:
    """diffusers' num_images_per_prompt: repeat every batch-axis tensor of a
    conditioning tuple n times in repeat_interleave order."""
    if n == 1 or tree is None:
        return tree
    if n < 1:
        raise ValueError(f"num_images_per_prompt must be >= 1, got {n}")
    if isinstance(tree, (tuple, list)):
        return type(tree)(repeat_per_prompt(x, n) for x in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        return tree.repeat_interleave(n, dim=0)
    return tree


def generator_for(seed: Optional[int], generator: Optional[torch.Generator]):
    """`generator` wins; else a CPU generator seeded with `seed` (0 when
    None)."""
    if generator is not None:
        return generator
    return torch.Generator().manual_seed(0 if seed is None else int(seed))


def initial_noise(
    latents: Optional[Any],
    generator: torch.Generator,
    shape: tuple,
    device: torch.device,
) -> torch.Tensor:
    """The sampler's starting noise in bf16 (as the JAX package rounds it,
    for every model dtype): caller-given `latents=` win over the generator."""
    if latents is None:
        noise = torch.randn(shape, generator=generator, device=generator.device)
        return noise.to(device=device, dtype=torch.bfloat16)
    latents = torch.as_tensor(latents).to(device=device, dtype=torch.bfloat16)
    if tuple(latents.shape) != tuple(shape):
        raise ValueError(
            f"latents shape {tuple(latents.shape)} != expected {tuple(shape)}"
        )
    return latents


def to_images(decoded: torch.Tensor, *, value_range: str = "unit") -> torch.Tensor:
    """VAE output [B, 3, H, W] → [B, H, W, 3] float32 in [0, 1].
    `value_range`: 'unit' for TAESD (its output is [0, 1]), 'pm1' for a KL
    VAE ([-1, 1] → /2 + 0.5, diffusers' postprocess); then clipped."""
    if value_range not in VALUE_RANGES:
        raise ValueError(f"unknown vae value_range {value_range!r} (one of {VALUE_RANGES})")
    x = decoded.float()
    if value_range == "pm1":
        x = x / 2.0 + 0.5
    return x.clamp(0.0, 1.0).permute(0, 2, 3, 1)
