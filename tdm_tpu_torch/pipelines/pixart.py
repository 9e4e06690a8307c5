"""PixArt-α pipeline: 4-NFE text-to-image with the TDM student.

Port of `tdm_tpu/pipelines/pixart.py` for the serving path: conditioning
from precomputed T5 embeddings (`prompt_embeds=(embeds, mask)`), the
deterministic few-step rollout on the reference grid (total_steps=900, K=4
→ t=[899, 674, 449, 224]) with optional CFG, or DPM-Solver++(2M) / UniPC
on the DDPM grid (`solver="dpm"|"unipc"`), and the TAESD decode.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from tdm_tpu_torch.core import sampling, schedules as sched, solvers
from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import pixart, vae as vae_lib
from tdm_tpu_torch.pipelines.base import (
    DiffusionPipelineBase,
    PipelineOutput,
    check_negative_prompt,
    generator_for,
    initial_noise,
    repeat_per_prompt,
    to_images,
)


class PixArtPipeline(DiffusionPipelineBase):
    family = "pixart"

    def __init__(
        self,
        transformer: pixart.PixArtTransformer2D,
        *,
        vae_decoder: Optional[Union[vae_lib.TAESDDecoder, vae_lib.KLDecoder]] = None,
        vae_scaling: float = 1.0,
        vae_range: str = "unit",  # TAESD decodes to [0, 1]; a KL VAE to [-1, 1]: 'pm1'
        schedule: Optional[sched.NoiseSchedule] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.transformer = transformer.to(self.device).eval()
        self.vae_decoder = (
            vae_decoder.to(self.device).eval() if vae_decoder is not None else None
        )
        self.vae_scaling = vae_scaling
        self.vae_range = vae_range
        self.schedule = (
            schedule if schedule is not None else sched.ddpm_linear(device=self.device)
        )

    def encode_prompt(self, prompts):
        raise NotImplementedError(
            "T5 encode_prompt is not ported yet: ROADMAP.md queue 1, slice 7 "
            "(text encoders from transformers); serve from an embedding "
            "cache or pass prompt_embeds=(embeds, mask)"
        )

    def _cond(self, embeds_and_mask) -> tuple[torch.Tensor, torch.Tensor]:
        embeds, mask = embeds_and_mask
        return (
            torch.as_tensor(embeds).to(self.device),
            torch.as_tensor(mask).to(self.device),
        )

    @torch.inference_mode()
    def __call__(
        self,
        prompt: Optional[list[str]] = None,
        *,
        negative_prompt: Optional[list[str]] = None,
        prompt_embeds: Optional[tuple] = None,
        negative_embeds: Optional[tuple] = None,
        num_inference_steps: int = 4,
        num_images_per_prompt: int = 1,
        guidance_scale: float = 1.0,
        height: int = 512,
        width: int = 512,
        seed: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        latents=None,
        solver: str = "fewstep",
        total_steps: int = 900,
        output_type: str = "image",
    ) -> PipelineOutput:
        if solver not in ("fewstep", "dpm", "unipc"):
            raise ValueError(f"unknown solver {solver!r} (fewstep|dpm|unipc)")
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt)
        cond = self._cond(prompt_embeds)
        negative_prompt = check_negative_prompt(negative_prompt, cond[0].shape[0])
        use_cfg = guidance_scale is not None and guidance_scale > 1.0
        uncond = None
        if use_cfg:
            if negative_embeds is None:
                negative_embeds = self.encode_prompt(negative_prompt)
            uncond = self._cond(negative_embeds)
        cond = repeat_per_prompt(cond, num_images_per_prompt)
        uncond = repeat_per_prompt(uncond, num_images_per_prompt)
        b = cond[0].shape[0]
        noise = initial_noise(
            latents, generator_for(seed, generator),
            (b, self.transformer.cfg.in_channels, height // 8, width // 8),
            self.device,
        )
        denoise = pixart.make_denoise_fn(self.transformer)
        cfg = guidance_scale if use_cfg else None
        if solver == "fewstep":
            out = sampling.sample_fewstep(
                denoise, self.schedule, noise, cond,
                timestep_grid=sched.fewstep_grid(total_steps, num_inference_steps),
                uncond=uncond, cfg=cfg,
            )
        else:
            sample = solvers.sample_dpm_solver if solver == "dpm" else solvers.sample_unipc
            out = sample(denoise, solvers.ddpm_grid(self.schedule, num_inference_steps),
                         noise, cond, uncond=uncond, cfg=cfg)
        if output_type == "latent" or self.vae_decoder is None:
            return PipelineOutput(images=None, latents=out)
        decoded = self.vae_decoder(out.float() / self.vae_scaling)
        return PipelineOutput(images=to_images(decoded, value_range=self.vae_range),
                              latents=out)
