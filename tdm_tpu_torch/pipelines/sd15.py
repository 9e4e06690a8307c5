"""SD1.5 / Dreamshaper pipeline: the reference's simplest 4-NFE recipe.

Port of `tdm_tpu/pipelines/sd15.py` for the serving path, as the recipe
drives `DiffusionPipeline.from_pretrained('lykon/dreamshaper-7')`: the TDM
LoRA merged into the UNet (`load_lora_weights`, `set_adapters`),
DPM-Solver++(2M) on the scaled-linear DDPM grid (UniPC with
`solver="unipc"`), `pipe(prompt_embeds=(embeds, mask),
num_inference_steps=4, guidance_scale=1)` at 512², and the KL VAE's decode
(scaling 0.18215, output range [-1, 1]).

Conditioning comes precomputed: CLIP-L's last hidden states [B, 77, 768]
and their mask; the text encoder is not ported yet, so `encode_prompt`
raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from tdm_tpu_torch.core import schedules as sched, solvers
from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import unet_sd15, vae as vae_lib
from tdm_tpu_torch.pipelines.base import (
    DiffusionPipelineBase,
    PipelineOutput,
    check_negative_prompt,
    generator_for,
    initial_noise,
    repeat_per_prompt,
    to_images,
)

SOLVERS = {"dpm": solvers.sample_dpm_solver, "unipc": solvers.sample_unipc}


class SD15Pipeline(DiffusionPipelineBase):
    family = "sd15"

    def __init__(
        self,
        unet: unet_sd15.UNet2DCondition,
        *,
        vae_decoder: Optional[vae_lib.KLDecoder] = None,
        vae_scaling: float = 0.18215,
        vae_range: str = "pm1",  # the KL VAE decodes to [-1, 1]
        schedule: Optional[sched.NoiseSchedule] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.unet = unet.to(self.device).eval()
        self.vae_decoder = (
            vae_decoder.to(self.device).eval() if vae_decoder is not None else None
        )
        self.vae_scaling = vae_scaling
        self.vae_range = vae_range
        # SD1.5's scheduler config: scaled-linear β in [0.00085, 0.012]
        self.schedule = (
            schedule if schedule is not None else sched.ddpm_scaled_linear(device=self.device)
        )

    def encode_prompt(self, prompts):
        raise NotImplementedError(
            "the CLIP-L encode_prompt is not ported yet: ROADMAP.md queue 1, slice 7 "
            "(text encoders from transformers); serve from an embedding cache or "
            "pass prompt_embeds=(embeds, mask)"
        )

    def _cond(self, embeds_and_mask) -> tuple[torch.Tensor, torch.Tensor]:
        embeds, mask = embeds_and_mask
        return (torch.as_tensor(embeds).to(self.device),
                torch.as_tensor(mask).to(self.device))

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
        solver: str = "dpm",
        output_type: str = "image",
    ) -> PipelineOutput:
        sample = SOLVERS.get(solver)
        if sample is None:
            raise ValueError(f"unknown solver {solver!r} (dpm|unipc)")
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
            (b, self.unet.cfg.in_channels, height // 8, width // 8), self.device,
        )
        out = sample(
            unet_sd15.make_denoise_fn(self.unet),
            solvers.ddpm_grid(self.schedule, num_inference_steps), noise, cond,
            uncond=uncond, cfg=guidance_scale if use_cfg else None,
        )
        if output_type == "latent" or self.vae_decoder is None:
            return PipelineOutput(images=None, latents=out)
        decoded = self.vae_decoder(out.float() / self.vae_scaling)
        return PipelineOutput(images=to_images(decoded, value_range=self.vae_range),
                              latents=out)
