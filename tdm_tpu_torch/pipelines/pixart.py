"""PixArt-α pipeline: 4-NFE text-to-image with the TDM student.

Port of `tdm_tpu/pipelines/pixart.py`: conditioning from raw prompts
through the attached tokenizer and T5 encoder (`encode_prompt`: T5 at
`max_text_len` 120, (embeds, mask)) or precomputed (`prompt_embeds=(embeds,
mask)`), the deterministic few-step rollout on the reference grid
(total_steps=900, K=4 → t=[899, 674, 449, 224]) with optional CFG (the
negative prompt, or "", encoded when no `negative_embeds` are given), or
DPM-Solver++(2M) / UniPC on the DDPM grid (`solver="dpm"|"unipc"`), and the
TAESD decode. `default_pixart_pipeline` assembles the reference's
validation setup (the full DiT and TAESD) from two JAX-layout trees.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from tdm_tpu_torch.core import sampling, schedules as sched, solvers
from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.models import pixart, t5 as t5_lib, vae as vae_lib
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
        text_encoder: Optional[t5_lib.T5Encoder] = None,
        tokenizer=None,
        schedule: Optional[sched.NoiseSchedule] = None,
        max_text_len: int = 120,  # the reference's T5 length
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
        self.text_encoder = (
            text_encoder.to(self.device).eval() if text_encoder is not None else None
        )
        self.tokenizer = tokenizer
        self.schedule = (
            schedule if schedule is not None else sched.ddpm_linear(device=self.device)
        )
        self.max_text_len = max_text_len

    @torch.inference_mode()
    def encode_prompt(self, prompts: list[str]) -> tuple[torch.Tensor, torch.Tensor]:
        """Tokenize and T5-encode: (embeds [B, max_text_len, d_model], mask
        [B, max_text_len] int32) on the pipeline's device. Needs a tokenizer
        and a text encoder; otherwise pass `prompt_embeds`."""
        if self.tokenizer is None or self.text_encoder is None:
            raise ValueError(
                "no tokenizer/text_encoder attached — pass prompt_embeds="
                "(embeds, mask) instead of raw prompts"
            )
        ids, mask = self.tokenizer(list(prompts), max_length=self.max_text_len)
        mask = torch.from_numpy(mask).to(self.device)
        return self.text_encoder(torch.from_numpy(ids).to(self.device), mask), mask

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
                negative_embeds = self.encode_prompt(negative_prompt or [""] * cond[0].shape[0])
            uncond = self._cond(negative_embeds)
        cond = repeat_per_prompt(cond, num_images_per_prompt)
        uncond = repeat_per_prompt(uncond, num_images_per_prompt)
        b = cond[0].shape[0]
        noise = initial_noise(
            latents, generator_for(seed, generator),
            (b, self.transformer.cfg.in_channels, height // 8, width // 8),
            self.device,
        )
        return self.run_rows(noise, cond, uncond, cfg=guidance_scale if use_cfg else None,
                             solver=solver, num_inference_steps=num_inference_steps,
                             total_steps=total_steps, output_type=output_type)

    def _run(self, noise, cond, uncond, *, cfg, solver, num_inference_steps, total_steps,
             output_type) -> PipelineOutput:
        """The sampler and the decode of a call's rows (`run_rows`)."""
        denoise = pixart.make_denoise_fn(self.transformer)
        with self.sampler_scope():
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


def default_pixart_pipeline(
    transformer_params,
    vae_params,
    *,
    cfg: Optional[pixart.PixArtConfig] = None,
    vae_cfg: Optional[vae_lib.TAESDConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
    **kw,
) -> PixArtPipeline:
    """The reference's validation setup, the full PixArt DiT and TAESD,
    from the JAX package's two param trees (nested or flat '/'-joined, the
    transformer stacked or unrolled, e.g. `io/params.load_params`'s) put
    into the modules on `device` by the weight carry. `kw` passes on to
    `PixArtPipeline` (`vae_scaling` is the TAESD config's)."""
    dev = resolve_device(device)
    cfg = cfg or pixart.PixArtConfig()
    vae_cfg = vae_cfg or vae_lib.TAESDConfig()
    transformer = from_jax.load_from_jax(from_jax.flatten_tree(transformer_params),
                                         pixart.PixArtTransformer2D(cfg, device=dev))
    decoder = from_jax.load_from_jax(from_jax.flatten_tree(vae_params),
                                     vae_lib.TAESDDecoder(vae_cfg, device=dev))
    return PixArtPipeline(transformer, vae_decoder=decoder,
                          vae_scaling=vae_cfg.scaling_factor, device=dev, **kw)
