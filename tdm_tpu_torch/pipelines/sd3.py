"""SD3-Medium pipeline: the reference's headline 4-NFE recipe.

Port of `tdm_tpu/pipelines/sd3.py` for the serving path, as the recipe
drives `StableDiffusion3Pipeline`: the TDM LoRA at adapter scale 0.125
(`load_lora_weights`, `set_adapters`), TAESD3 decode with shift 0,
DPM-Solver++(2M) on the flow grid with `flow_shift` (6 by default; UniPC
with `solver="unipc"`), `pipe(prompt_embeds=(context, pooled),
num_inference_steps=4, height=width=1024, guidance_scale=1.0)`.

Conditioning (the triple-encoder stack, `encode_prompt`):
  context = concat_seq(pad_features(concat_features(CLIP-L penultimate,
                       CLIP-G penultimate), → 4096), T5 states)
            [B, 77 + 256, 4096]
  pooled  = concat(CLIP-L projected pooled 768, CLIP-G projected pooled
            1280) [B, 2048]
or precomputed as `prompt_embeds=(context, pooled)` (an embedding cache
with pooled vectors).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from tdm_tpu_torch.core import solvers
from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import mmdit_sd3, vae as vae_lib
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


class SD3Pipeline(DiffusionPipelineBase):
    family = "sd3"

    def __init__(
        self,
        transformer: mmdit_sd3.SD3Transformer2D,
        *,
        vae_decoder: Optional[Union[vae_lib.TAESDDecoder, vae_lib.KLDecoder]] = None,
        vae_scaling: float = 1.0,  # TAESD3
        vae_shift: float = 0.0,  # the recipe pins TAESD3's shift to 0
        vae_range: str = "unit",  # TAESD decodes to [0, 1]; a KL VAE to [-1, 1]: 'pm1'
        text_encoders: Optional[dict] = None,  # {'clip_l', 'clip_g', 't5'}: modules
        tokenizers: Optional[dict] = None,  # the same keys
        flow_shift: float = 6.0,  # the recipe's value; the knob spans 1-6
        max_t5_len: int = 256,
        max_clip_len: int = 77,
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
        self.vae_shift = vae_shift
        self.text_encoders = {k: m.to(self.device).eval()
                              for k, m in (text_encoders or {}).items()}
        self.tokenizers = dict(tokenizers or {})
        self.flow_shift = flow_shift
        self.max_t5_len = max_t5_len
        self.max_clip_len = max_clip_len

    @torch.inference_mode()
    def encode_prompt(self, prompts: list[str]) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (context [B, max_clip_len + max_t5_len, context_dim], pooled
        [B, 2048]); needs all three encoders and tokenizers attached."""
        need = {"clip_l", "clip_g", "t5"}
        if not need <= set(self.text_encoders) or not need <= set(self.tokenizers):
            raise ValueError(
                "SD3 needs clip_l/clip_g/t5 encoders+tokenizers — or pass "
                "prompt_embeds=(context, pooled) precomputed"
            )
        prompts = list(prompts)

        def ids_of(name, length):
            ids, mask = self.tokenizers[name](prompts, max_length=length)
            return torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)

        seqs, pooleds = [], []
        for name in ("clip_l", "clip_g"):
            out = self.text_encoders[name](ids_of(name, self.max_clip_len)[0])
            seqs.append(out.hidden_states[-2])  # SD3 reads the PENULTIMATE layer
            pooleds.append(out.pooled)
        clip_seq = torch.cat(seqs, dim=-1)  # [B, 77, 768 + 1280]
        clip_seq = F.pad(clip_seq, (0, self.transformer.cfg.context_dim - clip_seq.shape[-1]))
        t5_seq = self.text_encoders["t5"](*ids_of("t5", self.max_t5_len))
        return torch.cat([clip_seq, t5_seq], dim=1), torch.cat(pooleds, dim=-1)

    def _cond(self, context_and_pooled) -> tuple[torch.Tensor, torch.Tensor]:
        context, pooled = context_and_pooled
        return (torch.as_tensor(context).to(self.device),
                torch.as_tensor(pooled).to(self.device))

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
        height: int = 1024,
        width: int = 1024,
        seed: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        latents=None,
        flow_shift: Optional[float] = None,
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
                             sample=sample, num_inference_steps=num_inference_steps,
                             shift=self.flow_shift if flow_shift is None else flow_shift,
                             output_type=output_type)

    def _run(self, noise, cond, uncond, *, cfg, sample, num_inference_steps, shift,
             output_type) -> PipelineOutput:
        """The sampler and the decode of a call's rows (`run_rows`)."""
        with self.sampler_scope():
            out = sample(
                mmdit_sd3.make_denoise_fn(self.transformer),
                solvers.flow_grid(num_inference_steps, flow_shift=shift), noise, cond,
                uncond=uncond, cfg=cfg,
            )
        if output_type == "latent" or self.vae_decoder is None:
            return PipelineOutput(images=None, latents=out)
        decoded = self.vae_decoder(out.float() / self.vae_scaling + self.vae_shift)
        return PipelineOutput(images=to_images(decoded, value_range=self.vae_range),
                              latents=out)


def default_sd3_pipeline(
    *,
    cfg: Optional[mmdit_sd3.MMDiTConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
    **kw,
) -> SD3Pipeline:
    """The recipe's assembly: the SD3 MMDiT and TAESD3 (shift 0), with
    freshly initialised weights (load real ones with `load_state_dict`, or
    use `from_pretrained`)."""
    dev = resolve_device(device)
    vae_cfg = vae_lib.TAESDConfig.taesd3()
    return SD3Pipeline(
        mmdit_sd3.SD3Transformer2D(cfg, device=dev),
        vae_decoder=vae_lib.TAESDDecoder(vae_cfg, device=dev),
        vae_scaling=vae_cfg.scaling_factor, vae_shift=0.0, device=dev, **kw,
    )
