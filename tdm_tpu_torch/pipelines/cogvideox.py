"""CogVideoX pipeline: 4-NFE text-to-video.

Port of `tdm_tpu/pipelines/cogvideox.py` for the serving path, as the
reference's video recipe drives `CogVideoXPipeline` with the TDM LoRA:
`pipe(prompt_embeds=embeds, guidance_scale=1, num_inference_steps=4,
num_frames=49)` at 480×720, sampled on the grid the TDM generator was
trained on, t = (999, 856, 665, 399) (`TDM_TRAINED_GRID`; another step
count takes `fewstep_grid(1000, K)`), under the CogVideoX schedule
(v-prediction, zero terminal SNR). The fp32 latents, divided by the VAE's
`scaling_factor`, are decoded by the causal 3D VAE in spatial tiles
(`vae_tile`, `vae_tile_overlap`, the reference's `enable_tiling()`), each
tile streamed in temporal chunks when `vae_temporal_chunk` is set
(`enable_slicing()`); the output is [B, F, H, W, 3] (`.frames`).

Conditioning is the T5 embedding sequence [B, 226, 4096] alone, with no
mask: from raw prompts through the attached tokenizer and T5 encoder at the
transformer's `max_text_len` (`encode_prompt`), or precomputed
(`prompt_embeds=embeds`). CFG (only above 1) takes `negative_embeds`, else
encodes the negative prompt ("" by default) as diffusers'
`CogVideoXPipeline` does, else, with no encoder attached, zeros.

Sequence parallelism (`sequence_parallel_mesh`, the JAX package's
`:44-78, 158-190, 227-245`): a `parallel.mesh.Mesh` over the world whose
'sp' axis (the one the transformer's config names) cuts the latent frames,
through `models/cogvideox.sequence_parallel_apply` with the batch over its
'data' axis; every rank of the world builds the pipeline and calls it with
the same arguments, each rank's sampler runs its frames (ring attention)
and ends with the whole latents, and the decode runs on rank 0 alone (the
other ranks return latents only). A ('data', 'sp', 'tp') mesh composes
'tp': the transformer is cut for this rank's 'tp' slice (`parallel/tp.py`)
inside each sequence shard. The JAX package's ValueErrors: the mesh and
the config's axis come together, the mesh excludes `data_parallel_devices`
and `tensor_parallel`, and the latent frame count must be a multiple of
the 'sp' size.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from tdm_tpu_torch.core import sampling, schedules as sched
from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.models import cogvideox as cog, t5 as t5_lib, vae3d
from tdm_tpu_torch.pipelines.base import (
    DiffusionPipelineBase,
    PipelineOutput,
    check_negative_prompt,
    generator_for,
    initial_noise,
    repeat_per_prompt,
    to_images,
)

TDM_TRAINED_GRID = (999, 856, 665, 399)  # the reference README.md:129


class CogVideoXPipeline(DiffusionPipelineBase):
    family = "cogvideox"

    def __init__(
        self,
        transformer: cog.CogVideoXTransformer3D,
        *,
        vae_decoder: Optional[vae3d.VAE3DDecoder] = None,
        vae_cfg: Optional[vae3d.VAE3DConfig] = None,
        text_encoder: Optional[t5_lib.T5Encoder] = None,
        tokenizer=None,
        schedule: Optional[sched.NoiseSchedule] = None,
        vae_tile: int = 32,
        vae_tile_overlap: int = 4,
        vae_temporal_chunk: Optional[int] = None,
        sequence_parallel_mesh=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        ax = transformer.cfg.sequence_parallel_axis
        if (sequence_parallel_mesh is None) != (ax is None):
            raise ValueError(
                "sequence_parallel_mesh and the transformer cfg's "
                "sequence_parallel_axis must be set together "
                f"(mesh={sequence_parallel_mesh}, axis={ax!r})"
            )
        self.sp_mesh = sequence_parallel_mesh
        self.device = resolve_device(device)
        self.transformer = transformer.to(self.device).eval()
        self.vae_decoder = (
            vae_decoder.to(self.device).eval() if vae_decoder is not None else None
        )
        self.vae_cfg = vae_cfg or (vae_decoder.cfg if vae_decoder is not None
                                   else vae3d.VAE3DConfig())
        self.text_encoder = (
            text_encoder.to(self.device).eval() if text_encoder is not None else None
        )
        self.tokenizer = tokenizer
        self.schedule = (
            schedule if schedule is not None else sched.cogvideox(device=self.device)
        )
        self.vae_tile = vae_tile
        self.vae_tile_overlap = vae_tile_overlap
        self.vae_temporal_chunk = vae_temporal_chunk
        self._sp_fn = None
        if sequence_parallel_mesh is not None:
            if sequence_parallel_mesh.n_tp > 1:  # sp+tp: each sp shard runs its heads
                self._cut_for_tp(sequence_parallel_mesh.tp)
            self._sp_fn = cog.sequence_parallel_apply(
                self.transformer, sequence_parallel_mesh, data_axis="data")

    @torch.inference_mode()
    def encode_prompt(self, prompts: list[str]) -> torch.Tensor:
        """T5 states [B, max_text_len, d_model] at the transformer's
        `max_text_len` (226), with no mask."""
        if self.tokenizer is None or self.text_encoder is None:
            raise ValueError("no tokenizer/text_encoder — pass prompt_embeds")
        ids, mask = self.tokenizer(list(prompts), max_length=self.transformer.cfg.max_text_len)
        return self.text_encoder(torch.from_numpy(ids).to(self.device),
                                 torch.from_numpy(mask).to(self.device))

    def latent_shape(self, batch: int, num_frames: int, height: int, width: int) -> tuple:
        """[B, C, 1 + (num_frames − 1)/tf, height/sf, width/sf]."""
        c = self.vae_cfg
        return (batch, self.transformer.cfg.in_channels,
                1 + (num_frames - 1) // c.temporal_factor,
                height // c.spatial_factor, width // c.spatial_factor)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """fp32 latents / scaling_factor → the tiled (and, with
        vae_temporal_chunk, streamed) 3D decode [B, 3, F, H, W], one video
        at a time: the convolutions' shapes, so the library's choice of
        algorithm and with it a video's bits, do not depend on the batch,
        and the peak memory is one video's."""
        c = self.vae_cfg
        if self.vae_temporal_chunk is not None:
            def decode_fn(z):
                return vae3d.decode_streaming(self.vae_decoder, z, chunk=self.vae_temporal_chunk)
        else:
            decode_fn = self.vae_decoder
        z = latents.float() / c.scaling_factor
        return torch.cat([
            vae3d.decode_tiled(decode_fn, z[i:i + 1], tile=self.vae_tile,
                               overlap=self.vae_tile_overlap, spatial_factor=c.spatial_factor)
            for i in range(z.shape[0])])

    @torch.inference_mode()
    def __call__(
        self,
        prompt: Optional[list[str]] = None,
        *,
        negative_prompt: Optional[list[str]] = None,
        prompt_embeds=None,
        negative_embeds=None,
        num_inference_steps: int = 4,
        num_videos_per_prompt: int = 1,
        guidance_scale: float = 1.0,
        num_frames: int = 49,
        height: int = 480,
        width: int = 720,
        seed: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        latents=None,
        timesteps: Optional[Sequence[int]] = None,
        output_type: str = "video",
    ) -> PipelineOutput:
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt)
        cond = torch.as_tensor(prompt_embeds).to(self.device)
        negative_prompt = check_negative_prompt(negative_prompt, cond.shape[0])
        use_cfg = guidance_scale is not None and guidance_scale > 1.0
        uncond = None
        if use_cfg:
            if negative_embeds is not None:
                uncond = torch.as_tensor(negative_embeds).to(self.device)
            elif self.tokenizer is not None and self.text_encoder is not None:
                uncond = self.encode_prompt(negative_prompt or [""] * cond.shape[0])
            else:  # cached-embeds serving with no encoder attached
                uncond = torch.zeros_like(cond)
        cond = repeat_per_prompt(cond, num_videos_per_prompt)
        uncond = repeat_per_prompt(uncond, num_videos_per_prompt)
        shape = self.latent_shape(cond.shape[0], num_frames, height, width)
        if self.sp_mesh is not None:
            ax = self.transformer.cfg.sequence_parallel_axis
            n_sp = self.sp_mesh.axis(ax).n
            if shape[2] % n_sp:
                raise ValueError(
                    f"latent frame count {shape[2]} does not divide by the "
                    f"'{ax}' axis size {n_sp} — pick num_frames so that "
                    f"1 + (num_frames-1)/temporal_factor is a multiple"
                )
        noise = initial_noise(latents, generator_for(seed, generator), shape, self.device)
        if timesteps is None:
            timesteps = (TDM_TRAINED_GRID if num_inference_steps == 4 else
                         sched.fewstep_grid(1000, num_inference_steps).tolist())
        return self.run_rows(noise, cond, uncond, cfg=guidance_scale if use_cfg else None,
                             timesteps=timesteps, output_type=output_type)

    def _run(self, noise, cond, uncond, *, cfg, timesteps, output_type) -> PipelineOutput:
        """The sampler and the decode of a call's rows (`run_rows`); under
        sequence parallelism every rank samples (its frames) and rank 0
        alone decodes."""
        denoise = self._sp_fn or cog.make_denoise_fn(self.transformer)
        with self.sampler_scope():
            out = sampling.sample_fewstep(
                denoise, self.schedule, noise, cond,
                timestep_grid=sched.grid_from_list(timesteps), uncond=uncond, cfg=cfg,
            )
        decodes = self.sp_mesh is None or self.sp_mesh.rank == 0
        if output_type == "latent" or self.vae_decoder is None or not decodes:
            return PipelineOutput(images=None, latents=out)
        return PipelineOutput(images=to_images(self.decode(out), value_range="pm1"),
                              latents=out)
