"""Model-family registry of the training CLI.

Port of `tdm_tpu/train/families.py`: the pixart family (the reference
demo's one trained family, `src/main.py:168-176`), the sd15 family (the
SD1.5 UNet of the Dreamshaper recipe), the sd3 family (SD3-Medium, the
reference's headline TDM LoRA) and the cogvideox family (CogVideoX-2B,
the video recipe). The bundle carries what
the CLI needs per family: the model, the native training schedule, the
latent sample shape, the text-conditioning sizes and `cond_of(text, mask,
pooled=None)`, `denoise_fn(params, x, t, cond)`, the seeded parameter init
and `convert`, which loads a diffusers transformer or UNet state dict (the
teacher directory) into the model.

`denoise_fn` puts a dict of tensors into the bundle's one module with
`torch.func.functional_call`, so the student, the critic and the teacher
share one architecture object and differ only in their dicts. The module
holds fp32 master weights and computes in the config's dtype (bf16 for the
full-size model under `--mixed_precision bf16`). Every attention call goes
through `ops.attention`: the flash kernels on CUDA, as the JAX training
family pins `attn_impl="pallas"` for PixArt (`families.py:114-121`) and
keeps `"auto"` for SD3 and SD1.5, all the flash route here.

sd15 trains under SD1.5's scaled-linear β schedule with ε prediction and
conditions on (CLIP-L tokens, mask), as pixart on (T5 tokens, mask); its
`--gradient_checkpointing` recomputes every ResBlock and SpatialTransformer
(`UNetConfig.remat`).

sd3 trains under the shifted rectified-flow schedule (`flow_match`, shift
3) with the velocity output passed through, and conditions on (T5 tokens,
pooled CLIP vector); without a pooled vector it folds a masked-mean
stand-in from the tokens, which a full-size run takes only under
`allow_pooled_standin`. Its `denoise_fn` feeds the MMDiT the flow timestep
σ̂(t)·1000 of the schedule index t, where the JAX family feeds the index
itself (ROADMAP.md §3).

cogvideox trains CogVideoX-2B on latents [16, F, 60, 90] (F = 1 +
(num_frames − 1)//4 latent frames, 13 for the 49 of 480×720) under its
v-prediction schedule (SNR-shifted, zero terminal SNR), the raw v output
passed through; it conditions on the T5 tokens alone, the padded rows
zeroed by `cond_of` (the model takes no mask), and its `denoise_fn` feeds
the schedule index t, as `pipelines/cogvideox.py` feeds it when serving.
`--gradient_checkpointing` recomputes every block (`CogVideoXConfig.remat`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.func import functional_call

from tdm_tpu_torch.core import schedules as sched
from tdm_tpu_torch.io import convert, from_jax
from tdm_tpu_torch.models import cogvideox as cog, mmdit_sd3, pixart, unet_sd15

FAMILIES = ("pixart", "sd15", "sd3", "cogvideox")
# SD3-Medium's training schedule: the HF scheduler config's `shift`
SD3_SHIFT = 3.0
STANDIN_REFUSED = (
    "sd3 training got no pooled CLIP-L/G vectors — build the cache with "
    "`build_cache --pipeline <sd3 dir>` (it stores the real pooled path), or "
    "pass --allow_pooled_standin to knowingly train on the masked-mean T5 "
    "stand-in"
)


@dataclass
class FamilyBundle:
    name: str
    model: Any  # the module denoise_fn runs; holds the seeded parameters
    schedule: Any  # NoiseSchedule, NATIVE prediction type
    sample_shape: tuple  # per-sample latent shape, no batch axis
    seq_len: int  # text tokens the data pipeline produces
    embed_dim: int  # text embedding width the data pipeline produces
    denoise_fn: Callable  # (params, x, t, cond) -> native model output
    init_params: Callable  # () -> {name: tensor}, the module's own parameters
    cond_of: Callable  # (text [B,L,D], mask [B,L], pooled [B,P] or None) -> cond
    # diffusers state dict -> the module's own parameters, loaded with its
    # weights (strict: a missing or unknown key raises)
    convert: Callable


def check_pooled_source(
    family: str, *, tiny: bool, allow_pooled_standin: bool, has_pooled: bool
) -> None:
    """The stand-in refusal of a full-size sd3 run, before any model is
    built: ValueError when its data carries no pooled vectors and
    `allow_pooled_standin` is off (tiny runs may always fold)."""
    if family == "sd3" and not (tiny or allow_pooled_standin or has_pooled):
        raise ValueError(STANDIN_REFUSED)


def pooled_standin(text: torch.Tensor, mask: torch.Tensor, pooled_dim: int) -> torch.Tensor:
    """The deterministic pooled stand-in of the JAX family (`_pooled_of`):
    the masked mean of the tokens, tiled and cut to `pooled_dim`. It is
    fabricated conditioning, not CLIP's pooled path."""
    m = mask.to(text.dtype)[..., None]
    mean = (text * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    reps = -(-pooled_dim // mean.shape[-1])
    return mean.repeat(1, reps)[:, :pooled_dim]


def _compute_dtype(mcfg, mixed_precision: Optional[str], tiny: bool):
    """`--mixed_precision` onto the config's compute dtype, as the JAX
    package maps it: 'bf16' → bfloat16 (tiny configs stay fp32),
    'no'/'fp32' → float32, 'fp16' → error, None → the config's own."""
    if mixed_precision == "fp16":
        raise ValueError(
            "--mixed_precision fp16 is not supported — use bf16 (what fp16 "
            "recipes map to) or no/fp32"
        )
    if mixed_precision in ("no", "fp32"):
        return dataclasses.replace(mcfg, dtype=torch.float32)
    if mixed_precision == "bf16":
        return mcfg if tiny else dataclasses.replace(mcfg, dtype=torch.bfloat16)
    if mixed_precision is not None:
        raise ValueError(
            f"unknown --mixed_precision {mixed_precision!r} (choose bf16 / no / fp32)"
        )
    return mcfg


def build(
    family: str,
    *,
    tiny: bool = False,
    resolution: int = 512,
    num_frames: int = 0,
    gradient_checkpointing: bool = False,
    mixed_precision: Optional[str] = None,
    allow_pooled_standin: bool = False,
    moe_experts: int = 0,
    moe_top_k: int = 2,
    seed: int = 0,
    device=None,
) -> FamilyBundle:
    """The training bundle of `--model_family`, its parameters drawn from
    `seed` on `device` (CUDA unless given). `num_frames` (pixel frames, 0
    for the config's own) sets cogvideox's latent frames; the image
    families take `resolution`. `allow_pooled_standin` lets a full-size sd3
    run fold the pooled stand-in when a batch carries no pooled vectors
    (tiny runs always may). `moe_experts > 0` (pixart only) swaps each
    block's MLP for a top-`moe_top_k` mixture of experts (`models/moe.py`);
    the teacher and the critic share the student's layout."""
    if family not in FAMILIES:
        raise ValueError(f"unknown --model_family {family!r}; choose from {FAMILIES}")
    if moe_experts > 0 and family != "pixart":
        raise ValueError(f"--moe_experts is a pixart-family extension (got {family!r})")
    lat = 8 if tiny else max(resolution // 8, 8)
    if family == "sd15":
        return _build_sd15(tiny, lat, gradient_checkpointing, mixed_precision, seed, device)
    if family == "cogvideox":
        return _build_cogvideox(tiny, num_frames, gradient_checkpointing, mixed_precision,
                                seed, device)
    if family == "pixart":
        mcfg = pixart.PixArtConfig.tiny() if tiny else pixart.PixArtConfig()
    else:
        mcfg = mmdit_sd3.MMDiTConfig.tiny() if tiny else mmdit_sd3.MMDiTConfig()
    if not tiny and lat != mcfg.sample_size:
        mcfg = dataclasses.replace(mcfg, sample_size=lat)
    if gradient_checkpointing:
        mcfg = dataclasses.replace(mcfg, remat=True)
    if moe_experts > 0:
        mcfg = dataclasses.replace(mcfg, moe_experts=moe_experts, moe_top_k=moe_top_k)
    mcfg = _compute_dtype(mcfg, mixed_precision, tiny)
    torch.manual_seed(seed)
    shape = (mcfg.in_channels, mcfg.sample_size, mcfg.sample_size)

    def init_params():
        return {k: p.detach() for k, p in model.named_parameters()}

    def converter(to_tree):
        def convert_params(sd):
            tree = to_tree(sd, scan_layers=False)
            from_jax.load_from_jax(convert.flatten(tree), model)
            return init_params()
        return convert_params

    if family == "pixart":
        model = pixart.PixArtTransformer2D(mcfg, device=device, param_dtype=torch.float32)
        model.requires_grad_(False)  # gradients flow to the dicts denoise_fn is given

        def denoise_fn(params, x, t, cond):
            text, mask = cond
            return pixart.epsilon(functional_call(model, params, (x, t, text, mask)))

        return FamilyBundle(
            name=family, model=model, schedule=sched.ddpm_linear(device=device),
            sample_shape=shape, seq_len=8 if tiny else 120, embed_dim=mcfg.caption_dim,
            denoise_fn=denoise_fn, init_params=init_params,
            cond_of=lambda text, mask, pooled=None: (text, mask),
            convert=converter(convert.pixart_params),
        )

    model = mmdit_sd3.SD3Transformer2D(mcfg, device=device, param_dtype=torch.float32)
    model.requires_grad_(False)
    schedule = sched.flow_match(shift=SD3_SHIFT, device=device)

    def denoise_fn(params, x, t, cond):
        ctx, pooled = cond
        # the MMDiT is conditioned on the flow timestep σ̂(t)·1000, as both
        # SD3 samplers feed it; the JAX family passes the index t itself
        # (tdm_tpu/train/families.py:244-246), a different timestep under
        # the shift (ROADMAP.md §3)
        t_model = schedule.sigmas[t.long()] * schedule.num_train_timesteps
        return functional_call(model, params, (x, t_model, ctx, pooled))

    def cond_of(text, mask, pooled=None):
        if pooled is None:
            check_pooled_source(family, tiny=tiny, allow_pooled_standin=allow_pooled_standin,
                                has_pooled=False)
            pooled = pooled_standin(text, mask, mcfg.pooled_dim)
        return text, pooled

    return FamilyBundle(
        name=family, model=model, schedule=schedule, sample_shape=shape,
        seq_len=8 if tiny else 154,  # T5 tokens of the joint context
        embed_dim=mcfg.context_dim, denoise_fn=denoise_fn, init_params=init_params,
        cond_of=cond_of, convert=converter(convert.sd3_params),
    )


def _build_sd15(tiny, lat, gradient_checkpointing, mixed_precision, seed, device):
    """The sd15 bundle (`tdm_tpu/train/families.py:163-200`): the UNet at
    the latent size of --resolution (its config has no sample size),
    holding fp32 masters and computing in the config's dtype."""
    mcfg = unet_sd15.UNetConfig.tiny() if tiny else unet_sd15.UNetConfig()
    if gradient_checkpointing:
        mcfg = dataclasses.replace(mcfg, remat=True)
    mcfg = _compute_dtype(mcfg, mixed_precision, tiny)
    torch.manual_seed(seed)
    model = unet_sd15.UNet2DCondition(mcfg, device=device, param_dtype=torch.float32)
    model.requires_grad_(False)

    def init_params():
        return {k: p.detach() for k, p in model.named_parameters()}

    def denoise_fn(params, x, t, cond):
        text, mask = cond
        return functional_call(model, params, (x, t, text, mask))

    def convert_params(sd):
        tree = convert.unet_sd15_params(sd, layers_per_block=mcfg.layers_per_block,
                                        n_stages=len(mcfg.block_widths))
        from_jax.load_from_jax(convert.flatten(tree), model)
        return init_params()

    return FamilyBundle(
        name="sd15", model=model,
        # SD1.5's scheduler config: scaled-linear β (README.md:97)
        schedule=sched.ddpm_scaled_linear(device=device),
        sample_shape=(mcfg.in_channels, lat, lat), seq_len=8 if tiny else 77,
        embed_dim=mcfg.context_dim, denoise_fn=denoise_fn, init_params=init_params,
        cond_of=lambda text, mask, pooled=None: (text, mask), convert=convert_params,
    )


def _build_cogvideox(tiny, num_frames, gradient_checkpointing, mixed_precision, seed, device):
    """The cogvideox bundle (`tdm_tpu/train/families.py:274-327`): the 3D
    DiT holding fp32 masters and computing in the config's dtype."""
    mcfg = cog.CogVideoXConfig.tiny() if tiny else cog.CogVideoXConfig()
    if num_frames > 0:
        # pixel frames → latent frames by the causal VAE's 4× temporal factor
        mcfg = dataclasses.replace(mcfg, sample_frames=1 + (num_frames - 1) // 4)
    if gradient_checkpointing:
        mcfg = dataclasses.replace(mcfg, remat=True)
    mcfg = _compute_dtype(mcfg, mixed_precision, tiny)
    torch.manual_seed(seed)
    model = cog.CogVideoXTransformer3D(mcfg, device=device, param_dtype=torch.float32)
    model.requires_grad_(False)

    def init_params():
        return {k: p.detach() for k, p in model.named_parameters()}

    def denoise_fn(params, x, t, cond):
        # the schedule index t, as the pipeline's sampler feeds it
        return functional_call(model, params, (x, t, cond))

    def cond_of(text, mask, pooled=None):
        # no mask reaches the model: the padded T5 rows are zeroed here
        return text * mask.to(text.dtype)[..., None]

    def convert_params(sd):
        tree = convert.cogvideox_params(sd, scan_layers=False)
        from_jax.load_from_jax(convert.flatten(tree), model)
        return init_params()

    return FamilyBundle(
        name="cogvideox", model=model,
        # v-prediction, SNR-shifted, zero terminal SNR; the raw v output is
        # passed through (the step works in the native parameterization)
        schedule=sched.cogvideox(device=device),
        sample_shape=(mcfg.in_channels, mcfg.sample_frames, mcfg.sample_h, mcfg.sample_w),
        seq_len=mcfg.max_text_len, embed_dim=mcfg.text_dim, denoise_fn=denoise_fn,
        init_params=init_params, cond_of=cond_of, convert=convert_params,
    )
