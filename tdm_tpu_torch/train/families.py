"""Model-family registry of the training CLI.

Port of `tdm_tpu/train/families.py` for the pixart family (the reference
demo's one trained family, `src/main.py:168-176`) and the sd3 family
(SD3-Medium, the reference's headline TDM LoRA); sd15 and cogvideox raise
NotImplementedError naming their ROADMAP slice. The bundle carries what
the CLI needs per family: the model, the native training schedule, the
latent sample shape, the text-conditioning sizes and `cond_of(text, mask,
pooled=None)`, `denoise_fn(params, x, t, cond)`, the seeded parameter init
and `convert`, which loads a diffusers transformer state dict (the teacher
directory) into the model.

`denoise_fn` puts a dict of tensors into the bundle's one module with
`torch.func.functional_call`, so the student, the critic and the teacher
share one architecture object and differ only in their dicts. The module
holds fp32 master weights and computes in the config's dtype (bf16 for the
full-size model under `--mixed_precision bf16`). Every attention call goes
through `ops.attention`: the flash kernels on CUDA, as the JAX training
family pins `attn_impl="pallas"` for PixArt (`families.py:114-121`) and
keeps `"auto"` for SD3, both the flash route here.

sd3 trains under the shifted rectified-flow schedule (`flow_match`, shift
3) with the velocity output passed through, and conditions on (T5 tokens,
pooled CLIP vector); without a pooled vector it folds a masked-mean
stand-in from the tokens, which a full-size run takes only under
`allow_pooled_standin`. Its `denoise_fn` feeds the MMDiT the flow timestep
σ̂(t)·1000 of the schedule index t, where the JAX family feeds the index
itself (ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.func import functional_call

from tdm_tpu_torch.core import schedules as sched
from tdm_tpu_torch.io import convert, from_jax
from tdm_tpu_torch.models import mmdit_sd3, pixart

FAMILIES = ("pixart", "sd15", "sd3", "cogvideox")
_NOT_PORTED = {
    "sd15": "slice 4 (sd15 TDM training: the UNet's remat and kernels 2 and 3 at head dim 160)",
    "cogvideox": "slice 5 (CogVideoX video)",
}
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
    gradient_checkpointing: bool = False,
    mixed_precision: Optional[str] = None,
    allow_pooled_standin: bool = False,
    moe_experts: int = 0,
    seed: int = 0,
    device=None,
) -> FamilyBundle:
    """The training bundle of `--model_family`, its parameters drawn from
    `seed` on `device` (CUDA unless given). `allow_pooled_standin` lets a
    full-size sd3 run fold the pooled stand-in when a batch carries no
    pooled vectors (tiny runs always may)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown --model_family {family!r}; choose from {FAMILIES}")
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"training --model_family {family} is not ported yet: ROADMAP.md "
            f"queue 1, {_NOT_PORTED[family]}"
        )
    if moe_experts > 0:
        if family != "pixart":
            raise ValueError(f"--moe_experts is a pixart-family extension (got {family!r})")
        raise NotImplementedError(
            "a mixture-of-experts PixArt (--moe_experts > 0) is not ported yet: "
            "ROADMAP.md queue 1, slice 6 (models/moe.py)"
        )
    lat = 8 if tiny else max(resolution // 8, 8)
    if family == "pixart":
        mcfg = pixart.PixArtConfig.tiny() if tiny else pixart.PixArtConfig()
    else:
        mcfg = mmdit_sd3.MMDiTConfig.tiny() if tiny else mmdit_sd3.MMDiTConfig()
    if not tiny and lat != mcfg.sample_size:
        mcfg = dataclasses.replace(mcfg, sample_size=lat)
    if gradient_checkpointing:
        mcfg = dataclasses.replace(mcfg, remat=True)
    mcfg = _compute_dtype(mcfg, mixed_precision, tiny)
    torch.manual_seed(seed)
    shape = (mcfg.in_channels, mcfg.sample_size, mcfg.sample_size)

    def init_params():
        return {k: p.detach() for k, p in model.named_parameters()}

    def converter(to_tree):
        def convert_params(sd):
            tree = to_tree(sd, scan_layers=False)
            with torch.no_grad():
                model.load_state_dict(
                    from_jax.state_dict_from_jax(convert.flatten(tree), model))
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
