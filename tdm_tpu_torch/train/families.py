"""Model-family registry of the training CLI.

Port of `tdm_tpu/train/families.py` for the pixart family (the reference
demo's one trained family, `src/main.py:168-176`); sd15, sd3 and cogvideox
raise NotImplementedError naming their ROADMAP slice. The bundle carries
what the CLI needs per family: the model, the native training schedule, the
latent sample shape, the text-conditioning sizes, `denoise_fn(params, x, t,
cond)`, the seeded parameter init and `convert`, which loads a diffusers
transformer state dict (the teacher directory) into the model.

`denoise_fn` puts a dict of tensors into the bundle's one module with
`torch.func.functional_call`, so the student, the critic and the teacher
share one architecture object and differ only in their dicts. The module
holds fp32 master weights and computes in the config's dtype (bf16 for the
full-size model under `--mixed_precision bf16`). Every attention call goes
through `ops.attention`: the flash kernels on CUDA, as the JAX training
family pins `attn_impl="pallas"` (`families.py:114-121`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.func import functional_call

from tdm_tpu_torch.core import schedules as sched
from tdm_tpu_torch.io import convert, from_jax
from tdm_tpu_torch.models import pixart

FAMILIES = ("pixart", "sd15", "sd3", "cogvideox")
_NOT_PORTED = {
    "sd3": "slice 3 (SD3)",
    "sd15": "slice 4 (the other image families)",
    "cogvideox": "slice 5 (CogVideoX video)",
}


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
    cond_of: Callable  # (text [B,L,D], mask [B,L]) -> cond
    # diffusers state dict -> the module's own parameters, loaded with its
    # weights (strict: a missing or unknown key raises)
    convert: Callable


def build(
    family: str,
    *,
    tiny: bool = False,
    resolution: int = 512,
    gradient_checkpointing: bool = False,
    mixed_precision: Optional[str] = None,
    moe_experts: int = 0,
    seed: int = 0,
    device=None,
) -> FamilyBundle:
    """The training bundle of `--model_family`, its parameters drawn from
    `seed` on `device` (CUDA unless given). `mixed_precision` maps onto the
    compute dtype as in the JAX package: 'bf16' → bfloat16 (tiny configs
    stay fp32), 'no'/'fp32' → float32, 'fp16' → error, None → the config's
    own."""
    if family not in FAMILIES:
        raise ValueError(f"unknown --model_family {family!r}; choose from {FAMILIES}")
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"training --model_family {family} is not ported yet: ROADMAP.md "
            f"queue 1, {_NOT_PORTED[family]}"
        )
    if moe_experts > 0:
        raise NotImplementedError(
            "a mixture-of-experts PixArt (--moe_experts > 0) is not ported yet: "
            "ROADMAP.md queue 1, slice 6 (models/moe.py)"
        )
    lat = 8 if tiny else max(resolution // 8, 8)
    mcfg = pixart.PixArtConfig.tiny() if tiny else pixart.PixArtConfig()
    if not tiny and lat != mcfg.sample_size:
        mcfg = dataclasses.replace(mcfg, sample_size=lat)
    if gradient_checkpointing:
        mcfg = dataclasses.replace(mcfg, remat=True)
    if mixed_precision == "fp16":
        raise ValueError(
            "--mixed_precision fp16 is not supported — use bf16 (what fp16 "
            "recipes map to) or no/fp32"
        )
    if mixed_precision in ("no", "fp32"):
        mcfg = dataclasses.replace(mcfg, dtype=torch.float32)
    elif mixed_precision == "bf16":
        if not tiny:
            mcfg = dataclasses.replace(mcfg, dtype=torch.bfloat16)
    elif mixed_precision is not None:
        raise ValueError(
            f"unknown --mixed_precision {mixed_precision!r} (choose bf16 / no / fp32)"
        )
    torch.manual_seed(seed)
    model = pixart.PixArtTransformer2D(mcfg, device=device, param_dtype=torch.float32)
    model.requires_grad_(False)  # gradients flow to the dicts denoise_fn is given
    shape = (mcfg.in_channels, mcfg.sample_size, mcfg.sample_size)

    def denoise_fn(params, x, t, cond):
        text, mask = cond
        return pixart.epsilon(functional_call(model, params, (x, t, text, mask)))

    def init_params():
        return {k: p.detach() for k, p in model.named_parameters()}

    def convert_params(sd):
        tree = convert.pixart_params(sd, scan_layers=False)
        with torch.no_grad():
            model.load_state_dict(from_jax.state_dict_from_jax(convert.flatten(tree), model))
        return init_params()

    return FamilyBundle(
        name=family,
        model=model,
        schedule=sched.ddpm_linear(device=device),
        sample_shape=shape,
        seq_len=8 if tiny else 120,
        embed_dim=mcfg.caption_dim,
        denoise_fn=denoise_fn,
        init_params=init_params,
        cond_of=lambda text, mask: (text, mask),
        convert=convert_params,
    )
