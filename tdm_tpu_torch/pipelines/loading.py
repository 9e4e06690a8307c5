"""`from_pretrained` / `save_pretrained` for the tdm_tpu pipeline layout.

Port of `tdm_tpu/pipelines/loading.py` layout 1, families pixart and sd3:

    my_pipe/
      pipeline.json               {"family": "pixart" | "sd3",
                                   "model": {...}, "vae": {...}}
                                   (config fields)
      transformer.safetensors     denoiser params, flat '/'-joined Flax keys
      vae_decoder.safetensors     optional TAESD (TAESD3 for sd3) decoder

Both directions go through the weight carry (`io/from_jax.py`), so a
directory the JAX package's `save_pretrained` wrote loads unchanged, and one
written here loads into the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

import torch

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.io import from_jax, params as params_io
from tdm_tpu_torch.models import mmdit_sd3, pixart, vae as vae_lib
from tdm_tpu_torch.pipelines.pixart import PixArtPipeline
from tdm_tpu_torch.pipelines.sd3 import SD3Pipeline

FAMILIES = ("pixart", "sd3")
_NOT_PORTED = {
    "sd15": "slice 4 (the other image families)",
    "cogvideox": "slice 5 (CogVideoX video)",
}


def _config(cls, conf: dict, default=None):
    """pipeline.json block → config dataclass (dtype names → torch dtypes,
    lists → tuples) over `default` (cls() when None). The JAX package's
    `attn_impl` is checked; a config that has the field keeps it (SD3:
    'splash' takes the splash kernel, the other names the flash route), one
    without it (PixArt, whose attention every name routes alike) drops it."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in conf.items()}
    if isinstance(kw.get("dtype"), str):
        kw["dtype"] = getattr(torch, kw["dtype"])
    impl = kw.get("attn_impl", "auto")
    if impl not in mmdit_sd3.ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r} in pipeline.json")
    if not any(f.name == "attn_impl" for f in dataclasses.fields(cls)):
        kw.pop("attn_impl", None)
    return dataclasses.replace(default if default is not None else cls(), **kw)


def _config_dict(cfg) -> dict:
    """Config dataclass → the JSON block the JAX package reads (dtype as its
    name)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = str(v).removeprefix("torch.")
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out


def from_pretrained(
    path: str,
    *,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs,
) -> Union[PixArtPipeline, SD3Pipeline]:
    """Assemble the pipeline of a tdm_tpu-layout directory on `device`
    (CUDA unless the caller passes 'cpu'). Extra kwargs go to the pipeline."""
    dev = resolve_device(device)
    meta_file = os.path.join(path, "pipeline.json")
    if not os.path.exists(meta_file):
        raise FileNotFoundError(
            f"{path!r} has no pipeline.json (the tdm_tpu layout); diffusers "
            "checkpoints are not ported yet: ROADMAP.md queue 1, slice 3 (its "
            "remainder: diffusers checkpoints and the KL VAE)"
        )
    with open(meta_file) as f:
        meta = json.load(f)
    family = meta["family"]
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {family!r} is not ported yet: ROADMAP.md queue 1, "
            f"{_NOT_PORTED[family]}"
        )
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    # a bundled text encoder is not loaded (the encoders are ROADMAP slice
    # 7): the pipeline takes prompt_embeds= and the server an embedding cache
    if family == "sd3":
        cfg = _config(mmdit_sd3.MMDiTConfig, meta.get("model", {}))
        transformer = mmdit_sd3.SD3Transformer2D(cfg, device=dev)
        vcfg = _config(vae_lib.TAESDConfig, meta.get("vae", {}), vae_lib.TAESDConfig.taesd3())
    else:
        cfg = _config(pixart.PixArtConfig, meta.get("model", {}))
        transformer = pixart.PixArtTransformer2D(cfg, device=dev)
        vcfg = _config(vae_lib.TAESDConfig, meta.get("vae", {}))
    transformer.load_state_dict(from_jax.state_dict_from_jax(
        params_io.load_file(os.path.join(path, "transformer.safetensors")),
        transformer,
    ))
    vae_file = os.path.join(path, "vae_decoder.safetensors")
    vae = None
    if os.path.exists(vae_file):
        vae = vae_lib.TAESDDecoder(vcfg, device=dev)
        vae.load_state_dict(
            from_jax.state_dict_from_jax(params_io.load_file(vae_file), vae)
        )
    if family == "sd3":
        return SD3Pipeline(
            transformer, vae_decoder=vae, vae_scaling=vcfg.scaling_factor,
            vae_shift=vcfg.shift_factor, device=dev, **kwargs,
        )
    return PixArtPipeline(
        transformer, vae_decoder=vae, vae_scaling=vcfg.scaling_factor,
        device=dev, **kwargs,
    )


def save_pretrained(path: str, pipe: Union[PixArtPipeline, SD3Pipeline]) -> None:
    """Write `pipe` as a tdm_tpu-layout directory (fp32 weights in the JAX
    package's tree, stacked or unrolled per the config's scan_layers). As
    in the JAX package, the pristine base weights are written: adapter
    merges are runtime state (load the LoRA file again after loading)."""
    os.makedirs(path, exist_ok=True)
    cfg = pipe.transformer.cfg
    meta = {"family": pipe.family, "model": _config_dict(cfg), "vae": {}}
    if pipe.vae_decoder is not None:
        meta["vae"] = _config_dict(pipe.vae_decoder.cfg)
    with open(os.path.join(path, "pipeline.json"), "w") as f:
        json.dump(meta, f, indent=1)
    params_io.save_file(
        from_jax.jax_layout({**pipe.transformer.state_dict(), **pipe._base},
                            stacks=from_jax.layer_stacks(cfg)),
        os.path.join(path, "transformer.safetensors"),
    )
    if pipe.vae_decoder is not None:
        params_io.save_file(
            from_jax.jax_layout(pipe.vae_decoder.state_dict()),
            os.path.join(path, "vae_decoder.safetensors"),
        )
