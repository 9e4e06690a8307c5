"""`from_pretrained` / `save_pretrained`: pipelines from a directory or a
cached hub repo id.

Port of `tdm_tpu/pipelines/loading.py`, families pixart, sd3, sd15 and
cogvideox, for its two layouts:

1. The tdm_tpu layout (written by `save_pretrained` of either package):

    my_pipe/
      pipeline.json               {"family": "pixart" | "sd3" | "sd15" |
                                   "cogvideox", "model": {...},
                                   "vae": {...}} (config fields)
      transformer.safetensors     denoiser params, flat '/'-joined Flax keys
                                  (SD1.5's UNet too)
      vae_decoder.safetensors     optional TAESD (TAESD3 for sd3) decoder;
                                  for sd15 the KL decoder, for cogvideox
                                  the 3D VAE's decoder

2. A stock diffusers checkout (`model_index.json` with `transformer/`, or
   SD1.5's `unet/`, and `vae/` subfolders): `_class_name` picks the family,
   each subfolder's `config.json` maps onto the port's config, and the
   torch state dicts run through the strict converters of `io/convert.py`.
   The VAE is an `AutoencoderKL` (the KL decoder), an `AutoencoderTiny`
   (TAESD) or, for CogVideoX, an `AutoencoderKLCogVideoX` (the 3D decoder;
   the transformer config's pixel `sample_frames` becomes latent frames).
   `text_encoder*/` subfolders are not loaded (ROADMAP.md queue 1, slice 7).

An `org/name` repo id resolves against the local hub cache first
(`io/hub.resolve_pretrained`). Both layouts reach the modules through the
weight carry (`io/from_jax.py`), so a directory the JAX package's
`save_pretrained` wrote loads unchanged, and one written here loads into the
JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

import torch

from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.io import convert, from_jax, hub, params as params_io
from tdm_tpu_torch.models import (
    cogvideox as cog, layers, mmdit_sd3, pixart, unet_sd15, vae as vae_lib, vae3d,
)
from tdm_tpu_torch.pipelines.cogvideox import CogVideoXPipeline
from tdm_tpu_torch.pipelines.pixart import PixArtPipeline
from tdm_tpu_torch.pipelines.sd15 import SD15Pipeline
from tdm_tpu_torch.pipelines.sd3 import SD3Pipeline

FAMILIES = ("pixart", "sd3", "sd15", "cogvideox")
Pipeline = Union[PixArtPipeline, SD3Pipeline, SD15Pipeline, CogVideoXPipeline]


def _config(cls, conf: dict, default=None):
    """pipeline.json block → config dataclass (dtype names → torch dtypes,
    lists → tuples) over `default` (cls() when None). The JAX package's
    `attn_impl` is checked; a config that has the field keeps it (SD3 and
    SD1.5: 'splash' takes the splash kernel where it applies, the other
    names the flash route), one without it (PixArt, whose attention every
    name routes alike) drops it."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in conf.items()}
    if isinstance(kw.get("dtype"), str):
        kw["dtype"] = getattr(torch, kw["dtype"])
    impl = kw.get("attn_impl", "auto")
    if impl not in layers.ATTN_IMPLS:
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
    revision: Optional[str] = None,
    cache_dir: Optional[str] = None,
    **kwargs,
) -> Pipeline:
    """Assemble the pipeline of a tdm_tpu-layout directory, a diffusers
    checkout or a cached `org/name` repo id on `device` (CUDA unless the
    caller passes 'cpu'). For a diffusers checkout `model_config=` overrides
    fields its config does not carry (e.g. {"dtype": "float32"}); other
    kwargs go to the pipeline."""
    dev = resolve_device(device)
    path = hub.resolve_pretrained(path, revision=revision, cache_dir=cache_dir)
    meta_file = os.path.join(path, "pipeline.json")
    if not os.path.exists(meta_file):
        if os.path.exists(os.path.join(path, "model_index.json")):
            return _from_diffusers(path, dev, **kwargs)
        raise FileNotFoundError(
            f"{path!r} has neither pipeline.json (tdm_tpu layout) nor "
            "model_index.json (diffusers layout)"
        )
    with open(meta_file) as f:
        meta = json.load(f)
    family = meta["family"]
    _check_family(family)
    # a bundled text encoder is not loaded (the encoders are ROADMAP slice
    # 7): the pipeline takes prompt_embeds= and the server an embedding cache
    if family == "sd15":
        return _sd15_from_layout(path, meta, dev, **kwargs)
    if family == "cogvideox":
        return _cogvideox_from_layout(path, meta, dev, **kwargs)
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


def _sd15_from_layout(path: str, meta: dict, dev: torch.device, **kwargs) -> SD15Pipeline:
    """The sd15 branch of layout 1 (`tdm_tpu/pipelines/loading.py:171-180`):
    the UNet from transformer.safetensors and, when there is one, the KL
    decoder from vae_decoder.safetensors."""
    cfg = _config(unet_sd15.UNetConfig, meta.get("model", {}))
    unet = unet_sd15.UNet2DCondition(cfg, device=dev)
    unet.load_state_dict(from_jax.state_dict_from_jax(
        params_io.load_file(os.path.join(path, "transformer.safetensors")), unet))
    vcfg = _config(vae_lib.KLVAEConfig, meta.get("vae", {}))
    vae_file = os.path.join(path, "vae_decoder.safetensors")
    vae = None
    if os.path.exists(vae_file):
        vae = vae_lib.KLDecoder(vcfg, device=dev)
        vae.load_state_dict(from_jax.state_dict_from_jax(params_io.load_file(vae_file), vae))
    return SD15Pipeline(unet, vae_decoder=vae, vae_scaling=vcfg.scaling_factor, device=dev,
                        **kwargs)


def _cogvideox_from_layout(path: str, meta: dict, dev: torch.device,
                           **kwargs) -> CogVideoXPipeline:
    """The cogvideox branch of layout 1 (`tdm_tpu/pipelines/loading.py:
    182-191`): the transformer and, when there is one, the 3D VAE's
    decoder."""
    cfg = _config(cog.CogVideoXConfig, meta.get("model", {}))
    transformer = cog.CogVideoXTransformer3D(cfg, device=dev)
    transformer.load_state_dict(from_jax.state_dict_from_jax(
        params_io.load_file(os.path.join(path, "transformer.safetensors")), transformer))
    vcfg = _config(vae3d.VAE3DConfig, meta.get("vae", {}))
    vae_file = os.path.join(path, "vae_decoder.safetensors")
    vae = None
    if os.path.exists(vae_file):
        vae = vae3d.VAE3DDecoder(vcfg, device=dev)
        vae.load_state_dict(from_jax.state_dict_from_jax(params_io.load_file(vae_file), vae))
    return CogVideoXPipeline(transformer, vae_decoder=vae, vae_cfg=vcfg, device=dev, **kwargs)


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")


def save_pretrained(path: str, pipe: Pipeline) -> None:
    """Write `pipe` as a tdm_tpu-layout directory (fp32 weights in the JAX
    package's tree, stacked or unrolled per the config's scan_layers). As
    in the JAX package, the pristine base weights are written: adapter
    merges are runtime state (load the LoRA file again after loading).
    Layout 1 holds a pixart/sd3 VAE as TAESD only, so such a pipeline with
    a KL decoder is refused; an sd15 one holds its KL decoder."""
    if pipe.family != "sd15" and isinstance(pipe.vae_decoder, vae_lib.KLDecoder):
        raise ValueError(
            "save_pretrained: the tdm_tpu layout stores pixart/sd3 VAEs as "
            "TAESD only (both packages' loaders rebuild vae_decoder.safetensors "
            "as a TAESDDecoder), so a pipeline decoding with a KLDecoder cannot "
            "be written; keep the diffusers checkout it came from, or give the "
            "pipeline a TAESD decoder"
        )
    os.makedirs(path, exist_ok=True)
    model = pipe.denoiser
    cfg = model.cfg
    meta = {"family": pipe.family, "model": _config_dict(cfg), "vae": {}}
    if pipe.vae_decoder is not None:
        meta["vae"] = _config_dict(pipe.vae_decoder.cfg)
    elif getattr(pipe, "vae_cfg", None) is not None:  # cogvideox's latent geometry
        meta["vae"] = _config_dict(pipe.vae_cfg)
    with open(os.path.join(path, "pipeline.json"), "w") as f:
        json.dump(meta, f, indent=1)
    params_io.save_file(
        from_jax.jax_layout({**model.state_dict(), **pipe._base},
                            stacks=from_jax.layer_stacks(cfg)),
        os.path.join(path, "transformer.safetensors"),
    )
    if pipe.vae_decoder is not None:
        params_io.save_file(
            from_jax.jax_layout(pipe.vae_decoder.state_dict()),
            os.path.join(path, "vae_decoder.safetensors"),
        )


# ---------------------------------------------------------------------------
# the diffusers checkout layout (model_index.json + subfolders)
# ---------------------------------------------------------------------------

# ordered: 'StableDiffusion3*' must match before 'StableDiffusion*'
_DIFFUSERS_FAMILIES = (
    ("StableDiffusion3", "sd3"),
    ("PixArt", "pixart"),
    ("CogVideoX", "cogvideox"),
    ("StableDiffusion", "sd15"),
    ("LatentConsistency", "sd15"),  # Dreamshaper-LCM style SD1.5 derivative
)


def _family_from_class(class_name: str) -> str:
    for prefix, family in _DIFFUSERS_FAMILIES:
        if class_name.startswith(prefix):
            return family
    raise ValueError(
        f"unsupported diffusers pipeline class {class_name!r} "
        f"(supported families: {FAMILIES})"
    )


def _subconfig(path: str, subfolder: str) -> dict:
    with open(os.path.join(path, subfolder, "config.json")) as f:
        return json.load(f)


def _mapped(hf: dict, mapping: dict[str, str]) -> dict:
    """The keys of a diffusers config that the port's config has, renamed;
    absent keys keep the port's defaults."""
    return {ours: hf[theirs] for theirs, ours in mapping.items() if theirs in hf}


def _pixart_config(hf: dict) -> pixart.PixArtConfig:
    kw = _mapped(hf, {
        "sample_size": "sample_size", "patch_size": "patch_size",
        "in_channels": "in_channels", "out_channels": "out_channels",
        "num_layers": "num_layers", "num_attention_heads": "num_heads",
        "attention_head_dim": "head_dim", "caption_channels": "caption_dim",
    })
    return dataclasses.replace(pixart.PixArtConfig(), **kw)


def _sd3_config(hf: dict) -> mmdit_sd3.MMDiTConfig:
    kw = _mapped(hf, {
        "sample_size": "sample_size", "patch_size": "patch_size",
        "in_channels": "in_channels", "out_channels": "out_channels",
        "num_layers": "num_layers", "num_attention_heads": "num_heads",
        "attention_head_dim": "head_dim",
        "joint_attention_dim": "context_dim",
        "pooled_projection_dim": "pooled_dim",
        "pos_embed_max_size": "pos_embed_max_size",
    })
    if hf.get("qk_norm") == "rms_norm":
        kw["qk_norm"] = "rms"
    if hf.get("dual_attention_layers"):
        kw["dual_attention_layers"] = tuple(hf["dual_attention_layers"])
    return dataclasses.replace(mmdit_sd3.MMDiTConfig(), **kw)


def _unet_config(hf: dict) -> unet_sd15.UNetConfig:
    kw = _mapped(hf, {
        "in_channels": "in_channels", "out_channels": "out_channels",
        "layers_per_block": "layers_per_block",
        "cross_attention_dim": "context_dim", "norm_num_groups": "norm_groups",
    })
    if "block_out_channels" in hf:
        kw["block_widths"] = tuple(hf["block_out_channels"])
    # SD1.5's int `attention_head_dim: 8` is the HEAD COUNT (diffusers' UNet
    # reads the int form as heads)
    heads = hf.get("attention_head_dim")
    if isinstance(heads, int):
        kw["num_heads"] = heads
    return dataclasses.replace(unet_sd15.UNetConfig(), **kw)


def _cogvideox_config(hf: dict) -> cog.CogVideoXConfig:
    kw = _mapped(hf, {
        "in_channels": "in_channels", "out_channels": "out_channels",
        "patch_size": "patch_size", "num_layers": "num_layers",
        "num_attention_heads": "num_heads", "attention_head_dim": "head_dim",
        "text_embed_dim": "text_dim", "time_embed_dim": "time_embed_dim",
        "max_text_seq_length": "max_text_len",
        "sample_height": "sample_h", "sample_width": "sample_w",
        "use_rotary_positional_embeddings": "use_rotary",
    })
    if "sample_frames" in hf:  # diffusers counts pixel frames, the config latent ones
        kw["sample_frames"] = (hf["sample_frames"] - 1) // hf.get(
            "temporal_compression_ratio", 4) + 1
    return dataclasses.replace(cog.CogVideoXConfig(), **kw)


def _load(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """A converter's tree into `module` through the weight carry."""
    module.load_state_dict(from_jax.state_dict_from_jax(convert.flatten(tree), module))
    return module


def _load_diffusers_vae(path: str, dev: torch.device):
    """vae/ subfolder → (decoder module or None, pipeline kwargs): an
    `AutoencoderKL` as the KL decoder (value range 'pm1'), an
    `AutoencoderTiny` as TAESD ('unit'), an `AutoencoderKLCogVideoX` as the
    3D decoder (its config as `vae_cfg`); none when the subfolder is absent
    or its class is another."""
    if not os.path.exists(os.path.join(path, "vae", "config.json")):
        return None, {}
    hf = _subconfig(path, "vae")
    cls = hf.get("_class_name", "")
    if cls not in ("AutoencoderTiny", "AutoencoderKL", "AutoencoderKLCogVideoX"):
        return None, {}
    sd = convert.load_torch_state_dict(os.path.join(path, "vae"))
    if cls == "AutoencoderKLCogVideoX":
        kw = _mapped(hf, {
            "latent_channels": "latent_channels", "layers_per_block": "layers_per_block",
            "norm_num_groups": "norm_groups", "scaling_factor": "scaling_factor",
            "temporal_compression_ratio": "temporal_factor",
        })
        if "block_out_channels" in hf:
            kw["block_widths"] = tuple(hf["block_out_channels"])
        vcfg = dataclasses.replace(vae3d.VAE3DConfig(), **kw)
        tree = convert.vae3d_decoder_params(sd, layers_per_block=vcfg.layers_per_block,
                                            n_stages=len(vcfg.block_widths))
        return _load(vae3d.VAE3DDecoder(vcfg, device=dev), tree), {"vae_cfg": vcfg}
    kw = _mapped(hf, {
        "latent_channels": "latent_channels",
        "scaling_factor": "scaling_factor",
        "shift_factor": "shift_factor",
    })
    if kw.get("shift_factor") is None:
        kw.pop("shift_factor", None)
    if cls == "AutoencoderTiny":
        # the stage topology from AutoencoderTiny's fields: num_decoder_blocks
        # [3, 3, 3, 1] = 3 upsampling stages of 3 blocks + the last block
        if hf.get("decoder_block_out_channels"):
            kw["width"] = hf["decoder_block_out_channels"][0]
        if hf.get("num_decoder_blocks"):
            nb = hf["num_decoder_blocks"]
            kw["num_stages"] = len(nb) - 1
            kw["blocks_per_stage"] = nb[0]
        vcfg = dataclasses.replace(vae_lib.TAESDConfig(), **kw)
        tree = convert.taesd_params(sd, num_stages=vcfg.num_stages,
                                    blocks_per_stage=vcfg.blocks_per_stage)["decoder"]
        dec = _load(vae_lib.TAESDDecoder(vcfg, device=dev), tree)
        return dec, {"vae_scaling": vcfg.scaling_factor, "vae_range": "unit"}
    kw.update(_mapped(hf, {"layers_per_block": "layers_per_block",
                           "norm_num_groups": "norm_groups"}))
    if "block_out_channels" in hf:
        kw["block_widths"] = tuple(hf["block_out_channels"])
    vcfg = dataclasses.replace(vae_lib.KLVAEConfig(), **kw)
    tree = convert.klvae_params(sd, layers_per_block=vcfg.layers_per_block,
                                n_stages=len(vcfg.block_widths))["decoder"]
    dec = _load(vae_lib.KLDecoder(vcfg, device=dev), tree)
    return dec, {"vae_scaling": vcfg.scaling_factor, "vae_range": "pm1"}


def _from_diffusers(path: str, dev: torch.device, model_config: Optional[dict] = None,
                    **kwargs):
    """A pipeline from a diffusers checkout: config.json → the port's
    config (`model_config` overrides, in pipeline.json's 'model' form),
    the torch safetensors → the strict converters → the modules. The
    transformer's tree is converted unrolled (scan_layers=False), which the
    carry takes as it is."""
    with open(os.path.join(path, "model_index.json")) as f:
        index = json.load(f)
    family = _family_from_class(index.get("_class_name", ""))
    _check_family(family)
    sub = "unet" if family == "sd15" else "transformer"
    hf = _subconfig(path, sub)
    sd = convert.load_torch_state_dict(os.path.join(path, sub))
    vae, vae_kw = _load_diffusers_vae(path, dev)
    vae_kw.update(kwargs)  # explicit kwargs win over derived settings
    if family == "cogvideox":
        cfg = _config(cog.CogVideoXConfig, model_config or {}, _cogvideox_config(hf))
        transformer = _load(cog.CogVideoXTransformer3D(cfg, device=dev),
                            convert.cogvideox_params(sd, scan_layers=False))
        return CogVideoXPipeline(transformer, vae_decoder=vae, device=dev, **vae_kw)
    if family == "sd15":
        cfg = _config(unet_sd15.UNetConfig, model_config or {}, _unet_config(hf))
        unet = _load(unet_sd15.UNet2DCondition(cfg, device=dev), convert.unet_sd15_params(
            sd, layers_per_block=cfg.layers_per_block, n_stages=len(cfg.block_widths)))
        return SD15Pipeline(unet, vae_decoder=vae, device=dev, **vae_kw)
    if family == "pixart":
        cfg = _config(pixart.PixArtConfig, model_config or {}, _pixart_config(hf))
        transformer = _load(pixart.PixArtTransformer2D(cfg, device=dev),
                            convert.pixart_params(sd, scan_layers=False))
        return PixArtPipeline(transformer, vae_decoder=vae, device=dev, **vae_kw)
    cfg = _config(mmdit_sd3.MMDiTConfig, model_config or {}, _sd3_config(hf))
    transformer = _load(mmdit_sd3.SD3Transformer2D(cfg, device=dev),
                        convert.sd3_params(sd, scan_layers=False))
    vae_kw.setdefault("vae_shift", vae.cfg.shift_factor if vae is not None else 0.0)
    return SD3Pipeline(transformer, vae_decoder=vae, device=dev, **vae_kw)
