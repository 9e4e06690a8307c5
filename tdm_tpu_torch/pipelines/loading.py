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
      text_encoder.safetensors    optional T5 (pixart, cogvideox) or CLIP
                                  (sd15) encoder, described by
                                  pipeline.json's "text_encoder" block:
                                  {"family": "t5" | "clip", "config": {...},
                                   "tokenizer": {"kind": "hf"} | {"kind":
                                   "hash", "vocab_size": N, "eos_id": E}}
      tokenizer/                  optional HF tokenizer folder ("kind": "hf")

2. A stock diffusers checkout (`model_index.json` with `transformer/`, or
   SD1.5's `unet/`, and `vae/` subfolders): `_class_name` picks the family,
   each subfolder's `config.json` maps onto the port's config, and the
   torch state dicts run through the strict converters of `io/convert.py`.
   The VAE is an `AutoencoderKL` (the KL decoder), an `AutoencoderTiny`
   (TAESD) or, for CogVideoX, an `AutoencoderKLCogVideoX` (the 3D decoder;
   the transformer config's pixel `sample_frames` becomes latent frames).
   `text_encoder/` (T5 for pixart and cogvideox, CLIP-L for sd15; SD3's
   `text_encoder`, `_2`, `_3`: CLIP-L, CLIP-G, T5) convert through the
   strict `t5_encoder_params` / `clip_text_params`, and `tokenizer*/`
   folders load as `HFTokenizer`s (which need `transformers`) unless the
   caller passes `tokenizer=` / `tokenizers=`.

An `org/name` repo id resolves against the local hub cache first
(`io/hub.resolve_pretrained`). Both layouts reach the modules through the
weight carry (`io/from_jax.py`), so a directory the JAX package's
`save_pretrained` wrote loads unchanged, and one written here loads into the
JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Optional, Union

import torch

from tdm_tpu_torch.data.tokenizer import HashTokenizer, HFTokenizer
from tdm_tpu_torch.device import resolve_device
from tdm_tpu_torch.io import convert, from_jax, hub, params as params_io
from tdm_tpu_torch.models import (
    clip as clip_lib, cogvideox as cog, layers, mmdit_sd3, pixart, t5 as t5_lib, unet_sd15,
    vae as vae_lib, vae3d,
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
    names the flash route), one without it (PixArt and the text encoders,
    whose attention every name routes alike) drops it."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in conf.items()}
    if isinstance(kw.get("dtype"), str):
        kw["dtype"] = getattr(torch, kw["dtype"])
    impl = kw.get("attn_impl", "auto")
    if impl not in layers.ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r} in pipeline.json")
    if not any(f.name == "attn_impl" for f in dataclasses.fields(cls)):
        kw.pop("attn_impl", None)
    return dataclasses.replace(default if default is not None else cls(), **kw)


def config_dict(cfg) -> dict:
    """Model/VAE config dataclass → the JSON-safe dict the JAX package's
    `config_dict` gives and its loader reads (the dtype as its name, e.g.
    'bfloat16'; tuples as lists)."""
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
    denoiser_only: bool = False,
    **kwargs,
) -> Pipeline:
    """Assemble the pipeline of a tdm_tpu-layout directory, a diffusers
    checkout or a cached `org/name` repo id on `device` (CUDA unless the
    caller passes 'cpu'). For a diffusers checkout `model_config=` overrides
    fields its config does not carry (e.g. {"dtype": "float32"}); other
    kwargs go to the pipeline. `denoiser_only` loads neither text encoders
    nor a VAE (a tensor-parallel follower's pipeline)."""
    dev = resolve_device(device)
    path = hub.resolve_pretrained(path, revision=revision, cache_dir=cache_dir)
    meta_file = os.path.join(path, "pipeline.json")
    if not os.path.exists(meta_file):
        if os.path.exists(os.path.join(path, "model_index.json")):
            return _from_diffusers(path, dev, denoiser_only=denoiser_only, **kwargs)
        raise FileNotFoundError(
            f"{path!r} has neither pipeline.json (tdm_tpu layout) nor "
            "model_index.json (diffusers layout)"
        )
    with open(meta_file) as f:
        meta = json.load(f)
    family = meta["family"]
    _check_family(family)
    if not denoiser_only:
        kwargs = {**_load_bundled_text_encoder(path, meta, family, dev, kwargs), **kwargs}
    vae_file = os.path.join(path, "vae_decoder.safetensors")
    load_vae = os.path.exists(vae_file) and not denoiser_only
    if family == "sd15":
        return _sd15_from_layout(path, meta, dev, load_vae, **kwargs)
    if family == "cogvideox":
        return _cogvideox_from_layout(path, meta, dev, load_vae, **kwargs)
    if family == "sd3":
        cfg = _config(mmdit_sd3.MMDiTConfig, meta.get("model", {}))
        transformer = mmdit_sd3.SD3Transformer2D(cfg, device=dev)
        vcfg = _config(vae_lib.TAESDConfig, meta.get("vae", {}), vae_lib.TAESDConfig.taesd3())
    else:
        cfg = _config(pixart.PixArtConfig, meta.get("model", {}))
        transformer = pixart.PixArtTransformer2D(cfg, device=dev)
        vcfg = _config(vae_lib.TAESDConfig, meta.get("vae", {}))
    from_jax.load_from_jax(
        params_io.load_file(os.path.join(path, "transformer.safetensors")), transformer)
    vae = None
    if load_vae:
        vae = vae_lib.TAESDDecoder(vcfg, device=dev)
        from_jax.load_from_jax(params_io.load_file(vae_file), vae)
    if family == "sd3":
        return SD3Pipeline(
            transformer, vae_decoder=vae, vae_scaling=vcfg.scaling_factor,
            vae_shift=vcfg.shift_factor, device=dev, **kwargs,
        )
    return PixArtPipeline(
        transformer, vae_decoder=vae, vae_scaling=vcfg.scaling_factor,
        device=dev, **kwargs,
    )


def _sd15_from_layout(path: str, meta: dict, dev: torch.device, load_vae: bool,
                      **kwargs) -> SD15Pipeline:
    """The sd15 branch of layout 1 (`tdm_tpu/pipelines/loading.py:171-180`):
    the UNet from transformer.safetensors and, with `load_vae`, the KL
    decoder from vae_decoder.safetensors."""
    cfg = _config(unet_sd15.UNetConfig, meta.get("model", {}))
    unet = unet_sd15.UNet2DCondition(cfg, device=dev)
    from_jax.load_from_jax(
        params_io.load_file(os.path.join(path, "transformer.safetensors")), unet)
    vcfg = _config(vae_lib.KLVAEConfig, meta.get("vae", {}))
    vae_file = os.path.join(path, "vae_decoder.safetensors")
    vae = None
    if load_vae:
        vae = vae_lib.KLDecoder(vcfg, device=dev)
        from_jax.load_from_jax(params_io.load_file(vae_file), vae)
    return SD15Pipeline(unet, vae_decoder=vae, vae_scaling=vcfg.scaling_factor, device=dev,
                        **kwargs)


def _cogvideox_from_layout(path: str, meta: dict, dev: torch.device, load_vae: bool,
                           **kwargs) -> CogVideoXPipeline:
    """The cogvideox branch of layout 1 (`tdm_tpu/pipelines/loading.py:
    182-191`): the transformer and, with `load_vae`, the 3D VAE's
    decoder."""
    cfg = _config(cog.CogVideoXConfig, meta.get("model", {}))
    transformer = cog.CogVideoXTransformer3D(cfg, device=dev)
    from_jax.load_from_jax(
        params_io.load_file(os.path.join(path, "transformer.safetensors")), transformer)
    vcfg = _config(vae3d.VAE3DConfig, meta.get("vae", {}))
    vae_file = os.path.join(path, "vae_decoder.safetensors")
    vae = None
    if load_vae:
        vae = vae3d.VAE3DDecoder(vcfg, device=dev)
        from_jax.load_from_jax(params_io.load_file(vae_file), vae)
    return CogVideoXPipeline(transformer, vae_decoder=vae, vae_cfg=vcfg, device=dev, **kwargs)


def _load_bundled_text_encoder(path: str, meta: dict, family: str, dev: torch.device,
                               given: dict) -> dict:
    """A bundled encoder (pipeline.json's "text_encoder" block,
    text_encoder.safetensors and tokenizer/) → the pipeline kwargs
    {text_encoder, tokenizer}; {} without one. SD3's triple stack is not
    bundled this way (as in the JAX package): its pipeline takes
    `text_encoders=` or precomputed embeddings. A tokenizer the caller
    passes is not loaded from the bundle."""
    spec = meta.get("text_encoder")
    enc_file = os.path.join(path, "text_encoder.safetensors")
    if not spec or not os.path.exists(enc_file) or family == "sd3":
        return {}
    enc_family = spec.get("family", "t5")
    if enc_family == "t5":
        encoder = t5_lib.T5Encoder(_config(t5_lib.T5Config, spec.get("config", {})),
                                   device=dev)
    elif enc_family == "clip":
        encoder = clip_lib.CLIPTextEncoder(
            _config(clip_lib.CLIPTextConfig, spec.get("config", {})), device=dev)
    else:
        raise ValueError(f"unknown text-encoder family {enc_family!r}")
    from_jax.load_from_jax(params_io.load_file(enc_file), encoder)
    out = {"text_encoder": encoder}
    if "tokenizer" not in given:
        tok_spec = spec.get("tokenizer", {"kind": "hf"})
        tok_dir = os.path.join(path, "tokenizer")
        if tok_spec.get("kind") == "hash":
            out["tokenizer"] = HashTokenizer(vocab_size=tok_spec.get("vocab_size", 30000),
                                             eos_id=tok_spec.get("eos_id"))
        elif os.path.isdir(tok_dir):
            out["tokenizer"] = HFTokenizer(tok_dir)
    return out


def _tokenizer_spec(tokenizer) -> Optional[dict]:
    """pipeline.json's tokenizer block for a pipeline's tokenizer: a
    HashTokenizer's vocabulary, or "hf" for an HFTokenizer of a local
    folder. Any other tokenizer cannot be bundled: as the JAX package, warn
    now (the reloaded pipeline has no tokenizer) and write none."""
    if tokenizer is None:
        return None
    if isinstance(tokenizer, HashTokenizer):
        return {"kind": "hash", "vocab_size": tokenizer.vocab_size, "eos_id": tokenizer.eos_id}
    if isinstance(tokenizer, HFTokenizer) and os.path.isdir(tokenizer.path):
        return {"kind": "hf"}
    logging.getLogger(__name__).warning(
        "save_pretrained: tokenizer %r cannot be bundled (not a local-dir "
        "HFTokenizer or HashTokenizer); the reloaded pipeline will have "
        "tokenizer=None — reattach one before passing raw prompts", tokenizer)
    return None


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")


def save_pretrained(path: str, pipe: Pipeline) -> None:
    """Write `pipe` as a tdm_tpu-layout directory (fp32 weights in the JAX
    package's tree, stacked or unrolled per the config's scan_layers). As
    in the JAX package, the pristine base weights are written: adapter
    merges are runtime state (load the LoRA file again after loading).
    Layout 1 holds a pixart/sd3 VAE as TAESD only, so such a pipeline with
    a KL decoder is refused; an sd15 one holds its KL decoder. A pixart,
    sd15 or cogvideox pipeline's text encoder is written as
    text_encoder.safetensors (fp32, the JAX tree) with its config and its
    tokenizer's kind (an HFTokenizer's folder copied to tokenizer/); SD3's
    triple stack has no place in the layout and is not written, as in the
    JAX package."""
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
    meta = {"family": pipe.family, "model": config_dict(cfg), "vae": {}}
    if pipe.vae_decoder is not None:
        meta["vae"] = config_dict(pipe.vae_decoder.cfg)
    elif getattr(pipe, "vae_cfg", None) is not None:  # cogvideox's latent geometry
        meta["vae"] = config_dict(pipe.vae_cfg)
    encoder = getattr(pipe, "text_encoder", None)
    tokenizer = getattr(pipe, "tokenizer", None)
    if encoder is not None:
        meta["text_encoder"] = {
            "family": "t5" if isinstance(encoder, t5_lib.T5Encoder) else "clip",
            "config": config_dict(encoder.cfg)}
        tok_spec = _tokenizer_spec(tokenizer)
        if tok_spec is not None:
            meta["text_encoder"]["tokenizer"] = tok_spec
    else:
        tok_spec = None
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
    if encoder is not None:
        params_io.save_file(from_jax.jax_layout(encoder.state_dict()),
                            os.path.join(path, "text_encoder.safetensors"))
        if tok_spec == {"kind": "hf"}:
            dst = os.path.join(path, "tokenizer")
            if os.path.abspath(tokenizer.path) != os.path.abspath(dst):
                shutil.copytree(tokenizer.path, dst, dirs_exist_ok=True)


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
    return from_jax.load_from_jax(convert.flatten(tree), module)


def _t5_config_from_hf(hf: dict, common: dict) -> t5_lib.T5Config:
    kw = _mapped(hf, {
        "vocab_size": "vocab_size", "d_model": "d_model", "d_kv": "d_kv",
        "num_heads": "num_heads", "d_ff": "d_ff", "num_layers": "num_layers",
        "relative_attention_num_buckets": "rel_buckets",
        "relative_attention_max_distance": "rel_max_distance",
    })
    return _config(t5_lib.T5Config, common, t5_lib.T5Config(**kw))


def _clip_config_from_hf(hf: dict, common: dict) -> clip_lib.CLIPTextConfig:
    kw = _mapped(hf, {
        "vocab_size": "vocab_size", "hidden_size": "hidden",
        "num_attention_heads": "num_heads", "num_hidden_layers": "num_layers",
        "max_position_embeddings": "max_positions",
        "eos_token_id": "eos_token_id", "hidden_act": "activation",
    })
    if "intermediate_size" in hf and "hidden_size" in hf:
        kw["mlp_ratio"] = hf["intermediate_size"] // hf["hidden_size"]
    # the projection exists only on the WithProjection variant (SD3's pooled
    # path); a plain CLIPTextModel (SD1.5) pools the final state
    if any("WithProjection" in a for a in hf.get("architectures") or []):
        kw["projection_dim"] = hf.get("projection_dim")
    return _config(clip_lib.CLIPTextConfig, common, clip_lib.CLIPTextConfig(**kw))


def _load_diffusers_text_encoders(path: str, family: str, common: dict, dev: torch.device,
                                  given: dict) -> dict:
    """text_encoder*/ and tokenizer*/ subfolders → the pipeline's
    conditioning kwargs. A missing encoder folder is skipped (the
    prompt_embeds path always works; SD3 takes its stack only whole); a
    present one converts strictly. `common` carries the dtype/attn_impl
    overrides of `model_config` to the encoder configs. A tokenizer folder
    loads as an HFTokenizer unless the caller passes `tokenizer=` (SD3:
    `tokenizers=`)."""

    def load_one(sub: str, kind: str):
        if not os.path.exists(os.path.join(path, sub, "config.json")):
            return None
        hf = _subconfig(path, sub)
        sd = convert.load_torch_state_dict(os.path.join(path, sub))
        if kind == "t5":
            model = t5_lib.T5Encoder(_t5_config_from_hf(hf, common), device=dev)
            tree = convert.t5_encoder_params(sd)
        else:
            model = clip_lib.CLIPTextEncoder(_clip_config_from_hf(hf, common), device=dev)
            tree = convert.clip_text_params(sd)
        return from_jax.load_from_jax(convert.flatten(tree), model)

    def load_tok(sub: str):
        d = os.path.join(path, sub)
        return HFTokenizer(d) if os.path.isdir(d) else None

    if family == "sd3":  # CLIP-L, CLIP-G (penultimate + pooled), T5
        encoders = {"clip_l": load_one("text_encoder", "clip"),
                    "clip_g": load_one("text_encoder_2", "clip"),
                    "t5": load_one("text_encoder_3", "t5")}
        if any(v is None for v in encoders.values()):
            return {}
        kw = {"text_encoders": encoders}
        if "tokenizers" not in given:
            toks = {"clip_l": load_tok("tokenizer"), "clip_g": load_tok("tokenizer_2"),
                    "t5": load_tok("tokenizer_3")}
            if all(v is not None for v in toks.values()):
                kw["tokenizers"] = toks
        return kw
    encoder = load_one("text_encoder", "clip" if family == "sd15" else "t5")
    if encoder is None:
        return {}
    kw = {"text_encoder": encoder}
    tok = None if "tokenizer" in given else load_tok("tokenizer")
    if tok is not None:
        kw["tokenizer"] = tok
    return kw


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
                    denoiser_only: bool = False, **kwargs):
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
    vae, vae_kw = (None, {}) if denoiser_only else _load_diffusers_vae(path, dev)
    common = {k: v for k, v in (model_config or {}).items() if k in ("dtype", "attn_impl")}
    if not denoiser_only:
        vae_kw.update(_load_diffusers_text_encoders(path, family, common, dev, kwargs))
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
