"""Checkpoint key/shape manifests: the diffusers key surface of each family.

Port of `tdm_tpu/io/manifest.py` for the families the port converts
(pixart, sd3, unet_sd15, klvae, cogvideox, vae3d_decoder, taesd, taesd3),
built on the port's own configs. The
inventory of a family is generated from its model config and lists exactly
the {torch key: shape} its converter in `io/convert.py` reads, so:
  * a checkpoint is checked from its safetensors header alone
    (`read_safetensors_manifest`, `check_manifest`);
  * a synthetic checkpoint with the real key surface is made from a seed
    (`synthetic_state_dict`, or `write_synthetic` one leaf at a time for a
    full-width file), which is how the tests and `chip_smoke.py` build
    diffusers checkouts without released weights.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator, Optional

import numpy as np

from tdm_tpu_torch.io import params as params_io

__all__ = [
    "expected_manifest",
    "read_safetensors_manifest",
    "check_manifest",
    "save_manifest",
    "load_manifest",
    "synthetic_state_dict",
    "write_synthetic",
    "MANIFEST_FAMILIES",
]


class _Shapes(dict):
    """{torch key: shape tuple}, filled with the common HF layer idioms."""

    def lin(self, name: str, din: int, dout: int, bias: bool = True) -> None:
        self[f"{name}.weight"] = (dout, din)
        if bias:
            self[f"{name}.bias"] = (dout,)

    def conv(self, name: str, cin: int, cout: int, k: int = 3, bias: bool = True) -> None:
        self[f"{name}.weight"] = (cout, cin, k, k)
        if bias:
            self[f"{name}.bias"] = (cout,)

    def conv3d(self, name: str, cin: int, cout: int, kt: int = 3, ks: int = 3) -> None:
        self[f"{name}.weight"] = (cout, cin, kt, ks, ks)
        self[f"{name}.bias"] = (cout,)

    def norm(self, name: str, dim: int) -> None:
        self[f"{name}.weight"] = (dim,)
        self[f"{name}.bias"] = (dim,)


def _pixart(cfg) -> _Shapes:
    """PixArt-alpha/PixArt-XL-2-512x512 transformer (convert.pixart_params)."""
    s = _Shapes()
    d, p = cfg.hidden, cfg.patch_size
    s.conv("pos_embed.proj", cfg.in_channels, d, k=p)
    s.lin("adaln_single.emb.timestep_embedder.linear_1", 256, d)
    s.lin("adaln_single.emb.timestep_embedder.linear_2", d, d)
    s.lin("adaln_single.linear", d, 6 * d)
    s.lin("caption_projection.linear_1", cfg.caption_dim, d)
    s.lin("caption_projection.linear_2", d, d)
    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}"
        s[f"{b}.scale_shift_table"] = (6, d)
        for attn in ("attn1", "attn2"):
            for pnm in ("to_q", "to_k", "to_v"):
                s.lin(f"{b}.{attn}.{pnm}", d, d)
            s.lin(f"{b}.{attn}.to_out.0", d, d)
        s.lin(f"{b}.ff.net.0.proj", d, cfg.mlp_ratio * d)
        s.lin(f"{b}.ff.net.2", cfg.mlp_ratio * d, d)
    s["scale_shift_table"] = (2, d)
    s.lin("proj_out", d, p * p * cfg.out_channels)
    return s


def _sd3(cfg) -> _Shapes:
    """stabilityai SD3/SD3.5 MMDiT (convert.sd3_params); qk_norm and
    dual_attention_layers follow the config."""
    s = _Shapes()
    d = cfg.hidden
    s.conv("pos_embed.proj", cfg.in_channels, d, k=cfg.patch_size)
    for name, din in (("timestep_embedder", 256), ("text_embedder", cfg.pooled_dim)):
        s.lin(f"time_text_embed.{name}.linear_1", din, d)
        s.lin(f"time_text_embed.{name}.linear_2", d, d)
    s.lin("context_embedder", cfg.context_dim, d)
    dual = set(cfg.dual_attention_layers)
    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}"
        last = i == cfg.num_layers - 1
        s.lin(f"{b}.norm1.linear", d, (9 if i in dual else 6) * d)
        s.lin(f"{b}.norm1_context.linear", d, (2 if last else 6) * d)
        for p in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            s.lin(f"{b}.attn.{p}", d, d)
        s.lin(f"{b}.attn.to_out.0", d, d)
        if cfg.qk_norm == "rms":
            s[f"{b}.attn.norm_q.weight"] = (cfg.head_dim,)
            s[f"{b}.attn.norm_k.weight"] = (cfg.head_dim,)
        if not last:
            s.lin(f"{b}.attn.to_add_out", d, d)
        if i in dual:
            for p in ("to_q", "to_k", "to_v"):
                s.lin(f"{b}.attn2.{p}", d, d)
            s.lin(f"{b}.attn2.to_out.0", d, d)
            if cfg.qk_norm == "rms":
                s[f"{b}.attn2.norm_q.weight"] = (cfg.head_dim,)
                s[f"{b}.attn2.norm_k.weight"] = (cfg.head_dim,)
        s.lin(f"{b}.ff.net.0.proj", d, 4 * d)
        s.lin(f"{b}.ff.net.2", 4 * d, d)
        if not last:
            s.lin(f"{b}.ff_context.net.0.proj", d, 4 * d)
            s.lin(f"{b}.ff_context.net.2", 4 * d, d)
    s.lin("norm_out.linear", d, 2 * d)
    s.lin("proj_out", d, cfg.patch_size**2 * cfg.out_channels)
    return s


def _unet_sd15(cfg) -> _Shapes:
    """runwayml SD1.5 UNet2DConditionModel (convert.unet_sd15_params):
    1×1-conv proj_in/proj_out, bias-free q/k/v, GEGLU's doubled proj_in."""
    s = _Shapes()
    widths = list(cfg.block_widths)
    n_stages = len(widths)
    lpb = cfg.layers_per_block
    temb = widths[0] * 4

    def resnet(name, cin, cout):
        s.norm(f"{name}.norm1", cin)
        s.conv(f"{name}.conv1", cin, cout)
        s.lin(f"{name}.time_emb_proj", temb, cout)
        s.norm(f"{name}.norm2", cout)
        s.conv(f"{name}.conv2", cout, cout)
        if cin != cout:
            s.conv(f"{name}.conv_shortcut", cin, cout, k=1)

    def spatial(name, w):
        s.norm(f"{name}.norm", w)
        s.conv(f"{name}.proj_in", w, w, k=1)
        s.conv(f"{name}.proj_out", w, w, k=1)
        t = f"{name}.transformer_blocks.0"
        for j in (1, 2, 3):
            s.norm(f"{t}.norm{j}", w)
        for attn, ctx in (("attn1", w), ("attn2", cfg.context_dim)):
            s.lin(f"{t}.{attn}.to_q", w, w, bias=False)
            s.lin(f"{t}.{attn}.to_k", ctx, w, bias=False)
            s.lin(f"{t}.{attn}.to_v", ctx, w, bias=False)
            s.lin(f"{t}.{attn}.to_out.0", w, w)
        s.lin(f"{t}.ff.net.0.proj", w, 8 * w)
        s.lin(f"{t}.ff.net.2", 4 * w, w)

    s.conv("conv_in", cfg.in_channels, widths[0])
    s.lin("time_embedding.linear_1", widths[0], temb)
    s.lin("time_embedding.linear_2", temb, temb)
    ch = widths[0]
    skips = [ch]
    for i, w in enumerate(widths):
        for j in range(lpb):
            resnet(f"down_blocks.{i}.resnets.{j}", ch, w)
            ch = w
            if i < n_stages - 1:
                spatial(f"down_blocks.{i}.attentions.{j}", w)
            skips.append(w)
        if i < n_stages - 1:
            s.conv(f"down_blocks.{i}.downsamplers.0.conv", w, w)
            skips.append(w)
    resnet("mid_block.resnets.0", widths[-1], widths[-1])
    spatial("mid_block.attentions.0", widths[-1])
    resnet("mid_block.resnets.1", widths[-1], widths[-1])
    for i, w in enumerate(reversed(widths)):
        stage = n_stages - 1 - i
        for j in range(lpb + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", ch + skips.pop(), w)
            ch = w
            if stage < n_stages - 1:
                spatial(f"up_blocks.{i}.attentions.{j}", w)
        if stage > 0:
            s.conv(f"up_blocks.{i}.upsamplers.0.conv", w, w)
    s.norm("conv_norm_out", widths[0])
    s.conv("conv_out", widths[0], cfg.out_channels)
    return s


def _klvae(cfg) -> _Shapes:
    """SD1.5/SD3 AutoencoderKL, encoder and decoder (convert.klvae_params)."""
    s = _Shapes()
    widths = list(cfg.block_widths)
    n_stages = len(widths)
    lpb = cfg.layers_per_block

    def resnet(name, cin, cout):
        s.norm(f"{name}.norm1", cin)
        s.conv(f"{name}.conv1", cin, cout)
        s.norm(f"{name}.norm2", cout)
        s.conv(f"{name}.conv2", cout, cout)
        if cin != cout:
            s.conv(f"{name}.conv_shortcut", cin, cout, k=1)

    def midattn(name, w):
        s.norm(f"{name}.group_norm", w)
        for p in ("to_q", "to_k", "to_v"):
            s.lin(f"{name}.{p}", w, w)
        s.lin(f"{name}.to_out.0", w, w)

    s.conv("decoder.conv_in", cfg.latent_channels, widths[-1])
    resnet("decoder.mid_block.resnets.0", widths[-1], widths[-1])
    midattn("decoder.mid_block.attentions.0", widths[-1])
    resnet("decoder.mid_block.resnets.1", widths[-1], widths[-1])
    ch = widths[-1]
    for i, w in enumerate(reversed(widths)):
        for j in range(lpb + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ch, w)
            ch = w
        if i < n_stages - 1:
            s.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", w, w)
    s.norm("decoder.conv_norm_out", widths[0])
    s.conv("decoder.conv_out", widths[0], cfg.image_channels)
    s.conv("post_quant_conv", cfg.latent_channels, cfg.latent_channels, k=1)
    s.conv("encoder.conv_in", cfg.image_channels, widths[0])
    ch = widths[0]
    for i, w in enumerate(widths):
        for j in range(lpb):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", ch, w)
            ch = w
        if i < n_stages - 1:
            s.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", w, w)
    resnet("encoder.mid_block.resnets.0", widths[-1], widths[-1])
    midattn("encoder.mid_block.attentions.0", widths[-1])
    resnet("encoder.mid_block.resnets.1", widths[-1], widths[-1])
    s.norm("encoder.conv_norm_out", widths[-1])
    s.conv("encoder.conv_out", widths[-1], 2 * cfg.latent_channels)
    s.conv("quant_conv", 2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1)
    return s


def _cogvideox(cfg) -> _Shapes:
    """THUDM/CogVideoX-2b transformer (convert.cogvideox_params)."""
    s = _Shapes()
    d = cfg.hidden
    s.conv("patch_embed.proj", cfg.in_channels, d, k=cfg.patch_size)
    s.lin("patch_embed.text_proj", cfg.text_dim, d)
    s.lin("time_embedding.linear_1", d, cfg.time_embed_dim)
    s.lin("time_embedding.linear_2", cfg.time_embed_dim, cfg.time_embed_dim)
    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}"
        for norm in ("norm1", "norm2"):
            s.lin(f"{b}.{norm}.linear", cfg.time_embed_dim, 6 * d)
            s.norm(f"{b}.{norm}.norm", d)
        for p in ("to_q", "to_k", "to_v"):
            s.lin(f"{b}.attn1.{p}", d, d)
        s.norm(f"{b}.attn1.norm_q", cfg.head_dim)
        s.norm(f"{b}.attn1.norm_k", cfg.head_dim)
        s.lin(f"{b}.attn1.to_out.0", d, d)
        s.lin(f"{b}.ff.net.0.proj", d, 4 * d)
        s.lin(f"{b}.ff.net.2", 4 * d, d)
    s.norm("norm_final", d)
    s.lin("norm_out.linear", cfg.time_embed_dim, 2 * d)
    s.norm("norm_out.norm", d)
    s.lin("proj_out", d, cfg.patch_size**2 * cfg.out_channels)
    return s


def _vae3d_decoder(cfg) -> _Shapes:
    """The CogVideoX causal 3D VAE, decoder side (convert.vae3d_decoder_params):
    every CogVideoXCausalConv3d wraps an nn.Conv3d as `.conv`."""
    s = _Shapes()
    widths = list(cfg.block_widths)
    n_stages = len(widths)

    def resnet(name, cin, cout):
        s.norm(f"{name}.norm1", cin)
        s.conv3d(f"{name}.conv1.conv", cin, cout)
        s.norm(f"{name}.norm2", cout)
        s.conv3d(f"{name}.conv2.conv", cout, cout)
        if cin != cout:
            s.conv3d(f"{name}.conv_shortcut.conv", cin, cout, kt=1, ks=1)

    s.conv3d("decoder.conv_in.conv", cfg.latent_channels, widths[-1])
    resnet("decoder.mid_block.resnets.0", widths[-1], widths[-1])
    resnet("decoder.mid_block.resnets.1", widths[-1], widths[-1])
    ch = widths[-1]
    for i, w in enumerate(reversed(widths)):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ch, w)
            ch = w
        if i < n_stages - 1:
            s.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", w, w)
    s.norm("decoder.norm_out", widths[0])
    s.conv3d("decoder.conv_out.conv", widths[0], cfg.image_channels)
    return s


def _taesd(cfg) -> _Shapes:
    """madebyollin/taesd and TAESD3 AutoencoderTiny (convert.taesd_params):
    positional nn.Sequential keys; the stage convs have no bias."""
    s = _Shapes()
    w = cfg.width

    def blk(name, cin, cout):
        s.conv(f"{name}.conv.0", cin, cout)
        s.conv(f"{name}.conv.2", cout, cout)
        s.conv(f"{name}.conv.4", cout, cout)
        if cin != cout:
            s.conv(f"{name}.skip", cin, cout, k=1, bias=False)

    s.conv("decoder.layers.0", cfg.latent_channels, w)
    idx = 2  # + ReLU
    for _stage in range(cfg.num_stages):
        for _b in range(cfg.blocks_per_stage):
            blk(f"decoder.layers.{idx}", w, w)
            idx += 1
        idx += 1  # nn.Upsample
        s.conv(f"decoder.layers.{idx}", w, w, bias=False)
        idx += 1
    blk(f"decoder.layers.{idx}", w, w)
    s.conv(f"decoder.layers.{idx + 1}", w, cfg.image_channels)
    s.conv("encoder.layers.0", cfg.image_channels, w)
    blk("encoder.layers.1", w, w)
    idx = 2
    for _stage in range(cfg.num_stages):
        s.conv(f"encoder.layers.{idx}", w, w, bias=False)
        idx += 1
        for _b in range(cfg.blocks_per_stage):
            blk(f"encoder.layers.{idx}", w, w)
            idx += 1
    s.conv(f"encoder.layers.{idx}", w, cfg.latent_channels)
    return s


def _default_cfg(family: str):
    from tdm_tpu_torch.models import cogvideox, mmdit_sd3, pixart, unet_sd15, vae, vae3d

    return {
        "cogvideox": cogvideox.CogVideoXConfig,
        "vae3d_decoder": vae3d.VAE3DConfig,
        "pixart": pixart.PixArtConfig,
        "sd3": mmdit_sd3.MMDiTConfig,
        "unet_sd15": unet_sd15.UNetConfig,
        "klvae": vae.KLVAEConfig,
        "taesd": vae.TAESDConfig,
        "taesd3": vae.TAESDConfig.taesd3,
    }[family]()


_INVENTORIES = {
    "pixart": _pixart,
    "sd3": _sd3,
    "unet_sd15": _unet_sd15,
    "klvae": _klvae,
    "cogvideox": _cogvideox,
    "vae3d_decoder": _vae3d_decoder,
    "taesd": _taesd,
    "taesd3": _taesd,
}
MANIFEST_FAMILIES = ("pixart", "sd3", "unet_sd15", "klvae", "cogvideox",
                     "vae3d_decoder", "taesd", "taesd3")

# checkpoint keys the converters skip (their ignore patterns, and buffers
# some dumps still serialize)
_IGNORED_PREFIXES = {
    "sd3": ("pos_embed.pos_embed",),
    "taesd": ("latent_magnitude", "latent_shift"),
    "taesd3": ("latent_magnitude", "latent_shift"),
    "vae3d_decoder": ("encoder.", "quant_conv.", "post_quant_conv."),
    "cogvideox": ("patch_embed.pos_embedding",),
    "pixart": (
        "adaln_single.emb.resolution_embedder.",
        "adaln_single.emb.aspect_ratio_embedder.",
        "caption_projection.y_embedding",
    ),
}


def expected_manifest(family: str, cfg=None) -> dict[str, tuple[int, ...]]:
    """The exact {torch key: shape} inventory the family's converter reads,
    generated from the model config (by default the released model's)."""
    if family not in _INVENTORIES:
        raise ValueError(f"unknown manifest family {family!r}; known: {MANIFEST_FAMILIES}")
    return dict(_INVENTORIES[family](cfg if cfg is not None else _default_cfg(family)))


def read_safetensors_manifest(path: str) -> dict[str, tuple[int, ...]]:
    """{key: shape} from safetensors headers only (an 8-byte little-endian
    length, then JSON; no tensor data is read). `path` is one .safetensors
    file or a directory of them."""
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors files under {path}")
    else:
        files = [path]
    out: dict[str, tuple[int, ...]] = {}
    for f in files:
        with open(f, "rb") as fh:
            n = int.from_bytes(fh.read(8), "little")
            header = json.loads(fh.read(n))
        for k, v in header.items():
            if k != "__metadata__":
                out[k] = tuple(v["shape"])
    return out


def save_manifest(manifest: dict[str, tuple[int, ...]], path: str) -> None:
    with open(path, "w") as f:
        json.dump({k: list(v) for k, v in sorted(manifest.items())}, f, indent=0)
        f.write("\n")


def load_manifest(path: str) -> dict[str, tuple[int, ...]]:
    """A manifest from JSON ({key: shape list}) or from a safetensors file
    or directory (headers only)."""
    if path.endswith(".json"):
        with open(path) as f:
            return {k: tuple(v) for k, v in json.load(f).items()}
    return read_safetensors_manifest(path)


def check_manifest(
    family: str,
    actual: dict[str, tuple[int, ...]],
    cfg=None,
    *,
    strip_prefix: Optional[str] = None,
) -> list[str]:
    """A checkpoint's key/shape inventory against the converter's
    expectation: a list of readable problems ([] when clean). `strip_prefix`
    removes a nesting prefix ('transformer.', 'model.') first."""
    if strip_prefix:
        actual = {k[len(strip_prefix):]: v for k, v in actual.items()
                  if k.startswith(strip_prefix)}
    expected = expected_manifest(family, cfg)
    ignored = _IGNORED_PREFIXES.get(family, ())
    actual = {k: tuple(v) for k, v in actual.items()
              if not any(k.startswith(p) for p in ignored)}
    problems = []
    for k in sorted(set(expected) - set(actual)):
        problems.append(f"missing key: {k} (expected shape {expected[k]})")
    for k in sorted(set(actual) - set(expected)):
        problems.append(f"unexpected key: {k} shape {actual[k]}")
    for k in sorted(set(expected) & set(actual)):
        if tuple(expected[k]) != tuple(actual[k]):
            problems.append(f"shape mismatch: {k} expected {tuple(expected[k])} got "
                            f"{tuple(actual[k])}")
    return problems


def _synthetic_leaves(
    family: str, cfg, seed: int, scale: float
) -> Iterator[tuple[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    for k, shape in expected_manifest(family, cfg).items():
        yield k, (rng.standard_normal(shape).astype(np.float32) * scale
                  if shape else np.float32(rng.standard_normal() * scale))


def synthetic_state_dict(
    family: str, cfg=None, *, seed: int = 0, scale: float = 0.02
) -> dict[str, Any]:
    """A seeded random state dict with the family's exact key/shape
    inventory (the same numbers as the JAX package's for the same seed)."""
    return dict(_synthetic_leaves(family, cfg, seed, scale))


def write_synthetic(
    family: str, path: str, cfg=None, *, seed: int = 0, scale: float = 0.02
) -> int:
    """Write `synthetic_state_dict(family, cfg, seed=seed, scale=scale)` as
    one safetensors file at fp16, as the hub's checkpoints are, one leaf in
    memory at a time. Returns the number of parameters."""
    manifest = expected_manifest(family, cfg)
    params_io.write_file(
        path, [(k, shape, np.float16) for k, shape in manifest.items()],
        (a for _, a in _synthetic_leaves(family, cfg, seed, scale)),
    )
    return sum(int(np.prod(s, dtype=np.int64)) for s in manifest.values())
