"""Checkpoint conversion: diffusers state dicts ↔ the JAX package's trees.

Port of the numpy half of `tdm_tpu/io/convert.py` for the families the port
builds: PixArt (`pixart_params`), SD3/SD3.5 (`sd3_params`), the SD1.5 UNet
(`unet_sd15_params`), TAESD/TAESD3 (`taesd_params`), AutoencoderKL
(`klvae_params`), the CogVideoX transformer (`cogvideox_params`), its 3D
VAE's decoder (`vae3d_decoder_params`), the text encoders: T5
(`t5_encoder_params`) and CLIP's text tower (`clip_text_params`), and the
CLIP score's towers (`clip_vision_params`, and `clip_model_params` for a
whole `CLIPModel`). Each converter returns
the same nested numpy tree as its JAX twin before `to_jax`; the weight carry
(`io/from_jax.load_from_jax` over `flatten`) loads that tree into the
port's modules, so a diffusers checkpoint and a tdm_tpu-layout directory take
one weight path. The reverse direction, a tree back to the diffusers state
dict, exists for PixArt (`pixart_to_torch`, with `unstack_layers`; the
`TO_TORCH` table).

torch Linear weights are [out, in] and the tree's Dense kernels [in, out];
torch Conv2d is [out, in, kh, kw] and the tree's HWIO; torch Conv3d is
[out, in, kt, kh, kw] and the tree's [kt, kh, kw, in, out]. Both are numpy views
here, so the carry's transpose back gives the checkpoint's own buffers and
the load into a module is the one copy.

Strict accounting: every converter records which checkpoint keys it read
and raises on leftovers (a renamed key would convert to a tree silently
missing a weight) and on missing keys (naming the family). Known non-weight
buffers are ignored per family; `strict=False` skips the leftover check.

`load_torch_state_dict` reads with the port's own safetensors reader
(`io/params.load_file`: F16 as float16, BF16 widened exactly to float32).
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import Mapping

import numpy as np

from tdm_tpu_torch.io import params as params_io


class _TrackedStateDict(dict):
    """State dict recording which keys the converter consumed ('in' checks
    do not consume: optional-key probes are not reads)."""

    def __init__(self, sd):
        super().__init__(sd)
        self.consumed: set[str] = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)


def _strict_converter(family: str, ignore: tuple[str, ...] = ()):
    """Wrap a converter with consumed-key accounting. The wrapped function
    gains `strict: bool = True`: unconsumed checkpoint keys (apart from the
    family's known non-weight buffers) raise ValueError, and a KeyError is
    raised again naming the family."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(sd, *args, strict: bool = True, **kwargs):
            tracked = _TrackedStateDict(sd)
            try:
                out = fn(tracked, *args, **kwargs)
            except KeyError as e:
                raise KeyError(
                    f"{family} converter: checkpoint is missing key "
                    f"{e.args[0]!r} — renamed, truncated, or wrong model "
                    f"family? (strict=False skips only the leftover check, "
                    f"not required keys)"
                ) from None
            if strict:
                leftovers = sorted(
                    k for k in tracked
                    if k not in tracked.consumed
                    and not any(re.fullmatch(p, k) for p in ignore)
                )
                if leftovers:
                    shown = ", ".join(leftovers[:8])
                    more = f" (+{len(leftovers) - 8} more)" if len(leftovers) > 8 else ""
                    raise ValueError(
                        f"{family} converter: {len(leftovers)} checkpoint "
                        f"key(s) were never consumed: {shown}{more} — "
                        f"renamed/unknown weights would be silently dropped. "
                        f"Pass strict=False for deliberately partial dicts."
                    )
            return out

        return wrapper

    return deco


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """A safetensors file, or every `*.safetensors` of a directory in sorted
    order (a later file's keys win), into {key: array}. A directory with a
    `model.safetensors.index.json` reads the shards that index names; no
    other index name is looked for."""
    if os.path.isfile(path):
        return params_io.load_file(path)
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        files = [os.path.join(path, f) for f in files]
    else:
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors")
        )
    out: dict[str, np.ndarray] = {}
    for f in files:
        out.update(params_io.load_file(f))
    return out


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """A converter's nested tree → flat '/'-joined keys, each leaf as it is
    (the carry's input; `from_jax.flatten_tree` copies instead)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def _set(tree: dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _linear(sd: dict, tree: dict, src: str, dst: str, *, bias: bool = True) -> None:
    """torch Linear src.{weight,bias} → dst/{kernel,bias} (the kernel a
    transposed view)."""
    _set(tree, f"{dst}/kernel", sd[f"{src}.weight"].T)
    if bias and f"{src}.bias" in sd:
        _set(tree, f"{dst}/bias", sd[f"{src}.bias"])


def _conv(sd: dict, tree: dict, src: str, dst: str) -> None:
    """torch Conv2d [out, in, kh, kw] → HWIO [kh, kw, in, out] (a view)."""
    _set(tree, f"{dst}/kernel", np.transpose(sd[f"{src}.weight"], (2, 3, 1, 0)))
    if f"{src}.bias" in sd:
        _set(tree, f"{dst}/bias", sd[f"{src}.bias"])


def _linear_1x1(sd: dict, tree: dict, src: str, dst: str) -> None:
    """A torch 1×1 Conv2d [out, in, 1, 1] or Linear [out, in] → a Dense
    kernel [in, out] (SD1.5's spatial transformers project with 1×1 convs;
    a view either way)."""
    w = sd[f"{src}.weight"]
    if w.ndim == 4:
        w = w[:, :, 0, 0]
    _set(tree, f"{dst}/kernel", w.T)
    if f"{src}.bias" in sd:
        _set(tree, f"{dst}/bias", sd[f"{src}.bias"])


def _norm(sd: dict, tree: dict, src: str, dst: str, *, scale_name: str = "scale") -> None:
    """torch LayerNorm/GroupNorm/RMSNorm {weight, bias} → {scale, bias}."""
    _set(tree, f"{dst}/{scale_name}", sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        _set(tree, f"{dst}/bias", sd[f"{src}.bias"])


def _n_blocks(sd: dict, pattern: str) -> int:
    return 1 + max(int(m.group(1)) for k in sd if (m := re.match(pattern, k)))


def _stack(subs: list):
    if isinstance(subs[0], Mapping):
        return {k: _stack([s[k] for s in subs]) for k in subs[0]}
    return np.stack(subs)


def stack_layers(
    tree: dict,
    prefix: str = "blocks",
    count: int | None = None,
    *,
    start: int = 0,
    out_name: str | None = None,
) -> dict:
    """Fold `{prefix}_{start} … {prefix}_{start+N-1}` sibling subtrees into
    one `{out_name or prefix}` subtree with a leading layer axis (the JAX
    package's scan_layers layout). `count` stacks only N blocks (SD3 keeps
    its last block unrolled); `start`/`out_name` build SD3.5's second stack
    after its dual-attention prefix."""
    names = sorted(
        (k for k in tree if re.fullmatch(rf"{prefix}_\d+", k)),
        key=lambda s: int(s.rsplit("_", 1)[1]),
    )
    names = [k for k in names if int(k.rsplit("_", 1)[1]) >= start]
    if count is not None:
        names = names[:count]
    if not names:
        return tree
    tree[out_name or prefix] = _stack([tree.pop(k) for k in names])
    return tree


# ---------------------------------------------------------------------------
# PixArt-α DiT (diffusers PixArtTransformer2DModel)
# ---------------------------------------------------------------------------


@_strict_converter(
    "pixart",
    ignore=(
        # the 1024 model's micro-conditioning embedders (unused at 512) and
        # the original repo's uncond caption buffer
        r"adaln_single\.emb\.(resolution|aspect_ratio)_embedder\..*",
        r"caption_projection\.y_embedding",
    ),
)
def pixart_params(sd: dict[str, np.ndarray], *, scan_layers: bool = True) -> dict:
    """diffusers PixArt transformer state dict → the PixArtTransformer2D
    tree: pos_embed.proj, adaln_single.{emb.timestep_embedder, linear},
    caption_projection.linear_{1,2}, transformer_blocks.{i}.{
    scale_shift_table, attn1, attn2, ff.net.{0.proj,2}}, the final
    scale_shift_table and proj_out. With scan_layers the blocks stack."""
    tree: dict = {}
    _conv(sd, tree, "pos_embed.proj", "pos_embed/proj")
    for j in (1, 2):
        _linear(sd, tree, f"adaln_single.emb.timestep_embedder.linear_{j}",
                f"t_embedder/linear_{j}")
    _linear(sd, tree, "adaln_single.linear", "t_block")
    _linear(sd, tree, "caption_projection.linear_1", "caption_linear_1")
    _linear(sd, tree, "caption_projection.linear_2", "caption_linear_2")
    for i in range(_n_blocks(sd, r"transformer_blocks\.(\d+)\.")):
        src, dst = f"transformer_blocks.{i}", f"blocks_{i}"
        _set(tree, f"{dst}/scale_shift_table", sd[f"{src}.scale_shift_table"])
        for attn in ("attn1", "attn2"):
            for p in ("to_q", "to_k", "to_v"):
                _linear(sd, tree, f"{src}.{attn}.{p}", f"{dst}/{attn}/{p}")
            _linear(sd, tree, f"{src}.{attn}.to_out.0", f"{dst}/{attn}/to_out")
        _linear(sd, tree, f"{src}.ff.net.0.proj", f"{dst}/ff/proj_in")
        _linear(sd, tree, f"{src}.ff.net.2", f"{dst}/ff/proj_out")
    _set(tree, "final_scale_shift_table", sd["scale_shift_table"])
    _linear(sd, tree, "proj_out", "proj_out")
    return stack_layers(tree) if scan_layers else tree


# ---------------------------------------------------------------------------
# TAESD (diffusers AutoencoderTiny)
# ---------------------------------------------------------------------------


@_strict_converter("taesd", ignore=(r"latent_(magnitude|shift)",))
def taesd_params(
    sd: dict[str, np.ndarray], *, num_stages: int = 3, blocks_per_stage: int = 3
) -> dict:
    """AutoencoderTiny state dict → {encoder: ..., decoder: ...} trees. Its
    sides are positional nn.Sequentials (`decoder.layers.{n}...`); the
    indices follow the stage structure (decoder: conv_in, ReLU, [blocks,
    upsample, conv] per stage, block, conv_out, as madebyollin/taesd and
    TAESD3)."""
    def block(dst_tree, src, dst):
        for j, conv_idx in enumerate((0, 2, 4)):
            _conv(sd, dst_tree, f"{src}.conv.{conv_idx}", f"{dst}/conv_{j}")
        if f"{src}.skip.weight" in sd:
            _conv(sd, dst_tree, f"{src}.skip", f"{dst}/skip")

    tree: dict = {"encoder": {}, "decoder": {}}
    dec = tree["decoder"]
    if any(k.startswith("decoder.") for k in sd):
        _conv(sd, dec, "decoder.layers.0", "conv_in")
        idx = 2  # + ReLU
        for s in range(num_stages):
            for b in range(blocks_per_stage):
                block(dec, f"decoder.layers.{idx}", f"stage_{s}_block_{b}")
                idx += 1
            idx += 1  # nn.Upsample (no parameters)
            _conv(sd, dec, f"decoder.layers.{idx}", f"stage_{s}_conv")
            idx += 1
        block(dec, f"decoder.layers.{idx}", "block_out")
        _conv(sd, dec, f"decoder.layers.{idx + 1}", "conv_out")
    enc = tree["encoder"]
    if any(k.startswith("encoder.") for k in sd):
        _conv(sd, enc, "encoder.layers.0", "conv_in")
        block(enc, "encoder.layers.1", "block_in")
        idx = 2
        for s in range(num_stages):
            _conv(sd, enc, f"encoder.layers.{idx}", f"stage_{s}_down")
            idx += 1
            for b in range(blocks_per_stage):
                block(enc, f"encoder.layers.{idx}", f"stage_{s}_block_{b}")
                idx += 1
        _conv(sd, enc, f"encoder.layers.{idx}", "conv_out")
    return tree


# ---------------------------------------------------------------------------
# SD3 MMDiT (diffusers SD3Transformer2DModel)
# ---------------------------------------------------------------------------


@_strict_converter(
    "sd3",
    # the checkpoint persists the sin-cos position table; the model computes it
    ignore=(r"pos_embed\.pos_embed",),
)
def sd3_params(sd: dict[str, np.ndarray], *, scan_layers: bool = True) -> dict:
    """SD3/SD3.5 transformer state dict → the SD3Transformer2D tree: the
    last block is context_pre_only (no to_add_out, no ff_context), SD3.5's
    RMS qk norms under norm_q/norm_k, its dual attention under attn2. With
    scan_layers the first N-1 blocks stack ('blocks_dual' for the dual
    prefix, then 'blocks'); the last stays unrolled."""
    tree: dict = {}
    _conv(sd, tree, "pos_embed.proj", "pos_embed/proj")
    for name in ("timestep_embedder", "text_embedder"):
        for j in (1, 2):
            _linear(sd, tree, f"time_text_embed.{name}.linear_{j}", f"{name}/linear_{j}")
    _linear(sd, tree, "context_embedder", "context_embedder")
    n = _n_blocks(sd, r"transformer_blocks\.(\d+)\.")
    for i in range(n):
        src, dst = f"transformer_blocks.{i}", f"blocks_{i}"
        _linear(sd, tree, f"{src}.norm1.linear", f"{dst}/norm1/linear")
        _linear(sd, tree, f"{src}.norm1_context.linear", f"{dst}/norm1_context/linear")
        for p in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            _linear(sd, tree, f"{src}.attn.{p}", f"{dst}/{p}")
        _linear(sd, tree, f"{src}.attn.to_out.0", f"{dst}/to_out")
        if f"{src}.attn.to_add_out.weight" in sd:
            _linear(sd, tree, f"{src}.attn.to_add_out", f"{dst}/to_add_out")
        for qk in ("norm_q", "norm_k"):  # SD3.5's RMS qk norm
            if f"{src}.attn.{qk}.weight" in sd:
                _set(tree, f"{dst}/{qk}/scale", sd[f"{src}.attn.{qk}.weight"])
        if f"{src}.attn2.to_q.weight" in sd:  # SD3.5's dual attention
            for p in ("to_q", "to_k", "to_v"):
                _linear(sd, tree, f"{src}.attn2.{p}", f"{dst}/attn2/{p}")
            _linear(sd, tree, f"{src}.attn2.to_out.0", f"{dst}/attn2/to_out")
            for qk in ("norm_q", "norm_k"):
                if f"{src}.attn2.{qk}.weight" in sd:
                    _set(tree, f"{dst}/attn2/{qk}/scale", sd[f"{src}.attn2.{qk}.weight"])
        _linear(sd, tree, f"{src}.ff.net.0.proj", f"{dst}/ff/proj_in")
        _linear(sd, tree, f"{src}.ff.net.2", f"{dst}/ff/proj_out")
        if f"{src}.ff_context.net.0.proj.weight" in sd:
            _linear(sd, tree, f"{src}.ff_context.net.0.proj", f"{dst}/ff_context/proj_in")
            _linear(sd, tree, f"{src}.ff_context.net.2", f"{dst}/ff_context/proj_out")
    _linear(sd, tree, "norm_out.linear", "norm_out/linear")
    _linear(sd, tree, "proj_out", "proj_out")
    if not scan_layers:
        return tree
    dual = [i for i in range(n) if f"transformer_blocks.{i}.attn2.to_q.weight" in sd]
    if dual:
        # two homogeneous stacks need the dual blocks to be a prefix
        if dual != list(range(len(dual))):
            raise ValueError(
                f"sd3: dual-attention blocks {dual} are not a contiguous "
                "prefix — convert with scan_layers=False"
            )
        if len(dual) >= n:
            raise ValueError(
                f"sd3: checkpoint carries dual attention on the FINAL "
                f"block ({n - 1}), which the MMDiT's context_pre_only "
                "output block does not support — no shipped SD3.5 config "
                "does this; refusing to convert rather than drop weights"
            )
        d = len(dual)
        tree = stack_layers(tree, count=d, out_name="blocks_dual")
        return stack_layers(tree, count=n - 1 - d, start=d)
    return stack_layers(tree, count=n - 1)


# ---------------------------------------------------------------------------
# SD1.5 UNet (diffusers UNet2DConditionModel)
# ---------------------------------------------------------------------------


def _unet_resnet(sd: dict, tree: dict, src: str, dst: str) -> None:
    _norm(sd, tree, f"{src}.norm1", f"{dst}/norm1")
    _conv(sd, tree, f"{src}.conv1", f"{dst}/conv1")
    _linear(sd, tree, f"{src}.time_emb_proj", f"{dst}/time_emb_proj")
    _norm(sd, tree, f"{src}.norm2", f"{dst}/norm2")
    _conv(sd, tree, f"{src}.conv2", f"{dst}/conv2")
    if f"{src}.conv_shortcut.weight" in sd:
        _conv(sd, tree, f"{src}.conv_shortcut", f"{dst}/conv_shortcut")


def _unet_spatial_transformer(sd: dict, tree: dict, src: str, dst: str) -> None:
    _norm(sd, tree, f"{src}.norm", f"{dst}/norm")
    _linear_1x1(sd, tree, f"{src}.proj_in", f"{dst}/proj_in")
    _linear_1x1(sd, tree, f"{src}.proj_out", f"{dst}/proj_out")
    b, d = f"{src}.transformer_blocks.0", f"{dst}/transformer_blocks_0"
    for j in (1, 2, 3):
        _norm(sd, tree, f"{b}.norm{j}", f"{d}/norm{j}")
    for attn in ("attn1", "attn2"):
        for p in ("to_q", "to_k", "to_v"):
            _linear(sd, tree, f"{b}.{attn}.{p}", f"{d}/{attn}/{p}")
        _linear(sd, tree, f"{b}.{attn}.to_out.0", f"{d}/{attn}/to_out")
    _linear(sd, tree, f"{b}.ff.net.0.proj", f"{d}/ff/proj_in")
    _linear(sd, tree, f"{b}.ff.net.2", f"{d}/ff/proj_out")


@_strict_converter("unet_sd15")
def unet_sd15_params(
    sd: dict[str, np.ndarray], *, layers_per_block: int = 2, n_stages: int = 4
) -> dict:
    """diffusers SD1.5 UNet state dict → the UNet2DCondition tree:
    conv_in, time_embedding.linear_{1,2}, down_blocks.{i}.{resnets,
    attentions, downsamplers} → down_{i}_{res,attn}_{j}/down_{i}_downsample,
    the mid block → mid_res_0/mid_attn/mid_res_1, up_blocks likewise (3
    resnets a stage, upsamplers → up_{i}_upsample), conv_norm_out and
    conv_out. The last down stage and the first up stage have no
    attentions."""
    tree: dict = {}
    _conv(sd, tree, "conv_in", "conv_in")
    for j in (1, 2):
        _linear(sd, tree, f"time_embedding.linear_{j}", f"time_embedding/linear_{j}")
    for i in range(n_stages):
        for j in range(layers_per_block):
            _unet_resnet(sd, tree, f"down_blocks.{i}.resnets.{j}", f"down_{i}_res_{j}")
            if i < n_stages - 1:
                _unet_spatial_transformer(sd, tree, f"down_blocks.{i}.attentions.{j}",
                                          f"down_{i}_attn_{j}")
        if i < n_stages - 1:
            _conv(sd, tree, f"down_blocks.{i}.downsamplers.0.conv", f"down_{i}_downsample")
    _unet_resnet(sd, tree, "mid_block.resnets.0", "mid_res_0")
    _unet_spatial_transformer(sd, tree, "mid_block.attentions.0", "mid_attn")
    _unet_resnet(sd, tree, "mid_block.resnets.1", "mid_res_1")
    for i in range(n_stages):
        stage = n_stages - 1 - i
        for j in range(layers_per_block + 1):
            _unet_resnet(sd, tree, f"up_blocks.{i}.resnets.{j}", f"up_{i}_res_{j}")
            if stage < n_stages - 1:
                _unet_spatial_transformer(sd, tree, f"up_blocks.{i}.attentions.{j}",
                                          f"up_{i}_attn_{j}")
        if stage > 0:
            _conv(sd, tree, f"up_blocks.{i}.upsamplers.0.conv", f"up_{i}_upsample")
    _norm(sd, tree, "conv_norm_out", "conv_norm_out")
    _conv(sd, tree, "conv_out", "conv_out")
    return tree


# ---------------------------------------------------------------------------
# AutoencoderKL (diffusers)
# ---------------------------------------------------------------------------


def _kl_resnet(sd: dict, tree: dict, src: str, dst: str) -> None:
    _norm(sd, tree, f"{src}.norm1", f"{dst}/norm1")
    _conv(sd, tree, f"{src}.conv1", f"{dst}/conv1")
    _norm(sd, tree, f"{src}.norm2", f"{dst}/norm2")
    _conv(sd, tree, f"{src}.conv2", f"{dst}/conv2")
    if f"{src}.conv_shortcut.weight" in sd:
        _conv(sd, tree, f"{src}.conv_shortcut", f"{dst}/shortcut")


def _kl_mid_attn(sd: dict, tree: dict, src: str, dst: str) -> None:
    _norm(sd, tree, f"{src}.group_norm", f"{dst}/norm")
    for p in ("to_q", "to_k", "to_v"):
        _linear(sd, tree, f"{src}.{p}", f"{dst}/{p}")
    _linear(sd, tree, f"{src}.to_out.0", f"{dst}/to_out")


@_strict_converter("klvae")
def klvae_params(
    sd: dict[str, np.ndarray], *, layers_per_block: int = 2, n_stages: int = 4
) -> dict:
    """AutoencoderKL → {'encoder': ..., 'decoder': ...} trees, the 1×1
    quant/post_quant convs under each side's tree: the decoder's for
    `models/vae.KLDecoder`, the encoder's for `KLEncoder`."""
    tree: dict = {"encoder": {}, "decoder": {}}
    enc, dec = tree["encoder"], tree["decoder"]
    if any(k.startswith("decoder.") for k in sd):
        _conv(sd, dec, "decoder.conv_in", "conv_in")
        _kl_resnet(sd, dec, "decoder.mid_block.resnets.0", "mid_block_1")
        _kl_mid_attn(sd, dec, "decoder.mid_block.attentions.0", "mid_attn")
        _kl_resnet(sd, dec, "decoder.mid_block.resnets.1", "mid_block_2")
        for i in range(n_stages):
            for j in range(layers_per_block + 1):
                _kl_resnet(sd, dec, f"decoder.up_blocks.{i}.resnets.{j}", f"up_{i}_res_{j}")
            if i < n_stages - 1:
                _conv(sd, dec, f"decoder.up_blocks.{i}.upsamplers.0.conv", f"up_{i}_conv")
        _norm(sd, dec, "decoder.conv_norm_out", "norm_out")
        _conv(sd, dec, "decoder.conv_out", "conv_out")
        if "post_quant_conv.weight" in sd:
            _conv(sd, dec, "post_quant_conv", "post_quant_conv")
    if any(k.startswith("encoder.") for k in sd):
        _conv(sd, enc, "encoder.conv_in", "conv_in")
        for i in range(n_stages):
            for j in range(layers_per_block):
                _kl_resnet(sd, enc, f"encoder.down_blocks.{i}.resnets.{j}", f"down_{i}_res_{j}")
            if i < n_stages - 1:
                _conv(sd, enc, f"encoder.down_blocks.{i}.downsamplers.0.conv", f"down_{i}_conv")
        _kl_resnet(sd, enc, "encoder.mid_block.resnets.0", "mid_block_1")
        _kl_mid_attn(sd, enc, "encoder.mid_block.attentions.0", "mid_attn")
        _kl_resnet(sd, enc, "encoder.mid_block.resnets.1", "mid_block_2")
        _norm(sd, enc, "encoder.conv_norm_out", "norm_out")
        _conv(sd, enc, "encoder.conv_out", "conv_out")
        if "quant_conv.weight" in sd:
            _conv(sd, enc, "quant_conv", "quant_conv")
    return tree


# ---------------------------------------------------------------------------
# CogVideoX 3D-DiT (diffusers CogVideoXTransformer3DModel)
# ---------------------------------------------------------------------------


@_strict_converter(
    "cogvideox",
    # the 2B's non-persistent 3D sin-cos buffer, recomputed on the host
    ignore=(r"patch_embed\.pos_embedding",),
)
def cogvideox_params(sd: dict[str, np.ndarray], *, scan_layers: bool = True) -> dict:
    """CogVideoX transformer state dict → the CogVideoXTransformer3D tree
    (the 5B's RoPE has no weights)."""
    tree: dict = {}
    _conv(sd, tree, "patch_embed.proj", "patch_proj")
    _linear(sd, tree, "patch_embed.text_proj", "text_proj")
    for j in (1, 2):
        _linear(sd, tree, f"time_embedding.linear_{j}", f"time_embedding/linear_{j}")
    for i in range(_n_blocks(sd, r"transformer_blocks\.(\d+)\.")):
        src, dst = f"transformer_blocks.{i}", f"blocks_{i}"
        for norm in ("norm1", "norm2"):
            _linear(sd, tree, f"{src}.{norm}.linear", f"{dst}/{norm}/linear")
            _norm(sd, tree, f"{src}.{norm}.norm", f"{dst}/{norm}/norm")
        for p in ("to_q", "to_k", "to_v"):
            _linear(sd, tree, f"{src}.attn1.{p}", f"{dst}/{p}")
        for qk in ("norm_q", "norm_k"):
            _norm(sd, tree, f"{src}.attn1.{qk}", f"{dst}/{qk}")
        _linear(sd, tree, f"{src}.attn1.to_out.0", f"{dst}/to_out")
        _linear(sd, tree, f"{src}.ff.net.0.proj", f"{dst}/ff/proj_in")
        _linear(sd, tree, f"{src}.ff.net.2", f"{dst}/ff/proj_out")
    _norm(sd, tree, "norm_final", "norm_final")
    _linear(sd, tree, "norm_out.linear", "norm_out_linear")
    _norm(sd, tree, "norm_out.norm", "norm_out_norm")
    _linear(sd, tree, "proj_out", "proj_out")
    return stack_layers(tree) if scan_layers else tree


# ---------------------------------------------------------------------------
# CogVideoX 3D VAE decoder (diffusers AutoencoderKLCogVideoX)
# ---------------------------------------------------------------------------


def _cconv3d(sd: dict, tree: dict, src: str, dst: str) -> None:
    """CogVideoXCausalConv3d (an nn.Conv3d as `.conv`): [out, in, kt, kh,
    kw] → [kt, kh, kw, in, out] under `{dst}/conv` (a view)."""
    _set(tree, f"{dst}/conv/kernel", np.transpose(sd[f"{src}.conv.weight"], (2, 3, 4, 1, 0)))
    if f"{src}.conv.bias" in sd:
        _set(tree, f"{dst}/conv/bias", sd[f"{src}.conv.bias"])


def _vae3d_resnet(sd: dict, tree: dict, src: str, dst: str) -> None:
    _norm(sd, tree, f"{src}.norm1", f"{dst}/norm1/gn")
    _cconv3d(sd, tree, f"{src}.conv1", f"{dst}/conv1")
    _norm(sd, tree, f"{src}.norm2", f"{dst}/norm2/gn")
    _cconv3d(sd, tree, f"{src}.conv2", f"{dst}/conv2")
    if f"{src}.conv_shortcut.conv.weight" in sd:
        _set(tree, f"{dst}/shortcut/kernel",
             np.transpose(sd[f"{src}.conv_shortcut.conv.weight"], (2, 3, 4, 1, 0)))
        if f"{src}.conv_shortcut.conv.bias" in sd:
            _set(tree, f"{dst}/shortcut/bias", sd[f"{src}.conv_shortcut.conv.bias"])


@_strict_converter(
    "vae3d_decoder",
    # a decoder-only converter: the encoder's weights are left alone
    ignore=(r"encoder\..*", r"quant_conv\..*", r"post_quant_conv\..*"),
)
def vae3d_decoder_params(
    sd: dict[str, np.ndarray], *, layers_per_block: int = 3, n_stages: int = 4
) -> dict:
    """The CogVideoX VAE's decoder state dict → the VAE3DDecoder tree; each
    stage's upsampler Conv2d [out, in, 3, 3] becomes the per-frame (1, 3,
    3) causal conv."""
    tree: dict = {}
    _cconv3d(sd, tree, "decoder.conv_in", "conv_in")
    _vae3d_resnet(sd, tree, "decoder.mid_block.resnets.0", "mid_block_1")
    _vae3d_resnet(sd, tree, "decoder.mid_block.resnets.1", "mid_block_2")
    for i in range(n_stages):
        for j in range(layers_per_block + 1):
            _vae3d_resnet(sd, tree, f"decoder.up_blocks.{i}.resnets.{j}", f"up_{i}_res_{j}")
        up = f"decoder.up_blocks.{i}.upsamplers.0.conv"
        if f"{up}.weight" in sd:
            _set(tree, f"up_{i}_upsampler/conv/kernel",
                 np.transpose(sd[f"{up}.weight"], (2, 3, 1, 0))[None])
            if f"{up}.bias" in sd:
                _set(tree, f"up_{i}_upsampler/conv/bias", sd[f"{up}.bias"])
    _norm(sd, tree, "decoder.norm_out", "norm_out/gn")
    _cconv3d(sd, tree, "decoder.conv_out", "conv_out")
    return tree


# ---------------------------------------------------------------------------
# T5 encoder (transformers T5EncoderModel → models/t5.T5Encoder)
# ---------------------------------------------------------------------------


@_strict_converter(
    "t5_encoder",
    ignore=(
        r"decoder\..*", r"lm_head\.weight",
        # HF files often carry the tied-embedding alias
        r"encoder\.embed_tokens\.weight",
    ),
)
def t5_encoder_params(sd: dict[str, np.ndarray]) -> dict:
    """HF T5EncoderModel state dict → the T5Encoder tree. q/k/v/o have no
    bias; the feed-forward is v1.1's gated GELU (`DenseReluDense.wi_0`,
    `wi_1`, `wo`); the relative attention bias exists in block 0 only."""
    tree: dict = {}
    _set(tree, "shared_embedding", sd["shared.weight"])
    for i in range(_n_blocks(sd, r"encoder\.block\.(\d+)\.")):
        src, dst = f"encoder.block.{i}", f"block_{i}"
        _norm(sd, tree, f"{src}.layer.0.layer_norm", f"{dst}/ln_attn")
        for p in ("q", "k", "v", "o"):
            _linear(sd, tree, f"{src}.layer.0.SelfAttention.{p}",
                    f"{dst}/SelfAttention/{p}", bias=False)
        rel = f"{src}.layer.0.SelfAttention.relative_attention_bias.weight"
        if rel in sd:
            _set(tree, f"{dst}/SelfAttention/relative_attention_bias", sd[rel])
        _norm(sd, tree, f"{src}.layer.1.layer_norm", f"{dst}/ln_ff")
        for p in ("wi_0", "wi_1", "wo"):
            _linear(sd, tree, f"{src}.layer.1.DenseReluDense.{p}", f"{dst}/{p}", bias=False)
    _norm(sd, tree, "encoder.final_layer_norm", "final_layer_norm")
    return tree


# ---------------------------------------------------------------------------
# CLIP text encoder (transformers CLIPTextModel[WithProjection] →
# models/clip.CLIPTextEncoder)
# ---------------------------------------------------------------------------


@_strict_converter(
    "clip_text",
    # old transformers checkpoints persist the position_ids buffer
    ignore=(r".*\.position_ids",),
)
def clip_text_params(sd: dict[str, np.ndarray]) -> dict:
    """HF CLIPTextModel(WithProjection) state dict → the CLIPTextEncoder
    tree; `text_projection` only where the checkpoint has one."""
    tree: dict = {}
    _set(tree, "token_embedding", sd["text_model.embeddings.token_embedding.weight"])
    _set(tree, "position_embedding", sd["text_model.embeddings.position_embedding.weight"])
    for i in range(_n_blocks(sd, r"text_model\.encoder\.layers\.(\d+)\.")):
        src, dst = f"text_model.encoder.layers.{i}", f"layers_{i}"
        _norm(sd, tree, f"{src}.layer_norm1", f"{dst}/layer_norm1")
        _norm(sd, tree, f"{src}.layer_norm2", f"{dst}/layer_norm2")
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, tree, f"{src}.self_attn.{p}", f"{dst}/{p}")
        _linear(sd, tree, f"{src}.mlp.fc1", f"{dst}/fc1")
        _linear(sd, tree, f"{src}.mlp.fc2", f"{dst}/fc2")
    _norm(sd, tree, "text_model.final_layer_norm", "final_layer_norm")
    if "text_projection.weight" in sd:
        _linear(sd, tree, "text_projection", "text_projection", bias=False)
    return tree


# ---------------------------------------------------------------------------
# CLIP vision tower (transformers CLIPVisionModel[WithProjection] →
# models/clip.CLIPVisionEncoder), the CLIP score's image half
# ---------------------------------------------------------------------------


@_strict_converter(
    "clip_vision",
    ignore=(r".*\.position_ids",),
)
def clip_vision_params(sd: dict[str, np.ndarray]) -> dict:
    """HF CLIPVisionModel(WithProjection) state dict → the
    CLIPVisionEncoder tree; `visual_projection` only where the checkpoint
    has one."""
    tree: dict = {}
    _set(tree, "class_embedding", sd["vision_model.embeddings.class_embedding"])
    _set(tree, "position_embedding", sd["vision_model.embeddings.position_embedding.weight"])
    _conv(sd, tree, "vision_model.embeddings.patch_embedding", "patch_embedding")
    _norm(sd, tree, "vision_model.pre_layrnorm", "pre_layrnorm")
    for i in range(_n_blocks(sd, r"vision_model\.encoder\.layers\.(\d+)\.")):
        src, dst = f"vision_model.encoder.layers.{i}", f"layers_{i}"
        _norm(sd, tree, f"{src}.layer_norm1", f"{dst}/layer_norm1")
        _norm(sd, tree, f"{src}.layer_norm2", f"{dst}/layer_norm2")
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, tree, f"{src}.self_attn.{p}", f"{dst}/{p}")
        _linear(sd, tree, f"{src}.mlp.fc1", f"{dst}/fc1")
        _linear(sd, tree, f"{src}.mlp.fc2", f"{dst}/fc2")
    _norm(sd, tree, "vision_model.post_layernorm", "post_layernorm")
    if "visual_projection.weight" in sd:
        _linear(sd, tree, "visual_projection", "visual_projection", bias=False)
    return tree


def clip_model_params(sd: dict[str, np.ndarray]) -> tuple[dict, dict, float]:
    """A whole `transformers.CLIPModel` state dict (both towers in one
    checkpoint, e.g. openai/clip-vit-large-patch14) → (text tree, vision
    tree, logit scale = exp(logit_scale), 100 without one). Each half goes
    through its own strict converter, and a key of neither raises."""
    text_sd = {k: v for k, v in sd.items()
               if k.startswith("text_model.") or k == "text_projection.weight"}
    vision_sd = {k: v for k, v in sd.items()
                 if k.startswith("vision_model.") or k == "visual_projection.weight"}
    unknown = sorted(set(sd) - set(text_sd) - set(vision_sd) - {"logit_scale"})
    if unknown:
        raise ValueError(f"clip_model converter: unrecognized keys: {unknown[:8]}")
    logit_scale = (float(np.exp(np.asarray(sd["logit_scale"]).reshape(())))
                   if "logit_scale" in sd else 100.0)
    return clip_text_params(text_sd), clip_vision_params(vision_sd), logit_scale


# ---------------------------------------------------------------------------
# The reverse direction: a tdm_tpu param tree → a diffusers state dict, so a
# distilled full-weight student loads back into the torch ecosystem. LoRA
# files interchange through the kohya layout (lora/io.py) instead.
# ---------------------------------------------------------------------------


def _unstacked(node, i: int):
    if isinstance(node, Mapping):
        return {k: _unstacked(v, i) for k, v in node.items()}
    return np.asarray(node[i])


def _first_leaf(node):
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    return node


def unstack_layers(tree: dict, prefix: str = "blocks") -> dict:
    """The inverse of `stack_layers`: a stacked `{prefix}` subtree (leading
    layer axis L) split back into `{prefix}_0 … {prefix}_{L-1}` siblings
    (views). A tree without a stacked subtree comes back unchanged."""
    if not isinstance(tree.get(prefix), Mapping):
        return tree
    tree = dict(tree)
    stacked = tree.pop(prefix)
    for i in range(np.shape(_first_leaf(stacked))[0]):
        tree[f"{prefix}_{i}"] = _unstacked(stacked, i)
    return tree


def _get(tree: Mapping, path: str):
    node = tree
    for p in path.split("/"):
        node = node[p]
    return node


def _inv_linear(tree: Mapping, sd: dict, src: str, dst: str) -> None:
    """dst.{weight, bias} ← src/{kernel, bias}, the kernel transposed back
    to [out, in] (contiguous)."""
    node = _get(tree, src)
    sd[f"{dst}.weight"] = np.ascontiguousarray(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[f"{dst}.bias"] = np.asarray(node["bias"])


def _inv_conv(tree: Mapping, sd: dict, src: str, dst: str) -> None:
    """An HWIO kernel [kh, kw, in, out] → torch Conv2d [out, in, kh, kw]."""
    node = _get(tree, src)
    sd[f"{dst}.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{dst}.bias"] = np.asarray(node["bias"])


def pixart_to_torch(tree: Mapping) -> dict[str, np.ndarray]:
    """A PixArtTransformer2D tree (stacked or unrolled) → the diffusers
    PixArt transformer state dict: the exact inverse of `pixart_params`."""
    tree = unstack_layers(dict(tree))
    sd: dict[str, np.ndarray] = {}
    _inv_conv(tree, sd, "pos_embed/proj", "pos_embed.proj")
    for j in (1, 2):
        _inv_linear(tree, sd, f"t_embedder/linear_{j}",
                    f"adaln_single.emb.timestep_embedder.linear_{j}")
    _inv_linear(tree, sd, "t_block", "adaln_single.linear")
    _inv_linear(tree, sd, "caption_linear_1", "caption_projection.linear_1")
    _inv_linear(tree, sd, "caption_linear_2", "caption_projection.linear_2")
    n_layers = 1 + max((int(m.group(1)) for k in tree if (m := re.match(r"blocks_(\d+)$", k))),
                       default=-1)
    for i in range(n_layers):
        src, dst = f"blocks_{i}", f"transformer_blocks.{i}"
        sd[f"{dst}.scale_shift_table"] = np.asarray(_get(tree, f"{src}/scale_shift_table"))
        for attn in ("attn1", "attn2"):
            for p in ("to_q", "to_k", "to_v"):
                _inv_linear(tree, sd, f"{src}/{attn}/{p}", f"{dst}.{attn}.{p}")
            _inv_linear(tree, sd, f"{src}/{attn}/to_out", f"{dst}.{attn}.to_out.0")
        _inv_linear(tree, sd, f"{src}/ff/proj_in", f"{dst}.ff.net.0.proj")
        _inv_linear(tree, sd, f"{src}/ff/proj_out", f"{dst}.ff.net.2")
    sd["scale_shift_table"] = np.asarray(tree["final_scale_shift_table"])
    _inv_linear(tree, sd, "proj_out", "proj_out")
    return sd


# family → its reverse converter (`cli/convert_checkpoint.py --reverse`)
TO_TORCH = {"pixart": pixart_to_torch}
