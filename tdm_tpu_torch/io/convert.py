"""Checkpoint conversion: diffusers state dicts → the JAX package's trees.

Port of the numpy half of `tdm_tpu/io/convert.py` for the families the port
builds: PixArt (`pixart_params`), SD3/SD3.5 (`sd3_params`), the SD1.5 UNet
(`unet_sd15_params`), TAESD/TAESD3 (`taesd_params`) and AutoencoderKL
(`klvae_params`). Each converter returns
the same nested numpy tree as its JAX twin before `to_jax`; the weight carry
(`io/from_jax.state_dict_from_jax` over `flatten`) loads that tree into the
port's modules, so a diffusers checkpoint and a tdm_tpu-layout directory take
one weight path.

torch Linear weights are [out, in] and the tree's Dense kernels [in, out];
torch Conv2d is [out, in, kh, kw] and the tree's HWIO. Both are numpy views
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
    quant/post_quant convs under each side's tree. Both sides convert (the
    encoder's keys count as read for the strict check); the port builds the
    decoder only."""
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
