"""The weight carry: the JAX package's parameter trees ↔ the port's
`state_dict`s.

The JAX package stores parameters as a flat dict of arrays keyed by
'/'-joined Flax paths (`tdm_tpu/io/params.py`). The port's modules keep the
same names, so the carry is a rename plus two layout changes:
  * Dense `kernel` [in, out] → `weight` [out, in];
  * Conv `kernel` HWIO → `weight` OIHW, and a 3D conv's [kt, kh, kw, in,
    out] → [out, in, kt, kh, kw] (the CogVideoX VAE);
and the layer stack becomes `blocks.{i}....`. The port's fp32 norms keep
Flax's `scale` and `bias` (the KL decoder's GroupNorms, SD3's RMS qk norms,
the SD1.5 UNet's GroupNorms and LayerNorms), so they carry by name; the
UNet's modules (`down_{i}_res_{j}`, `mid_attn`, `transformer_blocks_0`,
...) are the JAX tree's and hold no layer stack, and so are the text
encoders' (T5's `shared_embedding`, `block_{i}/SelfAttention/{q,k,v,o}`,
block 0's `relative_attention_bias`, `ln_attn`, `ln_ff`, `wi_0`, `wi_1`,
`wo`; CLIP's `token_embedding`, `position_embedding`,
`layers_{i}/{q,k,v,out}_proj`, `fc1`, `fc2`, `layer_norm1`, `layer_norm2`,
`text_projection`), which carry by name as they are; so do CLIP's vision
tower (`class_embedding`, `position_embedding`, the `patch_embedding`
conv, `pre_layrnorm`, `layers_{i}`, `post_layernorm`, `visual_projection`)
and the image VAE encoders (TAESD's `conv_in`, `block_in`,
`stage_{s}_down`, `stage_{s}_block_{b}`, `conv_out`; the KL encoder's
`down_{i}_res_{j}`, `down_{i}_conv`, `mid_*`, `norm_out`, `conv_out`,
`quant_conv`), and the 3D VAE's encoder (`conv_in/conv`,
`down_{i}_res_{j}/{norm1,norm2}/gn`, `conv1/conv`, `conv2/conv`,
`shortcut`, the strided `down_{i}_conv/conv`, `mid_block_{1,2}`,
`norm_out/gn`, `conv_out/conv`, its kernels [kt, kh, kw, in, out] like the
decoder's). The probe's toy denoiser (`d0`..`d3`, `out`) carries by name
too. The JAX package stores it
either unrolled (`blocks_{i}/...`) or, under its default `scan_layers=True`,
as stacks with a leading [L] axis: PixArt's `blocks/...` holds every block;
SD3's `blocks_dual/...` (the SD3.5 dual-attention prefix) and `blocks/...`
hold blocks 0..N-2 in that order, and the last block stays unrolled as
`blocks_{N-1}/...` (`layer_stacks`). The check is strict: every key of the
module is filled and every given key is used. `jax_name` and `port_key` map
single names both ways, for the LoRA merge (`lora/adapter.py`). Under
tensor parallelism weights are carried whole into the one-process layout
and then cut for a rank (`parallel/tp.shard_params_tp`), so a JAX tree
and a tp world are fed the same parameters.

`train_state_from_jax` carries a whole training state of the JAX package
(`tdm_tpu.train.tdm.TrainState`) of PixArt, SD3, the SD1.5 UNet or the
CogVideoX 3D DiT: the student (full weights or LoRA factors), critic and
EMA trees and each optax state (AdamW, 8-bit Adam, under accumulation or
not), so a test can start the port's train step and the JAX one from one
state. It reads the JAX objects by
their attributes and nested mappings only; nothing of JAX is imported.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

_UNROLLED = re.compile(r"blocks_(\d+)")
# the JAX package's stacked layer trees, in block order
STACK_NAMES = ("blocks_dual", "blocks")

Stacks = Sequence[tuple[str, int, int]]  # (tree name, first block, end)


def layer_stacks(cfg) -> tuple[tuple[str, int, int], ...]:
    """The stacked layer trees the JAX package writes for a model config:
    PixArt under scan_layers: ('blocks', 0, L); SD3 (a config with
    `dual_attention_layers`) under scan_layers with L > 1: the dual prefix
    as 'blocks_dual', blocks up to L-1 as 'blocks', the last unrolled;
    nothing stacked otherwise (and for configs without layers)."""
    n = getattr(cfg, "num_layers", 0)
    if not getattr(cfg, "scan_layers", False):
        return ()
    if not hasattr(cfg, "dual_attention_layers"):
        return (("blocks", 0, n),)
    if n <= 1:
        return ()
    n_dual = min(len(cfg.dual_attention_layers), n - 1)
    return tuple((name, a, b) for name, a, b in
                 (("blocks_dual", 0, n_dual), ("blocks", n_dual, n - 1)) if b > a)


def _stacks_of(flat: Mapping[str, np.ndarray]) -> dict[str, int]:
    """First block of each stacked tree in a flat JAX param dict: the dual
    prefix starts at 0 and 'blocks' after it."""
    n_dual = next((np.shape(a)[0] for p, a in flat.items()
                   if p.split("/")[0] == "blocks_dual"), 0)
    return {"blocks_dual": 0, "blocks": n_dual}


def _leaf(prefix: list[str], rest: list[str], arr: np.ndarray) -> tuple[str, np.ndarray]:
    name = rest[-1]
    if name == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 5:  # a 3D conv: [kt, kh, kw, in, out] → [out, in, kt, kh, kw]
            arr = arr.transpose(4, 3, 0, 1, 2)
        else:
            raise ValueError(f"kernel {'/'.join(prefix + rest)} has rank {arr.ndim}")
        name = "weight"
    return ".".join(prefix + rest[:-1] + [name]), arr


def _entries(
    path: str, arr: np.ndarray, starts: Mapping[str, int]
) -> Iterator[tuple[str, np.ndarray]]:
    parts = path.split("/")
    if parts[0] in STACK_NAMES:  # stacked layers: leading [L] axis
        for i in range(arr.shape[0]):
            yield _leaf(["blocks", str(starts[parts[0]] + i)], parts[1:], arr[i])
        return
    m = _UNROLLED.fullmatch(parts[0])
    if m:
        yield _leaf(["blocks", m.group(1)], parts[1:], arr)
        return
    yield _leaf([], parts, arr)


def jax_name(key: str, stacks: Stacks) -> tuple[str, Optional[int]]:
    """A port state_dict key → (its flat JAX path, its index in a stacked
    tree or None), e.g. 'blocks.3.to_q.weight' → ('blocks/to_q/kernel', 3)
    under scan_layers, ('blocks_3/to_q/kernel', None) unrolled."""
    parts = key.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    if parts[0] != "blocks":
        return "/".join(parts), None
    i, rest = int(parts[1]), "/".join(parts[2:])
    for name, start, end in stacks:
        if start <= i < end:
            return f"{name}/{rest}", i - start
    return f"blocks_{i}/{rest}", None


def port_key(path: str, layer: Optional[int], stacks: Stacks) -> str:
    """The inverse of `jax_name`: a flat JAX path (and its index in a
    stacked tree) → the port's state_dict key."""
    parts = path.split("/")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    start = {name: a for name, a, _ in stacks}
    if parts[0] in start and layer is not None:
        return ".".join(["blocks", str(start[parts[0]] + layer)] + parts[1:])
    m = _UNROLLED.fullmatch(parts[0])
    if m and layer is None:
        return ".".join(["blocks", m.group(1)] + parts[1:])
    if layer is None and parts[0] not in STACK_NAMES:
        return ".".join(parts)
    raise KeyError(f"{path} (layer {layer}) is not in the layout {tuple(stacks)}")


def state_dict_from_jax(
    flat: Mapping[str, np.ndarray], module: nn.Module
) -> dict[str, torch.Tensor]:
    """Flat JAX params → a state_dict for `module` (PixArtTransformer2D,
    SD3Transformer2D, UNet2DCondition, CogVideoXTransformer3D, TAESDDecoder,
    TAESDEncoder, KLDecoder, KLEncoder, VAE3DDecoder, VAE3DEncoder,
    T5Encoder, CLIPTextEncoder, CLIPVisionEncoder or the distill probe's
    ToyLatentDenoiser), from the stacked
    or the unrolled layout. Raises KeyError naming every missing and
    unexpected key, and ValueError on a shape mismatch."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _carried(flat, module).items()}


def load_from_jax(flat: Mapping[str, np.ndarray], module: nn.Module) -> nn.Module:
    """`module.load_state_dict(state_dict_from_jax(flat, module))` with the
    layout changes made on the module's device: each array goes to the
    device as it lies in memory (a transposed kernel as a strided view, one
    copy of its bytes) and is cast and laid out there, so the host copies
    nothing (a 4.8 B-parameter T5 moves in seconds). The same checks; the
    same values."""
    arrays = _carried(flat, module)
    with torch.no_grad(), warnings.catch_warnings():
        # read-only arrays (a JAX tree's) are only read here
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        for key, dst in module.state_dict(keep_vars=True).items():
            dst.copy_(torch.from_numpy(arrays[key]).to(dst.device))
    return module


def _carried(flat: Mapping[str, np.ndarray], module: nn.Module) -> dict[str, np.ndarray]:
    """The carry's arrays (views where the layout allows) by `module`'s
    state_dict keys, checked against the module."""
    out: dict[str, np.ndarray] = {}
    starts = _stacks_of(flat)
    for path, arr in flat.items():
        for key, value in _entries(path, np.asarray(arr), starts):
            out[key] = value
    expected = module.state_dict()
    missing = sorted(set(expected) - set(out))
    unexpected = sorted(set(out) - set(expected))
    if missing or unexpected:
        raise KeyError(
            f"weight carry into {type(module).__name__}: missing keys "
            f"{missing}, unexpected keys {unexpected}"
        )
    for key, ref in expected.items():
        if tuple(out[key].shape) != tuple(ref.shape):
            raise ValueError(
                f"weight carry: {key} has shape {tuple(out[key].shape)}, the "
                f"module expects {tuple(ref.shape)}"
            )
    return out


def jax_layout(
    state_dict: Mapping[str, torch.Tensor],
    *,
    scan_layers: bool = True,
    stacks: Optional[Stacks] = None,
    dtype: torch.dtype = torch.float32,
) -> dict[str, np.ndarray]:
    """The inverse carry: a port state_dict → flat JAX params in `dtype`
    (fp32 by default; each tensor cast where it lies, so a half-precision
    export moves half the bytes), with the layer stack stacked as `stacks`
    says (`layer_stacks(cfg)`); without `stacks`, every block under
    'blocks' (scan_layers) or none."""
    if stacks is None:
        n = 1 + max((int(k.split(".")[1]) for k in state_dict
                     if k.startswith("blocks.")), default=-1)
        stacks = (("blocks", 0, n),) if scan_layers and n else ()
    flat: dict[str, np.ndarray] = {}
    stacked: dict[str, dict[int, np.ndarray]] = {}
    for key, t in state_dict.items():
        arr = t.detach().to(dtype).cpu().numpy()
        if key.endswith(".weight"):
            arr = {2: lambda a: a.T, 4: lambda a: a.transpose(2, 3, 1, 0),
                   5: lambda a: a.transpose(2, 3, 4, 1, 0)}[arr.ndim](arr)
        path, layer = jax_name(key, stacks)
        if layer is None:
            flat[path] = arr
        else:
            stacked.setdefault(path, {})[layer] = arr
    for path, layers in stacked.items():
        flat[path] = np.stack([layers[i] for i in sorted(layers)])
    return flat


def flatten_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested mapping of arrays → flat '/'-joined keys (the JAX package's
    param-file layout), each leaf a writable numpy copy; bfloat16 leaves
    widen exactly to float32."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            arr = np.array(v)
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            out[key] = arr
    return out


def _adam_state(opt_state: Any) -> Optional[Any]:
    """The first node of an optax state (nested tuples and named tuples)
    that carries Adam's `mu`, `nu` and `count`."""
    if all(hasattr(opt_state, a) for a in ("mu", "nu", "count")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for child in opt_state:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def _is_q8(leaf: Any) -> bool:
    """The JAX package's blockwise-int8 moment (`optim._Q8Moment`)."""
    return hasattr(leaf, "values") and hasattr(leaf, "scales") and not isinstance(leaf, Mapping)


def _q8_decoded(q: Any, shape: tuple) -> np.ndarray:
    """A JAX `_Q8Moment` → the fp32 array of `shape` it holds (its
    `_q8_dequantize`: sign·u²·scale per block of 256, u = code/127)."""
    u = np.asarray(q.values).reshape(-1, 256).astype(np.float32) / 127.0
    flat = (np.sign(u) * u**2 * np.asarray(q.scales, np.float32)[:, None]).reshape(-1)
    return flat[: int(np.prod(shape))].reshape(shape)


def _flat_moments(tree: Mapping, shapes: Mapping[str, tuple], prefix: str = "") -> dict:
    """A JAX moment tree → flat '/'-joined fp32 arrays: int8 leaves decoded
    to the shape of their parameter, bf16 ones widened."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flat_moments(v, shapes, key))
        elif _is_q8(v):
            out[key] = _q8_decoded(v, shapes[key])
        else:
            out[key] = np.array(v).astype(np.float32)
    return out


def train_state_from_jax(
    state: Any,
    module: nn.Module,
    *,
    device=None,
    mu_dtype: Optional[torch.dtype] = None,
    lora: bool = False,
    eight_bit: bool = False,
):
    """A JAX `TrainState` → the port's `train.tdm.TrainState` for `module`
    (the PixArt, SD3, SD1.5 or CogVideoX model whose parameter names the
    trees take; the stacked and unrolled layouts alike), on `device`. With
    `lora`, the student and EMA trees are a LoRA student's factors, carried
    as the flat '{module path}/a', '/b' dict of `lora.factors`.

    Params and moments become fp32 (AdamW's first moment in `mu_dtype` when
    given). The optimizer states keep their structure: AdamW's moments;
    with `eight_bit` (a state of the JAX package's `adam8bit`, whose leaves
    under its size gate are plain arrays, so that a tree of small leaves
    looks like AdamW's), the int8 moments decoded to fp32, carried, and
    quantized again over the port's own leaves (`optim.q8_pack`; the JAX
    package's blocks run over its [in, out] kernels, so this is exact for
    zero moments and within one code step otherwise); `optax.MultiSteps` as
    a `MultiStepsState` with its accumulated gradient. A state without Adam
    moments, or with int8 moments and no `eight_bit`, raises."""
    from tdm_tpu_torch.train import optim as topt, tdm

    def carried(flat, factors):
        if factors:
            sd = {k: torch.from_numpy(np.ascontiguousarray(flat[k])) for k in sorted(flat)}
        else:
            sd = state_dict_from_jax(flat, module)  # copies of JAX's buffers
        return {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}

    def role(params_tree, opt_state, factors):
        params = carried(flatten_tree(params_tree), factors)
        shapes = {k: np.shape(v) for k, v in flatten_tree(params_tree).items()}
        return params, opt(opt_state, params, shapes, factors)

    def opt(opt_state, params, shapes, factors):
        if all(hasattr(opt_state, a) for a in ("mini_step", "gradient_step",
                                               "inner_opt_state", "acc_grads")):
            return topt.MultiStepsState(
                mini_step=int(np.asarray(opt_state.mini_step)),
                gradient_step=int(np.asarray(opt_state.gradient_step)),
                inner=opt(opt_state.inner_opt_state, params, shapes, factors),
                acc=carried(flatten_tree(opt_state.acc_grads), factors),
            )
        adam = _adam_state(opt_state)
        if adam is None:
            raise ValueError("the JAX optimizer state holds no Adam mu/nu/count")
        if not eight_bit and any(_is_q8(leaf) for leaf in _leaves(adam.mu)):
            raise ValueError("the JAX optimizer state holds int8 moments: pass eight_bit=True")
        count = int(np.asarray(adam.count))
        mu = carried(_flat_moments(adam.mu, shapes), factors)
        nu = carried(_flat_moments(adam.nu, shapes), factors)
        if eight_bit:
            return topt.Adam8State(count=count, mu=topt.q8_pack(mu, params),
                                   nu=topt.q8_pack(nu, params))
        if mu_dtype is not None:
            mu = {k: v.to(mu_dtype) for k, v in mu.items()}
        return topt.AdamWState(count=count, mu=mu, nu=nu)

    student, student_opt = role(state.student, state.student_opt, lora)
    critic, critic_opt = role(state.critic, state.critic_opt, False)
    return tdm.TrainState(
        step=int(np.asarray(state.step)),
        student=student,
        student_opt=student_opt,
        critic=critic,
        critic_opt=critic_opt,
        ema=None if state.ema is None else carried(flatten_tree(state.ema), lora),
    )


def _leaves(tree: Any) -> Iterator[Any]:
    """The leaves of a nested mapping, an int8 moment counting as one."""
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
