"""LoRA adapters as low-rank factors, merged into the weights.

Port of `tdm_tpu/lora/adapter.py`: the `LoRA` container, the default
targets, peft's initialization (`init_lora`), the merge behind
`set_adapters([...], [scale])` (the recipe's scale 0.125), the truncated-SVD
export of a finetune (`extract_lora`) and the LoRA student of training
(`wrap_denoise_fn`):

    W' = W + scale · (alpha / r) · (a @ b),  in fp32, cast back to W's dtype.

Factors keep the JAX package's layout and names, so a JAX adapter carries
across unchanged: an entry sits at the '/'-joined path of the kernel it
adapts (`blocks/to_q` for a stacked tree, `blocks_23/to_q` unrolled),
a [in, r] and b [r, out], with a leading [L] axis on a stacked tree. The
port's weights are [out, in] under `blocks.{i}`; `io/from_jax.port_key`
maps each entry (and each of its layers) to its weight, through the
model's `layer_stacks`. A training state holds the factors as one flat dict
(`factors`: '{path}/a', '{path}/b').
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from tdm_tpu_torch.io import from_jax

TARGETS = (
    "to_q", "to_k", "to_v", "to_out",
    "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out",
    "proj_in", "proj_out",
)


@dataclass
class LoRA:
    """One named adapter: {module path: {'a': [..., in, r], 'b': [..., r,
    out]}} plus each module's alpha (path → α; α = r when absent)."""

    params: dict
    alpha: tuple = ()  # ((path, α), ...)

    @property
    def alpha_map(self) -> dict:
        return dict(self.alpha)


def default_target(path: tuple, shape: tuple) -> bool:
    """Which kernels get adapters by default: the 2-D Dense kernels (3-D
    when stacked) of the attention and feed-forward projections, the
    to_q/to_k/to_v/to_out(+add_*) set of the released TDM LoRAs."""
    if len(shape) not in (2, 3):
        return False
    name = path[-1] if path else ""
    return any(t in name for t in TARGETS)


def jax_kernels(model: nn.Module) -> dict[str, tuple[tuple, list]]:
    """Every Dense kernel of `model` in the JAX package's layout: module
    path → (its JAX shape [(L,) in, out], [(port key, layer or None)])."""
    stacks = from_jax.layer_stacks(model.cfg)
    places: dict[str, list] = {}
    shapes: dict[str, tuple] = {}
    for key, w in model.state_dict().items():
        if key.endswith(".weight") and w.dim() == 2:
            path, layer = from_jax.jax_name(key, stacks)
            mpath = path.removesuffix("/kernel")
            places.setdefault(mpath, []).append((key, layer))
            shapes[mpath] = tuple(w.shape[::-1])  # [out, in] → [in, out]
    return {p: ((len(pl), *shapes[p]) if pl[0][1] is not None else shapes[p], pl)
            for p, pl in places.items()}


def init_lora(
    model: nn.Module,
    rank: int = 4,
    *,
    generator: Optional[torch.Generator] = None,
    target: Callable[[tuple, tuple], bool] = default_target,
    alpha: Optional[float] = None,
    dtype: torch.dtype = torch.float32,
) -> LoRA:
    """A fresh adapter over every matching kernel: a ~ U(±1/sqrt(in)), b = 0
    (peft's initialization: the delta starts at zero). The factors are drawn
    on the CPU from `generator` (seeded with 0 when None)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    entries, alphas = {}, []
    for mpath, (shape, _) in sorted(jax_kernels(model).items()):
        if not target(tuple(mpath.split("/")), shape):
            continue
        *layers, d_in, d_out = shape
        bound = 1.0 / math.sqrt(d_in)
        a = (torch.rand(*layers, d_in, rank, generator=gen) * 2 - 1) * bound
        entries[mpath] = {"a": a.to(dtype),
                          "b": torch.zeros(*layers, rank, d_out, dtype=dtype)}
        alphas.append((mpath, float(alpha if alpha is not None else rank)))
    return LoRA(params=entries, alpha=tuple(alphas))


def adapted_keys(lora: LoRA, stacks) -> dict[str, tuple[str, Optional[int]]]:
    """port weight key → (the LoRA entry's path, its layer) for every weight
    the adapter changes."""
    out = {}
    for mpath, entry in lora.params.items():
        layers = [None] if entry["a"].dim() == 2 else range(entry["a"].shape[0])
        for layer in layers:
            try:
                key = from_jax.port_key(f"{mpath}/kernel", layer, stacks)
            except KeyError:
                raise KeyError(f"LoRA entry {mpath} has no matching kernel") from None
            out[key] = (mpath, layer)
    return out


def factors(lora: LoRA) -> dict[str, torch.Tensor]:
    """The adapter's factors as one flat dict, '{module path}/a' and '/b'."""
    return {f"{mpath}/{w}": entry[w] for mpath, entry in sorted(lora.params.items())
            for w in ("a", "b")}


def from_factors(flat: Mapping[str, torch.Tensor], alpha: tuple) -> LoRA:
    """The inverse of `factors`, with the adapter's alphas."""
    params: dict = {}
    for key, t in flat.items():
        mpath, w = key.rsplit("/", 1)
        params.setdefault(mpath, {})[w] = t
    return LoRA(params=params, alpha=alpha)


def _merge(weights: Mapping[str, torch.Tensor], lora: LoRA, scale: float, stacks, cut=None):
    """The merge's arithmetic: one (batched) a@b per entry on the weights'
    device, its layers split off by `unbind` (whose backward stacks the
    layers' gradients once). `cut(key, delta)`, under tensor parallelism,
    turns a whole weight's delta into this rank's slice of it
    (`parallel/tp.lora_cutter`): the LoRA is merged into the whole weight,
    then cut."""
    out = dict(weights)
    places: dict[str, list] = {}
    for key, (mpath, layer) in adapted_keys(lora, stacks).items():
        if key not in out:
            raise KeyError(f"LoRA entry {mpath} has no matching kernel ({key})")
        places.setdefault(mpath, []).append((key, layer))
    alpha = lora.alpha_map
    for mpath, keys in places.items():
        a, b = lora.params[mpath]["a"], lora.params[mpath]["b"]
        dev = out[keys[0][0]].device
        r = a.shape[-1]
        eff = scale * alpha.get(mpath, float(r)) / r
        delta = (eff * (a.to(dev, torch.float32) @ b.to(dev, torch.float32))).transpose(-1, -2)
        per_layer = {None: delta} if a.dim() == 2 else dict(enumerate(delta.unbind(0)))
        for key, layer in keys:
            w, d = out[key], per_layer[layer]
            if cut is not None:
                d = cut(key, d)
            out[key] = (w.float() + d).to(w.dtype)
    return out


@torch.no_grad()
def merge(
    weights: Mapping[str, torch.Tensor], lora: LoRA, scale: float, stacks, cut=None
) -> dict[str, torch.Tensor]:
    """`weights` (port state_dict names) with every adapted weight replaced
    by W + scale·(α/r)·(a@b)ᵀ, computed in fp32 on the weight's device and
    cast to its dtype; the others are passed through. A LoRA entry with no
    weight in `weights` raises KeyError. `cut`: a tp rank's slices
    (`_merge`)."""
    return _merge(weights, lora, scale, stacks, cut)


@torch.no_grad()
def extract_lora(
    model: nn.Module,
    base: Mapping[str, torch.Tensor],
    tuned: Mapping[str, torch.Tensor],
    rank: int = 32,
) -> LoRA:
    """A full-weight finetune distilled into a LoRA by truncated SVD of each
    target kernel's delta, ΔW ≈ (U√S)(√S Vᵀ), with alpha = r (the JAX
    package's `extract_lora`, the form the reference releases its students
    in). `base` and `tuned` are state dicts of `model`; the SVD runs in fp32
    on their device, batched over the layers of a stacked kernel. Returns
    factors in the JAX package's layout (a [.., in, r], b [.., r, out])."""
    entries, alphas = {}, []
    for mpath, (shape, places) in sorted(jax_kernels(model).items()):
        if not default_target(tuple(mpath.split("/")), shape):
            continue
        places = sorted(places, key=lambda kl: -1 if kl[1] is None else kl[1])
        delta = torch.stack([(tuned[k].float() - base[k].float()).T for k, _ in places])
        r = min(rank, delta.shape[-2], delta.shape[-1])
        u, s, vt = torch.linalg.svd(delta, full_matrices=False)
        sq = torch.sqrt(s[..., :r])
        a = u[..., :, :r] * sq[..., None, :]  # [n, in, r]
        b = sq[..., :, None] * vt[..., :r, :]  # [n, r, out]
        if places[0][1] is None:
            a, b = a[0], b[0]
        entries[mpath] = {"a": a, "b": b}
        alphas.append((mpath, float(r)))
    return LoRA(params=entries, alpha=tuple(alphas))


class LoRADenoiseFn:
    """The LoRA student's forward, `fn(factors, x, t, cond, base)`: the flat
    factors (`factors`) merged into the frozen `base` weights, then
    `denoise_fn` (the JAX package's `wrap_denoise_fn`). Gradients reach the
    factors and never the base. `merge(factors, base)` gives the merged
    weights alone, so a caller can merge once and run several forwards."""

    def __init__(self, denoise_fn: Callable, lora_template: LoRA, stacks, cut=None):
        self.denoise_fn = denoise_fn
        self.alpha = lora_template.alpha
        self.stacks = stacks
        self.cut = cut

    def merge(self, flat: Mapping[str, torch.Tensor], base: Mapping[str, torch.Tensor]):
        frozen = {k: v.detach() for k, v in base.items()}
        return _merge(frozen, from_factors(flat, self.alpha), 1.0, self.stacks, self.cut)

    def __call__(self, flat, x, t, cond, base):
        return self.denoise_fn(self.merge(flat, base), x, t, cond)


def wrap_denoise_fn(denoise_fn: Callable, lora_template: LoRA, *, stacks,
                    cut=None) -> LoRADenoiseFn:
    """The LoRA-training adapter of `denoise_fn(params, x, t, cond)` over a
    model whose `layer_stacks` are `stacks`; `train.tdm.build_train_step`
    takes it as `student_denoise_fn` and threads its teacher through as the
    base. Under tensor parallelism `cut` gives a rank's slices of each
    merged delta (`parallel/tp.lora_cutter`); the factors stay whole."""
    return LoRADenoiseFn(denoise_fn, lora_template, stacks, cut)
