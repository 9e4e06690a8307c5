"""LoRA adapters as low-rank factors, merged into the weights.

Port of `tdm_tpu/lora/adapter.py` for serving: the `LoRA` container, the
default targets, peft's initialization (`init_lora`) and the merge behind
`set_adapters([...], [scale])` (the recipe's scale 0.125):

    W' = W + scale · (alpha / r) · (a @ b),  in fp32, cast back to W's dtype.

Factors keep the JAX package's layout and names, so a JAX adapter carries
across unchanged: an entry sits at the '/'-joined path of the kernel it
adapts (`blocks/to_q` for a stacked tree, `blocks_23/to_q` unrolled),
a [in, r] and b [r, out], with a leading [L] axis on a stacked tree. The
port's weights are [out, in] under `blocks.{i}`; `io/from_jax.port_key`
maps each entry (and each of its layers) to its weight, through the
model's `layer_stacks`.
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


@torch.no_grad()
def merge(
    weights: Mapping[str, torch.Tensor], lora: LoRA, scale: float, stacks
) -> dict[str, torch.Tensor]:
    """`weights` (port state_dict names) with every adapted weight replaced
    by W + scale·(α/r)·(a@b)ᵀ, computed in fp32 on the weight's device and
    cast to its dtype; the others are passed through. A LoRA entry with no
    weight in `weights` raises KeyError."""
    out = dict(weights)
    alpha = lora.alpha_map
    for key, (mpath, layer) in adapted_keys(lora, stacks).items():
        if key not in out:
            raise KeyError(f"LoRA entry {mpath} has no matching kernel ({key})")
        w = out[key]
        a, b = lora.params[mpath]["a"], lora.params[mpath]["b"]
        if layer is not None:
            a, b = a[layer], b[layer]
        r = a.shape[-1]
        eff = scale * alpha.get(mpath, float(r)) / r
        delta = a.to(w.device, torch.float32) @ b.to(w.device, torch.float32)  # [in, out]
        out[key] = (w.float() + eff * delta.T).to(w.dtype)
    return out
