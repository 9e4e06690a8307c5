"""The weight carry: the JAX package's parameter trees ↔ the port's
`state_dict`s.

The JAX package stores parameters as a flat dict of arrays keyed by
'/'-joined Flax paths (`tdm_tpu/io/params.py`). The port's modules keep the
same names, so the carry is a rename plus two layout changes:
  * Dense `kernel` [in, out] → `weight` [out, in];
  * Conv `kernel` HWIO → `weight` OIHW;
and the PixArt layer stack, stored either stacked (`blocks/...` with a
leading [L] axis, the JAX default `scan_layers=True`) or unrolled
(`blocks_{i}/...`), becomes `blocks.{i}....`. The check is strict: every
key of the module is filled and every given key is used.
"""

from __future__ import annotations

import re
from typing import Iterator, Mapping

import numpy as np
import torch
from torch import nn

_UNROLLED = re.compile(r"blocks_(\d+)")


def _leaf(prefix: list[str], rest: list[str], arr: np.ndarray) -> tuple[str, np.ndarray]:
    name = rest[-1]
    if name == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel {'/'.join(prefix + rest)} has rank {arr.ndim}")
        name = "weight"
    return ".".join(prefix + rest[:-1] + [name]), arr


def _entries(path: str, arr: np.ndarray) -> Iterator[tuple[str, np.ndarray]]:
    parts = path.split("/")
    if parts[0] == "blocks":  # stacked layers: leading [L] axis
        for i in range(arr.shape[0]):
            yield _leaf(["blocks", str(i)], parts[1:], arr[i])
        return
    m = _UNROLLED.fullmatch(parts[0])
    if m:
        yield _leaf(["blocks", m.group(1)], parts[1:], arr)
        return
    yield _leaf([], parts, arr)


def state_dict_from_jax(
    flat: Mapping[str, np.ndarray], module: nn.Module
) -> dict[str, torch.Tensor]:
    """Flat JAX params → a state_dict for `module` (PixArtTransformer2D or
    TAESDDecoder). Raises KeyError naming every missing and unexpected key,
    and ValueError on a shape mismatch."""
    out: dict[str, np.ndarray] = {}
    for path, arr in flat.items():
        for key, value in _entries(path, np.asarray(arr)):
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
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def jax_layout(
    state_dict: Mapping[str, torch.Tensor], *, scan_layers: bool = True
) -> dict[str, np.ndarray]:
    """The inverse carry: a port state_dict → flat fp32 JAX params, with the
    layer stack stacked under 'blocks' (scan_layers) or unrolled as
    'blocks_{i}'."""
    flat: dict[str, np.ndarray] = {}
    stacked: dict[str, dict[int, np.ndarray]] = {}
    for key, t in state_dict.items():
        arr = t.detach().float().cpu().numpy()
        parts = key.split(".")
        if parts[-1] == "weight":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
            parts[-1] = "kernel"
        if parts[0] == "blocks":
            i, rest = int(parts[1]), "/".join(parts[2:])
            if scan_layers:
                stacked.setdefault(rest, {})[i] = arr
            else:
                flat[f"blocks_{i}/{rest}"] = arr
        else:
            flat["/".join(parts)] = arr
    for rest, layers in stacked.items():
        flat[f"blocks/{rest}"] = np.stack([layers[i] for i in sorted(layers)])
    return flat
