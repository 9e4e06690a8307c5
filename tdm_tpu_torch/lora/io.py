"""LoRA safetensors interchange: the kohya-ss and diffusers/peft formats.

Port of `tdm_tpu/lora/io.py`, on the port's own numpy safetensors reader and
writer (`io/params.py`). On file, torch's layout: `lora_down.weight` /
`lora_A.weight` [r, in], `lora_up.weight` / `lora_B.weight` [out, r] and a
per-module `.alpha`; in memory, the JAX package's a [in, r], b [r, out]
(`lora/adapter.py`), transposed here, once.

Keys: kohya flattens a module path with underscores
(`lora_unet_blocks_23_to_q`), which is ambiguous without the model (module
names like `blocks_23` hold underscores themselves), so `load_lora` resolves
it against the model's kernels in the JAX package's layout
(`resolution_map`). A stacked tree takes one key per layer
(`blocks_3_to_q` → `blocks/to_q`, layer 3, as `save_kohya` writes them); a
dotted peft path (`transformer.blocks_3.to_q`) is resolved the same way.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from tdm_tpu_torch.io import params as params_io
from tdm_tpu_torch.lora.adapter import LoRA, jax_kernels


def default_to_file_key(path: str, prefix: str) -> str:
    """'blocks_0/to_q' → 'lora_unet_blocks_0_to_q' (kohya's underscore
    flattening; the caller appends '.lora_down.weight' and the like)."""
    return f"{prefix}_{path.replace('/', '_')}" if prefix else path.replace("/", "_")


def save_kohya(
    lora: LoRA,
    path: str,
    *,
    prefix: str = "lora_unet",
    dtype=np.float16,
    to_file_key: Callable[[str, str], str] = default_to_file_key,
) -> None:
    """Write a kohya-ss safetensors file; a stacked entry is written one
    key per layer (`{tree}_{i}_...`), as torch tooling expects."""
    tensors: dict[str, np.ndarray] = {}
    alpha_map = lora.alpha_map
    for mpath, entry in sorted(lora.params.items()):
        a = entry["a"].detach().cpu().float().numpy().astype(dtype)
        b = entry["b"].detach().cpu().float().numpy().astype(dtype)
        alpha = np.asarray(alpha_map.get(mpath, float(a.shape[-1])), dtype=dtype)
        parts = mpath.split("/")
        per_layer = (
            [(f"{parts[0]}_{i}/" + "/".join(parts[1:]), a[i], b[i]) for i in range(a.shape[0])]
            if a.ndim == 3 else [(mpath, a, b)]
        )
        for p, a_l, b_l in per_layer:
            key = to_file_key(p, prefix)
            tensors[f"{key}.lora_down.weight"] = np.ascontiguousarray(a_l.T)
            tensors[f"{key}.lora_up.weight"] = np.ascontiguousarray(b_l.T)
            tensors[f"{key}.alpha"] = alpha
    params_io.save_file(tensors, path)


_PEFT_RE = re.compile(r"^(.*?)\.?lora_(A|B)(?:\.[^.]+)?\.weight$")
_KOHYA_RE = re.compile(r"^(.*)\.lora_(down|up)\.weight$")
_PREFIXES = ("lora_unet_", "lora_transformer_", "lora_te_",
             "base_model/model/", "transformer/", "unet/")


def _detect_and_split(key: str) -> Optional[tuple[str, str]]:
    """→ (module key, 'a' | 'b'), or None for other keys (alpha)."""
    m = _KOHYA_RE.match(key)
    if m:
        return m.group(1), ("a" if m.group(2) == "down" else "b")
    m = _PEFT_RE.match(key)
    if m:
        return m.group(1), ("a" if m.group(2) == "A" else "b")
    return None


def default_from_file_key(module_key: str) -> str:
    """A file's module key → a '/'-joined path with the common family
    prefix stripped (dotted peft paths and kohya underscore paths)."""
    key = module_key.replace(".", "/")
    for pre in _PREFIXES:
        if key.startswith(pre):
            return key[len(pre):]
    return key


def resolution_map(model: nn.Module) -> dict[str, tuple[str, Optional[int]]]:
    """{underscore-flattened module path: (JAX path, layer or None)} for
    every Dense kernel of `model` in the JAX package's layout: a stacked
    kernel registers one entry per layer (`blocks_3_to_q` → ('blocks/to_q',
    3)), an unrolled one its own (`blocks_23_to_q` → ('blocks_23/to_q',
    None))."""
    out = {}
    for mpath, (_, places) in jax_kernels(model).items():
        parts = mpath.split("/")
        for _, layer in places:
            if layer is None:
                out[mpath.replace("/", "_")] = (mpath, None)
            else:
                out["_".join([f"{parts[0]}_{layer}"] + parts[1:])] = (mpath, layer)
    return out


def load_lora(
    path: str,
    *,
    model: Optional[nn.Module] = None,
    from_file_key: Callable[[str], str] = default_from_file_key,
) -> LoRA:
    """Read a kohya or peft/diffusers safetensors LoRA (the
    `load_lora_weights` of the recipe) into fp32 factors on the CPU. With
    `model`, module keys are resolved against its kernels; a stacked
    kernel's per-layer keys stack into [L, ...] factors, and a gap in the
    layers raises."""
    tensors = params_io.load_file(path)
    resolve = resolution_map(model) if model is not None else {}

    def locate(mkey: str) -> tuple[str, Optional[int]]:
        return resolve.get(mkey.replace("/", "_"), (mkey, None))

    entries: dict[str, dict] = {}
    alphas: dict[str, float] = {}
    for key, value in tensors.items():
        split = _detect_and_split(key)
        if split is None:
            if key.endswith(".alpha"):
                p, _ = locate(from_file_key(key[: -len(".alpha")]))
                alphas[p] = float(np.asarray(value).reshape(-1)[0])
            continue
        module_key, which = split
        p, layer = locate(from_file_key(module_key))
        entry = entries.setdefault(p, {"a": {}, "b": {}})
        # torch layout [r, in] / [out, r] → a [in, r], b [r, out]
        entry[which][layer] = torch.from_numpy(np.asarray(value, np.float32).T.copy())
    params = {}
    for p, entry in entries.items():
        for which in ("a", "b"):
            layers = entry[which]
            if not layers:
                raise ValueError(f"LoRA file {path}: missing factor {which} at {p}")
            if None in layers:
                entry[which] = layers[None]
                continue
            idx = sorted(layers)
            if idx != list(range(idx[-1] + 1)):
                missing = sorted(set(range(idx[-1] + 1)) - set(idx))
                raise ValueError(
                    f"LoRA file {path}: non-contiguous layer indices for "
                    f"{p}.{which}: missing layers {missing}"
                )
            entry[which] = torch.stack([layers[i] for i in idx])
        params[p] = entry
    alpha = tuple((p, alphas.get(p, float(params[p]["a"].shape[-1]))) for p in sorted(params))
    return LoRA(params=params, alpha=alpha)
