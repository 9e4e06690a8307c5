"""Safetensors files in numpy: the reader and writer of the port, and the
param-tree files of the JAX package's `io/params.py`.

A safetensors file is an 8-byte little-endian header length, a JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__"?},
then the raw little-endian buffer. The JAX package writes model weights in
it with '/'-joined Flax paths as names (`save_params`/`load_params` here
write and read that layout as nested dicts); the port reads and writes it
itself, so it needs no `safetensors` package. numpy has no bfloat16: BF16
entries read as float32, exactly, and are written (`BFLOAT16`) from
float32 by round-to-nearest-even, as `ml_dtypes` casts.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Iterable, Mapping, Optional, Sequence, Union

import numpy as np

_TO_NUMPY = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
_FROM_NUMPY = {np.dtype(v): k for k, v in _TO_NUMPY.items()}
# the dtype name of a BF16 entry (numpy has none) in `write_file`'s entries
BFLOAT16 = "bfloat16"


def bfloat16_bits(x: np.ndarray) -> np.ndarray:
    """float32 values → the uint16 bits of their bfloat16 rounding, to
    nearest with ties to even (a NaN becomes the quiet NaN of its sign, as
    Eigen's and ml_dtypes' conversion gives)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.where(bits >> 31, np.uint16(0xFFC0), np.uint16(0x7FC0))
    return np.where(np.isnan(x), nan, rounded).astype(np.uint16)


def load_file(path: str) -> dict[str, np.ndarray]:
    """name → array for every tensor of a safetensors file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            # bf16 is the top half of an fp32: widen exactly
            bits = raw.view("<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
            continue
        dt = _TO_NUMPY.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: unsupported dtype {info['dtype']} for {name!r}")
        out[name] = raw.view(np.dtype(dt).newbyteorder("<")).reshape(shape)
    return out


def save_file(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write name → array as one safetensors file (names sorted, as the
    safetensors package writes them)."""
    arrays = [(name, np.ascontiguousarray(tensors[name])) for name in sorted(tensors)]
    write_file(path, [(name, a.shape, a.dtype) for name, a in arrays],
               (a for _, a in arrays))


def write_file(
    path: str,
    entries: Sequence[tuple[str, tuple, np.dtype]],
    leaves: Iterable[np.ndarray],
) -> None:
    """Write a safetensors file whose header is known before its data:
    `entries` lists (name, shape, dtype) in the order `leaves` yields the
    arrays, each cast to its entry's dtype and written as it comes (a file
    need not fit in memory at once); the dtype `BFLOAT16` writes a float
    leaf rounded to bfloat16 (`bfloat16_bits`)."""
    header, offset = {}, 0
    for name, shape, dtype in entries:
        if dtype == BFLOAT16:
            code, itemsize = "BF16", 2
        else:
            dtype = np.dtype(dtype)
            code, itemsize = _FROM_NUMPY.get(dtype), dtype.itemsize
        if code is None:
            raise ValueError(f"unsupported dtype {dtype} for {name!r}")
        n = int(np.prod(shape, dtype=np.int64)) * itemsize
        header[name] = {"dtype": code, "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # pad the header to 8-byte alignment
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for (name, shape, dtype), arr in zip(entries, leaves, strict=True):
            # asarray keeps a 0-d leaf 0-d (a CLIPModel's logit_scale);
            # tobytes writes C order whatever the strides
            if dtype == BFLOAT16:
                arr = bfloat16_bits(np.asarray(arr)).astype("<u2")
            else:
                arr = np.asarray(arr, dtype=np.dtype(dtype).newbyteorder("<"))
            if arr.shape != tuple(shape):
                raise ValueError(f"{name!r} has shape {arr.shape}, its entry {tuple(shape)}")
            f.write(arr.tobytes())


def _numpy(leaf: Any) -> np.ndarray:
    """A leaf (numpy array, torch tensor, scalar) as a numpy array; a
    bfloat16 tensor widens to float32, exactly."""
    if hasattr(leaf, "detach"):  # a torch tensor
        leaf = leaf.detach().cpu()
        if str(leaf.dtype) == "torch.bfloat16":
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = _numpy(v)
    return out


def _dtype_name(dtype) -> str:
    """A numpy, torch or string dtype → its name ('float16', 'bfloat16', …)."""
    name = str(dtype).removeprefix("torch.")
    return name if name == BFLOAT16 else np.dtype(name).name


def save_params(params: Mapping, path: str, *, dtype=None) -> None:
    """A nested tree of arrays or tensors → one safetensors file of
    '/'-joined keys (the JAX package's `save_params` layout), float leaves
    cast to `dtype` when given (a numpy or torch dtype or its name;
    'bfloat16' rounds to nearest even and writes BF16 entries)."""
    flat = _flatten(params)
    name = None if dtype is None else _dtype_name(dtype)

    def entry_dtype(a: np.ndarray):
        if name is None or not np.issubdtype(a.dtype, np.floating):
            return a.dtype
        return BFLOAT16 if name == BFLOAT16 else np.dtype(name)

    keys = sorted(flat)
    write_file(path, [(k, flat[k].shape, entry_dtype(flat[k])) for k in keys],
               (flat[k] for k in keys))


def load_params(
    path: str,
    *,
    to_torch: bool = False,
    device: Optional[Union[str, "torch.device"]] = None,  # noqa: F821
) -> dict:
    """A param file → the nested tree of its '/'-joined keys: numpy arrays
    (BF16 entries widened to float32), or with `to_torch` tensors on
    `device` (default the CUDA device; the JAX package's `to_jnp`)."""
    flat = load_file(path)
    if to_torch:
        import torch

        from tdm_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        flat = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in flat.items()}
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
