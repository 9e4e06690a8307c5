"""Flat safetensors files in numpy: the reader and writer of the port.

A safetensors file is an 8-byte little-endian header length, a JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__"?},
then the raw little-endian buffer. This is the format the JAX package's
`io/params.py` writes with '/'-joined Flax paths as names; the port reads
and writes it itself so it needs no `safetensors` package. bfloat16 entries
(numpy has no such dtype) read as float32, exactly.
"""

from __future__ import annotations

import json
import struct
from typing import Iterable, Mapping, Sequence

import numpy as np

_TO_NUMPY = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
_FROM_NUMPY = {np.dtype(v): k for k, v in _TO_NUMPY.items()}


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
    need not fit in memory at once)."""
    header, offset = {}, 0
    for name, shape, dtype in entries:
        dtype = np.dtype(dtype)
        code = _FROM_NUMPY.get(dtype)
        if code is None:
            raise ValueError(f"unsupported dtype {dtype} for {name!r}")
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
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
            arr = np.asarray(arr, dtype=np.dtype(dtype).newbyteorder("<"))
            if arr.shape != tuple(shape):
                raise ValueError(f"{name!r} has shape {arr.shape}, its entry {tuple(shape)}")
            f.write(arr.tobytes())
