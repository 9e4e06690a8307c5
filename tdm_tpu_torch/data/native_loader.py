"""ctypes bindings of the port's native C++ prompt loader (`csrc/dataloader.cc`).

Port of `tdm_tpu/data/native_loader.py`: one mmap of the prompt shard, a
background C++ thread keeping a ring of shuffled batches full, no Python
work per prompt. `NativePromptLoader` keeps the `PromptBatcher` iterator
contract, so the training CLI takes either. The library is built with
`g++ -O2 -std=c++17 -shared -fPIC -pthread` at first use into the
repository's `build/tdm_tpu_torch/` (beside the CUDA kernels), keyed by the
hash of the source and the flags; nothing is built when the module is
imported. Where no compiler is found, `unavailable_reason()` says why and
the CLI keeps the Python batcher, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from tdm_tpu_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "dataloader.cc"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
# batches the C++ thread keeps ready, and the bytes one batch's prompts may take
QUEUE_DEPTH, BATCH_BUF_BYTES = 4, 1 << 20

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdataloader-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the loader unless it is built; RuntimeError naming the reason
    when no g++ is found or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ on PATH to build csrc/dataloader.cc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on csrc/dataloader.cc:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.ldr_create.restype = ctypes.c_void_p
            lib.ldr_create.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.ldr_next.restype = ctypes.c_int
            lib.ldr_next.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ]
            lib.ldr_num_prompts.restype = ctypes.c_int64
            lib.ldr_num_prompts.argtypes = [ctypes.c_void_p]
            lib.ldr_destroy.restype = None
            lib.ldr_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def unavailable_reason() -> Optional[str]:
    """None when the loader builds and loads, else why it does not."""
    try:
        _get_lib()
    except (RuntimeError, OSError) as e:
        return str(e)
    return None


class NativePromptLoader:
    """Iterator of dict(prompts=[...], input_ids?, attention_mask?) batches
    from a .txt / .jsonl prompt shard, forever, reshuffled each epoch; the
    `PromptBatcher` contract. `close()` stops the C++ thread."""

    def __init__(
        self,
        path: str,
        batch_size: int,
        *,
        caption_column: str = "prompt",
        tokenizer=None,
        max_length: int = 120,
        seed: int = 0,
        host_index: int = 0,
        host_count: int = 1,
    ):
        lib = _get_lib()
        self._lib = lib
        self._h = lib.ldr_create(
            path.encode(), caption_column.encode(), batch_size,
            seed, host_index, host_count, QUEUE_DEPTH,
        )
        if not self._h:
            raise ValueError(
                f"native loader failed on {path!r} (missing file, empty shard, or "
                f"shard smaller than batch_size={batch_size})"
            )
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.max_length = max_length
        self._buf = ctypes.create_string_buffer(BATCH_BUF_BYTES)
        self._offsets = (ctypes.c_int64 * (batch_size + 1))()

    @property
    def num_prompts(self) -> int:
        return int(self._lib.ldr_num_prompts(self._h))

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        n = self._lib.ldr_next(self._h, self._buf, len(self._buf), self._offsets,
                               self.batch_size)
        if n == -2:
            raise RuntimeError("native loader: batch larger than its buffer")
        if n < 0:
            raise StopIteration
        offs = list(self._offsets[: n + 1])
        raw = ctypes.string_at(self._buf, offs[n])  # this batch's bytes, not the whole buffer
        prompts = [raw[offs[i]:offs[i + 1]].decode("utf-8", "replace") for i in range(n)]
        out = {"prompts": prompts}
        if self.tokenizer is not None:
            ids, mask = self.tokenizer(prompts, max_length=self.max_length)
            out["input_ids"] = np.asarray(ids)
            out["attention_mask"] = np.asarray(mask)
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ldr_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
