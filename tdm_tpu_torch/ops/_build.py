"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles with `nvcc` into a shared library with a
plain C interface (`build/tdm_tpu_torch/lib<name>-<hash>.so`, keyed by the
hash of the source, of the shared headers `csrc/*.cuh` and of the flags, so
an edited source or header rebuilds and an unchanged one loads at once). No PyTorch headers are compiled in: the wrapper passes
raw pointers and the current stream as integers. The target is Hopper,
`sm_90a`. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tdm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": wall time of its nvcc, "ptxas": registers/smem report}
build_log: dict[str, dict] = {}


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put it on PATH): the port's CUDA "
        "kernels are compiled from tdm_tpu_torch/csrc at first use"
    )


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compile every named kernel that is not built yet, one `nvcc` per
    source, all started together. Raises with the compiler's output if any
    build fails."""
    out = {n: _library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.monotonic()
    for n in todo:
        tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{log}")
            continue
        os.replace(tmp, out[n])
        build_log[n] = {"seconds": time.monotonic() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
