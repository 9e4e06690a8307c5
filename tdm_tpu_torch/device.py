"""The device rule of every entry point: CUDA unless the caller asks for the
CPU, and a clear error instead of a quiet fall back to the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device` or, when None, the CUDA device. Raises RuntimeError when a
    CUDA device is asked for (explicitly or by default) and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tdm_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or --device cpu) to run on the CPU"
        )
    return dev
