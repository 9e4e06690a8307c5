"""The device rule of every entry point: CUDA unless the caller asks for the
CPU, and a clear error instead of a quiet fall back to the CPU; and the fp32
precision rule: the server and the trainer set it themselves before they
build a model."""

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


def set_fp32_precision(allow_tf32: bool = False) -> None:
    """Full fp32 for cuBLAS products and cuDNN convolutions (TF32 off), or
    TF32 for both under `allow_tf32` (the trainer's --allow_tf32, which the
    reference turns on the same way). Set explicitly because PyTorch's own
    default runs cuDNN's fp32 convolutions, the VAE decoders', in TF32,
    where the JAX package's decoders compute in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
