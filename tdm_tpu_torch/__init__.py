"""tdm_tpu_torch — the PyTorch/CUDA port of tdm_tpu.

A second package beside `tdm_tpu` (which stays the JAX reference). It keeps
the JAX package's module layout so each module's counterpart is easy to
find; every TPU kernel on a ported path is a CUDA kernel written by hand for
Hopper (`csrc/`). Ported so far: serving the PixArt-α-512 4-NFE TDM student
over HTTP (`python -m tdm_tpu_torch.serve.server`) and TDM distillation of
PixArt-α-512 (`python -m tdm_tpu_torch.cli.train_tdm`). Entry points run on
the CUDA device unless the caller passes `device="cpu"`.
"""

from tdm_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
