"""tdm_tpu_torch — the PyTorch/CUDA port of tdm_tpu.

A second package beside `tdm_tpu` (which stays the JAX reference). It keeps
the JAX package's module layout so each module's counterpart is easy to
find; every TPU kernel on a ported path is a CUDA kernel written by hand for
Hopper (`csrc/`). Ported so far: serving PixArt-α-512, SD3-Medium,
SD1.5/Dreamshaper and CogVideoX-2B (49-frame videos as GIFs) at 4 NFE over
HTTP (`python -m tdm_tpu_torch.serve.server`), and TDM distillation of
PixArt-α-512, SD3-Medium and SD1.5 (`python -m tdm_tpu_torch.cli.train_tdm`).
Entry points run on the CUDA device unless the caller passes `device="cpu"`.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # imported on first use, so that a host-only entry point (the checkpoint
    # converter's --src/--dst and --reverse) starts without importing torch
    if name == "resolve_device":
        from tdm_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
