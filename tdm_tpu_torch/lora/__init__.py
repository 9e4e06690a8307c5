"""LoRA adapters: low-rank factors merged into the denoiser's weights, with
kohya and diffusers/peft safetensors interchange."""

from tdm_tpu_torch.lora.adapter import (  # noqa: F401
    LoRA, default_target, extract_lora, factors, from_factors, init_lora, merge,
    wrap_denoise_fn,
)
from tdm_tpu_torch.lora.io import load_lora, save_kohya  # noqa: F401
