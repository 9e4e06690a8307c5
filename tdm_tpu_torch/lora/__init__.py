"""LoRA adapters: low-rank factors merged into the denoiser's weights, with
kohya and diffusers/peft safetensors interchange."""

from tdm_tpu_torch.lora.adapter import LoRA, default_target, init_lora, merge  # noqa: F401
from tdm_tpu_torch.lora.io import load_lora, save_kohya  # noqa: F401
