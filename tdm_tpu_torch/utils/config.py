"""Training configuration: the argparse surface of the training CLI.

Port of `tdm_tpu/utils/config.py`'s `TrainConfig` and `parse_args`: the same
flag names and defaults (the reference's `src/args.py:20-339` plus the JAX
package's extensions), so a launch command of the JAX CLI parses here too.
One flag is the port's own: `--device` (CUDA unless `cpu` is given; under
a world of processes each one's `cuda:LOCAL_RANK`). Flags whose path is not
ported yet (--pp) are accepted by the parser and refused by the
CLI before the first step (`cli/train_tdm.py`); `--compilation_cache`
configures XLA and is accepted and ignored. The JAX-only helpers
(`apply_platform_env`, `enable_compilation_cache`) are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class TrainConfig:
    # model / data (src/args.py:24-66)
    pretrained_model_name_or_path: str = "PixArt-alpha/PixArt-XL-2-512x512"
    revision: Optional[str] = None
    variant: Optional[str] = None
    dataset_name: Optional[str] = "JourneyDB/JourneyDB"
    dataset_config_name: Optional[str] = None
    train_data_dir: Optional[str] = None
    image_column: str = "image"
    caption_column: str = "prompt"
    max_train_samples: Optional[int] = None
    cache_dir: Optional[str] = None

    # image geometry (image-free training; parity only), video frames
    resolution: int = 512
    center_crop: bool = False
    random_flip: bool = False
    num_frames: int = 0

    # core loop (src/args.py:120-160)
    output_dir: str = "tdm-output"
    seed: Optional[int] = None
    train_batch_size: int = 4
    num_train_epochs: int = 100
    max_train_steps: Optional[int] = 10001
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = False

    # optimizer / LR (src/args.py:161-231)
    learning_rate: float = 2e-5
    scale_lr: bool = False
    lr_scheduler: str = "cosine_with_restarts"
    lr_warmup_steps: int = 50
    snr_gamma: Optional[float] = None  # parsed but unused, as in the reference
    use_8bit_adam: bool = False
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    use_ema: bool = False
    non_ema_revision: Optional[str] = None

    # precision / memory (src/args.py:232-242,277-279): the denoiser's
    # compute dtype ('bf16' default, 'no'/'fp32' = fp32, 'fp16' refused)
    mixed_precision: Optional[str] = "bf16"
    enable_xformers_memory_efficient_attention: bool = False  # the flash kernels always run
    allow_tf32: bool = False
    dataloader_num_workers: int = 0
    local_rank: int = -1

    # logging / hub (src/args.py:243-252,94-119)
    logging_dir: str = "logs"
    report_to: str = "tensorboard"
    tracker_project_name: str = "tdm-tpu"
    push_to_hub: bool = False
    hub_token: Optional[str] = None
    hub_model_id: Optional[str] = None

    # checkpointing (src/args.py:253-276)
    checkpointing_steps: int = 500
    checkpoints_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None

    # validation (src/args.py:280-301)
    validation_prompts: tuple = (
        "a photo of a cat",
        "a photo of a dog",
        "a photo of a panda",
        "a photo of a pikachu",
    )
    validation_epochs: int = 5
    validation_steps: int = 50
    prediction_type: Optional[str] = None

    # the JAX package's mesh and parallelism extensions: --fsdp, --ep,
    # --moe_experts, --tp and --sp are ported (parallel/mesh.py,
    # models/moe.py, parallel/tp.py, models/cogvideox.py); --pp waits for
    # slice 6
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    pp_microbatches: int = 0
    ep: int = 1
    sp: int = 1
    moe_experts: int = 0
    moe_top_k: int = 2
    max_devices: int = 0

    # TDM-specific (src/args.py:302-328)
    cfg: float = 4.5
    total_steps: int = 900
    num_steps: int = 4
    use_huber: bool = False
    use_separate: bool = False
    use_reg: bool = False
    noise_offset: float = 0.0
    loss_mode: str = "dmd"  # 'dmd' | 'instruct'
    model_family: str = "pixart"
    critic_updates: int = 1
    quant_forwards: bool = False
    allow_pooled_standin: bool = False
    # rank of the kohya-LoRA artifact extracted at the end (0 = skip)
    export_lora_rank: int = 32
    train_lora_rank: int = 0
    debug_nans: bool = False
    profile_steps: int = 0
    compilation_cache: str = "auto"  # XLA's; accepted and ignored here

    # the port's own: the device every tensor lives on (None = CUDA)
    device: Optional[str] = None

    def resolved_output_dir(self) -> str:
        """output_dir + _cfg{cfg}_steps{total_steps}[_Reg][_Huber], as the
        reference derives it (`src/main.py:75-79`)."""
        d = f"{self.output_dir}_cfg{self.cfg}_steps{self.total_steps}"
        if self.use_reg:
            d += "_Reg"
        if self.use_huber:
            d += "_Huber"
        return d

    def effective_lr(self, n_devices: int) -> float:
        """--scale_lr semantics (`src/main.py:200-203`)."""
        if not self.scale_lr:
            return self.learning_rate
        return (
            self.learning_rate
            * self.gradient_accumulation_steps
            * self.train_batch_size
            * n_devices
        )


_NONE_TYPES = {
    "max_train_samples": int, "checkpoints_total_limit": int, "seed": int,
    "snr_gamma": float, "max_train_steps": int,
}


def parse_args(argv: Optional[list[str]] = None) -> TrainConfig:
    """CLI → TrainConfig. Every field becomes `--{name}`; booleans are
    store_true flags; the LOCAL_RANK environment variable is merged as the
    reference does (`src/args.py:331-333`)."""
    parser = argparse.ArgumentParser(description="TDM distillation (PyTorch/CUDA)")
    for f in dataclasses.fields(TrainConfig):
        name = f"--{f.name}"
        default = f.default
        if isinstance(default, bool):
            parser.add_argument(name, action="store_true", default=default)
        elif f.name == "validation_prompts":
            parser.add_argument(name, nargs="+", default=list(default))
        else:
            typ = type(default) if default is not None else _NONE_TYPES.get(f.name, str)
            parser.add_argument(name, type=typ, default=default)
    ns = parser.parse_args(argv)
    cfg = TrainConfig(**{
        f.name: (tuple(getattr(ns, f.name)) if f.name == "validation_prompts"
                 else getattr(ns, f.name))
        for f in dataclasses.fields(TrainConfig)
    })
    env_rank = int(os.environ.get("LOCAL_RANK", -1))
    if env_rank != -1 and env_rank != cfg.local_rank:
        cfg.local_rank = env_rank
    if cfg.dataset_name is None and cfg.train_data_dir is None:
        raise ValueError("Need either a dataset name or a training folder.")
    if cfg.mixed_precision not in (None, "no", "fp32", "bf16"):
        raise ValueError(
            f"--mixed_precision {cfg.mixed_precision!r} is not supported — "
            "use 'bf16' (what fp16 recipes map to) or 'no'/'fp32'"
        )
    return cfg
