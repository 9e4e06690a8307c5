"""Validation images during training: fixed-seed grids of the student.

Port of `tdm_tpu/train/validation.py`: `save_validation_images` renders
K-step rollouts (4 and 1 NFE) of the student on fixed (prompts, noise)
under the family's schedule and cond (PixArt's DDPM tables and (text,
mask); SD3's flow tables and (ctx, pooled)), decodes them with a TAESD
decoder (TAESD3 for SD3's 16 channels) and writes one PNG grid per K;
`log_validation` renders the student (K steps, no CFG) beside the teacher
(28 steps, CFG 7) from the same seed. PNGs go through the port's own
encoder (`serve.server.encode_png`: the card's machine has no Pillow).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from tdm_tpu_torch.core import sampling, schedules as sched
from tdm_tpu_torch.pipelines.base import to_images
from tdm_tpu_torch.serve.server import encode_png


def make_grid(images: np.ndarray, *, cols: Optional[int] = None) -> np.ndarray:
    """[N, H, W, 3] floats in [0, 1] → one [rows·H, cols·W, 3] uint8 grid."""
    n, h, w, c = images.shape
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = images[i]
    return (np.clip(grid, 0, 1) * 255).astype(np.uint8)


def save_png(path: str, array: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(array)))


@torch.no_grad()
def _grid(denoise_fn, params, schedule, cond, noise, decode_fn, steps, total_steps,
          uncond=None, cfg=None) -> np.ndarray:
    latents = sampling.sample_fewstep(
        lambda x, t, c: denoise_fn(params, x, t, c), schedule, noise, cond,
        timestep_grid=sched.fewstep_grid(total_steps, steps), uncond=uncond, cfg=cfg,
    )
    return make_grid(to_images(decode_fn(latents)).cpu().numpy())


def save_validation_images(
    denoise_fn,
    params: Any,
    schedule: sched.NoiseSchedule,
    cond: Any,
    fixed_noise: torch.Tensor,
    decode_fn,
    *,
    output_dir: str,
    step: int,
    total_steps: int = 900,
    steps_list: tuple = (4, 1),
) -> dict[int, np.ndarray]:
    """K-step rollouts on fixed (cond, noise) → decoded grids, written as
    `validation_step{step}_{K}nfe.png`; returns {K: grid}.
    decode_fn(latents) → [B, 3, H, W] in [0, 1]."""
    os.makedirs(output_dir, exist_ok=True)
    grids = {}
    for k in steps_list:
        grids[k] = _grid(denoise_fn, params, schedule, cond, fixed_noise, decode_fn, k,
                         total_steps)
        save_png(os.path.join(output_dir, f"validation_step{step}_{k}nfe.png"), grids[k])
    return grids


def log_validation(
    denoise_fn,
    student_params: Any,
    teacher_params: Any,
    schedule: sched.NoiseSchedule,
    cond: Any,
    uncond: Any,
    decode_fn,
    *,
    output_dir: str,
    step: int,
    sample_shape: tuple,
    student_steps: int = 4,
    teacher_steps: int = 28,
    teacher_cfg: float = 7.0,
    total_steps: int = 900,
    seed: int = 42,
) -> dict[str, np.ndarray]:
    """Student (K steps, no CFG) against teacher (many steps, CFG) from one
    fixed seed, each written as `compare_step{step}_{name}.png`."""
    batch = cond[0].shape[0]
    gen = torch.Generator(device=cond[0].device).manual_seed(seed)
    noise = torch.randn((batch, *sample_shape), generator=gen, device=cond[0].device)
    os.makedirs(output_dir, exist_ok=True)
    out = {
        "student": _grid(denoise_fn, student_params, schedule, cond, noise, decode_fn,
                         student_steps, total_steps),
        "teacher": _grid(denoise_fn, teacher_params, schedule, cond, noise, decode_fn,
                         teacher_steps, total_steps, uncond=uncond, cfg=teacher_cfg),
    }
    for name, grid in out.items():
        save_png(os.path.join(output_dir, f"compare_step{step}_{name}.png"), grid)
    return out
