"""Diffusion noise schedules as precomputed tables plus pure schedule math.

Port of the serving path's part of `tdm_tpu/core/schedules.py`: the linear-β
DDPM schedule (reference `src/main.py:132-139`), the forward process and the
x₀ / ε projections, and the few-step timestep grids. Tables are built on the
host in float64 (a cumprod of ~1000 terms loses digits in fp32) and stored
fp32 on the device; every function takes integer timesteps `t` of any
leading shape and broadcasts the gathered values against the sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from tdm_tpu_torch.device import resolve_device

EPSILON = "epsilon"
V_PREDICTION = "v_prediction"
FLOW = "flow"  # model predicts velocity v = ε - x₀


@dataclass(frozen=True)
class NoiseSchedule:
    """α/σ tables: x_t = alphas[t]·x₀ + sigmas[t]·ε."""

    alphas: torch.Tensor  # [T] fp32
    sigmas: torch.Tensor  # [T] fp32
    num_train_timesteps: int = 1000
    prediction_type: str = EPSILON


def ddpm_linear(
    num_train_timesteps: int = 1000,
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
    prediction_type: str = EPSILON,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> NoiseSchedule:
    """Linear-β DDPM schedule (DDPMScheduler(beta_schedule='linear'))."""
    dev = resolve_device(device)
    betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - betas)
    return NoiseSchedule(
        alphas=torch.tensor(np.sqrt(alphas_cumprod), dtype=torch.float32, device=dev),
        sigmas=torch.tensor(
            np.sqrt(1.0 - alphas_cumprod), dtype=torch.float32, device=dev
        ),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )


def _broadcast(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] with singleton dims appended up to rank `ndim`."""
    vals = table[torch.as_tensor(t, device=table.device).long()]
    return vals.reshape(vals.shape + (1,) * (ndim - vals.dim()))


def alpha_sigma(
    schedule: NoiseSchedule, t: torch.Tensor, ndim: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(α(t), σ(t)) broadcast to a rank-`ndim` sample."""
    return (
        _broadcast(schedule.alphas, t, ndim),
        _broadcast(schedule.sigmas, t, ndim),
    )


def add_noise(
    schedule: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """Forward process x_t = α(t)x₀ + σ(t)ε, in the dtype of x₀."""
    a, s = alpha_sigma(schedule, t, x0.dim())
    return (a * x0 + s * noise).to(x0.dtype)


def predicted_origin(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    t: torch.Tensor,
    sample: torch.Tensor,
) -> torch.Tensor:
    """x₀ estimate from the model output at timestep t (reference
    `src/utils.py:47-59`, plus the flow branch)."""
    a, s = alpha_sigma(schedule, t, sample.dim())
    if schedule.prediction_type == EPSILON:
        x0 = (sample - s * model_output) / a
    elif schedule.prediction_type == V_PREDICTION:
        x0 = a * sample - s * model_output
    elif schedule.prediction_type == FLOW:
        x0 = sample - s * model_output
    else:
        raise ValueError(f"unknown prediction_type {schedule.prediction_type!r}")
    return x0.to(sample.dtype)


def predicted_noise(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    t: torch.Tensor,
    sample: torch.Tensor,
) -> torch.Tensor:
    """ε estimate from the model output at timestep t (the dual of
    `predicted_origin`)."""
    a, s = alpha_sigma(schedule, t, sample.dim())
    if schedule.prediction_type == EPSILON:
        eps = model_output
    elif schedule.prediction_type == V_PREDICTION:
        eps = s * sample + a * model_output
    elif schedule.prediction_type == FLOW:
        eps = sample + a * model_output
    else:
        raise ValueError(f"unknown prediction_type {schedule.prediction_type!r}")
    return eps.to(sample.dtype)


def fewstep_grid(total_steps: int, num_steps: int) -> torch.Tensor:
    """The reference's K-step grid t_k = (total_steps-1) - k·(total_steps//K)
    (`src/models.py:28,57`): [899, 674, 449, 224] for 900 and K=4. Host
    int64; the sampler moves each step's t to the sample's device."""
    start = total_steps - 1
    step = total_steps // num_steps
    grid = start - step * torch.arange(num_steps, dtype=torch.int64)
    return torch.clamp(grid, min=0)


def grid_from_list(timesteps: Sequence[int]) -> torch.Tensor:
    """Custom timestep grid, e.g. CogVideoX's [999, 856, 665, 399]."""
    return torch.tensor(list(timesteps), dtype=torch.int64)
