"""Diffusion noise schedules as precomputed tables plus pure schedule math.

Port of `tdm_tpu/core/schedules.py` for the PixArt, SD1.5 and SD3 paths:
the linear-β DDPM schedule (reference `src/main.py:132-139`), SD1.5's
scaled-linear one, the shifted
rectified-flow schedule SD3 trains under, the forward process, the x₀ / ε
projections, the few-step timestep grids, and the training step's
inter-timestep transport, mixed noise, SNR and native DSM target. Tables
are built on the host in float64 (a cumprod of ~1000 terms loses digits in
fp32) and stored fp32 on the device; every function takes integer
timesteps `t` of any leading shape and broadcasts the gathered values
against the sample.
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
    betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    return _from_betas(betas, num_train_timesteps, prediction_type, device)


def ddpm_scaled_linear(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    prediction_type: str = EPSILON,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> NoiseSchedule:
    """Scaled-linear β schedule of the SD1.x family (SD1.5's scheduler
    config, the Dreamshaper recipe): β_t = linspace(√β₀, √β₁)²."""
    betas = np.linspace(
        beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    return _from_betas(betas, num_train_timesteps, prediction_type, device)


def _from_betas(betas: np.ndarray, num_train_timesteps: int, prediction_type: str,
                device) -> NoiseSchedule:
    """α/σ tables of a β schedule: the cumprod in float64 on the host,
    stored fp32 on `device`."""
    dev = resolve_device(device)
    alphas_cumprod = np.cumprod(1.0 - betas)
    return NoiseSchedule(
        alphas=torch.tensor(np.sqrt(alphas_cumprod), dtype=torch.float32, device=dev),
        sigmas=torch.tensor(
            np.sqrt(1.0 - alphas_cumprod), dtype=torch.float32, device=dev
        ),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )


def shift_sigma(sigma, shift: float):
    """The flow shift σ̂ = s·σ / (1 + (s−1)·σ) (`flow_shift`, the identity at
    s = 1), on numpy arrays or tensors alike."""
    return shift * sigma / (1.0 + (shift - 1.0) * sigma)


def flow_match(
    num_train_timesteps: int = 1000,
    shift: float = 1.0,
    prediction_type: str = FLOW,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> NoiseSchedule:
    """The rectified-flow schedule (SD3): x_t = (1−σ̂)x₀ + σ̂ε with σ(t) =
    (t+1)/T shifted by `shift`; the model predicts the velocity v = ε − x₀.
    t = T−1 is pure noise. The tables are built in float64 and stored fp32."""
    dev = resolve_device(device)
    sigma = np.arange(1, num_train_timesteps + 1, dtype=np.float64) / float(num_train_timesteps)
    sigma = shift_sigma(sigma, shift)
    return NoiseSchedule(
        alphas=torch.tensor(1.0 - sigma, dtype=torch.float32, device=dev),
        sigmas=torch.tensor(sigma, dtype=torch.float32, device=dev),
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


def native_target(
    schedule: NoiseSchedule, x0: torch.Tensor, eps: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """The denoising-score-matching target in the schedule's NATIVE output
    space, given the clean sample and the true noise: ε (epsilon), α·ε − σ·x₀
    (v_prediction), ε − x₀ (flow). Finite at zero terminal SNR."""
    if schedule.prediction_type == EPSILON:
        return eps
    a, s = alpha_sigma(schedule, t, x0.dim())
    x0f, ef = x0.float(), eps.float()
    if schedule.prediction_type == V_PREDICTION:
        return a * ef - s * x0f
    if schedule.prediction_type == FLOW:
        return ef - x0f
    raise ValueError(f"unknown prediction_type {schedule.prediction_type!r}")


def _transport_coeffs(schedule, t1, t2, ndim):
    """(α₂/α₁, sqrt(max(σ₂² − (α₂/α₁)²σ₁², 0)), σ₁, σ₂) broadcast to rank
    `ndim`. The clamp keeps t2 < t1 finite (the reference NaNs there)."""
    a1, s1 = alpha_sigma(schedule, t1, ndim)
    a2, s2 = alpha_sigma(schedule, t2, ndim)
    ratio = a2 / a1
    return ratio, torch.sqrt(torch.clamp(s2**2 - (ratio * s1) ** 2, min=0.0)), s1, s2


def transport(
    schedule: NoiseSchedule,
    x_t1: torch.Tensor,
    noise: torch.Tensor,
    t1: torch.Tensor,
    t2: torch.Tensor,
) -> torch.Tensor:
    """Move x_{t1} to noise level t2 with fresh noise ε, preserving the
    forward marginal: x_{t2} = (α₂/α₁)·x_{t1} + sqrt(σ₂² − (α₂/α₁)²σ₁²)·ε
    (reference `Predictor.add_noise`, `src/predictor.py:76-85`)."""
    ratio, root, _, _ = _transport_coeffs(schedule, t1, t2, x_t1.dim())
    return (ratio * x_t1 + root * noise).to(x_t1.dtype)


def mixed_noise(
    schedule: NoiseSchedule,
    model_noise: torch.Tensor,
    noise: torch.Tensor,
    t1: torch.Tensor,
    t2: torch.Tensor,
) -> torch.Tensor:
    """The total noise of `transport`'s output: ε_mix = ((α₂/α₁)σ₁·ε_model +
    sqrt(σ₂² − (α₂/α₁)²σ₁²)·ε_fresh)/σ₂ (reference
    `Predictor.obtain_mixed_noise`, `src/predictor.py:87-97`)."""
    ratio, root, s1, s2 = _transport_coeffs(schedule, t1, t2, model_noise.dim())
    return ((ratio * s1 * model_noise + root * noise) / s2).to(model_noise.dtype)


def snr(schedule: NoiseSchedule, t: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio (α/σ)² at timestep t, in the shape of t
    (reference `compute_snr`, `src/utils.py:21-44`)."""
    t = torch.as_tensor(t, device=schedule.alphas.device).long()
    return (schedule.alphas[t] / schedule.sigmas[t]) ** 2


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
