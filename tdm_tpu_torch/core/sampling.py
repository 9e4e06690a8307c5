"""The deterministic few-step trajectory sampler.

Port of `tdm_tpu/core/sampling.py`: the same per-step math (CFG mix, x₀
projection, deterministic re-noise with the predicted ε) with a Python loop
in place of `lax.scan` — PyTorch runs eagerly, so the loop body is the
program. The denoiser is a function `denoise_fn(x, t, cond) -> ε` where
`cond` is the family's conditioning (text embeddings and mask for PixArt).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from tdm_tpu_torch.core import schedules as sched

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


class Trajectory(NamedTuple):
    """states[k] is the sample entering step k (states[0] is the noise at
    grid[0]); states[K] is the final x₀. x0s[k] and noise_preds[k] are step
    k's x₀ and (CFG-mixed) ε estimates."""

    final: torch.Tensor  # [B, ...]
    states: torch.Tensor  # [K+1, B, ...]
    x0s: torch.Tensor  # [K, B, ...]
    noise_preds: torch.Tensor  # [K, B, ...]


def cfg_mix(cond_out: torch.Tensor, uncond_out: torch.Tensor, scale) -> torch.Tensor:
    """Classifier-free guidance u + w·(c - u) (reference
    `src/predictor.py:42`)."""
    return uncond_out + scale * (cond_out - uncond_out)


def sample_fewstep(
    denoise_fn: DenoiseFn,
    schedule: sched.NoiseSchedule,
    noise: torch.Tensor,
    cond: Any,
    *,
    timestep_grid: torch.Tensor,
    uncond: Any = None,
    cfg: Optional[float] = None,
    return_trajectory: bool = False,
):
    """Deterministic K-step sampling from pure noise (reference
    `src/models.py:36-58`). Per step at t = grid[k]: ε̂ from the denoiser
    (CFG-mixed when `cfg` is set), x₀ = predicted_origin, then re-noise to
    grid[k+1] with the predicted ε. Returns the last x₀, or a Trajectory."""
    grid = [int(t) for t in timestep_grid]
    next_grid = grid[1:] + [0]
    b = noise.shape[0]
    x = noise
    states, x0s, eps_list = [], [], []
    for t, t_next in zip(grid, next_grid):
        t_b = torch.full((b,), t, dtype=torch.int64, device=x.device)
        out = denoise_fn(x, t_b, cond)
        if cfg is not None:
            out = cfg_mix(out, denoise_fn(x, t_b, uncond), cfg)
        x0 = sched.predicted_origin(schedule, out, t_b, x)
        eps = sched.predicted_noise(schedule, out, t_b, x)
        states.append(x)
        x0s.append(x0)
        eps_list.append(eps)
        x = sched.add_noise(schedule, x0, eps, torch.full_like(t_b, t_next))
    final = x0s[-1]
    if not return_trajectory:
        return final
    return Trajectory(
        final=final,
        states=torch.stack(states + [final]),
        x0s=torch.stack(x0s),
        noise_preds=torch.stack(eps_list),
    )


def predict_x0(
    denoise_fn: DenoiseFn,
    schedule: sched.NoiseSchedule,
    x_t: torch.Tensor,
    t: torch.Tensor,
    cond: Any,
    *,
    uncond: Any = None,
    cfg: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-step x₀ prediction: (x₀ under the CFG-mixed output, x₀ under
    the cond-only output); both are the cond-only x₀ when `cfg` is None."""
    out_c = denoise_fn(x_t, t, cond)
    x0_nocfg = sched.predicted_origin(schedule, out_c, t, x_t)
    if cfg is None:
        return x0_nocfg, x0_nocfg
    mixed = cfg_mix(out_c, denoise_fn(x_t, t, uncond), cfg)
    return sched.predicted_origin(schedule, mixed, t, x_t), x0_nocfg


def gather_trajectory_states(
    traj: Trajectory, timestep_grid: torch.Tensor, seg: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample gather of a trajectory point by segment index: states[seg[b],
    b] for each sample b, and its noise level. seg = k selects the state
    entering step k (level grid[k]); seg = K the final x₀ (level 0)."""
    k_steps = int(timestep_grid.shape[0])
    seg = seg.to(traj.states.device).long()
    levels = torch.cat([
        timestep_grid.to(seg.device).long(),
        torch.zeros(1, dtype=torch.long, device=seg.device),
    ])
    state = traj.states[seg, torch.arange(seg.shape[0], device=seg.device)]
    return state, levels[seg.clamp(0, k_steps)]
