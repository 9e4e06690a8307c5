"""Multistep solvers on precomputed grids: DPM-Solver++(2M), UniPC and LCM.

Port of `tdm_tpu/core/solvers.py`: the same grids (`flow_grid` for the
rectified-flow SD3 path with its `flow_shift`, `ddpm_grid` over a discrete
schedule) and the same per-step arithmetic, in fp32, with a Python loop in
place of `lax.scan`. The step index is known on the host, so the JAX
package's `jnp.where` guards (which keep discarded branches finite) become
plain `if`s. The sampler state keeps the noise's dtype between steps, as in
the JAX package; everything between is fp32.

The grids are built on the host (fp32 tensors on the CPU) and the samplers
move them to the sample's device. `sample_lcm` re-noises with fresh noise
at every step: the draws are an input (`step_noise`), or come from a
`torch.Generator`; the JAX package's `jax.random` draws differ by
construction.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from tdm_tpu_torch.core import schedules as sched
from tdm_tpu_torch.core.sampling import cfg_mix

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


@dataclass(frozen=True)
class SolverGrid:
    """The inference grid of a K-step run: model_t[i] is the timestep fed to
    the denoiser at step i (continuous for flow models); alphas/sigmas[i]
    are the forward-process coefficients at step i, index K the terminal
    level (α=1, σ=0)."""

    model_t: torch.Tensor  # [K] fp32
    alphas: torch.Tensor  # [K+1] fp32
    sigmas: torch.Tensor  # [K+1] fp32
    prediction_type: str = sched.EPSILON

    @property
    def num_steps(self) -> int:
        return int(self.model_t.shape[0])

    def to(self, device) -> "SolverGrid":
        return replace(self, model_t=self.model_t.to(device),
                       alphas=self.alphas.to(device), sigmas=self.sigmas.to(device))


def flow_grid(
    num_steps: int, *, num_train_timesteps: int = 1000, flow_shift: float = 3.0
) -> SolverGrid:
    """The rectified-flow grid (SD3): σ_i is the flow-shifted linspace from
    ~1 down to ~0 over K steps, model timesteps σ·num_train_timesteps."""
    alphas_lin = np.linspace(1.0, 1.0 / num_train_timesteps, num_steps + 1)
    sigma = 1.0 - alphas_lin  # ascending 0 → ~1
    sigma = sched.shift_sigma(sigma, flow_shift)
    sigma = sigma[::-1][:-1]  # descending, K values (drop the 0)
    sigmas = np.concatenate([sigma, [0.0]])

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32))

    return SolverGrid(model_t=f32(sigma * num_train_timesteps), alphas=f32(1.0 - sigmas),
                      sigmas=f32(sigmas), prediction_type=sched.FLOW)


def ddpm_grid(
    schedule: sched.NoiseSchedule,
    num_steps: int,
    *,
    timestep_spacing: str = "linspace",
    steps_offset: int = 0,
) -> SolverGrid:
    """K integer timesteps of a discrete DDPM schedule (descending), with
    α/σ read from its tables and the terminal level (α=1, σ=0)."""
    t_max = schedule.num_train_timesteps
    if timestep_spacing == "linspace":
        ts = np.linspace(0, t_max - 1, num_steps + 1).round()[::-1][:-1]
    elif timestep_spacing == "leading":
        step = t_max // num_steps
        ts = (np.arange(0, num_steps) * step).round()[::-1] + steps_offset
    elif timestep_spacing == "trailing":
        ts = np.arange(t_max, 0, -t_max / num_steps).round() - 1
    else:
        raise ValueError(f"unknown timestep_spacing {timestep_spacing!r}")
    ts = torch.tensor(np.ascontiguousarray(ts).astype(np.int64))
    a = schedule.alphas.cpu()[ts]
    s = schedule.sigmas.cpu()[ts]
    return SolverGrid(
        model_t=ts.float(),
        alphas=torch.cat([a, torch.ones(1)]),
        sigmas=torch.cat([s, torch.zeros(1)]),
        prediction_type=schedule.prediction_type,
    )


def _to_x0(grid: SolverGrid, out: torch.Tensor, i: int, sample: torch.Tensor) -> torch.Tensor:
    """x₀ projection at grid index i (fp32 model output and sample)."""
    a, s = grid.alphas[i], grid.sigmas[i]
    if grid.prediction_type == sched.EPSILON:
        return (sample - s * out) / a
    if grid.prediction_type == sched.V_PREDICTION:
        return a * sample - s * out
    if grid.prediction_type == sched.FLOW:
        return sample - s * out
    raise ValueError(f"unknown prediction_type {grid.prediction_type!r}")


def _model_x0(denoise_fn, grid, i, x, cond, uncond, cfg) -> torch.Tensor:
    """Step i's fp32 x₀ estimate (CFG-mixed when `cfg` is set)."""
    t_b = grid.model_t[i].expand(x.shape[0])
    out = denoise_fn(x, t_b, cond)
    if cfg is not None:
        out = cfg_mix(out, denoise_fn(x, t_b, uncond), cfg)
    return _to_x0(grid, out.float(), i, x.float())


def _log_snr(grid: SolverGrid) -> torch.Tensor:
    """λ = log(α/σ), with the terminal σ=0 clamped to 1e-20."""
    return torch.log(grid.alphas.clamp_min(1e-20)) - torch.log(grid.sigmas.clamp_min(1e-20))


def sample_dpm_solver(
    denoise_fn: DenoiseFn,
    grid: SolverGrid,
    noise: torch.Tensor,
    cond: Any,
    *,
    uncond: Any = None,
    cfg: Optional[float] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M), data-prediction form, first order on the first and
    the last step (`lower_order_final`). From level i to i+1 (h = λ_{i+1} −
    λ_i): x ← (σ_{i+1}/σ_i)·x − α_{i+1}·(e^{−h} − 1)·D, with D = x₀_i, or
    on a 2M step D = (1 + 1/(2r))·x₀_i − 1/(2r)·x₀_{i−1}, r = h_{i−1}/h.
    `cfg=None` runs the conditional branch only (K NFE)."""
    g = grid.to(noise.device)
    k_steps = g.num_steps
    lam = _log_snr(g)
    x, prev_x0 = noise, None
    for i in range(k_steps):
        x0 = _model_x0(denoise_fn, g, i, x, cond, uncond, cfg)
        h = lam[i + 1] - lam[i]
        if i == 0 or i == k_steps - 1:
            d = x0
        else:
            r = (lam[i] - lam[i - 1]) / h
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * prev_x0
        x_next = (g.sigmas[i + 1] / g.sigmas[i].clamp_min(1e-20)) * x.float() \
            - g.alphas[i + 1] * torch.expm1(-h) * d
        x, prev_x0 = x_next.to(noise.dtype), x0
    return x


def sample_unipc(
    denoise_fn: DenoiseFn,
    grid: SolverGrid,
    noise: torch.Tensor,
    cond: Any,
    *,
    uncond: Any = None,
    cfg: Optional[float] = None,
    solver_order: int = 2,
    solver_type: str = "bh2",
    corrector: bool = True,
) -> torch.Tensor:
    """UniPC (data prediction, `bh2` B(h), `lower_order_final`): each step's
    fresh model output first corrects the current sample (UniC), then drives
    the prediction of the next level (UniP). With `corrector=False`,
    UniP-2(bh2) is DPM-Solver++(2M)."""
    if solver_order not in (1, 2):
        raise ValueError(f"solver_order must be 1 or 2, got {solver_order}")
    if solver_type not in ("bh1", "bh2"):
        raise ValueError(f"unknown solver_type {solver_type!r} (bh1|bh2)")
    g = grid.to(noise.device)
    k_steps = g.num_steps
    lam = _log_snr(g)
    sig, alp = g.sigmas, g.alphas

    def coeffs(h):
        """(h_phi_1, B_h, b1, b2) of one λ-interval h > 0."""
        hh = -h
        h_phi_1 = torch.expm1(hh)
        b_h = h_phi_1 if solver_type == "bh2" else hh
        h_phi_k1 = h_phi_1 / hh - 1.0
        return h_phi_1, b_h, h_phi_k1 / b_h, 2.0 * (h_phi_k1 / hh - 0.5) / b_h

    x, x_last = noise, noise
    m1 = m2 = torch.zeros_like(noise, dtype=torch.float32)
    for i in range(k_steps):
        m_t = _model_x0(denoise_fn, g, i, x, cond, uncond, cfg)
        xf = x.float()
        if corrector and i >= 1:  # UniC: move λ_{i-1} → λ_i again with m_t
            h_c = lam[i] - lam[i - 1]
            h_phi_1c, b_hc, b1c, b2c = coeffs(h_c)
            base = (sig[i] / sig[i - 1].clamp_min(1e-20)) * x_last.float() \
                - (alp[i] * h_phi_1c) * m1
            d1_t = m_t - m1
            if i >= 2 and solver_order >= 2:
                r0 = (lam[i - 2] - lam[i - 1]) / h_c
                d1_0 = (m2 - m1) / r0
                det = torch.abs(1.0 - r0).clamp_min(1e-20) * torch.sign(1.0 - r0)
                corr = (b1c - b2c) / det * d1_0 + (b2c - r0 * b1c) / det * d1_t
            else:
                corr = 0.5 * d1_t
            xf = base - alp[i] * b_hc * corr
        # UniP: predict level i+1 from the corrected level-i sample
        h = lam[i + 1] - lam[i]
        h_phi_1, b_h, _, _ = coeffs(h)
        x_next = (sig[i + 1] / sig[i].clamp_min(1e-20)) * xf - (alp[i + 1] * h_phi_1) * m_t
        if not (i == 0 or i == k_steps - 1 or solver_order == 1):
            r0p = (lam[i - 1] - lam[i]) / h
            x_next = x_next - alp[i + 1] * b_h * 0.5 * ((m1 - m_t) / r0p)
        x, x_last, m2, m1 = x_next.to(noise.dtype), xf.to(noise.dtype), m1, m_t
    return x


def sample_lcm(
    denoise_fn: DenoiseFn,
    grid: SolverGrid,
    noise: torch.Tensor,
    cond: Any,
    *,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    uncond: Any = None,
    cfg: Optional[float] = None,
) -> torch.Tensor:
    """LCM multistep sampling (diffusers `LCMScheduler`, the reference's
    validation sampler): x₀ from the model output, then, before the last
    step, re-noise to level i+1 with FRESH noise ε_i: x ← α_{i+1}x₀ +
    σ_{i+1}ε_i (σ_K = 0, so the last step returns x₀). `step_noise` gives the
    K draws; without it they come from `generator` (a CPU generator seeded
    with 0 when None)."""
    g = grid.to(noise.device)
    k_steps = g.num_steps
    if step_noise is not None and len(step_noise) != k_steps:
        raise ValueError(f"step_noise has {len(step_noise)} draws for {k_steps} steps")
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    x = noise
    for i in range(k_steps):
        x0 = _model_x0(denoise_fn, g, i, x, cond, uncond, cfg)
        if step_noise is not None:
            eps = step_noise[i]
            if not isinstance(eps, torch.Tensor):
                eps = torch.from_numpy(np.array(eps, np.float32))
            eps = eps.to(x.device, torch.float32)
        else:
            eps = torch.randn(x.shape, generator=gen, device=gen.device).to(x.device)
        x = (g.alphas[i + 1] * x0 + g.sigmas[i + 1] * eps).to(noise.dtype)
    return x
