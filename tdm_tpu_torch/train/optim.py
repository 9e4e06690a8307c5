"""Optimizer, LR schedules and EMA of the TDM step, on dicts of tensors.

Port of `tdm_tpu/train/optim.py`. The JAX package builds its optimizer from
optax (`clip_by_global_norm` → `adamw`); the port writes optax's formulas
out, so the two agree to fp32 rounding:

  * clip: g ← g / ‖g‖ · max_norm only where ‖g‖ ≥ max_norm (no epsilon);
  * Adam: μ ← β₁μ + (1−β₁)g, ν ← β₂ν + (1−β₂)g², with count c ← c+1,
    u = (μ/(1−β₁ᶜ)) / (sqrt(ν/(1−β₂ᶜ)) + ε);
  * decoupled weight decay: u ← u + wd·p;
  * the learning rate at the count BEFORE the increment: p ← p − lr(c−1)·u,
    so the first update uses lr(0), which is 0 under a warmup.

`low_precision_moments` stores μ in bf16 (optax's `mu_dtype`; ν stays fp32).
Parameters are updated in place (`apply_updates`), which keeps one copy of
each model on the device; the JAX step returns new arrays instead.
`eight_bit` (the JAX package's blockwise-int8 `adam8bit`) and
`accumulation_steps > 1` (optax.MultiSteps) raise NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Optional, Union

import torch

Params = dict[str, torch.Tensor]
Schedule = Callable[[int], float]

LR_SCHEDULES = (
    "constant", "constant_with_warmup", "linear", "cosine",
    "cosine_with_restarts", "polynomial",
)


def make_lr_schedule(
    name: str,
    base_lr: float,
    *,
    warmup_steps: int = 0,
    total_steps: int = 10000,
    num_cycles: float = 1.0,
    power: float = 1.0,
) -> Schedule:
    """HF `get_scheduler`-compatible schedules (names per the reference's
    `src/args.py:161-167`), evaluated in fp32 as the JAX package does.
    Returns step -> learning rate (a Python float)."""
    if name not in LR_SCHEDULES:
        raise ValueError(f"unknown lr schedule {name!r}")
    f32 = torch.float32

    def sched(step: int) -> float:
        step = torch.tensor(float(step), dtype=f32)
        warm = step / max(warmup_steps, 1) if warmup_steps > 0 else torch.tensor(1.0)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = torch.clamp(progress, 0.0, 1.0)
        if name in ("constant", "constant_with_warmup"):
            decay = torch.tensor(1.0)
        elif name == "linear":
            decay = 1.0 - progress
        elif name == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * num_cycles * 2.0 * progress))
        elif name == "cosine_with_restarts":
            # hard restarts: decay 1→0 within each of `num_cycles` cycles
            cycle_pos = torch.remainder(progress * num_cycles, 1.0)
            decay = torch.where(
                progress >= 1.0, torch.tensor(0.0),
                0.5 * (1.0 + torch.cos(math.pi * cycle_pos)),
            )
        else:  # polynomial
            decay = (1.0 - progress) ** power
        return float(base_lr * torch.clamp(warm, max=1.0) * decay)

    return sched


class AdamWState(NamedTuple):
    """optax's ScaleByAdamState (its count also drives the schedule)."""

    count: int
    mu: Params
    nu: Params


class Optimizer(NamedTuple):
    """clip → AdamW as a pair of functions, optax-style:
    `init(params) -> state`, `update(grads, state, params) -> (updates,
    state)`."""

    init: Callable[[Params], AdamWState]
    update: Callable[[Params, AdamWState, Params], tuple[Params, AdamWState]]


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree.values()))


def make_optimizer(
    lr: Union[Schedule, float],
    *,
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
    max_grad_norm: Optional[float] = 1.0,
    low_precision_moments: bool = False,
    eight_bit: bool = False,
    accumulation_steps: int = 1,
) -> Optimizer:
    """clip(max_grad_norm) → AdamW, the reference's update rule
    (`src/main.py:206-224, 537`)."""
    if eight_bit:
        raise NotImplementedError(
            "8-bit Adam (--use_8bit_adam, the blockwise-int8 adam8bit) is not "
            "ported yet: ROADMAP.md queue 1, slice 2 follow-ups"
        )
    if accumulation_steps > 1:
        raise NotImplementedError(
            "gradient accumulation (--gradient_accumulation_steps > 1) is not "
            "ported yet: ROADMAP.md queue 1, slice 2 follow-ups"
        )
    b1, b2 = betas
    mu_dtype = torch.bfloat16 if low_precision_moments else None
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Params) -> AdamWState:
        return AdamWState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=mu_dtype or p.dtype) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def update(grads: Params, state: AdamWState, params: Params):
        if max_grad_norm is not None:
            norm = global_norm(grads)
            if not bool(norm < max_grad_norm):
                grads = {k: (g / norm.to(g.dtype)) * max_grad_norm for k, g in grads.items()}
        count = state.count + 1
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
        step = -lr_fn(state.count)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            # β₁ rounded to μ's dtype first, as JAX rounds a Python scalar
            # to a bf16 operand's dtype
            mu_k = state.mu[k]
            m = (1 - b1) * g + torch.tensor(b1, dtype=mu_k.dtype) * mu_k
            v = (1 - b2) * (g * g) + b2 * state.nu[k]
            u = (m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype)) + eps)
            updates[k] = step * (u + weight_decay * params[k])
            mu[k] = m if mu_dtype is None else m.to(mu_dtype)
            nu[k] = v
        return updates, AdamWState(count=count, mu=mu, nu=nu)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """p ← p + u, in place, in p's dtype (optax.apply_updates)."""
    for k, p in params.items():
        p.copy_((p + updates[k]).to(p.dtype))


@torch.no_grad()
def ema_update(ema_params: Params, new_params: Params, decay: float) -> None:
    """Polyak average e ← d·e + (1−d)·p, in place (the diffusers EMAModel
    equivalent)."""
    for k, e in ema_params.items():
        e.copy_(decay * e + (1.0 - decay) * new_params[k].to(e.dtype))
