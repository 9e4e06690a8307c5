"""The TDM (Trajectory Distribution Matching) train step.

Port of `tdm_tpu/train/tdm.py`: the same algorithm, step by step, in eager
PyTorch. One step:

  1. the student's K-step rollout from the noise z, no gradient;
  2. per sample a segment s and a timestep t_fake in the segment's interval;
  3. 'dmd': the student's x₀ at the trajectory input of step s−1 (no grad),
     noised to t_fake with the fresh ε; one or more critic DSM updates on it;
     the teacher's CFG x₀ and the updated critic's x₀ there (no grad); the
     student update with gradient (x0_fake − x0_real)·∂x̂₀/∂θ;
     'instruct': the trajectory state transported to t_fake; the critic DSM
     update on the mixed noise; the critic's x₀ anchor; the teacher's CFG x₀
     target; the student regressed onto it;
  4. both optimizer updates, then the EMA.

Differences from the JAX step that a caller sees:

  * The random draws are inputs (`StepDraws`), per ROADMAP "Same RNG draws":
    `make_draws` makes them with a `torch.Generator` on the device, and the
    parity tests hand in the draws JAX's own key splits make.
  * `denoise_fn(params, x, t, cond)` takes a dict of tensors (`params`) that
    `torch.func.functional_call` puts into one module; only the two
    grad-carrying forwards (the critic DSM loss and the student loss) run
    under autograd, so only they reach the flash forward with its lse and
    the backward kernels. The other forwards run under `torch.no_grad()`.
  * The state is updated in place (one copy of each model on the device) and
    returned with the metrics.
  * A LoRA student (`student_denoise_fn`, `lora.wrap_denoise_fn`): the JAX
    step merges the factors into the frozen teacher at every student call
    inside its trace; here they are merged once per step without gradient
    (for the rollout and x0_gen_sg) and once under autograd (for the student
    loss). The values are the same: the merge is deterministic.
  * `quant_forwards` raises NotImplementedError (ROADMAP.md slice 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from tdm_tpu_torch.core import sampling, schedules as sched
from tdm_tpu_torch.train import optim as topt

# denoise_fn(params, x, t, cond) -> the model's output in its schedule's
# NATIVE parameterization; cond is (text_embeds, text_mask)
ParamDenoiseFn = Callable[[Any, torch.Tensor, torch.Tensor, Any], torch.Tensor]


@dataclass(frozen=True)
class TDMConfig:
    """Algorithm knobs; names and defaults as the JAX package's TDMConfig."""

    cfg: float = 4.5
    total_steps: int = 900
    num_steps: int = 4
    use_huber: bool = True
    huber_c: float = 1e-3
    use_separate: bool = True
    student_cfg_in_loss: bool = True
    ema_decay: float = 0.9999
    min_seg: int = 1
    loss_mode: str = "dmd"  # 'dmd' | 'instruct'
    critic_updates: int = 1
    quant_forwards: bool = False


class TrainState(NamedTuple):
    step: int  # train_step calls; a restored state takes its checkpoint's optimizer step
    student: dict  # name -> tensor (fp32 master weights, or LoRA factors)
    student_opt: Any  # the optimizer's state (train/optim.py)
    critic: dict
    critic_opt: Any
    ema: Optional[dict]  # EMA of the student (None to disable)


class StepMetrics(NamedTuple):
    loss_student: torch.Tensor
    loss_critic: torch.Tensor
    grad_norm_student: torch.Tensor
    grad_norm_critic: torch.Tensor
    t_fake_mean: torch.Tensor


class StepDraws(NamedTuple):
    """Every random number one step uses, drawn outside the step: z and
    fresh [B, *sample_shape] fp32 normals, seg [B] integers in [min_seg, K],
    u [B] uniforms in [0, 1); critic_u [critic_updates−1, B] and critic_eps
    [critic_updates−1, B, *sample_shape] for the extra critic updates."""

    z: torch.Tensor
    seg: torch.Tensor
    u: torch.Tensor
    fresh: torch.Tensor
    critic_u: torch.Tensor
    critic_eps: torch.Tensor


def make_draws(
    config: TDMConfig,
    batch: int,
    sample_shape: tuple[int, ...],
    generator: torch.Generator,
    device,
) -> StepDraws:
    """One step's draws from `generator` (a torch.Generator on `device`).
    The same distributions as the JAX step's key splits, not its numbers."""
    shape = (batch, *sample_shape)
    n = config.critic_updates - 1
    kw = dict(generator=generator, device=device)
    return StepDraws(
        z=torch.randn(shape, **kw),
        seg=torch.randint(config.min_seg, config.num_steps + 1, (batch,), **kw),
        u=torch.rand(batch, **kw),
        fresh=torch.randn(shape, **kw),
        critic_u=torch.rand((n, batch), **kw),
        critic_eps=torch.randn((n, *shape), **kw),
    )


def segment_levels(config: TDMConfig) -> torch.Tensor:
    """Noise level of each trajectory source point, s ∈ {0..K}: grid[s] for
    s < K, 0 for s = K (the final x₀). Host int64."""
    grid = sched.fewstep_grid(config.total_steps, config.num_steps)
    return torch.cat([grid, torch.zeros(1, dtype=grid.dtype)])


def sample_segment_and_t(
    config: TDMConfig, seg: torch.Tensor, u: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(seg, source level, t_fake) from the draws, with the interval coupled
    to the segment: t_fake = lo + u·(hi − lo) truncated, hi = level(s−1)
    ('separate') or T−1 ('joint')."""
    levels = segment_levels(config).to(seg.device)
    lo = levels[seg]
    hi = levels[seg - 1] if config.use_separate else torch.full_like(lo, config.total_steps - 1)
    t_fake = (lo + u * (hi - lo)).to(torch.int64)
    return seg, lo, t_fake


def _detached(params: dict) -> dict:
    """Leaf copies (shared storage) that autograd differentiates against."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _value_and_grad(loss_fn, params: dict):
    leaves = _detached(params)
    with torch.enable_grad():
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves.keys(), grads))


def build_train_step(
    denoise_fn: ParamDenoiseFn,
    teacher_params: Any,
    schedule: sched.NoiseSchedule,
    config: TDMConfig,
    student_tx: topt.Optimizer,
    critic_tx: topt.Optimizer,
    *,
    sample_shape: tuple[int, ...],
    student_denoise_fn: Optional[ParamDenoiseFn] = None,
):
    """Returns `train_step(state, draws, cond, uncond, teacher=None) ->
    (state, metrics)`; `teacher` defaults to `teacher_params`.

    `student_denoise_fn`: the LoRA student (`lora.wrap_denoise_fn`), whose
    state.student holds only the adapter factors; the step's teacher is its
    frozen base, and its `merge(factors, teacher)` gives the weights every
    student forward runs with through `denoise_fn`."""
    if config.loss_mode not in ("dmd", "instruct"):
        raise ValueError(f"unknown loss_mode {config.loss_mode!r} (dmd | instruct)")
    if config.loss_mode == "instruct" and schedule.prediction_type != sched.EPSILON:
        raise ValueError(
            "loss_mode='instruct' requires an epsilon-prediction schedule; "
            f"got {schedule.prediction_type!r} — use loss_mode='dmd'"
        )
    if config.quant_forwards:
        raise NotImplementedError(
            "quant_forwards (int8 no-grad forwards) is not ported yet: "
            "ROADMAP.md queue 1, slice 4 (ops/quant.py)"
        )
    grid = sched.fewstep_grid(config.total_steps, config.num_steps)
    levels = segment_levels(config)

    def train_step(state: TrainState, draws: StepDraws, cond, uncond, teacher=None):
        teacher = teacher_params if teacher is None else teacher
        z = draws.z
        dev = z.device
        batch = z.shape[0]
        g = grid.to(dev)
        lv = levels.to(dev)

        def student_weights(student_params):
            """The weights the student's forward runs with."""
            if student_denoise_fn is None:
                return student_params
            return student_denoise_fn.merge(student_params, teacher)

        # ---- 1-2. student rollout from pure noise, no gradient ----
        with torch.no_grad():
            student_sg = student_weights(state.student)
            traj = sampling.sample_fewstep(
                lambda x, t, c: denoise_fn(student_sg, x, t, c),
                schedule, z, cond, timestep_grid=grid, return_trajectory=True,
            )

        # ---- 3. segment + interval-coupled t_fake ----
        seg, lo, t_fake = sample_segment_and_t(config, draws.seg.to(dev), draws.u)
        fresh = draws.fresh

        def weighted_loss(x_pred, target, weight_anchor):
            """Huber(c)/w or MSE/w with the per-sample no-grad normalizer
            w = mean|weight_anchor| (reference main.py:519-529)."""
            diff32 = x_pred.float() - target.float()
            axes = tuple(range(1, diff32.dim()))
            w = weight_anchor.float().abs().mean(dim=axes, keepdim=True).detach()
            w = torch.clamp(w, min=1e-8)
            if config.use_huber:
                per = (torch.sqrt(diff32**2 + config.huber_c**2) - config.huber_c) / w
            else:
                per = diff32**2 / w
            return per.mean()

        @torch.no_grad()
        def teacher_cfg_x0(x_t, t):
            """The teacher's x₀ pair → CFG target in x₀ space, with cond and
            uncond in one batched (2B) forward."""
            if config.cfg == 1.0:
                eps = denoise_fn(teacher, x_t, t, cond)
                return sched.predicted_origin(schedule, eps, t, x_t)
            x2, t2 = torch.cat([x_t, x_t]), torch.cat([t, t])
            cond2 = tuple(torch.cat([a, b]) for a, b in zip(cond, uncond))
            x0_2 = sched.predicted_origin(schedule, denoise_fn(teacher, x2, t2, cond2), t2, x2)
            x0_c, x0_u = x0_2.chunk(2)
            return x0_u + config.cfg * (x0_c - x0_u)

        if config.loss_mode == "dmd":
            state_in, _ = sampling.gather_trajectory_states(traj, g, seg - 1)
            t_in = g[seg - 1]

            def gen_x0(weights):
                out = denoise_fn(weights, state_in, t_in, cond)
                return sched.predicted_origin(schedule, out, t_in, state_in)

            with torch.no_grad():
                x0_gen_sg = gen_x0(student_sg)
            a_f, s_f = sched.alpha_sigma(schedule, t_fake, z.dim())
            x_t_sg = (a_f * x0_gen_sg + s_f * fresh).to(x0_gen_sg.dtype)

            def one_critic_update(critic_opt, x_t_i, t_i, eps_i):
                target_i = sched.native_target(schedule, x0_gen_sg, eps_i, t_i)

                def critic_loss_fn(critic_params):
                    out_pred = denoise_fn(critic_params, x_t_i, t_i, cond)
                    return ((out_pred.float() - target_i) ** 2).mean()

                loss, grads = _value_and_grad(critic_loss_fn, state.critic)
                updates, critic_opt = critic_tx.update(grads, critic_opt, state.critic)
                topt.apply_updates(state.critic, updates)
                return critic_opt, loss, grads

            critic_opt = state.critic_opt
            hi = lv[seg - 1] if config.use_separate else torch.full_like(lo, config.total_steps - 1)
            for i in range(config.critic_updates - 1):
                t_i = (lo + draws.critic_u[i] * (hi - lo)).to(torch.int64)
                eps_i = draws.critic_eps[i]
                a_i, s_i = sched.alpha_sigma(schedule, t_i, z.dim())
                x_t_i = (a_i * x0_gen_sg + s_i * eps_i).to(x0_gen_sg.dtype)
                critic_opt, _, _ = one_critic_update(critic_opt, x_t_i, t_i, eps_i)
            critic_opt, loss_critic, critic_grads = one_critic_update(
                critic_opt, x_t_sg, t_fake, fresh
            )

            # ---- score probes at (x_t, t_fake), no gradient ----
            x0_real = teacher_cfg_x0(x_t_sg, t_fake)
            with torch.no_grad():
                eps_fake = denoise_fn(state.critic, x_t_sg, t_fake, cond)
                x0_fake = sched.predicted_origin(schedule, eps_fake, t_fake, x_t_sg)

            def student_loss_fn(student_params):
                x0_gen = gen_x0(student_weights(student_params))
                target = (x0_gen + x0_real - x0_fake).detach()
                return weighted_loss(x0_gen, target, x0_gen_sg - x0_real)

        else:  # 'instruct' — the demo's shipped term (main.py:481-529)
            source, _ = sampling.gather_trajectory_states(traj, g, seg)
            eps_src = traj.noise_preds[seg - 1, torch.arange(batch, device=dev)]
            x_f = sched.transport(schedule, source, fresh, lo, t_fake)
            eps_mix = sched.mixed_noise(schedule, eps_src, fresh, lo, t_fake)

            def critic_loss_fn(critic_params):
                eps_pred = denoise_fn(critic_params, x_f, t_fake, cond)
                return ((eps_pred - eps_mix) ** 2).mean()

            loss_critic, critic_grads = _value_and_grad(critic_loss_fn, state.critic)
            updates, critic_opt = critic_tx.update(critic_grads, state.critic_opt, state.critic)
            topt.apply_updates(state.critic, updates)

            with torch.no_grad():
                eps_fake = denoise_fn(state.critic, x_f, t_fake, cond)
                x_in = sched.predicted_origin(schedule, eps_fake, t_fake, x_f)
            target = teacher_cfg_x0(x_in, t_fake)

            def student_loss_fn(student_params):
                weights = student_weights(student_params)
                if config.student_cfg_in_loss and config.cfg != 1.0:
                    x2, t2 = torch.cat([x_in, x_in]), torch.cat([t_fake, t_fake])
                    cond2 = tuple(torch.cat([a, b]) for a, b in zip(cond, uncond))
                    eps_c, eps_u = denoise_fn(weights, x2, t2, cond2).chunk(2)
                    eps_s = eps_u + config.cfg * (eps_c - eps_u)
                else:
                    eps_s = denoise_fn(weights, x_in, t_fake, cond)
                x0_s = sched.predicted_origin(schedule, eps_s, t_fake, x_in)
                return weighted_loss(x0_s, target, x0_s.float() - target.float())

        student_sg = None  # a LoRA student's merged weights, before the loss merges again
        loss_student, student_grads = _value_and_grad(student_loss_fn, state.student)
        updates, student_opt = student_tx.update(
            student_grads, state.student_opt, state.student
        )
        topt.apply_updates(state.student, updates)

        # ---- 9. EMA + bookkeeping ----
        if state.ema is not None:
            topt.ema_update(state.ema, state.student, config.ema_decay)
        new_state = TrainState(
            step=state.step + 1,
            student=state.student,
            student_opt=student_opt,
            critic=state.critic,
            critic_opt=critic_opt,
            ema=state.ema,
        )
        metrics = StepMetrics(
            loss_student=loss_student,
            loss_critic=loss_critic,
            grad_norm_student=topt.global_norm(student_grads),
            grad_norm_critic=topt.global_norm(critic_grads),
            t_fake_mean=t_fake.float().mean(),
        )
        return new_state, metrics

    return train_step


def init_state(
    student_params: dict,
    critic_params: dict,
    student_tx: topt.Optimizer,
    critic_tx: topt.Optimizer,
    *,
    use_ema: bool = False,
) -> TrainState:
    """A fresh TrainState; each role gets its own copy of the tensors (the
    recipe starts student and critic from the same teacher weights; a LoRA
    student starts from its factors)."""
    copy = lambda tree: {k: v.detach().clone() for k, v in tree.items()}  # noqa: E731
    return TrainState(
        step=0,
        student=copy(student_params),
        student_opt=student_tx.init(student_params),
        critic=copy(critic_params),
        critic_opt=critic_tx.init(critic_params),
        ema=copy(student_params) if use_ema else None,
    )
