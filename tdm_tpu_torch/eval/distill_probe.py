"""Synthetic decoded-pixel distillation-quality probe, in PyTorch.

Port of `tdm_tpu/eval/distill_probe.py`: an end-to-end TDM efficacy
measurement with a VAE decode in the quality loop, small enough to run in
seconds on one card and needing no released weights:
  1. image-shaped latents [4, 4, 4] on a curved 1-D manifold, the ring
     x₀(θ) = cos θ·A + sin θ·B in two fixed orthonormal spatial patterns
     (at high noise the x₀ projection is the ring's centre, so a 4-step
     trajectory undershoots the manifold);
  2. a tiny TAESD decoder (`models/vae.py`) trained to render each manifold
     latent as a Gaussian blob whose position tracks θ;
  3. a toy ε-denoiser DSM-pretrained on the latents: the teacher;
  4. full TDM distillation (`train/tdm.py`) of a 4-NFE student;
  5. the metric in decoded pixels: the mean distance of each decoded sample
     to its nearest point of the decoded manifold (a dense θ grid through
     the same decoder), normalised by the references' RMS norm.

`run_probe` returns gap_closure = 1 − gap_after/gap_before, the fraction of
the 4-NFE-versus-50-NFE decoded gap that distillation closes (1.0: the
4-NFE student reaches the 50-NFE teacher).

Differences from the JAX module that a caller sees:
  * A and B are the JAX module's patterns (drawn there from
    `jax.random.PRNGKey(99)`), carried here as constants.
  * Every other random number comes from a `torch.Generator` on the
    device, seeded with the number of the JAX module's `PRNGKey` at the
    same place (decoder init 1, its draws 2, teacher init 3, its draws 4,
    distillation 7, the evaluation noise 42); the numbers differ from
    JAX's, the distributions do not. Each stage also takes its draws and
    its starting weights as inputs (`draws=`, `params=`), so a test can
    hand both packages the same ones.
  * Weights start as flax initialises them (`flax_init_`: truncated-normal
    LeCun kernels, zero biases), not as torch does.
  * Parameters are dicts of tensors put into one module with
    `torch.func.functional_call`, as the trainer's families do.
  * `run_probe` sets fp32 products in full fp32 (TF32 off,
    `device.set_fp32_precision`, as the trainer does), and fills an
    optional `timings` dict with each stage's seconds. The loops read no
    loss or metric back to the host before a stage ends; the distillation
    step's own reads remain (the clip's test of ‖g‖ against its limit in
    `train/optim.clip_by_global_norm`, the grid's copies to the device).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from tdm_tpu_torch.core import sampling, schedules as sched
from tdm_tpu_torch.device import resolve_device, set_fp32_precision
from tdm_tpu_torch.models import vae
from tdm_tpu_torch.train import optim as topt, tdm

IMG = 16  # canvas (pixels); 2 TAESD stages: 4× upsample from 4×4 latents
DEC_CFG = vae.TAESDConfig(latent_channels=4, width=16, num_stages=2, blocks_per_stage=1)
LAT_SHAPE = (4, 4, 4)  # (C, H/4, W/4)
_DIM = int(np.prod(LAT_SHAPE))
_TWO_PI = 2 * math.pi

# the JAX module's _A and _B (unit-RMS, orthogonal), float32 value by value
_A_VALUES = (
    1.3444824, -0.26027837, -0.7771787, 0.7863821, 0.35917756, 1.7050176, 1.5540649,
    -0.8165013, -0.48828685, -1.903704, -0.38893783, -1.7211562, -0.99676836, 0.6579296,
    0.6011001, -0.20058809, 0.99856305, 0.3264462, 1.3283106, -0.2684837, -1.5778887,
    -0.9467512, -1.0879002, -1.5079718, -1.107634, -1.0913867, 0.79217803, 0.919754,
    -0.13086063, 0.8529635, 0.9289418, 0.92089355, -0.23139623, 1.332995, -0.5946783,
    0.8686708, -1.6443478, 0.19130132, -0.4902253, 1.4312878, -1.4840004, 0.8277558,
    2.2160866, -1.015874, -1.0593292, -0.9407126, 0.043582086, 1.3705789, -0.10535393,
    0.74360293, 0.6633716, 0.7527769, 0.52927417, 0.28709885, -0.39994192, 1.5716064,
    0.010819918, -0.6033919, -1.7334132, -0.29025796, 0.74939644, 0.5185775,
    -0.0027280883, 0.5624633,
)
_B_VALUES = (
    -0.5789621, -1.0825927, 0.08315288, 0.96733093, -0.29927376, -0.1289849, 0.16205376,
    -0.5258239, -1.549242, -0.08725002, -1.0040668, -1.6057605, -1.3747389, -0.84532875,
    -0.8624891, -0.45866477, 1.3405933, 0.9091405, -1.0258257, 1.2048355, -0.105632216,
    1.1283678, -1.005416, 0.48263237, 1.1662207, 0.46209526, -0.053994443, 0.13306077,
    2.0625498, -1.4121766, -0.9856586, 0.8063069, 0.6446159, 1.3342392, -0.97275347,
    1.1235749, 1.5583738, -1.2337265, 0.21451047, -0.34466296, -0.11123594, 0.51211566,
    0.14119169, -0.71722347, -0.9930687, 1.2634794, -2.3759441, 0.029705398, -1.330729,
    1.2476481, 0.6886396, -1.0228612, 2.026636, -1.167045, 0.3502604, -0.15601349,
    0.654313, 0.4513557, 1.2584285, 0.3221201, 0.33970687, -0.10606774, -0.69989556,
    -1.8736814,
)
_A = np.asarray(_A_VALUES, np.float32).reshape(LAT_SHAPE)
_B = np.asarray(_B_VALUES, np.float32).reshape(LAT_SHAPE)

# the generator seeds: the JAX module's PRNGKey numbers at the same places
SEEDS = {"decoder_init": 1, "decoder": 2, "teacher_init": 3, "teacher": 4, "distill": 7,
         "eval": 42}

Params = dict[str, torch.Tensor]
DecodeFn = Callable[[torch.Tensor], torch.Tensor]


def manifold_latents(theta: torch.Tensor) -> torch.Tensor:
    """θ [N] → the ring's latents [N, 4, 4, 4], fp32, on θ's device."""
    a = torch.from_numpy(_A).to(theta.device)
    b = torch.from_numpy(_B).to(theta.device)
    return torch.cos(theta)[:, None, None, None] * a + torch.sin(theta)[:, None, None, None] * b


def manifold_images(theta: torch.Tensor) -> torch.Tensor:
    """θ [N] → [N, 3, IMG, IMG] blobs centred on a circle of radius 4.5: the
    decoder's supervised rendering target."""
    cx = IMG / 2 + 4.5 * torch.cos(theta)
    cy = IMG / 2 + 4.5 * torch.sin(theta)
    idx = torch.arange(IMG, device=theta.device)
    yy, xx = torch.meshgrid(idx, idx, indexing="ij")
    d2 = (xx[None] - cx[:, None, None]) ** 2 + (yy[None] - cy[:, None, None]) ** 2
    bump = torch.exp(-d2 / (2 * 1.5**2))
    gains = torch.tensor([1.0, 0.6, 0.3], device=theta.device)
    return gains[None, :, None, None] * bump[:, None]


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every Linear and Conv2d of `module` initialised as flax's Dense and
    Conv are by default: the kernel from a normal truncated at ±2σ with σ
    scaled so that its variance is 1/fan_in (lecun_normal), the bias zero.
    In place; returns `module`."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                # the std of a unit normal truncated at ±2 is 0.8796…
                std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return module


class ToyLatentDenoiser(nn.Module):
    """The probe's ε-model: the flat latent, 5 timestep features and the
    condition through 4 GELU (tanh) Dense layers of `width` and a Dense
    back to the latent's size. Module names follow the JAX tree (d0..d3,
    out), so the weight carry fills them."""

    def __init__(self, width: int = 256, *, cond_dim: int = 1,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        dev = resolve_device(device)
        dims = [_DIM + 5 + cond_dim] + [width] * 4
        for i in range(4):
            self.add_module(f"d{i}", nn.Linear(dims[i], width, device=dev))
        self.out = nn.Linear(width, _DIM, device=dev)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        flat = x.reshape(b, -1).float()
        tt = t.float() / 1000.0
        temb = torch.stack([torch.cos(math.pi * tt), torch.sin(math.pi * tt), tt,
                            torch.cos(4 * math.pi * tt), torch.sin(4 * math.pi * tt)], dim=-1)
        h = torch.cat([flat, temb, cond.float()], dim=-1)
        for i in range(4):
            h = F.gelu(getattr(self, f"d{i}")(h), approximate="tanh")
        return self.out(h).reshape(x.shape)


def _params(module: nn.Module, params: Optional[Params]) -> Params:
    """The module's weights as a dict of fresh leaf tensors (the module
    itself holds no gradient): `params` copied onto its device, or its own
    initialised ones."""
    module.requires_grad_(False)
    dev = next(module.parameters()).device
    src = params if params is not None else module.state_dict()
    return {k: torch.as_tensor(v).detach().to(dev, torch.float32).clone() for k, v in src.items()}


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def train_decoder(
    steps: int = 700,
    *,
    device: Optional[Union[str, torch.device]] = None,
    params: Optional[Params] = None,
    draws: Optional[Iterable[torch.Tensor]] = None,
) -> tuple[DecodeFn, float]:
    """The TAESD decoder (`DEC_CFG`) trained to render manifold latents as
    their blobs: `steps` Adam (lr 2e-3) steps of the MSE at batch 128.
    `params`: starting weights (a state_dict; default flax's init from
    SEEDS["decoder_init"]); `draws`: each step's θ [128] (default uniform
    on [0, 2π) from SEEDS["decoder"]). Returns (decode, the last step's
    loss)."""
    dev = resolve_device(device)
    dec = vae.TAESDDecoder(DEC_CFG, device=dev)
    if params is None:
        flax_init_(dec, torch.Generator(dev).manual_seed(SEEDS["decoder_init"]))
    weights = _params(dec, params)
    tx = topt.adamw(2e-3, weight_decay=0.0)
    opt = tx.init(weights)
    if draws is None:
        gen = torch.Generator(dev).manual_seed(SEEDS["decoder"])
        draws = (torch.rand(128, generator=gen, device=dev) * _TWO_PI for _ in range(steps))
    loss = torch.full((), float("nan"))
    for theta in draws:
        theta = theta.to(dev)
        z, target = manifold_latents(theta), manifold_images(theta)

        def loss_fn(p):
            return ((functional_call(dec, p, (z,)) - target) ** 2).mean()

        loss, grads = tdm._value_and_grad(loss_fn, weights)
        updates, opt = tx.update(grads, opt, weights)
        topt.apply_updates(weights, updates)

    @torch.no_grad()
    def decode(z: torch.Tensor) -> torch.Tensor:
        return functional_call(dec, weights, (z,))

    return decode, float(loss)


class DSMDraws(NamedTuple):
    """One DSM step's draws, batch N: θ [N] in [0, 2π), jitter [N, 4, 4, 4]
    unit normals (×0.02 on x₀), t [N] integers in [0, 1000), eps
    [N, 4, 4, 4] unit normals."""

    theta: torch.Tensor
    jitter: torch.Tensor
    t: torch.Tensor
    eps: torch.Tensor


def toy_denoise_fn(model: ToyLatentDenoiser):
    """denoise_fn(params, x, t, cond) → ε̂ through `model`."""

    def denoise_fn(params, x, t, cond):
        return functional_call(model, params, (x, t, cond))

    return denoise_fn


def train_teacher(
    steps: int = 3000,
    *,
    device: Optional[Union[str, torch.device]] = None,
    params: Optional[Params] = None,
    draws: Optional[Iterable[DSMDraws]] = None,
):
    """The DSM-pretrained toy ε-teacher on the manifold: `steps` Adam (lr
    1e-3) steps at batch 512 on the DDPM linear schedule, x₀ jittered by
    0.02. `params`: starting weights (default flax's init from
    SEEDS["teacher_init"]); `draws`: each step's `DSMDraws` (default from
    SEEDS["teacher"]). Returns (model, params, schedule, denoise_fn, the
    last step's loss)."""
    dev = resolve_device(device)
    schedule = sched.ddpm_linear(device=dev)
    model = ToyLatentDenoiser(device=dev)
    if params is None:
        flax_init_(model, torch.Generator(dev).manual_seed(SEEDS["teacher_init"]))
    weights = _params(model, params)
    denoise_fn = toy_denoise_fn(model)
    tx = topt.adamw(1e-3, weight_decay=0.0)
    opt = tx.init(weights)
    if draws is None:
        gen = torch.Generator(dev).manual_seed(SEEDS["teacher"])
        kw = dict(generator=gen, device=dev)
        draws = (DSMDraws(theta=torch.rand(512, **kw) * _TWO_PI,
                          jitter=torch.randn((512, *LAT_SHAPE), **kw),
                          t=torch.randint(0, 1000, (512,), **kw),
                          eps=torch.randn((512, *LAT_SHAPE), **kw)) for _ in range(steps))
    cond = torch.ones(512, 1, device=dev)
    loss = torch.full((), float("nan"))
    for d in draws:
        theta, jitter, t, eps = (v.to(dev) for v in d)
        x0 = manifold_latents(theta) + 0.02 * jitter
        x_t = sched.add_noise(schedule, x0, eps, t.long())

        def loss_fn(p):
            return ((denoise_fn(p, x_t, t, cond) - eps) ** 2).mean()

        loss, grads = tdm._value_and_grad(loss_fn, weights)
        updates, opt = tx.update(grads, opt, weights)
        topt.apply_updates(weights, updates)
    return model, weights, schedule, denoise_fn, float(loss)


@torch.no_grad()
def decoded_manifold_error(decode: DecodeFn, z: torch.Tensor) -> float:
    """The mean pixel-space distance from each decoded sample to its
    nearest decoded manifold point (a 128-point θ grid through the same
    decoder, so its approximation error cancels), over the references' RMS
    norm. The squared distances are expanded as ‖a‖² − 2a·b + ‖b‖², one
    fp32 product, as in JAX."""
    theta = torch.from_numpy(np.arange(128) * (_TWO_PI / 128)).float().to(z.device)
    ref = decode(manifold_latents(theta)).reshape(128, -1)
    imgs = decode(z).reshape(z.shape[0], -1)
    d2 = (imgs**2).sum(-1)[:, None] - 2 * imgs @ ref.T + (ref**2).sum(-1)[None]
    dist = torch.sqrt(torch.clamp(d2.min(dim=-1).values, min=0.0))
    return float(dist.mean() / torch.sqrt((ref**2).sum(-1).mean()))


@torch.no_grad()
def sample_grid(denoise_fn, params, schedule, noise: torch.Tensor, steps: int) -> torch.Tensor:
    """Few-step samples at `steps` NFE on the 900-step grid, cond 1, from
    `noise` [n, 4, 4, 4] (the JAX function's key and n: the port's
    samplers take their noise as inputs)."""
    cond = torch.ones(noise.shape[0], 1, device=noise.device)
    return sampling.sample_fewstep(
        lambda x, t, c: denoise_fn(params, x, t, c), schedule, noise, cond,
        timestep_grid=sched.fewstep_grid(900, steps),
    )


def distill_config() -> tdm.TDMConfig:
    """Huber, separate intervals, no CFG, and critic_updates=5: the
    DMD2-style ratio the 64-dim latent space needs (the JAX module's)."""
    return tdm.TDMConfig(total_steps=900, num_steps=4, cfg=1.0, use_huber=True,
                         use_separate=True, student_cfg_in_loss=False, critic_updates=5)


def distill(
    denoise_fn,
    teacher: Params,
    schedule: sched.NoiseSchedule,
    steps: int = 500,
    *,
    draws: Optional[Iterable[tdm.StepDraws]] = None,
):
    """Full TDM distillation of a 4-NFE student from `teacher` (student
    and critic start as copies of it): `steps`
    steps of `train/tdm.build_train_step` at batch 128 under
    `distill_config()`, with clip(1) → Adam (lr 3e-4, no weight decay) for
    both roles. `draws`: each step's `StepDraws` (default from
    SEEDS["distill"] on the teacher's device). Returns (state, the last
    step's metrics)."""
    dev = next(iter(teacher.values())).device
    config = distill_config()
    tx_s = topt.make_optimizer(3e-4, weight_decay=0.0)
    tx_c = topt.make_optimizer(3e-4, weight_decay=0.0)
    step = tdm.build_train_step(denoise_fn, teacher, schedule, config, tx_s, tx_c,
                                sample_shape=LAT_SHAPE)
    state = tdm.init_state(teacher, teacher, tx_s, tx_c)
    if draws is None:
        gen = torch.Generator(dev).manual_seed(SEEDS["distill"])
        draws = (tdm.make_draws(config, 128, LAT_SHAPE, gen, dev) for _ in range(steps))
    cond = torch.ones(128, 1, device=dev)
    uncond = torch.zeros(128, 1, device=dev)
    metrics = None
    for d in draws:
        state, metrics = step(state, d, cond, uncond, teacher)
    return state, metrics


def run_probe(
    distill_steps: int = 500,
    n_eval: int = 256,
    *,
    device: Optional[Union[str, torch.device]] = None,
    timings: Optional[dict] = None,
) -> dict:
    """Train the decoder and the teacher, distill, and measure. Returns the
    decoded manifold errors (the teacher at 50 NFE, the student before
    (= the teacher) and after distillation at 4 NFE), gap_closure = 1 −
    gap_after/gap_before ∈ (−∞, 1], the two pre-training losses, the
    student's last loss and `distill_steps`: the JAX module's keys. The
    three evaluations share one noise draw. `timings`, when given, gets
    each stage's seconds."""
    dev = resolve_device(device)
    set_fp32_precision()
    times = timings if timings is not None else {}
    t0 = _clock(dev)
    decode, dec_loss = train_decoder(device=dev)
    t1 = _clock(dev)
    _, teacher, schedule, denoise_fn, dsm_loss = train_teacher(device=dev)
    t2 = _clock(dev)
    noise = torch.randn((n_eval, *LAT_SHAPE), device=dev,
                        generator=torch.Generator(dev).manual_seed(SEEDS["eval"]))

    def error(params, steps):
        z = sample_grid(denoise_fn, params, schedule, noise, steps)
        return decoded_manifold_error(decode, z)

    err_teacher_50 = error(teacher, 50)
    err_before_4 = error(teacher, 4)
    t3 = _clock(dev)
    state, metrics = distill(denoise_fn, teacher, schedule, distill_steps)
    t4 = _clock(dev)
    err_after_4 = error(state.student, 4)
    t5 = _clock(dev)
    times.update(decoder_s=t1 - t0, teacher_s=t2 - t1, eval_before_s=t3 - t2,
                 distill_s=t4 - t3, eval_after_s=t5 - t4)
    gap_before = err_before_4 - err_teacher_50
    gap_after = err_after_4 - err_teacher_50
    return dict(
        err_teacher_50nfe=err_teacher_50,
        err_student_4nfe_before=err_before_4,
        err_student_4nfe_after=err_after_4,
        gap_closure=1.0 - gap_after / gap_before,
        decoder_loss=dec_loss,
        teacher_dsm_loss=dsm_loss,
        loss_student_final=float(metrics.loss_student) if metrics is not None else float("nan"),
        distill_steps=distill_steps,
    )
