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
`eight_bit` takes `adam8bit`, the JAX package's blockwise-int8 AdamW, which
reads the learning rate at the count AFTER the increment, as its JAX
counterpart does; `accumulation_steps > 1` wraps the chain in `multi_steps`
(optax.MultiSteps). Parameters are updated in place (`apply_updates`), which
keeps one copy of each model on the device; the JAX step returns new arrays
instead. So where optax returns zero updates inside an accumulation window,
the port returns None, and `apply_updates` leaves the parameters alone.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, NamedTuple, Optional, Union

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
    """An optimizer as a pair of functions, optax-style: `init(params) ->
    state`, `update(grads, state, params) -> (updates, state)`."""

    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Optional[Params], Any]]


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32 (optax.global_norm),
    in a few multi-tensor launches whatever the number of leaves."""
    norms = torch._foreach_norm([g.float() for g in tree.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(inner: Optimizer, max_norm: float) -> Optimizer:
    """optax.clip_by_global_norm before `inner`: g ← g / ‖g‖ · max_norm only
    where ‖g‖ ≥ max_norm (no epsilon)."""

    @torch.no_grad()
    def update(grads: Params, state, params: Params):
        norm = global_norm(grads)
        if not bool(norm < max_norm):
            keys = list(grads)
            scaled = torch._foreach_div([grads[k] for k in keys], norm)
            torch._foreach_mul_(scaled, max_norm)
            grads = dict(zip(keys, scaled))
        return inner.update(grads, state, params)

    return Optimizer(inner.init, update)


def adamw(
    lr: Union[Schedule, float],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
    mu_dtype: Optional[torch.dtype] = None,
) -> Optimizer:
    """optax.adamw, leaf by leaf; the LR at the count before the increment."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Params) -> AdamWState:
        return AdamWState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=mu_dtype or p.dtype) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def update(grads: Params, state: AdamWState, params: Params):
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


# --- 8-bit Adam: the JAX package's adam8bit ------------------------------------

Q8_BLOCK = 256
# leaves with fewer elements keep fp32 moments (the JAX package's default
# min_quantize_size)
Q8_MIN_SIZE = 4096
# elements per fused slice of the 8-bit update: its fp32 temporaries stay at
# a few x 128 MB, and a full-size model takes ~20 slices
_SLICE = 1 << 25


class Q8Moment(NamedTuple):
    """Blockwise-int8 tensor (the JAX package's `_Q8Moment`): codes in
    [-127, 127] and one fp32 absmax scale per block of 256 elements of the
    flattened, zero-padded tensor."""

    values: torch.Tensor  # int8 [padded_n]
    scales: torch.Tensor  # fp32 [padded_n // 256]


def _quantize_blocks(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 [k·256] → (fp32 codes, already rounded; fp32 [k] scales)."""
    blocks = flat.view(-1, Q8_BLOCK)
    scale = blocks.abs().amax(dim=1)
    unit = torch.clamp(blocks.abs() / torch.clamp(scale, min=1e-30)[:, None], 0.0, 1.0)
    return torch.round(torch.sign(blocks) * torch.sqrt(unit) * 127.0).view(-1), scale


def _dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 [k·256] codes and fp32 [k] scales → fp32 [k·256]: sign·u²·scale."""
    u = codes.view(-1, Q8_BLOCK).float() / 127.0
    return (torch.sign(u) * u**2 * scales[:, None]).view(-1)


def q8_quantize(x: torch.Tensor) -> Q8Moment:
    """Sqrt-companded blockwise quantization (`_q8_quantize`): u =
    sign·√(|x|/absmax)·127, rounded half to even, per block of 256 elements
    of the flattened tensor zero-padded to whole blocks."""
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % Q8_BLOCK))
    codes, scales = _quantize_blocks(flat)
    return Q8Moment(values=codes.to(torch.int8), scales=scales)


def q8_dequantize(q: Q8Moment, shape) -> torch.Tensor:
    """The fp32 tensor of `shape` a Q8Moment holds (`_q8_dequantize`)."""
    n = math.prod(shape)
    return _dequantize_blocks(q.values, q.scales)[:n].reshape(shape)


class Q8Moments(NamedTuple):
    """One Adam moment of every leaf, packed in the order of the parameter
    dict: the quantized leaves' codes and scales, each leaf zero-padded to
    whole blocks on its own (so its blocks are `q8_quantize`'s), and the
    leaves under the size gate in fp32. `leaf_moments` gives per-leaf views."""

    codes: torch.Tensor  # int8 [Σ padded sizes of the quantized leaves]
    scales: torch.Tensor  # fp32 [len(codes) // 256]
    small: torch.Tensor  # fp32 [Σ sizes of the other leaves]


class Adam8State(NamedTuple):
    count: int
    mu: Q8Moments
    nu: Q8Moments


class _Span(NamedTuple):
    """A run of consecutive leaves updated by one fused slice."""

    quantized: bool
    start: int  # offset in Q8Moments.codes (quantized) or .small
    size: int  # elements, padding included
    leaves: tuple  # ((name, shape, numel, padded numel), ...)


def _layout(params: Params) -> tuple[list[_Span], int, int]:
    """The leaves of `params` cut into slices of at most _SLICE elements (a
    larger leaf alone), the quantized ones first; and the packed sizes."""
    spans, sizes = [], {True: 0, False: 0}
    for quantized in (True, False):
        run, run_size = [], 0
        for name, p in params.items():
            n = p.numel()
            if (n >= Q8_MIN_SIZE) != quantized:
                continue
            padded = n + (-n) % Q8_BLOCK if quantized else n
            if run and run_size + padded > _SLICE:
                spans.append(_Span(quantized, sizes[quantized], run_size, tuple(run)))
                sizes[quantized] += run_size
                run, run_size = [], 0
            run.append((name, tuple(p.shape), n, padded))
            run_size += padded
        if run:
            spans.append(_Span(quantized, sizes[quantized], run_size, tuple(run)))
            sizes[quantized] += run_size
    return spans, sizes[True], sizes[False]


def _gather(tree: Params, span: _Span, pad: torch.Tensor) -> torch.Tensor:
    """The span's leaves of `tree` as one flat fp32 buffer, each leaf
    followed by its zero padding."""
    parts = []
    for name, _, n, padded in span.leaves:
        parts.append(tree[name].reshape(-1))
        if padded > n:
            parts.append(pad[: padded - n])
    return torch.cat(parts).float()


def leaf_moments(moments: Q8Moments, params: Params) -> dict:
    """name → Q8Moment (views into the packed codes and scales) for each
    quantized leaf of `params`, name → fp32 tensor (a view) for the others."""
    out = {}
    for span in _layout(params)[0]:
        off = span.start
        for name, shape, n, padded in span.leaves:
            if span.quantized:
                out[name] = Q8Moment(moments.codes[off:off + padded],
                                     moments.scales[off // Q8_BLOCK:(off + padded) // Q8_BLOCK])
            else:
                out[name] = moments.small[off:off + n].view(shape)
            off += padded
    return out


def q8_pack(moments: Params, params: Params) -> Q8Moments:
    """One fp32 moment per leaf of `params` (name → tensor of its shape) →
    the packed Q8Moments that `adam8bit` keeps for `params`: each quantized
    leaf through `q8_quantize` on its own, the others as they are."""
    codes, scales, small = [], [], []
    for span in _layout(params)[0]:
        for name, _, _, _ in span.leaves:
            m = moments[name].float()
            if span.quantized:
                q = q8_quantize(m)
                codes.append(q.values)
                scales.append(q.scales)
            else:
                small.append(m.reshape(-1))
    dev = next(iter(params.values())).device

    def cat(parts, dtype):
        return torch.cat(parts).to(dev) if parts else torch.zeros(0, dtype=dtype, device=dev)

    return Q8Moments(codes=cat(codes, torch.int8), scales=cat(scales, torch.float32),
                     small=cat(small, torch.float32))


def adam8bit(
    lr: Union[Schedule, float],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
) -> Optimizer:
    """AdamW with blockwise-int8 moments (`tdm_tpu/train/optim.py` adam8bit,
    the bitsandbytes AdamW8bit equivalent): each moment of a leaf of at
    least Q8_MIN_SIZE elements is stored as int8 codes and one fp32
    scale per 256 elements; smaller leaves keep fp32 moments. An update
    dequantizes, updates in fp32 and requantizes; the LR is read at the
    incremented count, and the weight decay is decoupled.

    The leaves are packed (`Q8Moments`) and the update runs over slices of
    the packed buffers, ~55 launches per slice of up to 2²⁵ elements, so its
    launch count follows the parameter count, not the number of leaves. The
    moments are updated in place; the returned updates are views into each
    slice's update buffer.

    A leaf is one of the port's tensors: one per layer, a weight [out, in].
    The JAX package quantizes its kernels [in, out], a stacked tree as one
    flat leaf, so on a model the same formulas run over blocks of other
    elements (and the size gate sees one layer, not the stack)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Params) -> Adam8State:
        _, n_codes, n_small = _layout(params)
        dev = next(iter(params.values())).device

        def zeros():  # q8_quantize of zeros: codes 0, scales 0
            return Q8Moments(
                codes=torch.zeros(n_codes, dtype=torch.int8, device=dev),
                scales=torch.zeros(n_codes // Q8_BLOCK, dtype=torch.float32, device=dev),
                small=torch.zeros(n_small, dtype=torch.float32, device=dev),
            )

        return Adam8State(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(grads: Params, state: Adam8State, params: Params):
        count = state.count + 1
        lr_t = lr_fn(count)
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
        first = next(iter(params.values()))
        pad = torch.zeros(Q8_BLOCK, dtype=torch.float32, device=first.device)
        updates = {}
        for span in _layout(params)[0]:
            lo, hi = span.start, span.start + span.size
            g = _gather(grads, span, pad)
            p = _gather(params, span, pad)
            if span.quantized:
                blo, bhi = lo // Q8_BLOCK, hi // Q8_BLOCK
                m = _dequantize_blocks(state.mu.codes[lo:hi], state.mu.scales[blo:bhi])
                v = _dequantize_blocks(state.nu.codes[lo:hi], state.nu.scales[blo:bhi])
            else:
                m, v = state.mu.small[lo:hi], state.nu.small[lo:hi]
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g**2
            u = -(lr_t * ((m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p))
            if span.quantized:
                for moment, new in ((state.mu, m), (state.nu, v)):
                    codes, scales = _quantize_blocks(new)
                    moment.codes[lo:hi].copy_(codes)  # exact: integers in [-127, 127]
                    moment.scales[blo:bhi].copy_(scales)
            else:
                state.mu.small[lo:hi].copy_(m)
                state.nu.small[lo:hi].copy_(v)
            off = 0
            for name, shape, n, padded in span.leaves:
                updates[name] = u[off:off + n].view(shape).to(params[name].dtype)
                off += padded
        return updates, state._replace(count=count)

    return Optimizer(init, update)


# --- gradient accumulation: optax.MultiSteps -------------------------------------


class MultiStepsState(NamedTuple):
    """optax's MultiStepsState without the skip state."""

    mini_step: int  # micro-steps into the current window
    gradient_step: int  # windows completed (optimizer steps)
    inner: Any  # the wrapped optimizer's state
    acc: Params  # the running mean of the window's gradients


def multi_steps(inner: Optimizer, every: int) -> Optimizer:
    """optax.MultiSteps(inner, every_k_schedule=every): each call folds its
    gradient into the running mean acc ← acc + (g − acc)/(n + 1); the
    `every`-th call runs `inner` on the mean and resets acc to zero, the
    others keep `inner`'s state and return None for optax's zero updates, so
    the parameters keep their bits without a pass over them."""

    def init(params: Params) -> MultiStepsState:
        return MultiStepsState(
            mini_step=0, gradient_step=0, inner=inner.init(params),
            acc={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def update(grads: Params, state: MultiStepsState, params: Params):
        keys = list(state.acc)
        acc = [state.acc[k] for k in keys]
        step = torch._foreach_sub([grads[k] for k in keys], acc)
        torch._foreach_div_(step, state.mini_step + 1)
        torch._foreach_add_(acc, step)
        if state.mini_step + 1 < every:
            return None, state._replace(mini_step=state.mini_step + 1)
        updates, inner_state = inner.update(state.acc, state.inner, params)
        torch._foreach_zero_(acc)
        return updates, MultiStepsState(
            mini_step=0, gradient_step=state.gradient_step + 1, inner=inner_state,
            acc=state.acc,
        )

    return Optimizer(init, update)


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
    (`src/main.py:206-224, 537`); `eight_bit` takes `adam8bit` for AdamW and
    `accumulation_steps > 1` wraps the chain in `multi_steps` (the clip then
    sees the window's mean gradient)."""
    if eight_bit:
        tx = adam8bit(lr, b1=betas[0], b2=betas[1], eps=eps, weight_decay=weight_decay)
    else:
        tx = adamw(lr, b1=betas[0], b2=betas[1], eps=eps, weight_decay=weight_decay,
                   mu_dtype=torch.bfloat16 if low_precision_moments else None)
    if max_grad_norm is not None:
        tx = clip_by_global_norm(tx, max_grad_norm)
    return multi_steps(tx, accumulation_steps) if accumulation_steps > 1 else tx


@torch.no_grad()
def apply_updates(params: Params, updates: Optional[Params]) -> None:
    """p ← p + u, in place, in p's dtype (optax.apply_updates), in a few
    multi-tensor launches; None (a micro-step inside an accumulation
    window) leaves `params` as they are."""
    if updates is None:
        return
    keys = list(params)
    torch._foreach_add_([params[k] for k in keys], [updates[k] for k in keys])


@torch.no_grad()
def ema_update(ema_params: Params, new_params: Params, decay: float) -> None:
    """Polyak average e ← d·e + (1−d)·p, in place (the diffusers EMAModel
    equivalent)."""
    for k, e in ema_params.items():
        e.copy_(decay * e + (1.0 - decay) * new_params[k].to(e.dtype))
