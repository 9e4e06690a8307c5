"""Mixture-of-Experts feed-forward and its expert parallelism.

Port of `tdm_tpu/models/moe.py`: the GShard/Switch static-capacity MoE
that replaces a PixArt block's MLP when `PixArtConfig.moe_experts > 0`.
The function is the JAX module's (`:68-160`):

  * router: one fp32 Dense (no bias) on x in fp32 → softmax over E experts;
    top-k by probability, ties to the lower index (`jax.lax.top_k`); the k
    gates renormalised over the chosen k (`normalize_gates`);
  * capacity C = max(1, min(ceil(cf·k·T/E), T)) over the call's T tokens;
  * position-in-expert by a cumsum in slot-major order (slot 0 of every
    token claims capacity before slot 1); pairs at or past C are dropped
    and contribute 0, with no renormalisation of the kept gates;
  * stacked experts `experts_in` [E, D, F] ([E, D, 2F] under geglu),
    `experts_in_bias`, `experts_out` [E, F, D], `experts_out_bias`, run in
    the compute dtype; activations 'gelu-approximate', 'gelu' and 'geglu'
    (whose gate takes the tanh GELU, as the JAX module);
  * combine: each kept pair's expert output times its gate, the gate cast
    to the compute dtype first.

The route differs from the JAX module's form, not its function. JAX builds
one-hot dispatch/combine tensors [T, E, C] and contracts them with einsums,
XLA's static-shape idiom; in eager PyTorch at PixArt-α-512's batch 4 that
is 2 × 97 GFLOP and ~0.7 GB of one-hots a layer. Here each kept pair's
token row is copied into an [E, C, D] buffer at its position-in-expert
(`index_copy`), the experts run as two batched products over the buffer
(the same [E, C] slots, empty ones zero, as JAX computes them), and each
pair's output row is gathered back and summed with its gate. The result is
the einsums' up to the order of a ≤k-term sum. `plain_moe` keeps the JAX
form (one-hot einsums) beside it for the tests; no path runs it.

The Switch load-balance term E·Σ_e (dispatch share of slot 0)·(mean
probability) (`:91-99`) is recorded on the layer at every forward, as a
detached value (`aux`); `moe_aux_loss(model)` sums the last forward's.
TDM training does not use it, as in JAX.

Across processes (`Dispatch`, set by the step's reducer,
`parallel/mesh.py`): the JAX module runs over the GLOBAL batch under GSPMD,
so its capacity and its slot-major cumsum run over every data rank's tokens
in the global order. A rank here holds `rows` rows of each block of a call
(one block for a plain call, two for the CFG call `[x; x]`, whose global
order is `[x of all ranks; x of all ranks]`); it all-gathers each block's
per-(slot, expert) counts over the ranks that hold distinct rows, takes
the exclusive prefix in the global order (slot, block, rank) and adds it to
its local cumsum, so its drops are those of the global batch. Only the
drop decision crosses tokens: each kept pair's output is MLP_e(x) alone.
With expert parallelism each 'ep' rank holds experts [e·E/n, (e+1)·E/n) of
every expert leaf (`experts_in` of shape [E/n, ...]) and computes only
their pairs, which hold a buffer of min(C, T_local) rows an expert; the
partial combine is summed over the 'ep' group (all_reduce forward, identity
backward), and the experts' input and the gates pass an identity whose
backward sums the gradient over the group, so x's and the router's
gradients are whole on every 'ep' rank.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Iterator

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tdm_tpu_torch.models import layers as L

ACTIVATIONS = ("gelu-approximate", "gelu", "geglu")


@dataclass(frozen=True)
class Dispatch:
    """Where a MoE call's tokens sit in the global batch, and which experts
    this process holds. `rows`: this rank's rows in each block of a call
    (0: a call is one block); `index` of `count` ranks holding distinct
    rows, `group` their process group; `ep_index` of `n_ep` ranks sharing
    rows and splitting the experts, `ep_group` theirs."""

    rows: int = 0
    index: int = 0
    count: int = 1
    group: Any = None
    ep_index: int = 0
    n_ep: int = 1
    ep_group: Any = None


# the dispatch of the current calls: one for the process, not per thread, as
# a remat block's forward runs again on the autograd engine's thread
_DISPATCH = [Dispatch()]


@contextlib.contextmanager
def dispatching(d: Dispatch) -> Iterator[Dispatch]:
    """MoE calls inside the block see `d` (the step's reducer sets it)."""
    prev = _DISPATCH[0]
    _DISPATCH[0] = d
    try:
        yield d
    finally:
        _DISPATCH[0] = prev


class _GradSum(torch.autograd.Function):
    """Identity forward; the gradient summed over `group` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Sum(torch.autograd.Function):
    """Summed over `group` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest in descending
    order, ties to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(factor: float, k: int, tokens: int, experts: int) -> int:
    """C = max(1, min(ceil(cf·k·T/E), T)) (the JAX module's `cap`)."""
    return max(1, min(int(math.ceil(factor * k * tokens / experts)), tokens))


def route(probs: torch.Tensor, k: int, normalize: bool):
    """(gates [T, k], experts [T, k]) of the router's probabilities."""
    gates, idx = top_k(probs, k)
    if normalize:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def switch_aux(probs: torch.Tensor, idx: torch.Tensor, weight: float) -> torch.Tensor:
    """The Switch term weight·E·Σ_e mean(slot-0 one-hot)_e · mean(probs)_e."""
    e = probs.shape[-1]
    first = F.one_hot(idx[:, 0], e).float()
    return weight * e * torch.sum(first.mean(0) * probs.mean(0))


def _expert_major(idx: torch.Tensor, experts: int) -> torch.Tensor:
    """The one-hot [E, k, T] of the pairs' experts (idx [T, k]), expert
    first, so that its cumsums run along the last, contiguous axis (a
    parallel scan; along a leading axis a scan is sequential)."""
    arange = torch.arange(experts, device=idx.device)[:, None, None]
    return (idx.T[None] == arange).int().contiguous()


def positions(idx: torch.Tensor, experts: int, tokens_per_block: int,
              d: Dispatch) -> torch.Tensor:
    """Each pair's position-in-expert [k, T] in the global slot-major
    order: within one process the running count of its expert's pairs
    over (slot, token); across `d.count` ranks the count within its block
    plus the exclusive prefix of every rank's counts in the order (slot,
    block, rank)."""
    k, t = idx.shape[1], idx.shape[0]
    hot = _expert_major(idx, experts)
    if d.count == 1:
        pos = hot.view(experts, k * t).cumsum(1).view(experts, k, t)
    else:
        if t % tokens_per_block:
            raise ValueError(
                f"a MoE call of {t} tokens is not whole blocks of {tokens_per_block}")
        nb = t // tokens_per_block
        blocks = hot.view(experts, k, nb, tokens_per_block)
        counts = blocks.sum(3)  # [E, k, nb]
        gathered = counts.new_empty(d.count * counts.numel())
        dist.all_gather_into_tensor(gathered, counts.reshape(-1), group=d.group)
        order = gathered.view(d.count, experts, k, nb).permute(1, 2, 3, 0).reshape(experts, -1)
        before = (order.cumsum(1) - order).view(experts, k, nb, d.count)[..., d.index]
        pos = (blocks.cumsum(3) + before[..., None]).view(experts, k, t)
    return pos.gather(0, idx.T[None])[0] - 1


class MoEFeedForward(nn.Module):
    """Drop-in for `layers.FeedForward` with E experts: forward(x [B, S, D])
    → [B, S, D] in x's dtype. With `num_experts=1, top_k=1` and capacity ≥
    tokens it is the dense MLP. The router is held in fp32 always; the
    experts in `param_dtype` (default `dtype`) and run in `dtype`."""

    def __init__(self, dim: int, num_experts: int, top_k: int = 2, mult: int = 4,
                 capacity_factor: float = 1.25, activation: str = "gelu-approximate",
                 normalize_gates: bool = True, aux_loss_weight: float = 1.0, *,
                 dtype, param_dtype=None, device=None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, num_experts={num_experts}]")
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.normalize_gates = normalize_gates
        self.aux_loss_weight = aux_loss_weight
        self.compute_dtype = dtype
        self.aux = None  # the last forward's Switch term, detached
        inner = dim * mult * (2 if activation == "geglu" else 1)
        pdt = param_dtype or dtype
        self.router = L.Dense(dim, num_experts, bias=False, dtype=torch.float32,
                              param_dtype=torch.float32, device=device)

        def stack(*shape, fan_in):
            w = torch.empty(shape, dtype=torch.float32, device=device)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # flax's truncated normal
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)
            return nn.Parameter(w.to(pdt))

        self.experts_in = stack(num_experts, dim, inner, fan_in=dim)
        self.experts_in_bias = nn.Parameter(torch.zeros(num_experts, inner, dtype=pdt,
                                                        device=device))
        self.experts_out = stack(num_experts, dim * mult, dim, fan_in=dim * mult)
        self.experts_out_bias = nn.Parameter(torch.zeros(num_experts, dim, dtype=pdt,
                                                         device=device))

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        """The experts' activation on [E, C, F'] in the compute dtype."""
        if self.activation == "geglu":
            h, gate = h.chunk(2, dim=-1)
            return h * F.gelu(gate, approximate="tanh")
        return F.gelu(h, approximate="tanh" if self.activation == "gelu-approximate" else "none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = _DISPATCH[0]
        b, s, dim = x.shape
        xt = x.reshape(b * s, dim)
        gates, idx, pos, cap = self._route(xt, s, d)
        buf, flat, mine = self._dispatch(xt, idx, pos, cap, d)
        y = self._combine(self._experts(buf), flat, gates, mine, d)
        return y.to(self.compute_dtype).reshape(b, s, dim).to(x.dtype)

    # the four parts of a call, methods so that a profile can name them

    def _route(self, xt: torch.Tensor, seq: int, d: Dispatch):
        """The router in fp32, top-k, the Switch term, and each pair's
        position-in-expert [k, T] in the global slot-major order."""
        e, k, t = self.num_experts, self.top_k, xt.shape[0]
        probs = torch.softmax(self.router(xt.float()), dim=-1)  # [T, E] fp32
        gates, idx = route(probs, k, self.normalize_gates)
        self.aux = switch_aux(probs, idx, self.aux_loss_weight).detach()
        cap = capacity(self.capacity_factor, k, t * d.count, e)
        return gates, idx, positions(idx, e, d.rows * seq, d), cap

    def _dispatch(self, xt, idx, pos, cap: int, d: Dispatch):
        """This rank's kept pairs' token rows copied into the [n, rows, D]
        buffer of its n experts (rows = min(C, T): an expert keeps at most
        C pairs and one a token) at their rank among the expert's kept
        pairs here, which within one process is the position-in-expert;
        every other pair writes a sink row. Returns (buffer with the sink
        row last, each pair's row, which pairs are this rank's)."""
        e, k, t = self.num_experts, self.top_k, xt.shape[0]
        n = self.experts_in.shape[0]
        if n != e and n * d.n_ep != e:
            raise ValueError(f"{n} of {e} experts held by one of {d.n_ep} 'ep' ranks")
        local = idx.T - (d.ep_index * n if n != e else 0)  # [k, T]
        mine = (pos < cap) & (local >= 0) & (local < n)
        rows = min(cap, t)
        here = local.clamp(0, n - 1)
        if n == e and d.count == 1:  # every pair before a kept one is kept
            slot = pos
        else:
            hot = _expert_major(here.T, n) * mine[None]
            slot = hot.view(n, k * t).cumsum(1).view(n, k, t).gather(0, here[None])[0] - 1
        flat = torch.where(mine, here * rows + slot, n * rows).reshape(-1)
        xe = _GradSum.apply(xt, d.ep_group) if n != e else xt
        xe = xe.to(self.compute_dtype)
        buf = xe.new_zeros(n * rows + 1, xt.shape[1]).index_copy(0, flat, xe.repeat(k, 1))
        return buf, flat, mine

    def _experts(self, buf: torch.Tensor) -> torch.Tensor:
        """The expert MLPs over the buffer (two batched products in the
        compute dtype); the sink row's output is 0."""
        cdt, n, dim = self.compute_dtype, self.experts_in.shape[0], buf.shape[1]
        x = buf[:-1].view(n, -1, dim)
        h = torch.baddbmm(self.experts_in_bias.to(cdt)[:, None], x, self.experts_in.to(cdt))
        out = torch.baddbmm(self.experts_out_bias.to(cdt)[:, None], self._mlp(h),
                            self.experts_out.to(cdt))
        return torch.cat([out.reshape(-1, dim), out.new_zeros(1, dim)])

    def _combine(self, out, flat, gates, mine, d: Dispatch) -> torch.Tensor:
        """Each pair's output row gathered back and summed with its gate
        (cast to the compute dtype) in fp32: [T, D]; the partial sums of the
        'ep' ranks summed over the group."""
        k, t = gates.shape[1], gates.shape[0]
        sharded = self.experts_in.shape[0] != self.num_experts
        # 0 for a dropped pair or another rank's; each rank's gradient
        # reaches its own pairs' gates, summed over 'ep' to all of them
        g = (_GradSum.apply(gates.T, d.ep_group) if sharded else gates.T) * mine
        y = torch.einsum("kt,ktd->td", g.to(self.compute_dtype).float(),
                         out[flat].view(k, t, -1).float())
        return _Sum.apply(y, d.ep_group) if sharded else y


def plain_moe(m: MoEFeedForward, x: torch.Tensor) -> torch.Tensor:
    """The JAX module's own form (`tdm_tpu/models/moe.py:101-160`) on `m`'s
    parameters, one process, every expert: one-hot position, dispatch and
    combine tensors contracted by einsums. The tests' reference for the
    row route; no path runs it."""
    e, k, cdt = m.num_experts, m.top_k, m.compute_dtype
    b, s, dim = x.shape
    t = b * s
    xt = x.reshape(t, dim)
    probs = torch.softmax(xt.float() @ m.router.weight.float().T, dim=-1)
    gates, idx = route(probs, k, m.normalize_gates)
    cap = capacity(m.capacity_factor, k, t, e)
    slot_hot = F.one_hot(idx.T, e)  # [k, T, E]
    pos = (slot_hot.reshape(k * t, e).cumsum(0) - 1).view(k, t, e)
    within = (pos < cap) & (slot_hot > 0)
    disp_k = F.one_hot(pos.clamp(0, cap - 1), cap).float() * within[..., None].float()
    dispatch = disp_k.sum(0)  # [T, E, C]
    combine = (disp_k * gates.T[:, :, None, None].float()).sum(0)
    ex_in = torch.einsum("tec,td->ecd", dispatch.to(cdt), xt.to(cdt))
    h = (torch.einsum("ecd,edf->ecf", ex_in, m.experts_in.to(cdt))
         + m.experts_in_bias.to(cdt)[:, None])
    ex_out = (torch.einsum("ecf,efd->ecd", m._mlp(h), m.experts_out.to(cdt))
              + m.experts_out_bias.to(cdt)[:, None])
    y = torch.einsum("tec,ecd->td", combine.to(cdt), ex_out)
    return y.reshape(b, s, dim).to(x.dtype)


def moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """The sum of the Switch terms every MoE layer of `model` recorded in
    its last forward (the JAX `moe_aux_loss` over the sowed entries)."""
    total = torch.zeros((), dtype=torch.float32)
    for m in model.modules():
        if isinstance(m, MoEFeedForward) and m.aux is not None:
            total = total + m.aux.cpu()
    return total


def is_expert_key(key: str) -> bool:
    """Whether a state_dict key names an expert stack (leading expert axis):
    its leaf's name starts with 'experts', `ep_shardings`' rule."""
    return key.rsplit(".", 1)[-1].startswith("experts")


def expert_slice(key: str, t: torch.Tensor, index: int, n_ep: int) -> torch.Tensor:
    """Rank `index`'s experts of an expert leaf (its leading axis cut in
    `n_ep` equal parts); ValueError when they do not divide."""
    if t.shape[0] % n_ep:
        raise ValueError(
            f"expert leaf {key} has {t.shape[0]} experts on axis 0, not divisible by the "
            f"'ep' mesh axis ({n_ep}) — pick a divisor or drop the ep axis")
    n = t.shape[0] // n_ep
    return t[index * n:(index + 1) * n]
