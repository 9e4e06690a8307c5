"""Megatron tensor parallelism (`--tp`) across processes.

Port of `tdm_tpu/parallel/tp.py`. The JAX package states tensor
parallelism as a name-driven GSPMD sharding rule and leaves the
collectives to XLA. The port runs one process per GPU and makes them
itself:

  * The JAX package's name-driven rule on the port's modules (`plan`,
    `parallelize`): column-parallel (output features cut) to_q/to_k/to_v,
    add_{q,k,v}_proj and a feed-forward's `proj_in`; row-parallel (input
    features cut, the bias replicated and added once after the sum)
    to_out, to_add_out and a feed-forward's `proj_out`; everything else
    replicated (the model-level proj_out, pos_embed.proj, ...). Each module
    names its own cuts (`tp_cuts`). Torch's weight is [out, in]: a column
    layer cuts dim 0, a row layer dim 1. A
    module is cut only where the tp size divides its heads (or its
    feed-forward's inner width): each rank then runs heads/n of them and
    holds the matching slices. Elsewhere the module runs replicated and no
    collective runs in it (the JAX rule cuts any divisible leaf, even
    mid-head). GEGLU's `proj_in` emits [h | gate]: each rank takes the
    matching slices of both halves (`Cut.halves`).
  * The two collectives as autograd Functions: `copy_to_tp` (Megatron's f:
    identity forward, all-reduce over 'tp' in the backward) at a
    column-parallel input, and `reduce_from_tp` (g: all-reduce forward,
    identity backward) at a row-parallel output. A per-head norm's weights
    (SD3's RMS qk norm, CogVideoX's norm_q/norm_k) go through f as well,
    since each rank sees only its heads' share of their gradient.
  * `shard_params_tp` cuts a state dict to this rank's slices and
    `gather_leaf` puts one leaf back into the one-process layout.

Serving across processes (`TPWorld`, `follow`): rank 0 draws the noise,
encodes the prompts and broadcasts both with the call's settings; the
followers hold the denoiser alone and run the sampler in step with it;
rank 0 decodes. A server or `generate` asked for `--tp N` starts the N−1
followers itself (`launch`), or joins a world that torchrun or the
TDM_* variables already formed.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import threading
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

# the shared adaLN modulation heads, replicated under --fsdp as the JAX
# package's `tp_fsdp_spec` keeps them (`tdm_tpu/parallel/tp.py:141-182`)
MODULATION_HEADS = {"t_block", "norm_out"}


def is_modulation_head(key: str) -> bool:
    """Whether a port state-dict key ('.'-joined, or a LoRA factor's
    '/'-joined path) lies under t_block or norm_out (the last three parts
    of its path, as the JAX package's `tp_fsdp_spec` reads them)."""
    return any(n in MODULATION_HEADS for n in key.replace("/", ".").split(".")[-3:])


# ---- this rank's place on the 'tp' axis ----

@dataclass(frozen=True)
class TPGroup:
    """The 'tp' axis as one rank sees it: its size, this rank's index on it
    and the process group over it (None at n == 1)."""

    n: int
    index: int = 0
    group: Any = None


def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    t = t.contiguous()
    dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: the identity, and an all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        copy_to_tp.calls += 1
        return _all_reduce(grad.clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: an all-reduce, and the identity on the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """f at a column-parallel input: x itself forward; the backward sums
    the ranks' partial gradients, in x's dtype (counted in
    `copy_to_tp.calls`). Without autograd, x."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """g at a row-parallel output: the sum of the ranks' partial products
    (one all-reduce, counted in `reduce_from_tp.calls`)."""
    reduce_from_tp.calls += 1
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, tp.group)
    return _all_reduce(x.clone(), tp.group)


def all_reduce_max(t: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The elementwise max over the 'tp' ranks (int8's absmax of a cut K)."""
    return _all_reduce(t.clone(), tp.group, dist.ReduceOp.MAX)


def all_reduce_sum(t: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The sum over the 'tp' ranks, outside autograd (int8's int32
    accumulators: exact)."""
    reduce_from_tp.calls += 1
    return _all_reduce(t.clone(), tp.group)


copy_to_tp.calls = 0
reduce_from_tp.calls = 0


def reset_counts() -> None:
    copy_to_tp.calls = 0
    reduce_from_tp.calls = 0


# ---- the rule on the port's modules ----

@dataclass(frozen=True)
class Cut:
    """How a leaf is cut over 'tp': along `dim`, in `halves` equal blocks
    each cut in n (GEGLU's [h | gate] proj_in: 2), rank i keeping part i
    of every block."""

    dim: int
    halves: int = 1


COLUMN, ROW = Cut(0), Cut(1)


def cut(t: torch.Tensor, c: Cut, index: int, n: int) -> torch.Tensor:
    """Rank `index`'s part of the whole leaf `t` (a view where it can be)."""
    if c.halves == 1:
        return t.chunk(n, c.dim)[index]
    return torch.cat([h.chunk(n, c.dim)[index] for h in t.chunk(c.halves, c.dim)], c.dim)


def uncut(parts: list, c: Cut) -> torch.Tensor:
    """The whole leaf from every rank's part, in rank order."""
    if c.halves == 1:
        return torch.cat(parts, c.dim)
    blocks = [p.chunk(c.halves, c.dim) for p in parts]
    return torch.cat([b[h] for h in range(c.halves) for b in blocks], c.dim)


def plan(model: torch.nn.Module, n: int) -> dict:
    """port state-dict key → Cut for every leaf cut over n 'tp' ranks: the
    leaves of each module whose `tp_cuts(n)` names them (Attention,
    FeedForward and the SD3 and CogVideoX blocks' own projections, where n
    divides their heads or inner width)."""
    out = {}
    if n <= 1:
        return out
    for name, mod in model.named_modules():
        cuts = getattr(mod, "tp_cuts", None)
        if cuts is None:
            continue
        for leaf, c in cuts(n).items():
            out[f"{name}.{leaf}" if name else leaf] = c
    return out


def parallelize(model: torch.nn.Module, tp: TPGroup) -> dict:
    """Cut `model` in place for this rank: every module that `plan` cuts
    runs its share (its `tp` set), its Dense layers in column or row mode,
    its parameters replaced by this rank's slices. Returns the plan. At
    n == 1 nothing changes."""
    layout = plan(model, tp.n)
    if not layout:
        return layout
    params = dict(model.named_parameters())
    for name, mod in model.named_modules():
        cuts = getattr(mod, "tp_cuts", None)
        if cuts is None or not cuts(tp.n):
            continue
        mod.set_tp(tp)
    for key, c in layout.items():
        owner, leaf = key.rsplit(".", 1)
        mod = model.get_submodule(owner)
        p = params[key]
        setattr(mod, leaf, torch.nn.Parameter(cut(p.detach(), c, tp.index, tp.n).clone(),
                                              requires_grad=p.requires_grad))
    return layout


def shard_params_tp(state: dict, layout: dict, tp: TPGroup) -> dict:
    """This rank's part of a whole state dict (one-process layout): each
    leaf of `layout` cut, the others as they are."""
    return {k: cut(v, layout[k], tp.index, tp.n).clone() if k in layout else v
            for k, v in state.items()}


def gather_leaf(t: torch.Tensor, c: Cut, tp: TPGroup) -> torch.Tensor:
    """A whole leaf from every 'tp' rank's part of it (one all_gather)."""
    from tdm_tpu_torch.parallel.mesh import all_gather_flat

    out = all_gather_flat(t.reshape(-1), tp.group)
    return uncut([p.view(t.shape) for p in out.chunk(tp.n)], c)


def lora_cutter(layout: dict, tp: TPGroup):
    """The LoRA merge's `cut(key, delta)`: a whole delta → this rank's part
    of it; under autograd the delta passes f first, so its gradient is the
    whole one on every rank (the factors stay replicated)."""
    def fn(key: str, delta: torch.Tensor) -> torch.Tensor:
        c = layout.get(key)
        if c is None:
            return delta
        return cut(copy_to_tp(delta, tp), c, tp.index, tp.n)

    return fn


# ---- serving across processes ----

# a served world idles between requests for as long as it likes
SERVE_TIMEOUT = datetime.timedelta(days=30)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_env() -> bool:
    """Whether the environment already names a world (TDM_* or torchrun's
    variables)."""
    env = os.environ
    return bool(env.get("TDM_COORDINATOR")) or ("WORLD_SIZE" in env and "RANK" in env)


def backend_for(device: torch.device) -> str:
    """gloo on the CPU and where every rank shares one named card (NCCL
    refuses two ranks on one GPU), NCCL across cards."""
    return "nccl" if device.type == "cuda" and device.index is None else "gloo"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """A rank's device: cuda:rank for an unnamed card (one process per
    GPU), the named card or the CPU as they are."""
    if device.type == "cuda" and device.index is None:
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


class TPWorld:
    """A 'tp' world for serving, from rank 0's side: the followers it
    started (if any), a watcher that ends this process with exit code 3 when
    one of them dies, and `stop()`, which tells the followers to leave, waits
    for them and takes the process group down."""

    def __init__(self, tp: TPGroup, procs: Optional[list] = None, env: tuple = ()):
        self.tp = tp
        self.procs = procs or []
        self._env = env  # the variables `launch` set in this process
        self._stopping = threading.Event()
        if self.procs:
            threading.Thread(target=self._watch, name="tdm-tp-watch", daemon=True).start()

    def _watch(self) -> None:
        while not self._stopping.wait(0.5):
            for r, p in enumerate(self.procs, start=1):
                code = p.poll()
                if code is not None and not self._stopping.is_set():
                    print(f"tdm-tp: follower rank {r} exited with {code}; stopping",
                          file=sys.stderr, flush=True)
                    # a call in flight fails on its collective; then this process ends
                    self._stopping.wait(2.0)
                    os._exit(3)

    def stop(self, timeout: float = 60.0) -> None:
        """The followers' stop message, then their exits (a follower that
        exits non-zero, or not at all, raises RuntimeError)."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        try:
            if self.tp.n > 1 and dist.is_initialized():
                dist.broadcast_object_list([None], src=0, group=self.tp.group)
        finally:
            bad = []
            for r, p in enumerate(self.procs, start=1):
                try:
                    code = p.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    p.kill()
                    code = p.wait()
                if code != 0:
                    bad.append((r, code))
            if dist.is_initialized():
                dist.destroy_process_group()
            for var in self._env:
                os.environ.pop(var, None)
            if bad:
                raise RuntimeError(f"tp followers exited non-zero: {bad}")


def check_devices(n: int, device: torch.device) -> None:
    """A world of n ranks on `device`: an unnamed CUDA device means
    cuda:0..n−1, all of which must exist (no smaller world); a named card or
    the CPU holds every rank."""
    if device.type == "cuda" and device.index is None:
        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(f"--tp {n} needs {n} CUDA devices; {count} visible")


def launch(module: str, argv: list, n: int, device: torch.device) -> TPWorld:
    """Form a world of `n` processes for serving with this process as rank
    0: join the one the environment names (its size must be n), else start
    `python -m module argv` n−1 times as ranks 1..n−1 with TDM_COORDINATOR
    on a free local port. Returns the TPWorld."""
    from tdm_tpu_torch.parallel import mesh as pmesh

    procs, env = [], ()
    if not world_env():
        port = free_port()
        base = dict(os.environ, TDM_COORDINATOR=f"tcp://127.0.0.1:{port}",
                    TDM_NUM_PROCESSES=str(n))
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            base.pop(var, None)
        procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                                  env=dict(base, TDM_PROCESS_ID=str(r)))
                 for r in range(1, n)]
        env = ("TDM_COORDINATOR", "TDM_NUM_PROCESSES", "TDM_PROCESS_ID")
        os.environ.update(TDM_COORDINATOR=base["TDM_COORDINATOR"],
                          TDM_NUM_PROCESSES=str(n), TDM_PROCESS_ID="0")
    try:
        pmesh.maybe_initialize_distributed(device.type, backend=backend_for(device),
                                           timeout=SERVE_TIMEOUT)
        if pmesh.world_size() != n:
            raise ValueError(f"--tp {n} in a world of {pmesh.world_size()} processes")
        if pmesh.rank() != 0:
            raise ValueError(f"launch() runs on rank 0, not rank {pmesh.rank()}")
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        for var in env:
            os.environ.pop(var, None)
        raise
    rank_device(device, 0)
    return TPWorld(TPGroup(n, 0, dist.group.WORLD), procs, env)


def run_follower(n: int, device: torch.device, load) -> int:
    """A follower process of a served world (`launch` started it, or
    torchrun): join the world, `load(device)` this rank's pipeline (the
    denoiser alone), cut it and follow rank 0's calls until the stop
    message. Returns 0."""
    from tdm_tpu_torch.parallel import mesh as pmesh

    if not pmesh.maybe_initialize_distributed(device.type, backend=backend_for(device),
                                              timeout=SERVE_TIMEOUT):
        raise ValueError("a tp follower needs the world's TDM_* or torchrun variables")
    if pmesh.world_size() != n:
        raise ValueError(f"--tp {n} in a world of {pmesh.world_size()} processes")
    tp = TPGroup(n, pmesh.rank(), dist.group.WORLD)
    pipe = load(rank_device(device, tp.index))
    pipe.tensor_parallel = tp
    follow(pipe, tp)
    dist.destroy_process_group()
    return 0


def is_follower() -> bool:
    """Whether this process is rank 1.. of a world the environment names."""
    env = os.environ
    if env.get("TDM_COORDINATOR"):
        return int(env.get("TDM_PROCESS_ID", "0")) != 0
    return world_env() and int(env["RANK"]) != 0


def _host(tree):
    """Tensors of a call's inputs and settings copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def _put(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_put(t, dev) for t in tree)
    if isinstance(tree, dict):
        return {k: _put(v, dev) for k, v in tree.items()}
    return tree


def lead(tp: TPGroup, noise, cond, uncond, kw: dict) -> None:
    """Rank 0's side of one call: its noise, conditioning and settings to
    every follower (host copies, one broadcast)."""
    dist.broadcast_object_list([_host((noise, cond, uncond, kw))], src=0, group=tp.group)


def follow(pipe, tp: TPGroup) -> int:
    """A follower's loop: each call rank 0 broadcasts runs the pipeline's
    sampler on this rank's share of the denoiser (no decode; the follower
    holds no decoder), until the stop message. Returns the calls served."""
    served = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=tp.group)
        if box[0] is None:
            return served
        noise, cond, uncond, kw = _put(box[0], pipe.device)
        with torch.inference_mode():
            pipe._run(noise, cond, uncond, **dict(kw, output_type="latent"))
        served += 1
