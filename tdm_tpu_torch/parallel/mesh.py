"""Process groups, the ('data', 'fsdp', 'ep', 'sp', 'tp') mesh, the
gradient mean, ZeRO-3, expert parallelism, the state under tensor
parallelism and the ring permute of sequence parallelism.

Port of `tdm_tpu/parallel/mesh.py`. The reference's distributed surface is
data parallelism over N GPUs (accelerate process groups over NCCL, the DDP
allreduce in `backward`, `src/main.py:93-98,321-323,535`) with optional
DeepSpeed ZeRO-3 parameter sharding (`:141-160`). The JAX package compiles
that from shardings; the port makes the collectives itself, with one
process per GPU (a JAX process drives every local device instead):

  * `maybe_initialize_distributed`: the process group from the JAX
    package's TDM_COORDINATOR / TDM_NUM_PROCESSES / TDM_PROCESS_ID, or
    from torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
    MASTER_PORT; NCCL for CUDA, gloo for the CPU. A world that was asked
    for and does not form raises; nothing carries on at world 1.
  * `Mesh`: the ('data', 'fsdp', 'ep') axes over the world, rank =
    (d·n_fsdp + f)·n_ep + e (the JAX mesh's row-major order,
    `tdm_tpu/cli/train_tdm.py:137-151`). 'fsdp' ranks process rows of their
    own (`batch_rows`), as in `batch_sharding`; 'ep' ranks share their rows
    (the JAX CLI's data ranks are world // ep) and split the experts.
  * `DataParallel`: the compute copy is the master weights, and gradients
    are averaged over the world with one flattened all_reduce per dict
    (the JAX step's psum).
  * `ZeRO3` over a `ShardLayout` per role: `fsdp_spec`'s selection rule
    (each leaf of at least 2¹⁶ elements is sharded, smaller ones stay
    replicated) with a layout of the port's own: the leaf flattened,
    zero-padded and cut into n_fsdp equal contiguous chunks, one per
    'fsdp' rank, each a whole number of 8-bit Adam's 256-element blocks.
    Master weights, optimizer state and the EMA live on the chunks; the
    whole compute copy is gathered before the forwards that read it (not
    layer by layer), gradients are reduce-scattered onto the chunks and
    averaged over the data axis, and the clip's global norm sums the
    chunks' squares with one all_reduce. The arithmetic per element is the
    unsharded step's, so the numbers are its own up to the order of the
    norm's sum.
  * Expert parallelism (`--ep`, the port's `ep_shardings`,
    `tdm_tpu/models/moe.py:181-248`): each 'ep' rank holds experts
    [e·E/n_ep, (e+1)·E/n_ep) of every expert leaf (`models/moe.is_expert_key`)
    of the student, the critic, their optimizer states, the EMA and the
    teacher; under --fsdp its slices are then chunked over 'fsdp' by the
    rule above. An expert leaf's gradient is averaged over the data×fsdp
    ranks only; every other leaf's over the world, where the 'ep' ranks'
    copies are equal (the MoE layer makes x's and the router's gradients
    whole on each). The MoE layer's drops follow the global batch
    (`moe_scope`, `models/moe.Dispatch`), under plain data parallelism too.
    Checkpoints keep the one-process layout: the experts are gathered over
    'ep' for process 0's write and cut again on resume.
  * Tensor parallelism (`--tp`, `parallel/tp.py`): 'tp' is the innermost
    axis, rank = ((d·n_fsdp + f)·n_ep + e)·n_tp + t (JAX's
    `make_train_mesh` order; 'ep' and 'tp' never both exceed 1). The 'tp'
    ranks share their rows. Each holds its slice of every leaf the model's
    tp plan cuts (`ShardLayout(..., tp_plan=)`), in the student, the critic,
    their optimizer states, the EMA and the teacher; under --fsdp the slice
    is then chunked over 'fsdp'. A tp leaf's gradient is averaged over the
    data×fsdp ranks only; a replicated leaf's over the world, where its
    copies are equal (f's backward all-reduce makes them whole). The clip's
    norm counts each tp slice once. The checkpoint gathers the slices.
  * Under --fsdp the shared adaLN heads (`t_block`, `norm_out`) stay
    replicated, as the JAX CLI's `tp_fsdp_spec` keeps them with or without
    'tp'.
  * Sequence parallelism (`--sp`, CogVideoX only): 'sp' sits between 'ep'
    and 'tp', rank = (((d·n_fsdp + f)·n_ep + e)·n_sp + s)·n_tp + t, so it
    is innermost on the training meshes ('data', 'sp') and ('data', 'fsdp',
    'sp') and 'tp' is innermost on the pipeline's ('data', 'sp', 'tp'), as
    in the JAX package (`tdm_tpu/cli/train_tdm.py:151-175`,
    `tests/test_cogvideox_sp.py:98-140`). Under 'sp' only 'data' splits
    rows (`batch_sharding`, `tdm_tpu/parallel/mesh.py:152-165`): the sp and
    fsdp ranks of one data index read the same prompts, take the same
    draws and hold one video's frames each (`models/cogvideox.py`). A
    rank's parameter gradient is then its frames' share of its rows', so
    the reducers sum over the world and divide by the ranks that hold
    distinct rows' whole gradients, world / n_sp: the mean over 'data' of
    the sum over 'sp' (under --fsdp the 'fsdp' ranks' copies are equal, and
    their reduce-scatter sum is divided out too). `ppermute` moves tensors
    to the next rank of the 'sp' ring (`ops/ring_attention.py`).

At world 1 nothing here runs: the training CLI passes the step no reducer,
so the single-GPU step issues no collective and makes no copy.
"""

from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tdm_tpu_torch.models import moe
from tdm_tpu_torch.parallel import tp as tp_lib
from tdm_tpu_torch.train import optim as topt

# fsdp_spec's size gate: smaller leaves stay replicated
SHARD_MIN_SIZE = 2**16


def maybe_initialize_distributed(
    device_type: str = "cuda",
    *,
    backend: Optional[str] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Form the process group the environment asks for, the `accelerate
    launch --num_processes=N` equivalent (reference `README.md:158-162`):
    TDM_COORDINATOR (host:port, or an init URL such as tcp://host:port or
    file:///path) with TDM_NUM_PROCESSES and TDM_PROCESS_ID, as the JAX
    package reads them; else torchrun's RANK and WORLD_SIZE with
    MASTER_ADDR and MASTER_PORT. `backend` defaults to NCCL for CUDA and
    gloo for the CPU (gloo also takes CUDA tensors in all_reduce, which is
    how two processes share one card in a test). Returns False when the
    environment asks for nothing, True when a group is up (formed here or
    before); a group that does not form raises."""
    if dist.is_initialized():
        return True
    env = os.environ
    if env.get("TDM_COORDINATOR"):
        coord = env["TDM_COORDINATOR"]
        init_method = coord if "://" in coord else f"tcp://{coord}"
        world = int(env["TDM_NUM_PROCESSES"])
        me = int(env["TDM_PROCESS_ID"])
    elif "WORLD_SIZE" in env and "RANK" in env:
        init_method = "env://"
        world, me = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    if not 0 <= me < world:
        raise ValueError(f"process {me} outside a world of {world} processes")
    dist.init_process_group(
        backend or ("nccl" if device_type == "cuda" else "gloo"),
        init_method=init_method, world_size=world, rank=me, timeout=timeout,
    )
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank (nothing at world 1)."""
    if world_size() > 1:
        dist.barrier()


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether `flag` holds on any rank (one all_reduce; `flag` itself at
    world 1): a signal to one process stops every process at one step."""
    if world_size() == 1:
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def local_device(device: torch.device) -> torch.device:
    """This process's device: one process per GPU, so in a world of more
    than one process a CUDA device without an index is `cuda:LOCAL_RANK`
    (the rank when LOCAL_RANK is unset), which must exist: no rank falls
    back to another card or the CPU. At world 1 `device` is returned as
    it is."""
    if device.type != "cuda" or world_size() == 1:
        return device
    index = device.index
    if index is None:
        index = int(os.environ.get("LOCAL_RANK", rank()))
    count = torch.cuda.device_count()
    if index >= count:
        raise ValueError(
            f"rank {rank()} wants cuda:{index} and {count} CUDA device(s) are "
            "visible: the port runs one process per GPU"
        )
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


AXES = ("data", "fsdp", "ep", "sp", "tp")


@dataclass(frozen=True)
class AxisGroup(tp_lib.TPGroup):
    """One mesh axis as a rank sees it (`tp.TPGroup`: its size, this
    rank's index on it, the process group over it) and the global ranks of
    its members in index order (point-to-point calls name global ranks)."""

    ranks: tuple = ()

    @property
    def next_rank(self) -> int:
        return self.ranks[(self.index + 1) % self.n]

    @property
    def prev_rank(self) -> int:
        return self.ranks[(self.index - 1) % self.n]


@dataclass(frozen=True)
class Mesh:
    """The ('data', 'fsdp', 'ep', 'sp', 'tp') mesh over the world: rank =
    (((d·n_fsdp + f)·n_ep + e)·n_sp + s)·n_tp + t. `groups` maps a tuple
    of axes to this rank's process group over them (the ranks that differ
    only along those axes): None where it has one rank (no collective over
    it), `dist.group.WORLD` where it spans the world."""

    n_data: int
    n_fsdp: int
    rank: int
    n_ep: int = 1
    groups: Any = None
    n_tp: int = 1
    n_sp: int = 1

    @property
    def world(self) -> int:
        return self.n_data * self.n_fsdp * self.n_ep * self.n_sp * self.n_tp

    @property
    def n_rows(self) -> int:
        """The ranks that hold rows of their own: data x fsdp, or 'data'
        alone under 'sp' (its fsdp ranks cooperate on the same rows, as
        `batch_sharding` drops 'fsdp' on an 'sp' mesh)."""
        return self.n_data if self.n_sp > 1 else self.n_data * self.n_fsdp

    @property
    def row_index(self) -> int:
        if self.n_sp > 1:
            return self.axis("data").index
        return self.rank // (self.n_ep * self.n_sp * self.n_tp)

    @property
    def fsdp_index(self) -> int:
        return self.axis("fsdp").index

    @property
    def ep_index(self) -> int:
        return self.axis("ep").index

    @property
    def tp(self) -> AxisGroup:
        """This rank's place on the 'tp' axis."""
        return self.axis("tp")

    def axis(self, name: str) -> AxisGroup:
        """This rank's place on one axis, with its members' global ranks."""
        if name not in AXES:
            raise ValueError(f"the mesh has no axis {name!r} (its axes: {AXES})")
        sizes = dict(zip(AXES, (self.n_data, self.n_fsdp, self.n_ep, self.n_sp, self.n_tp)))
        stride = math.prod(sizes[a] for a in AXES[AXES.index(name) + 1:])
        index = (self.rank // stride) % sizes[name]
        base = self.rank - index * stride
        return AxisGroup(sizes[name], index, self.group(name),
                         tuple(base + i * stride for i in range(sizes[name])))

    @property
    def sp(self) -> AxisGroup:
        """This rank's place on the 'sp' ring."""
        return self.axis("sp")

    def group(self, *axes: str):
        return self.groups[tuple(a for a in AXES if a in axes)]

    @property
    def data_group(self):
        return self.group("data")

    @property
    def fsdp_group(self):
        return self.group("fsdp")

    def batch_rows(self, local_batch: int) -> slice:
        """This rank's rows of the global batch: every 'data' and 'fsdp'
        rank holds rows of its own (as `batch_sharding` shards rows over
        both), but under 'sp' only 'data' does; the 'ep', 'sp' and 'tp'
        ranks of one row index share them."""
        i = self.row_index
        return slice(i * local_batch, (i + 1) * local_batch)

    def moe_scope(self, rows: Optional[int]):
        """The MoE calls' `Dispatch` inside a block: a call's `rows` rows a
        block are this rank's of the global batch; None when every rank
        runs the same rows (validation), which still splits the experts."""
        spread = rows is not None and self.n_rows > 1
        return moe.dispatching(moe.Dispatch(
            rows=rows or 0, index=self.row_index if spread else 0,
            count=self.n_rows if spread else 1,
            group=self.group("data", "fsdp") if spread else None,
            ep_index=self.ep_index, n_ep=self.n_ep, ep_group=self.group("ep")))


def make_mesh(n_data: Optional[int] = None, n_fsdp: int = 1, n_ep: int = 1,
              n_tp: int = 1, n_sp: int = 1) -> Mesh:
    """('data', 'fsdp', 'ep', 'sp', 'tp') mesh over the world (all of it on
    'data' by default, the reference's topology). Every rank calls it, in
    the same order, since it forms the axes' process groups."""
    world, me = world_size(), rank()
    inner = n_fsdp * n_ep * n_sp * n_tp
    if n_fsdp < 1 or n_ep < 1 or n_sp < 1 or n_tp < 1 or world % inner:
        raise ValueError(
            f"fsdp {n_fsdp} x ep {n_ep} x sp {n_sp} x tp {n_tp} does not divide the world "
            f"of {world} processes")
    if n_data is None:
        n_data = world // inner
    if n_data * inner != world:
        raise ValueError(
            f"mesh {n_data}x{n_fsdp}x{n_ep}x{n_sp}x{n_tp} does not divide the world of "
            f"{world} processes")
    sizes = dict(zip(AXES, (n_data, n_fsdp, n_ep, n_sp, n_tp)))

    def coords(r: int) -> dict:
        out, rest = {}, r
        for a in reversed(AXES):
            out[a] = rest % sizes[a]
            rest //= sizes[a]
        return out

    groups, made = {}, {}
    subsets = [tuple(a for i, a in enumerate(AXES) if m >> i & 1)
               for m in range(1, 2 ** len(AXES))]
    for axes in subsets:  # every rank forms every group, in one order
        size = math.prod(sizes[a] for a in axes)
        if size == 1:
            groups[axes] = None
            continue
        if size == world:
            groups[axes] = dist.group.WORLD
            continue
        members: dict = {}
        for r in range(world):
            key = tuple(v for a, v in coords(r).items() if a not in axes)
            members.setdefault(key, []).append(r)
        for ranks in members.values():
            ranks = tuple(ranks)
            if ranks not in made:  # one group per set of ranks
                made[ranks] = dist.new_group(list(ranks))
            if me in ranks:
                groups[axes] = made[ranks]
    return Mesh(n_data=n_data, n_fsdp=n_fsdp, rank=me, n_ep=n_ep, groups=groups, n_tp=n_tp,
                n_sp=n_sp)


def ppermute(tensors: list, sp: AxisGroup) -> list:
    """Each tensor sent to the next rank of the ring `sp` and its
    counterpart received from the previous one (JAX's `lax.ppermute` with
    perm i → i+1), in one message: the tensors packed byte by byte into one
    buffer (each at a 256-byte boundary, so a received tensor is aligned as
    the kernels' TMA reads want it), returned as views of the received
    buffer. The route follows the group's backend: NCCL sends device
    memory (`batch_isend_irecv`: an isend to rank+1 and an irecv from
    rank−1); gloo sends no CUDA tensor, so a CUDA buffer is staged through
    host memory and back, and a CPU buffer is sent as it is. Counted in
    `ppermute.calls` and `ppermute.bytes` (the bytes sent). A failed
    transfer raises."""
    if sp.n == 1:
        return list(tensors)
    dev = tensors[0].device
    sizes = [t.numel() * t.element_size() for t in tensors]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 256) * 256
    send = torch.empty(total, dtype=torch.uint8, device=dev)
    for t, off, n in zip(tensors, offsets, sizes):
        send[off:off + n].copy_(t.contiguous().reshape(-1).view(torch.uint8))
    backend = dist.get_backend(sp.group)
    if backend == "nccl":
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, sp.next_rank, sp.group),
            dist.P2POp(dist.irecv, recv, sp.prev_rank, sp.group)])
    elif backend == "gloo":  # a CUDA buffer through pinned host memory
        host = send
        if dev.type == "cuda":
            host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            host.copy_(send)
        recv_host = torch.empty(total, dtype=torch.uint8, pin_memory=dev.type == "cuda")
        reqs = [dist.isend(host, sp.next_rank, group=sp.group),
                dist.irecv(recv_host, sp.prev_rank, group=sp.group)]
    else:
        raise ValueError(f"no ppermute route for the {backend!r} backend")
    for req in reqs:
        req.wait()
    if backend == "gloo":
        recv = recv_host.to(dev) if dev.type == "cuda" else recv_host
    _COUNTED.calls += 1
    _COUNTED.bytes += total
    return [recv[off:off + n].view(t.dtype).view(t.shape)
            for t, off, n in zip(tensors, offsets, sizes)]


# the counts live on the function itself (a caller may wrap the module's name)
_COUNTED = ppermute
ppermute.calls = 0
ppermute.bytes = 0


def reset_ppermute_counts() -> None:
    _COUNTED.calls = 0
    _COUNTED.bytes = 0


def _allreduce_sum(tree: dict, group) -> dict:
    """Every leaf summed over `group`: one all_reduce of the leaves
    flattened into one buffer per dtype; the results are views of it."""
    out = {}
    by_dtype: dict = {}
    for k, t in tree.items():
        by_dtype.setdefault(t.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([tree[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, group=group)
        off = 0
        for k in keys:
            n = tree[k].numel()
            out[k] = flat[off:off + n].view(tree[k].shape)
            off += n
    return {k: out[k] for k in tree}


def allreduce_mean(tree: dict) -> dict:
    """The mean of each leaf over the world: one flattened all_reduce per
    dtype, then a divide by the world's size."""
    out = _allreduce_sum(tree, None)
    torch._foreach_div_(list(out.values()), dist.get_world_size())
    return out


def reduce_scatter(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """`out` ← this rank's chunk of the sum of `t` over `group`
    (reduce_scatter_single where torch has it, its older name before)."""
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, t, group=group)


def all_gather_flat(t: torch.Tensor, group) -> torch.Tensor:
    """The 1-D chunks of every rank of `group`, concatenated in rank order
    (all_gather_single where torch has it, its older name before)."""
    out = t.new_empty(t.numel() * dist.get_world_size(group))
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, t.contiguous(), group=group)
    return out


class ShardLayout:
    """The layout of one role's parameter dict on a mesh. Under 'ep' each
    expert leaf is cut to this rank's experts (its leading axis, in n_ep
    equal parts); under 'tp' each leaf of `tp_plan` (`parallel/tp.plan`) to
    this rank's slice. Then ZeRO-3: a leaf of at least SHARD_MIN_SIZE
    elements (and at least Q8_MIN_SIZE per 'fsdp' rank, so that 8-bit Adam
    quantizes a chunk as it does the whole leaf), other than the shared
    adaLN heads (`tp.is_modulation_head`), is flattened, zero-padded to
    n_fsdp equal chunks of whole 256-element blocks, and rank f keeps chunk
    f; the other leaves are replicated. The zero padding stays zero through
    AdamW, 8-bit Adam and the EMA (a zero gradient and weight give a zero
    update)."""

    def __init__(self, mesh: Mesh, params: dict, tp_plan: Optional[dict] = None):
        self.mesh = mesh
        ne, tp = mesh.n_ep, mesh.tp
        self.full_shapes = {k: tuple(p.shape) for k, p in params.items()}
        # the leaves cut over 'ep' and over 'tp', and every leaf's shape on
        # this rank (in the dict's order: every rank makes the collectives
        # in one order)
        self.experts = tuple(k for k in params if ne > 1 and moe.is_expert_key(k))
        self.tp_cuts = {k: c for k, c in (tp_plan or {}).items()
                        if tp.n > 1 and k in params}
        self.shapes = {k: tuple(self.cut_model({k: torch.empty(p.shape, device="meta")})[k].shape)
                       for k, p in params.items()}
        nf = mesh.n_fsdp
        self.chunks: dict[str, int] = {}  # sharded leaf -> elements per rank
        for k, shape in self.shapes.items():
            n = math.prod(shape)
            if (nf > 1 and n >= max(SHARD_MIN_SIZE, nf * topt.Q8_MIN_SIZE)
                    and not tp_lib.is_modulation_head(k)):
                per = -(-n // nf)
                self.chunks[k] = per + (-per) % topt.Q8_BLOCK

    def _padded(self, k: str, flat: torch.Tensor) -> torch.Tensor:
        """A sharded leaf's flat elements zero-padded to n_fsdp chunks."""
        return F.pad(flat, (0, self.mesh.n_fsdp * self.chunks[k] - flat.numel()))

    def _chunk(self, k: str, t: torch.Tensor) -> torch.Tensor:
        c, f = self.chunks[k], self.mesh.fsdp_index
        return self._padded(k, t.reshape(-1))[f * c:(f + 1) * c].clone()

    def cut_model(self, full: dict) -> dict:
        """This rank's experts of each expert leaf and its slice of each tp
        leaf (the module's layout on this rank); the rest as it is."""
        m, tp = self.mesh, self.mesh.tp
        out = {}
        for k, v in full.items():
            if k in self.experts:
                v = moe.expert_slice(k, v, m.ep_index, m.n_ep)
            if k in self.tp_cuts:
                v = tp_lib.cut(v, self.tp_cuts[k], tp.index, tp.n)
            out[k] = v
        return out

    def uncut_model(self, local: dict) -> dict:
        """The inverse of `cut_model` (every rank calls it): the experts
        gathered over 'ep', the tp slices over 'tp'."""
        out = dict(local)
        for k in self.experts:
            out[k] = all_gather_flat(out[k].reshape(-1), self.mesh.group("ep")).view(
                self.full_shapes[k])
        for k, c in self.tp_cuts.items():
            if k in out:
                out[k] = tp_lib.gather_leaf(out[k], c, self.mesh.tp)
        return out

    def shard(self, full: dict) -> dict:
        """This rank's part of a full dict: its experts of each expert leaf
        and its slice of each tp leaf, then its chunk of each sharded leaf
        (1-D); the rest as it is."""
        out = self.cut_model(full)
        return {k: self._chunk(k, v) if k in self.chunks else v.clone() if k in self.tp_cuts
                else v for k, v in out.items()}

    def gather(self, local: dict) -> dict:
        """The compute copy from every 'fsdp' rank's chunks (one all_gather
        per sharded leaf); this rank's experts and tp slices stay its own."""
        out = {}
        for k, v in local.items():
            if k in self.chunks:
                n = math.prod(self.shapes[k])
                v = all_gather_flat(v, self.mesh.fsdp_group)[:n].view(self.shapes[k])
            out[k] = v
        return out

    def full(self, local: dict) -> dict:
        """The whole dict: the compute copy with every expert leaf gathered
        over 'ep' and every tp leaf over 'tp' (every rank calls it)."""
        return self.uncut_model(self.gather(local))

    def _split(self, k: str) -> bool:
        """Whether a leaf's copies differ across the model axis: an expert
        leaf ('ep') or a tp slice ('tp')."""
        return k in self.experts or k in self.tp_cuts

    def reduce(self, grads: dict) -> dict:
        """Full gradients of this rank's rows → the mean gradient of the
        global batch: each sharded leaf reduce-scattered onto this rank's
        chunk over 'fsdp', then summed over the rest of its ranks; an
        expert leaf or a tp slice over the data x fsdp ranks that hold it,
        every other leaf over the world (the 'ep' and 'tp' ranks' copies
        are equal; the 'sp' ranks' are the parts of one sum); one flattened
        all_reduce per group and dtype."""
        m = self.mesh
        rep, shards = {}, {}
        for k, g in grads.items():
            if k in self.chunks:
                s = g.new_empty(self.chunks[k])
                reduce_scatter(s, self._padded(k, g.reshape(-1)), group=m.fsdp_group)
                shards[k] = s
            else:
                rep[k] = g
        out = {}
        for tree, split_group, dense_group in (
                (rep, m.group("data", "fsdp"), dist.group.WORLD),
                (shards, m.group("data"), m.group("data", "ep", "sp", "tp"))):
            split = {k: g for k, g in tree.items() if self._split(k)}
            dense = {k: g for k, g in tree.items() if not self._split(k)}
            out.update(_allreduce_sum(split, split_group)
                       if split and split_group is not None else split)
            out.update(_allreduce_sum(dense, dense_group)
                       if dense and dense_group is not None else dense)
        split = [out[k] for k in grads if self._split(k)]
        dense = [out[k] for k in grads if not self._split(k)]
        if dense:
            torch._foreach_div_(dense, m.world // m.n_sp)
        if split and m.n_rows > 1:
            torch._foreach_div_(split, m.n_rows)
        return {k: out[k] for k in grads}

    def global_norm(self, grads: dict) -> torch.Tensor:
        """optax.global_norm of the full gradient from this rank's part:
        each leaf's squares summed over the axes it is cut along ('fsdp'
        for a chunk, 'ep' for experts, 'tp' for a tp slice), each
        replicated leaf counted once."""
        m = self.mesh
        dev = next(iter(grads.values())).device
        by_axes: dict = {}
        for k in grads:
            axes = tuple(a for a, cut in (("fsdp", k in self.chunks), ("ep", k in self.experts),
                                          ("tp", k in self.tp_cuts)) if cut)
            by_axes.setdefault(axes, []).append(k)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for axes, keys in by_axes.items():  # the dict's order: the same on every rank
            part = torch.stack(
                torch._foreach_norm([grads[k].float() for k in keys])).square().sum()
            if axes and m.group(*axes) is not None:
                dist.all_reduce(part, group=m.group(*axes))
            total = total + part
        return torch.sqrt(total)

    def meta(self, *, local: bool) -> dict:
        """Tensors of the local (chunk) or full shapes on the meta device,
        for the 8-bit optimizer's packed layout."""
        return {k: torch.empty((self.chunks[k],) if local and k in self.chunks else s,
                               device="meta")
                for k, s in self.shapes.items()}

    # ---- the optimizer state between its local and its full form ----

    def _refuse_q8_experts(self) -> None:
        if self.experts or self.tp_cuts:
            raise NotImplementedError(
                "8-bit Adam moments of leaves split over 'ep' or 'tp' have no one-process "
                "form yet: ROADMAP.md queue 1, slice 6")

    def _q8_sizes(self, k: str) -> tuple[int, int]:
        """(codes of the whole leaf padded to whole blocks, n_fsdp chunks)."""
        n = math.prod(self.shapes[k])
        return n + (-n) % topt.Q8_BLOCK, self.mesh.n_fsdp * self.chunks[k]

    def gather_opt(self, node):
        """An optimizer state of the local dict → the state the optimizer
        keeps for the full dict, on the CPU (every 'fsdp' rank calls it)."""
        def leaves(d):
            return {k: v.cpu() for k, v in self.full(d).items()}

        def q8(moments):
            self._refuse_q8_experts()
            full = {}
            for k, v in topt.leaf_moments(moments, self.meta(local=True)).items():
                if k in self.chunks:
                    size, _ = self._q8_sizes(k)
                    g = self.mesh.fsdp_group
                    v = topt.Q8Moment(all_gather_flat(v.values, g)[:size],
                                      all_gather_flat(v.scales, g)[:size // topt.Q8_BLOCK])
                full[k] = v
            return topt.q8_pack_leaves(full, self.meta(local=False), torch.device("cpu"))

        return _map_opt(node, leaves, q8)

    def shard_opt(self, node, device: torch.device):
        """The inverse of `gather_opt`: a full optimizer state → this
        rank's, on `device`."""
        def leaves(d):
            return {k: v.to(device) for k, v in self.shard(d).items()}

        def q8(moments):
            self._refuse_q8_experts()
            local = {}
            f = self.mesh.fsdp_index
            for k, v in topt.leaf_moments(moments, self.meta(local=False)).items():
                if k in self.chunks:
                    size, padded = self._q8_sizes(k)
                    c = self.chunks[k]
                    codes = F.pad(v.values, (0, padded - size))[f * c:(f + 1) * c]
                    scales = F.pad(v.scales, (0, (padded - size) // topt.Q8_BLOCK))
                    cb = c // topt.Q8_BLOCK
                    v = topt.Q8Moment(codes, scales[f * cb:(f + 1) * cb])
                local[k] = v
            return topt.q8_pack_leaves(local, self.meta(local=True), device)

        return _map_opt(node, leaves, q8)


def _map_opt(node, leaves_fn, q8_fn):
    """An optimizer state (named tuples of ints, dicts of per-leaf tensors
    and packed 8-bit moments) with each dict through `leaves_fn` and each
    Q8Moments through `q8_fn`."""
    if isinstance(node, topt.Q8Moments):
        return q8_fn(node)
    if isinstance(node, dict):
        return leaves_fn(node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_opt(getattr(node, f), leaves_fn, q8_fn) for f in node._fields))
    return node


class DataParallel:
    """The step's reducer under plain data parallelism: the compute copy is
    the master weights, gradients are averaged over the world (one
    flattened all_reduce per dict; under 'sp' summed over the world and
    divided by its data ranks) and the metrics too. Every rank holds the
    whole state, so the state's full form is the state itself."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def shard(self, role: str, params: dict) -> dict:
        """This rank's part of a role's full parameters."""
        return params

    def compute(self, role: str, params: dict) -> dict:
        return params

    def full(self, role: str, params: dict) -> dict:
        """A role's whole parameters from this rank's part (every rank
        calls it): for the export."""
        return params

    def teacher(self, params: dict) -> dict:
        """This rank's part of the frozen teacher."""
        return params

    def full_teacher(self, params: dict) -> dict:
        return params

    def moe_scope(self, rows: Optional[int]):
        """The MoE layers' dispatch over the mesh (`Mesh.moe_scope`)."""
        return self.mesh.moe_scope(rows)

    def reduce(self, role: str, grads: dict) -> dict:
        if self.mesh.n_sp == 1:
            return allreduce_mean(grads)
        out = _allreduce_sum(grads, None)
        torch._foreach_div_(list(out.values()), self.mesh.world // self.mesh.n_sp)
        return out

    def norm(self, role: str, grads: dict) -> torch.Tensor:
        return topt.global_norm(grads)

    def mean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean of a tensor over the world (the metrics for the log)."""
        out = values.clone()
        dist.all_reduce(out)
        return out / self.mesh.world

    def gather_state(self, state):
        return state

    def full_template(self, state, student_tx, critic_tx):
        return state

    def shard_state(self, full, device: torch.device):
        return full


class ZeRO3(DataParallel):
    """The step's reducer under ZeRO-3, expert parallelism and/or tensor
    parallelism: a `ShardLayout` for the student (its EMA too) and one for
    the critic. The frozen teacher keeps its experts of each expert leaf
    under 'ep' (as `ep_shardings` puts the teacher's stacks on 'ep') and
    its slice of each tp leaf under 'tp', and is otherwise replicated, as
    the reference's ZeRO-3 leaves frozen models out."""

    def __init__(self, mesh: Mesh, student: ShardLayout, critic: ShardLayout):
        super().__init__(mesh)
        self.layouts = {"student": student, "critic": critic}

    def shard(self, role: str, params: dict) -> dict:
        return self.layouts[role].shard(params)

    def compute(self, role: str, params: dict) -> dict:
        return self.layouts[role].gather(params)

    def full(self, role: str, params: dict) -> dict:
        return self.layouts[role].full(params)

    def teacher(self, params: dict) -> dict:
        """The teacher cut as the critic's module layout (its experts under
        'ep', its tp slices under 'tp'), not chunked."""
        return self.layouts["critic"].cut_model(params)

    def full_teacher(self, params: dict) -> dict:
        return self.layouts["critic"].uncut_model(params)

    def reduce(self, role: str, grads: dict) -> dict:
        return self.layouts[role].reduce(grads)

    def norm(self, role: str, grads: dict) -> torch.Tensor:
        return self.layouts[role].global_norm(grads)

    def gather_state(self, state):
        """The TrainState of one unsharded process, on the CPU: what a
        checkpoint holds (every 'fsdp' rank calls it)."""
        s, c = self.layouts["student"], self.layouts["critic"]

        def host(layout, tree):
            return None if tree is None else {k: v.cpu() for k, v in layout.full(tree).items()}

        return state._replace(
            student=host(s, state.student), critic=host(c, state.critic),
            ema=host(s, state.ema), student_opt=s.gather_opt(state.student_opt),
            critic_opt=c.gather_opt(state.critic_opt))

    def full_template(self, state, student_tx, critic_tx):
        """Zeros of the unsharded TrainState's form on the CPU (a checkpoint
        restores into it)."""
        s, c = self.layouts["student"], self.layouts["critic"]

        def zeros(layout, like):
            return {k: torch.zeros(layout.full_shapes[k], dtype=v.dtype) for k, v in like.items()}

        student, critic = zeros(s, state.student), zeros(c, state.critic)
        return state._replace(
            student=student, critic=critic,
            ema=None if state.ema is None else zeros(s, state.ema),
            student_opt=student_tx.init(student), critic_opt=critic_tx.init(critic))

    def shard_state(self, full, device: torch.device):
        """This rank's part of an unsharded TrainState, on `device`."""
        s, c = self.layouts["student"], self.layouts["critic"]

        def local(layout, tree):
            return None if tree is None else {
                k: v.to(device) for k, v in layout.shard(tree).items()}

        return full._replace(
            student=local(s, full.student), critic=local(c, full.critic),
            ema=local(s, full.ema), student_opt=s.shard_opt(full.student_opt, device),
            critic_opt=c.shard_opt(full.critic_opt, device))
