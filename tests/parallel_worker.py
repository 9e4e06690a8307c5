"""The processes of the port's multi-process tests
(tests/test_torch_port_parallel*.py): a world of gloo processes on the CPU,
joined through a file store (TDM_COORDINATOR=file://...), so no port is
taken. Not a test module: `launch` starts `python tests/parallel_worker.py
<job> <json arguments>` once per rank, each process with a time limit of
its own. Imports no JAX."""

import json
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)


def launch(job: str, args: dict, world: int, tmp_dir, *, timeout: float = 240.0,
           env: dict | None = None) -> list[str]:
    """Run `job` on `world` processes; every one must exit 0 within
    `timeout` seconds. Returns their outputs."""
    store = tempfile.mkdtemp(dir=str(tmp_dir), prefix="store")
    procs = []
    for rank in range(world):
        penv = dict(os.environ, **(env or {}))
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            penv.pop(var, None)
        penv.update(TDM_COORDINATOR=f"file://{store}/store", TDM_NUM_PROCESSES=str(world),
                    TDM_PROCESS_ID=str(rank), OMP_NUM_THREADS="1",
                    PYTHONPATH=os.pathsep.join([REPO, penv.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, job, json.dumps(args)], env=penv, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def _lower_gates(args: dict) -> None:
    """The tiny models' leaves are small: the tests lower ZeRO-3's size
    gate (and 8-bit Adam's) so that tiny leaves are sharded (quantized),
    and the MoE capacity factor of the tiny PixArt (`moe_cf`) so that
    pairs drop."""
    import dataclasses

    from tdm_tpu_torch.models import pixart
    from tdm_tpu_torch.parallel import mesh as pmesh
    from tdm_tpu_torch.train import optim as topt

    if "shard_min" in args:
        pmesh.SHARD_MIN_SIZE = args["shard_min"]
    if "q8_min" in args:
        topt.Q8_MIN_SIZE = args["q8_min"]
    if "moe_cf" in args:
        tiny = pixart.PixArtConfig.tiny
        pixart.PixArtConfig.tiny = staticmethod(
            lambda: dataclasses.replace(tiny(), moe_capacity_factor=args["moe_cf"]))


def job_cli(args: dict) -> None:
    """The training CLI's main() in this world."""
    _lower_gates(args)
    from tdm_tpu_torch.cli import train_tdm

    train_tdm.main(args["argv"])


def job_step(args: dict) -> None:
    """One TDM step of the tiny PixArt (a MoE one with args['moe'] experts)
    from the state and the global draws in args['inputs'] (torch.save'd by
    the test), each rank on its rows, under DataParallel (fsdp 1, ep 1) or
    ZeRO3 (fsdp and/or ep > 1); rank 0 saves the unsharded new state and
    the metrics to args['out'], and every rank its own part of the new
    state to args['out'] + '.<rank>'."""
    import functools

    from tdm_tpu_torch.parallel import mesh as pmesh
    from tdm_tpu_torch.train import families, optim as topt, tdm

    _lower_gates(args)
    inp = torch.load(args["inputs"], weights_only=False)
    assert pmesh.maybe_initialize_distributed("cpu")
    ep = args.get("ep", 1)
    mesh = pmesh.make_mesh(pmesh.world_size() // (args["fsdp"] * ep), args["fsdp"], ep)
    full = inp["state"]
    if args["fsdp"] > 1 or ep > 1:
        sync = pmesh.ZeRO3(mesh, pmesh.ShardLayout(mesh, full.student),
                           pmesh.ShardLayout(mesh, full.critic))
        assert sync.layouts["critic"].chunks or args["fsdp"] == 1, "no leaf is sharded"
    else:
        sync = pmesh.DataParallel(mesh)
    tx_s, tx_c = (topt.make_optimizer(inp["lr"], eps=inp["eps"],
                                      norm_fn=functools.partial(sync.norm, role))
                  for role in ("student", "critic"))
    bundle = families.build("pixart", tiny=True, moe_experts=args.get("moe", 0), device="cpu")
    step = tdm.build_train_step(bundle.denoise_fn, sync.teacher(inp["teacher"]), bundle.schedule,
                                tdm.TDMConfig(**inp["config"]), tx_s, tx_c,
                                sample_shape=bundle.sample_shape, sync=sync)
    local = inp["draws"].z.shape[0] // mesh.n_rows
    rows = mesh.batch_rows(local)
    draws = tdm.draw_rows(inp["draws"], rows)
    cond = tuple(t[rows] for t in inp["cond"])
    uncond = tuple(t[rows] for t in inp["uncond"])
    state = sync.shard_state(full, torch.device("cpu"))
    new, metrics = step(state, draws, cond, uncond)
    torch.save({role: getattr(new, role) for role in ("student", "critic", "ema")},
               f"{args['out']}.{mesh.rank}")
    new = sync.gather_state(new)
    if mesh.rank == 0:
        torch.save({"state": new, "metrics": {k: float(v) for k, v in metrics._asdict().items()}},
                   args["out"])


def job_collectives(args: dict) -> None:
    """ShardLayout's gather, reduce, norm and optimizer-state round trips,
    and the mesh's helpers, against the unsharded arithmetic every rank
    can do alone (each rank's gradients come from a seed of its own)."""
    from tdm_tpu_torch.parallel import mesh as pmesh
    from tdm_tpu_torch.train import optim as topt
    from tdm_tpu_torch.utils.checkpoint import _opt_parts

    assert pmesh.maybe_initialize_distributed("cpu")
    world, me = pmesh.world_size(), pmesh.rank()
    mesh = pmesh.make_mesh(world // args["fsdp"], args["fsdp"])
    assert mesh.batch_rows(3) == slice(3 * me, 3 * me + 3)
    assert pmesh.any_rank(me == world - 1, torch.device("cpu"))
    assert not pmesh.any_rank(False, torch.device("cpu"))
    shapes = {"big": (70, 300), "odd": (4097, 17), "vec": (1000,), "small": (8, 8)}

    def tree(seed):
        g = torch.Generator().manual_seed(seed)
        return {k: torch.randn(s, generator=g) for k, s in shapes.items()}

    params = tree(0)
    pmesh.SHARD_MIN_SIZE = 1000
    layout = pmesh.ShardLayout(mesh, params)
    want_sharded = {"big", "odd"} if args["fsdp"] > 1 else set()
    assert set(layout.chunks) == want_sharded, layout.chunks
    for c in layout.chunks.values():
        assert c % topt.Q8_BLOCK == 0 and c >= topt.Q8_MIN_SIZE
    local = layout.shard(params)
    back = layout.gather(local)
    assert all(torch.equal(back[k], params[k]) for k in params)

    grads = [tree(100 + r) for r in range(world)]
    mean = {k: sum(g[k] for g in grads) / world for k in shapes}
    got = layout.reduce(grads[me])
    ref_local = layout.shard(mean)
    for k in shapes:
        torch.testing.assert_close(got[k], ref_local[k], rtol=1e-6, atol=1e-7)
    dp = pmesh.allreduce_mean(grads[me])
    for k in shapes:
        torch.testing.assert_close(dp[k], mean[k], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(layout.global_norm(got), topt.global_norm(mean), rtol=1e-6,
                               atol=0)

    # the optimizer state: AdamW and 8-bit Adam under accumulation, updated
    # on the chunks, gathered, equal the same updates of the whole dict
    for tx in (topt.make_optimizer(1e-3, max_grad_norm=None),
               topt.make_optimizer(1e-3, max_grad_norm=None, eight_bit=True,
                                   accumulation_steps=2)):
        full_state = tx.init(params)
        loc_state = layout.shard_opt(tx.init(params), torch.device("cpu"))
        loc_params = {k: v.clone() for k, v in local.items()}
        for _ in range(2):
            upd, full_state = tx.update(mean, full_state, params)
            upd_l, loc_state = tx.update(ref_local, loc_state, loc_params)
        gathered = layout.gather_opt(loc_state)
        ref, c_ref = _opt_parts(full_state)
        got_parts, c_got = _opt_parts(gathered)
        assert c_ref == c_got and set(ref) == set(got_parts)
        for k in ref:
            assert torch.equal(ref[k], got_parts[k]), k
        again, _ = _opt_parts(layout.shard_opt(gathered, torch.device("cpu")))
        mine, _ = _opt_parts(loc_state)
        assert all(torch.equal(again[k], mine[k]) for k in mine)
        got_upd = layout.gather(upd_l)
        for k in upd:
            assert torch.equal(got_upd[k], upd[k]), k
    print("collectives ok", me, flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"cli": job_cli, "step": job_step, "collectives": job_collectives}[sys.argv[1]](
        json.loads(sys.argv[2]))
