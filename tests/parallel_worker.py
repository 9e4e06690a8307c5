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

import numpy as np
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

    from tdm_tpu_torch.parallel import tp as tp_lib

    _lower_gates(args)
    inp = torch.load(args["inputs"], weights_only=False)
    assert pmesh.maybe_initialize_distributed("cpu")
    ep, tp = args.get("ep", 1), args.get("tp", 1)
    mesh = pmesh.make_mesh(pmesh.world_size() // (args["fsdp"] * ep * tp), args["fsdp"], ep, tp)
    full = inp["state"]
    bundle = families.build("pixart", tiny=True, moe_experts=args.get("moe", 0), device="cpu")
    plan = tp_lib.parallelize(bundle.model, mesh.tp) if tp > 1 else {}
    if args["fsdp"] > 1 or ep > 1 or tp > 1:
        sync = pmesh.ZeRO3(mesh, pmesh.ShardLayout(mesh, full.student, plan),
                           pmesh.ShardLayout(mesh, full.critic, plan))
        assert sync.layouts["critic"].chunks or args["fsdp"] == 1, "no leaf is sharded"
        assert bool(sync.layouts["critic"].tp_cuts) == (tp > 1)
    else:
        sync = pmesh.DataParallel(mesh)
    tx_s, tx_c = (topt.make_optimizer(inp["lr"], eps=inp["eps"],
                                      norm_fn=functools.partial(sync.norm, role))
                  for role in ("student", "critic"))
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
    if tp > 1:  # the leaves that 'tp' does not cut: equal bit for bit on every rank
        for role in ("student", "critic"):
            rep = {k: v for k, v in getattr(new, role).items()
                   if k not in sync.layouts[role].tp_cuts}
            sums = torch.stack([torch.stack([v.double().sum(), v.double().square().sum()])
                                for v in rep.values()])
            others = [torch.empty_like(sums) for _ in range(mesh.world)]
            torch.distributed.all_gather(others, sums)
            assert all(torch.equal(o, sums) for o in others), role
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


def job_tp(args: dict) -> None:
    """The checks of a 2-rank 'tp' world (`--tp 2`), in one launch, each
    against the inputs and references the test saved in args['inputs']:

    * each family's tiny denoiser cut for this rank (`tp.parallelize`): the
      forward and every parameter's gradient of mean(out²) (the tp slices
      gathered) against the JAX unsharded model's, at JAX's tp tolerances;
    * the int8 forward under 'tp' (gates lowered) against the one-process
      int8 forward of the same weights, with the same rerouted calls;
    * a LoRA student's merge cut per rank (`tp.lora_cutter`): the loss and
      the factors' gradients against the one-process merge's;
    * ShardLayout under 'tp': shard, gather, reduce and norm against the
      unsharded arithmetic."""
    from torch.func import functional_call

    from tdm_tpu_torch import lora as lora_lib
    from tdm_tpu_torch.io import from_jax
    from tdm_tpu_torch.ops import quant
    from tdm_tpu_torch.parallel import mesh as pmesh, tp as tp_lib
    from tdm_tpu_torch.train import families, optim as topt

    inp = torch.load(args["inputs"], weights_only=False)
    assert pmesh.maybe_initialize_distributed("cpu")
    mesh = pmesh.make_mesh(1, 1, 1, 2)
    tp = mesh.tp
    assert tp.n == 2 and tp.index == mesh.rank

    def grads_of(model, params, inputs):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        out = functional_call(model, params, inputs)
        loss = out.square().mean()
        return out.detach(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    for fam, case in inp["families"].items():
        model = families.build(fam, tiny=True, device="cpu").model
        model.load_state_dict(case["params"])
        plan = tp_lib.parallelize(model, tp)
        assert plan, fam
        local = tp_lib.shard_params_tp(case["params"], plan, tp)
        assert all(local[k].shape == p.shape for k, p in model.named_parameters()), fam
        tp_lib.reset_counts()
        out, grads = grads_of(model, local, case["inputs"])
        assert tp_lib.reduce_from_tp.calls > 0 and tp_lib.copy_to_tp.calls > 0, fam
        np.testing.assert_allclose(out.numpy(), case["out"], atol=2e-5, err_msg=fam)
        whole = {k: tp_lib.gather_leaf(g, plan[k], tp) if k in plan else g
                 for k, g in grads.items()}
        assert set(whole) == set(case["grads"]), fam
        for k, ref in case["grads"].items():
            assert whole[k].shape == ref.shape, (fam, k)
            np.testing.assert_allclose(whole[k].numpy(), ref.numpy(), atol=3e-5,
                                       err_msg=f"{fam} {k}")
        print(f"{fam} ok {mesh.rank}: {len(plan)} leaves cut", flush=True)

    # int8 under tp: the same scales and codes, so the one-process result
    pix = inp["families"]["pixart"]
    quant.MIN_TOKENS, quant.MIN_DIM, quant.WIDE_DIM = 1, 1, 1
    calls = {"one": [], "tp": []}
    real = quant.int8_dot
    results = {}
    for mode in ("one", "tp"):
        model = families.build("pixart", tiny=True, device="cpu").model
        model.load_state_dict(pix["params"])
        if mode == "tp":
            tp_lib.parallelize(model, tp)

        def counted(x, w, tp_group=None, _mode=mode):
            calls[_mode].append(tuple(x.shape[-1:]) + (tp_group is not None,))
            return real(x, w, tp_group)

        quant.int8_dot = counted
        try:
            with torch.no_grad(), quant.quantize_int8():
                results[mode] = model(*pix["inputs"])
        finally:
            quant.int8_dot = real
    assert len(calls["one"]) == len(calls["tp"]) > 0
    assert sum(c[-1] for c in calls["tp"]) > 0  # row-parallel calls reduce over 'tp'
    np.testing.assert_allclose(results["tp"].numpy(), results["one"].numpy(), atol=1e-4,
                               rtol=1e-4)
    print(f"int8 ok {mesh.rank}: {len(calls['tp'])} rerouted calls, max |diff| "
          f"{float((results['tp'] - results['one']).abs().max())}", flush=True)

    # a LoRA student under tp: merged whole, then cut
    model = families.build("pixart", tiny=True, device="cpu").model
    model.load_state_dict(pix["params"])
    template = lora_lib.init_lora(model, 4, generator=torch.Generator().manual_seed(3))
    factors = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
               for i, (k, v) in enumerate(lora_lib.factors(template).items())}
    stacks = from_jax.layer_stacks(model.cfg)

    def lora_loss(m, base, cut):
        fn = lora_lib.wrap_denoise_fn(
            lambda p, x, t, cond: functional_call(m, p, (x, t, *cond)), template,
            stacks=stacks, cut=cut)
        f = {k: v.clone().requires_grad_(True) for k, v in factors.items()}
        x, t, *cond = pix["inputs"]
        loss = fn(f, x, t, tuple(cond), base).square().mean()
        return loss.detach(), dict(zip(f, torch.autograd.grad(loss, list(f.values()))))

    ref_loss, ref_g = lora_loss(model, pix["params"], None)
    plan = tp_lib.parallelize(model, tp)
    loss, g = lora_loss(model, tp_lib.shard_params_tp(pix["params"], plan, tp),
                        tp_lib.lora_cutter(plan, tp))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for k in ref_g:
        np.testing.assert_allclose(g[k].numpy(), ref_g[k].numpy(), atol=3e-5, err_msg=k)
    print(f"lora ok {mesh.rank}", flush=True)

    # ShardLayout under tp against the unsharded arithmetic
    params = {k: v.clone() for k, v in pix["params"].items()}
    layout = pmesh.ShardLayout(mesh, params, plan)
    assert set(layout.tp_cuts) == set(plan)
    local = layout.shard(params)
    assert all(torch.equal(a, b) for a, b in zip(layout.full(local).values(), params.values()))
    gen = torch.Generator().manual_seed(11)
    g_full = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    mine = layout.shard(g_full)
    mine = {k: v * (1 + tp.index) if k not in plan else v for k, v in mine.items()}
    red = layout.reduce(mine)
    want = layout.shard(g_full)
    for k, v in red.items():
        scale = 1.5 if k not in plan else 1.0  # replicated leaves: the mean of the ranks'
        torch.testing.assert_close(v, want[k] * scale, rtol=1e-6, atol=1e-7)
    norm = layout.global_norm(layout.shard(g_full))
    torch.testing.assert_close(norm, topt.global_norm(g_full), rtol=1e-6, atol=0)
    print(f"layout ok {mesh.rank}", flush=True)


def job_cli_runs(args: dict) -> None:
    """The training CLI's main() once per argv of args['argvs'], in one
    world formed here (main() leaves a world it did not form standing);
    then once per [argv, message] of args['refused'], each of which must
    raise ValueError with that message on every rank."""
    from tdm_tpu_torch.parallel import mesh as pmesh

    _lower_gates(args)
    assert pmesh.maybe_initialize_distributed("cpu")
    from tdm_tpu_torch.cli import train_tdm

    for argv in args["argvs"]:
        train_tdm.main(argv)
        pmesh.barrier()
    for argv, message in args.get("refused", ()):
        try:
            train_tdm.main(argv)
        except ValueError as e:
            assert message in str(e), str(e)
        else:
            raise AssertionError(f"{argv} was not refused")
        pmesh.barrier()
    torch.distributed.destroy_process_group()


def job_ring(args: dict) -> None:
    """`ops.ring_attention` in a world of 4 against the JAX flash-hop
    ring's outputs and gradients (args['inputs'], each case with its ring
    size n: a mesh of 4/n 'data' ranks by n 'sp' ranks, every data index
    running the case on its n ranks): this rank's shard of the output and
    of dQ/dK/dV, and the prefix's dK/dV summed over the ring (JAX's
    shard_map sums a replicated input's cotangent); the permutes each
    direction makes, counted."""
    from tdm_tpu_torch.ops import ring_attention as ring
    from tdm_tpu_torch.parallel import mesh as pmesh

    inp = torch.load(args["inputs"], weights_only=False)
    assert pmesh.maybe_initialize_distributed("cpu")
    for name, case in inp["cases"].items():
        n = case["n"]
        mesh = pmesh.make_mesh(pmesh.world_size() // n, n_sp=n)
        sp = mesh.sp
        assert sp.n == n and sp.ranks[sp.index] == mesh.rank

        def mine(t, dim):
            per = t.shape[dim] // n
            return t.narrow(dim, sp.index * per, per).clone()

        q, k, v, g = (mine(case[x], 2) for x in ("q", "k", "v", "g"))
        leaves = [q, k, v]
        kw = {}
        if case.get("mask") is not None:
            kw["key_mask"] = mine(case["mask"], 1)
        if case.get("k_p") is not None:
            k_p, v_p = case["k_p"].clone(), case["v_p"].clone()
            leaves += [k_p, v_p]
            kw["prefix_kv"] = (k_p, v_p)
            kw["prefix_mask"] = case.get("prefix_mask")
        for t in leaves:
            t.requires_grad_(True)
        pmesh.reset_ppermute_counts()
        out = ring.ring_attention(q, k, v, group=sp, impl=case["impl"], **kw)
        fwd = pmesh.ppermute.calls
        grads = torch.autograd.grad((out * g).sum(), leaves)
        bwd = pmesh.ppermute.calls - fwd
        assert (fwd, bwd) == (n - 1, n if n > 1 else 0), (name, fwd, bwd)
        tol = case["tol"]
        np.testing.assert_allclose(out.detach().numpy(), mine(case["out"], 2).numpy(),
                                   atol=tol, rtol=tol, err_msg=f"{name} out")
        if case.get("zero_rows"):
            assert float(out[case["zero_rows"]].abs().max()) == 0.0, name
        refs = [mine(case["grads"][i], 2) for i in range(3)] + list(case["grads"][3:])
        for i, (got, ref) in enumerate(zip(grads, refs)):
            if i >= 3 and n > 1:  # the prefix's partials, summed over the ring
                got = got.clone()
                torch.distributed.all_reduce(got, group=sp.group)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol, rtol=tol,
                                       err_msg=f"{name} grad {i}")
        print(f"ring {name} ok {mesh.rank}: permutes {fwd} + {bwd}", flush=True)


def _sp_model(cfg_kw: dict):
    """The tiny CogVideoX with the frames cut over 'sp'."""
    import dataclasses

    from tdm_tpu_torch.models import cogvideox as cog

    cfg = dataclasses.replace(cog.CogVideoXConfig.tiny(cfg_kw.get("use_rotary", False)),
                              sample_frames=cfg_kw["frames"], sequence_parallel_axis="sp")
    return cog.CogVideoXTransformer3D(cfg, device="cpu")


def job_sp(args: dict) -> None:
    """CogVideoX sequence parallelism in a world of 4 (args['inputs']):

    * each forward case on its ('data', 'sp', 'tp') mesh through
      `sequence_parallel_apply(..., data_axis='data')` (the model cut for
      'tp' where the case asks), the full output against JAX's
      `sequence_parallel_apply`; with a cotangent, every parameter's
      gradient of sum(out·g) summed over the world against JAX's;
    * one TDM step on the ('data', 'sp') = (2, 2) mesh through the
      family's sp denoiser and the DataParallel reducer (each data rank on
      its row, its sp ranks on its frames); rank 0 saves the new state and
      the metrics to args['out'], and every rank its student's bit
      checksum (the sp ranks of one row must agree bit for bit)."""
    import functools

    from tdm_tpu_torch.models import cogvideox as cog
    from tdm_tpu_torch.parallel import mesh as pmesh, tp as tp_lib
    from tdm_tpu_torch.train import families, optim as topt, tdm

    inp = torch.load(args["inputs"], weights_only=False)
    assert pmesh.maybe_initialize_distributed("cpu")
    for name, case in inp["forward"].items():
        n_data, n_sp, n_tp = case["mesh"]
        mesh = pmesh.make_mesh(n_data, n_tp=n_tp, n_sp=n_sp)
        model = _sp_model(case)
        model.load_state_dict(case["params"])
        params = case["params"]
        plan = {}
        if n_tp > 1:
            plan = tp_lib.parallelize(model, mesh.tp)
            assert plan
            params = tp_lib.shard_params_tp(params, plan, mesh.tp)
        fn = cog.sequence_parallel_apply(model, mesh, data_axis="data")
        latent, t, text = case["inputs"]
        if "g" not in case:
            with torch.no_grad():
                out = fn(latent, t, text)
        else:
            leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
            out = fn(latent, t, text, params=leaves)
            grads = dict(zip(leaves, torch.autograd.grad((out * case["g"]).sum(),
                                                         list(leaves.values()))))
        np.testing.assert_allclose(out.detach().numpy(), case["out"], atol=3e-5, rtol=3e-5,
                                   err_msg=name)
        if "g" in case:
            for k, ref in case["grads"].items():
                g = grads[k].clone()
                torch.distributed.all_reduce(g)
                np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=2e-4, rtol=2e-4,
                                           err_msg=f"{name} {k}")
        print(f"sp {name} ok {mesh.rank}", flush=True)

    from tdm_tpu_torch.models import vae3d
    from tdm_tpu_torch.pipelines import CogVideoXPipeline

    for name, case in inp["pipeline"].items():
        n_data, n_sp, n_tp = case["mesh"]
        mesh = pmesh.make_mesh(n_data, n_tp=n_tp, n_sp=n_sp)
        model = _sp_model(case)
        model.load_state_dict(case["params"])
        pipe = CogVideoXPipeline(model, vae_cfg=vae3d.VAE3DConfig.tiny(),
                                 sequence_parallel_mesh=mesh, device="cpu")
        pmesh.reset_ppermute_counts()
        out = pipe(**case["call"]).latents
        assert pmesh.ppermute.calls > 0
        np.testing.assert_allclose(out.float().numpy(), case["ref"], **case["tol"], err_msg=name)
        try:  # 3 latent frames over 2 'sp' ranks
            pipe(**dict(case["call"], num_frames=5, latents=None))
        except ValueError as e:
            assert "latent frame count 3 does not divide by the 'sp' axis size 2" in str(e)
        else:
            raise AssertionError("an odd frame count was not refused")
        print(f"sp {name} ok {mesh.rank}", flush=True)

    step = inp["step"]
    mesh = pmesh.make_mesh(2, n_sp=2)
    bundle = families.build("cogvideox", tiny=True, num_frames=step["num_frames"], device="cpu")
    sp_model = _sp_model({"frames": bundle.sample_shape[1]})
    fn = cog.sequence_parallel_apply(sp_model, mesh)
    sync = pmesh.DataParallel(mesh)
    tx_s, tx_c = (topt.make_optimizer(step["lr"], eps=step["eps"],
                                      norm_fn=functools.partial(sync.norm, role))
                  for role in ("student", "critic"))
    train_step = tdm.build_train_step(
        lambda p, x, t, c: fn(x, t, c, params=p), step["teacher"], bundle.schedule,
        tdm.TDMConfig(**step["config"]), tx_s, tx_c, sample_shape=bundle.sample_shape,
        sync=sync)
    rows = mesh.batch_rows(1)
    pmesh.reset_ppermute_counts()
    new, metrics = train_step(step["state"], tdm.draw_rows(step["draws"], rows),
                              step["cond"][rows], step["uncond"][rows])
    assert pmesh.ppermute.calls > 0
    sums = torch.stack([torch.stack([v.double().sum(), v.double().square().sum()])
                        for v in new.student.values()])
    others = [torch.empty_like(sums) for _ in range(mesh.world)]
    torch.distributed.all_gather(others, sums)
    assert all(torch.equal(o, sums) for o in others), "the ranks' students differ"
    if mesh.rank == 0:
        torch.save({"state": new, "metrics": {k: float(v) for k, v in metrics._asdict().items()}},
                   args["out"])
    print(f"sp step ok {mesh.rank}: {pmesh.ppermute.calls} permutes", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    try:
        {"cli": job_cli, "step": job_step, "collectives": job_collectives, "tp": job_tp,
         "cli_runs": job_cli_runs, "ring": job_ring, "sp": job_sp}[sys.argv[1]](
            json.loads(sys.argv[2]))
    finally:
        # a group left standing at exit can abort the process in gloo's teardown
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
