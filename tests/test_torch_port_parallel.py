"""The port's multi-process training pieces (`tdm_tpu_torch/parallel/mesh.py`,
the step's reducer) on the CPU: worlds of gloo processes started by
`tests/parallel_worker.py`.

* The 2-rank TDM step of the tiny PixArt (each rank its rows of the global
  draws), at fsdp 1 (the gradient mean) and fsdp 2 (ZeRO-3), against the
  JAX step jitted on a 2-device ('data', 'fsdp') mesh of the CPU devices
  `tests/conftest.py` forces, from one state carried by
  `io/from_jax.train_state_from_jax`, with the tolerances of
  `tests/test_torch_port_train.py::test_train_step_matches_jax`.
* ShardLayout's gather, reduce-scatter, norm and optimizer-state round
  trips against the unsharded arithmetic, on 2 and on 4 processes (a 2x2
  mesh: reduce-scatter over 'fsdp', all_reduce over 'data').
* Process start-up: nothing asked, nothing formed; a world that does not
  form raises; the mesh's "does not divide".

The tiny model's leaves are under ZeRO-3's 2¹⁶ gate, so the workers lower
it (`shard_min`) and tiny leaves are sharded."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import parallel_worker
from test_torch_port_train import ADAM_EPS, LR, _jax_draws, _update_close
from tdm_tpu.parallel import mesh as jmesh
from tdm_tpu.train import families as jfamilies, optim as jopt, tdm as jtdm
from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.parallel import mesh as pmesh
from tdm_tpu_torch.train import families as tfamilies, tdm as ttdm

torch.set_num_threads(2)

GLOBAL_BATCH = 4  # 2 rows a rank
SHARD_MIN = 512  # the tiny model's largest leaves (1,024-8,192 elements) are sharded


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("fsdp", [1, 2])
def test_two_rank_step_matches_jax_on_a_two_device_mesh(tmp_path, fsdp):
    """One dmd step with two critic updates, Huber and the EMA: metrics to
    1e-4 relative, each role's update within `_update_close`'s bounds of
    JAX's, the EMA to 1e-7."""
    config = jtdm.TDMConfig(loss_mode="dmd", critic_updates=2, use_huber=True)
    jb = jfamilies.build("pixart", tiny=True)
    tb = tfamilies.build("pixart", tiny=True, device="cpu")
    teacher = jb.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)
    text = rng.standard_normal((GLOBAL_BATCH, 8, jb.embed_dim)).astype(np.float32)
    mask = np.ones((GLOBAL_BATCH, 8), np.int32)
    mask[1, 5:] = 0
    mask[3, 2:] = 0
    utext, umask = np.zeros_like(text), np.ones_like(mask)
    rng_p = np.random.default_rng(16)
    student = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng_p.standard_normal(a.shape).astype(np.float32)), teacher)
    jtx = jopt.make_optimizer(LR, eps=ADAM_EPS)
    jstate = jtdm.init_state(student, teacher, jtx, jtx, use_ema=True)
    tstate = from_jax.train_state_from_jax(jstate, tb.model, device="cpu")
    tteacher = from_jax.state_dict_from_jax(from_jax.flatten_tree(teacher), tb.model)
    before = {role: {k: v.clone() for k, v in getattr(tstate, role).items()}
              for role in ("student", "critic")}

    # the JAX step on a 2-device mesh: rows over ('data', 'fsdp'), the
    # state under fsdp_spec at the same lowered gate
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2 // fsdp, fsdp),
                (jmesh.DATA_AXIS, jmesh.FSDP_AXIS))
    rows = jmesh.batch_sharding(mesh)
    jstep = jax.jit(jtdm.build_train_step(jb.denoise_fn, teacher, jb.schedule, config, jtx, jtx,
                                          sample_shape=jb.sample_shape))
    key = jax.random.PRNGKey(5)
    jnew, jm = jax.block_until_ready(jstep(
        jax.device_put(jstate, jmesh.fsdp_shardings(jstate, mesh, min_size=SHARD_MIN)), key,
        tuple(jax.device_put(x, rows) for x in (text, mask)),
        tuple(jax.device_put(x, rows) for x in (utext, umask)),
        jax.device_put(teacher, jmesh.replicated(mesh))))

    inputs, out = tmp_path / "inputs.pt", tmp_path / "out.pt"
    torch.save({
        "state": tstate, "teacher": tteacher, "lr": LR, "eps": ADAM_EPS,
        "config": {"loss_mode": "dmd", "critic_updates": 2, "use_huber": True},
        "draws": _jax_draws(key, config, GLOBAL_BATCH, jb.sample_shape),
        "cond": (_t(text), _t(mask)), "uncond": (_t(utext), _t(umask)),
    }, inputs)
    parallel_worker.launch("step", {"inputs": str(inputs), "out": str(out), "fsdp": fsdp,
                                    "shard_min": SHARD_MIN}, 2, tmp_path)
    got = torch.load(out, weights_only=False)
    for name in jtdm.StepMetrics._fields:
        assert got["metrics"][name] == pytest.approx(float(getattr(jm, name)), rel=1e-4,
                                                     abs=1e-7), name
    tnew = got["state"]
    assert tnew.step == 1 and tnew.student_opt.count == 1 and tnew.critic_opt.count == 2
    ema = from_jax.state_dict_from_jax(from_jax.flatten_tree(jnew.ema), tb.model)
    for k, v in ema.items():
        np.testing.assert_allclose(tnew.ema[k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                   err_msg=f"ema {k}")
    for role in ("student", "critic"):
        ref = from_jax.state_dict_from_jax(from_jax.flatten_tree(getattr(jnew, role)), tb.model)
        _update_close(before[role], ref, getattr(tnew, role), role)


@pytest.mark.parametrize("world,fsdp", [(2, 1), (2, 2), (4, 2)])
def test_shard_layout_against_unsharded_arithmetic(tmp_path, world, fsdp):
    """Gather ∘ shard is the identity; the reduce-scattered gradient is the
    chunk of the ranks' mean (and allreduce_mean the mean); the sharded
    global norm is the whole gradient's; AdamW and 8-bit Adam under
    accumulation, run on the chunks and gathered, equal the updates of the
    whole dict bit for bit, and shard_opt undoes gather_opt. Each chunk is
    whole 8-bit blocks of at least Q8_MIN_SIZE elements."""
    outs = parallel_worker.launch("collectives", {"fsdp": fsdp}, world, tmp_path, timeout=120)
    assert all(f"collectives ok {r}" in o for r, o in enumerate(outs))


def test_process_start_up_and_the_mesh(tmp_path, monkeypatch):
    """No environment, no world (the CLI then runs one process with no
    collective); a process id outside the world raises; a world whose other
    process never comes raises within its timeout rather than carrying on
    alone; the mesh's factors must divide the world."""
    for var in ("TDM_COORDINATOR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not pmesh.maybe_initialize_distributed("cpu")
    assert pmesh.world_size() == 1 and pmesh.rank() == 0
    assert pmesh.local_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        pmesh.make_mesh(n_fsdp=2)
    monkeypatch.setenv("TDM_COORDINATOR", f"file://{tmp_path}/store0")
    monkeypatch.setenv("TDM_NUM_PROCESSES", "2")
    monkeypatch.setenv("TDM_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="outside a world of 2"):
        pmesh.maybe_initialize_distributed("cpu")
    child = (
        "import datetime, os; from tdm_tpu_torch.parallel import mesh; "
        "mesh.maybe_initialize_distributed('cpu', timeout=datetime.timedelta(seconds=3))")
    env = {"TDM_COORDINATOR": f"file://{tmp_path}/store1", "TDM_NUM_PROCESSES": "2",
           "TDM_PROCESS_ID": "0", "PYTHONPATH": parallel_worker.REPO}
    proc = subprocess.run([sys.executable, "-c", child], env=env, capture_output=True,
                          text=True, timeout=120, cwd=parallel_worker.REPO)
    assert proc.returncode != 0
    assert "imed out" in proc.stderr or "timeout" in proc.stderr.lower(), proc.stderr[-2000:]


def test_draw_rows_take_a_ranks_rows_of_every_draw():
    config = ttdm.TDMConfig(critic_updates=3)
    gen = torch.Generator().manual_seed(0)
    draws = ttdm.make_draws(config, 4, (2, 3, 3), gen, "cpu")
    part = ttdm.draw_rows(draws, slice(2, 4))
    assert torch.equal(part.z, draws.z[2:]) and torch.equal(part.seg, draws.seg[2:])
    assert torch.equal(part.critic_u, draws.critic_u[:, 2:])
    assert torch.equal(part.critic_eps, draws.critic_eps[:, 2:])
    assert part.critic_eps.shape == (2, 2, 2, 3, 3)


def test_the_step_without_a_reducer_makes_no_collective(monkeypatch):
    """At world 1 the CLI passes no reducer: the step touches no
    torch.distributed call (each one raises here)."""
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError("a collective at world 1")

    for name in ("all_reduce", "all_gather_into_tensor", "all_gather_single",
                 "reduce_scatter_tensor", "reduce_scatter_single", "barrier"):
        monkeypatch.setattr(dist, name, refuse, raising=False)
    tb = tfamilies.build("pixart", tiny=True, device="cpu")
    teacher = tb.init_params()
    from tdm_tpu_torch.train import optim as topt

    tx = topt.make_optimizer(1e-4)
    step = ttdm.build_train_step(tb.denoise_fn, teacher, tb.schedule, ttdm.TDMConfig(), tx, tx,
                                 sample_shape=tb.sample_shape)
    state = ttdm.init_state(teacher, teacher, tx, tx)
    draws = ttdm.make_draws(ttdm.TDMConfig(), 2, tb.sample_shape, torch.Generator(), "cpu")
    text = torch.randn(2, 8, tb.embed_dim)
    mask = torch.ones(2, 8, dtype=torch.int32)
    student = state.student
    new, metrics = step(state, draws, (text, mask), (torch.zeros_like(text), mask))
    assert new.student is student  # updated in place: no copy of the weights
    assert all(bool(torch.isfinite(v)) for v in metrics)
