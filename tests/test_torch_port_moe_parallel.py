"""The mixture-of-experts PixArt across processes on the CPU: worlds of gloo
processes started by `tests/parallel_worker.py`, at capacity factor 0.6 so
that pairs drop, each held against the one-process step of the port on the
same global batch of 4 (the port's one-process MoE step is held against
JAX in tests/test_torch_port_moe.py):

* world 2 at --ep 2 (each rank 2 of the 4 experts of every expert leaf of
  the student, critic, their AdamW moments, the EMA and the teacher; both
  ranks on all 4 rows);
* world 2 of plain data parallelism (2 rows a rank): the drops follow the
  global batch, through the teacher's CFG call `[x; x]` too;
* world 4 at --fsdp 2 --ep 2 (ZeRO-3 chunks of the expert slices).

Metrics to 1e-4 relative, each role's update within the bounds of
tests/test_torch_port_train.py::_update_close, the EMA to 1e-7, and every
leaf that is not an expert stack equal bit for bit on the 'ep' ranks that
hold the same chunk. Then the training CLI: `--moe_experts 4 --ep 2` on two
processes against one process, its checkpoint resumed at world 1 and the
one-process checkpoint at --ep 2 (the one-process layout both ways).
ZeRO-3's 2¹⁶ gate is lowered (`shard_min`) so the tiny leaves are sharded.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import parallel_worker
from test_torch_port_parallel_cli import (
    LR as CLI_LR, STEPS, _argv, _checkpoint, _close_to, _metrics, _run_dir, tiny_env,  # noqa: F401
)
from test_torch_port_train import ADAM_EPS, LR, _update_close
from tdm_tpu_torch.models import moe as tmoe, pixart as tpixart
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm

torch.set_num_threads(2)

GLOBAL_BATCH = 4
SHARD_MIN = 512
CF = 0.6


@pytest.fixture
def moe_cf(monkeypatch):
    tiny = tpixart.PixArtConfig.tiny
    monkeypatch.setattr(tpixart.PixArtConfig, "tiny", staticmethod(
        lambda: dataclasses.replace(tiny(), moe_capacity_factor=CF)))


def _inputs(tmp_path):
    """The state (a student 5% from the seeded teacher), the global draws
    and conditions, saved for the workers; and the one-process step's new
    state and metrics, with the number of pairs its first call drops."""
    config = ttdm.TDMConfig(loss_mode="dmd", critic_updates=2, use_huber=True)
    tb = tfamilies.build("pixart", tiny=True, moe_experts=4, seed=3, device="cpu")
    teacher = tb.init_params()
    g = torch.Generator().manual_seed(16)
    student = {k: v * (1 + 0.05 * torch.randn(v.shape, generator=g)) for k, v in teacher.items()}
    tx = topt.make_optimizer(LR, eps=ADAM_EPS)
    state = ttdm.init_state(student, teacher, tx, tx, use_ema=True)
    rng = np.random.default_rng(21)
    text = torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, 8, tb.embed_dim)).astype(np.float32))
    mask = torch.ones(GLOBAL_BATCH, 8, dtype=torch.int32)
    mask[1, 5:] = 0
    mask[3, 2:] = 0
    cond, uncond = (text, mask), (torch.zeros_like(text), torch.ones_like(mask))
    draws = ttdm.make_draws(config, GLOBAL_BATCH, tb.sample_shape,
                            torch.Generator().manual_seed(5), "cpu")
    inputs = tmp_path / "inputs.pt"
    torch.save({"state": state, "teacher": teacher, "lr": LR, "eps": ADAM_EPS,
                "config": {"loss_mode": "dmd", "critic_updates": 2, "use_huber": True},
                "draws": draws, "cond": cond, "uncond": uncond}, inputs)
    before = {role: {k: v.clone() for k, v in getattr(state, role).items()}
              for role in ("student", "critic")}
    drops = []
    ff = tb.model.blocks[0].ff
    orig = ff.forward

    def counted(x):
        with torch.no_grad():
            probs = torch.softmax(ff.router(x.reshape(-1, x.shape[-1]).float()), -1)
            _, idx = tmoe.top_k(probs, ff.top_k)
            cap = tmoe.capacity(ff.capacity_factor, ff.top_k, idx.shape[0], ff.num_experts)
            pos = tmoe.positions(idx, ff.num_experts, 0, tmoe.Dispatch())
            drops.append(int((pos >= cap).sum()))
        return orig(x)

    ff.forward = counted
    step = ttdm.build_train_step(tb.denoise_fn, teacher, tb.schedule, config, tx, tx,
                                 sample_shape=tb.sample_shape)
    new, metrics = step(state, draws, cond, uncond)
    return inputs, before, new, metrics, drops


@pytest.mark.parametrize("world,fsdp,ep", [(2, 1, 2), (2, 1, 1), (4, 2, 2)],
                         ids=["ep2", "data2", "fsdp2-ep2"])
def test_moe_step_across_processes_matches_one_process(tmp_path, moe_cf, world, fsdp, ep):
    inputs, before, ref, ref_m, drops = _inputs(tmp_path)
    assert min(drops) > 0, drops  # every call drops pairs
    out = tmp_path / "out.pt"
    parallel_worker.launch("step", {"inputs": str(inputs), "out": str(out), "fsdp": fsdp,
                                    "ep": ep, "moe": 4, "moe_cf": CF,
                                    "shard_min": SHARD_MIN}, world, tmp_path)
    got = torch.load(out, weights_only=False)
    for name in ttdm.StepMetrics._fields:
        assert got["metrics"][name] == pytest.approx(float(getattr(ref_m, name)), rel=1e-4,
                                                     abs=1e-7), name
    new = got["state"]
    assert new.step == 1 and new.student_opt.count == 1 and new.critic_opt.count == 2
    for k, v in ref.ema.items():
        np.testing.assert_allclose(new.ema[k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                   err_msg=f"ema {k}")
    for role in ("student", "critic"):
        _update_close(before[role], getattr(ref, role), getattr(new, role), role)
    # the ranks that differ only along 'ep' hold equal copies of every leaf
    # that is not an expert stack
    parts = [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
    for r in range(0, world, ep):
        for e in range(1, ep):
            for role in ("student", "critic", "ema"):
                a, b = parts[r][role], parts[r + e][role]
                for k in a:
                    if tmoe.is_expert_key(k):  # this rank's experts (a chunk of them)
                        assert a[k].numel() * ep * fsdp <= ref.ema[k].numel() + 256 * fsdp, k
                    else:
                        assert torch.equal(a[k], b[k]), (role, k)


def test_moe_cli_at_ep_2_matches_one_process_and_checkpoints_move(tmp_path, tiny_env, moe_cf):
    """`--moe_experts 4 --ep 2` on two processes (both on the global batch
    of 2) against one process: metrics, both checkpoints and the exported
    student within the bounds of tests/test_torch_port_parallel_cli.py;
    the --ep 2 checkpoint-1 resumed in one process and the one-process
    checkpoint-1 resumed at --ep 2 take the same next step."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.io import params as params_io

    moe = ("--moe_experts", "4")
    gates = {"shard_min": SHARD_MIN, "moe_cf": CF}
    one, two = tmp_path / "one", tmp_path / "two"
    train_tdm.main(_argv(one, 2, *moe))
    parallel_worker.launch("cli", {"argv": _argv(two, 2, *moe, "--ep", "2"), **gates}, 2,
                           tmp_path)
    r1, r2 = _run_dir(one), _run_dir(two)
    (m1,), (m2,) = _metrics(r1), _metrics(r2)
    for k in ("loss_student", "loss_critic", "grad_norm_student", "grad_norm_critic"):
        assert m2[k] == pytest.approx(m1[k], rel=1e-4, abs=1e-7), k
    for step in (1, STEPS):
        _close_to(_checkpoint(r2, step), _checkpoint(r1, step), step)
    s1 = params_io.load_file(str(r1 / "student.safetensors"))
    s2 = params_io.load_file(str(r2 / "student.safetensors"))
    assert s1.keys() == s2.keys() and s1["blocks/ff/experts_in"].shape[:2] == (2, 4)
    for k in s1:
        np.testing.assert_allclose(s2[k].astype(np.float32), s1[k].astype(np.float32),
                                   rtol=2**-10, atol=0.1 * CLI_LR * STEPS, err_msg=k)
    resumed = {}
    for src, ep in ((r2, 1), (r1, 2)):
        dst = tmp_path / f"resumed_at_ep{ep}"
        res = _run_dir(dst)
        res.mkdir()
        shutil.copytree(src / "checkpoint-1", res / "checkpoint-1")
        argv = _argv(dst, 2, *moe, "--resume_from_checkpoint", "latest")
        if ep == 1:
            train_tdm.main(argv)
        else:
            parallel_worker.launch("cli", {"argv": argv + ["--ep", "2"], **gates}, 2,
                                   tmp_path)
        resumed[ep] = _checkpoint(res, STEPS)
    _close_to(resumed[2], resumed[1], STEPS)
