"""The port's training CLI across processes on the CPU (2 gloo processes,
`tests/parallel_worker.py`), at the tiny model with --device cpu:

* world-size independence: the 2-process run (--train_batch_size 1 per
  process, --fsdp 1 or 2) against the 1-process run at the same global
  batch (2): metrics.jsonl, the checkpoints (every tensor of the state,
  the optimizer's too) and student.safetensors;
* checkpoints move between world sizes: the 2-process run's checkpoint-1
  resumed in one process, and the 1-process run's resumed in two, take the
  same next step;
* 8-bit Adam: --use_8bit_adam --fsdp 2 equals --fsdp 1 bit for bit;
* only process 0 writes: one line per logged step in metrics.jsonl, one
  events file.

Every process reads its own share of the prompts (host_index = rank), as
in the JAX CLI, so the runs train on one prompt (--validation_prompts of
one entry, the prompt list when no data is given): every row's condition
is the same whatever its process, and the runs differ only by the world.
Adam's ε is 1e-4, as in tests/test_torch_port_train.py, so that an update
is a smooth function of its gradient; the learning rate is a constant 1e-4
from step 1. The 1-process and the 2-process runs differ in the order of
fp32 sums (products of 2 rows against 1, the mean of two gradients, the
norm of a sharded gradient): each weight within 10% of a step's learning
rate per step and the metrics within 1e-4 relative, as in
test_train_step_matches_jax; each Adam moment within 1e-3 of the largest
magnitude of its field (μ or ν) over the role's weights: a gradient's
rounding error follows the gradient's scale, not its element's, and a
near-cancelling sum (the key bias's gradient is 0 in exact arithmetic)
holds nothing but rounding. ZeRO-3's 2¹⁶
gate is lowered (`shard_min`) so the tiny leaves are sharded."""

import json
import os
import shutil

import numpy as np
import pytest

import parallel_worker
from tdm_tpu_torch.io import params as params_io

LR = 1e-4
STEPS = 2
SHARD_MIN = 512


def _argv(out, batch, *extra):
    return ["--device", "cpu", "--output_dir", str(out), "--seed", "0",
            "--export_lora_rank", "0", "--train_batch_size", str(batch),
            "--max_train_steps", str(STEPS), "--checkpointing_steps", "1",
            "--lr_scheduler", "constant", "--lr_warmup_steps", "0",
            "--learning_rate", str(LR), "--adam_epsilon", "1e-4", "--use_ema",
            "--validation_prompts", "a photo of a cat", *extra]


@pytest.fixture
def tiny_env(monkeypatch):
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    for var in ("TDM_EMBEDDING_CACHE", "TDM_TAESD_DIR", "TDM_COORDINATOR", "RANK",
                "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)


def _one_process(argv):
    from tdm_tpu_torch.cli import train_tdm

    train_tdm.main(argv)


def _two_processes(tmp_path, argv, **gates):
    parallel_worker.launch("cli", {"argv": argv, "shard_min": SHARD_MIN, **gates}, 2, tmp_path)


def _run_dir(out):
    return out.parent / (out.name + "_cfg4.5_steps900")


def _checkpoint(run, step):
    d = run / f"checkpoint-{step}"
    files = {f[:-len(".safetensors")]: params_io.load_file(str(d / f))
             for f in sorted(os.listdir(d)) if f.endswith(".safetensors")}
    return json.loads((d / "state.json").read_text()), files


def _close_to(got, want, steps):
    """Two checkpoints of one step: equal counters and keys; each float
    tensor within the bounds of the module docstring."""
    (gmeta, gfiles), (wmeta, wfiles) = got, want
    assert gmeta == wmeta
    assert gfiles.keys() == wfiles.keys()
    for name, wf in wfiles.items():
        assert gfiles[name].keys() == wf.keys(), name
        scale: dict = {}  # an optimizer field's largest magnitude over all its tensors
        for k, w in wf.items():
            field = k.rsplit("/", 1)[0]
            scale[field] = max(scale.get(field, 0.0), float(np.abs(w).max(initial=0)))
        for k, w in wf.items():
            g = gfiles[name][k]
            assert g.shape == w.shape and g.dtype == w.dtype, (name, k)
            if name in ("student", "critic", "ema"):
                bound = 0.1 * LR * steps
            else:
                bound = 1e-3 * scale[k.rsplit("/", 1)[0]]
            np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=f"{name} {k}")


def _metrics(run):
    return [json.loads(s) for s in (run / "logs" / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("fsdp", [1, 2])
def test_two_processes_match_one_process_and_checkpoints_move(tmp_path, tiny_env, fsdp):
    one, two = tmp_path / "one", tmp_path / "two"
    _one_process(_argv(one, 2))
    _two_processes(tmp_path, _argv(two, 1, "--fsdp", str(fsdp)))
    r1, r2 = _run_dir(one), _run_dir(two)

    # metrics.jsonl: process 0 alone writes it, one line per logged step
    m1, m2 = _metrics(r1), _metrics(r2)
    assert [r["step"] for r in m2] == [r["step"] for r in m1] == [1]
    for k in ("loss_student", "loss_critic", "grad_norm_student", "grad_norm_critic",
              "t_fake_mean"):
        assert m2[0][k] == pytest.approx(m1[0][k], rel=1e-4, abs=1e-7), k
    logs = os.listdir(r2 / "logs")
    assert len([f for f in logs if f.startswith("events")]) <= 1, logs

    for step in (1, STEPS):
        _close_to(_checkpoint(r2, step), _checkpoint(r1, step), step)
    s1 = params_io.load_file(str(r1 / "student.safetensors"))
    s2 = params_io.load_file(str(r2 / "student.safetensors"))
    assert s1.keys() == s2.keys()
    for k in s1:  # fp16: one half-precision step of the value, plus the bound above
        np.testing.assert_allclose(s2[k].astype(np.float32), s1[k].astype(np.float32),
                                   rtol=2**-10, atol=0.1 * LR * STEPS, err_msg=k)

    # the 2-process checkpoint-1 resumed in one process, and the 1-process
    # one resumed in two: one step from equal states. A resumed run draws
    # its steps' noise and prompts from the start again, as the JAX CLI
    # (its key is PRNGKey(seed + 1) at every start), so the two resumed runs
    # are held against each other, not against the runs they came from
    resumed = {}
    for src, world in ((r2, 1), (r1, 2)):
        dst = tmp_path / f"resumed_at_{world}"
        res = _run_dir(dst)
        res.mkdir()
        shutil.copytree(src / "checkpoint-1", res / "checkpoint-1")
        if world == 1:
            _one_process(_argv(dst, 2, "--resume_from_checkpoint", "latest"))
        else:
            _two_processes(tmp_path, _argv(dst, 1, "--fsdp", str(fsdp),
                                           "--resume_from_checkpoint", "latest"))
        resumed[world] = _checkpoint(res, STEPS)
    _close_to(resumed[2], resumed[1], STEPS)
    assert resumed[1][0]["student_count"] == STEPS


def test_eight_bit_adam_under_fsdp_2_equals_fsdp_1(tmp_path, tiny_env):
    """--use_8bit_adam with accumulation 2: ZeRO-3's chunks are whole
    256-element blocks of each leaf, so every block's absmax scale is the
    unsharded state's, and the runs agree bit for bit: every tensor of both
    checkpoints (int8 codes, scales, weights), the exported student and the
    losses (the logged gradient norms to a rounding). The clip is off
    (--max_grad_norm 1e9): a sharded gradient's norm is summed in another
    order, which moves the clipped update by a rounding (held in the test
    above). 8-bit Adam's size gate is lowered to
    256 so the tiny leaves are quantized."""
    runs = {}
    for fsdp in (1, 2):
        out = tmp_path / f"fsdp{fsdp}"
        _two_processes(tmp_path, _argv(out, 1, "--fsdp", str(fsdp), "--use_8bit_adam",
                                       "--gradient_accumulation_steps", "2",
                                       "--max_grad_norm", "1e9"), q8_min=256)
        runs[fsdp] = _run_dir(out)
    for step in (1, STEPS):
        (m1, f1), (m2, f2) = _checkpoint(runs[1], step), _checkpoint(runs[2], step)
        assert m1 == m2 and f1.keys() == f2.keys()
        assert any(k.endswith("codes") for k in f1["student_opt"])
        for name in f1:
            assert f1[name].keys() == f2[name].keys()
            for k in f1[name]:
                np.testing.assert_array_equal(f2[name][k], f1[name][k], err_msg=f"{name} {k}")
    assert ((runs[1] / "student.safetensors").read_bytes()
            == (runs[2] / "student.safetensors").read_bytes())
    (a,), (b,) = _metrics(runs[1]), _metrics(runs[2])
    for k in ("loss_student", "loss_critic", "t_fake_mean"):
        assert a[k] == b[k], k
    for k in ("grad_norm_student", "grad_norm_critic"):  # summed in another order
        assert b[k] == pytest.approx(a[k], rel=1e-6), k
