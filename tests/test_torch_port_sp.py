"""CogVideoX sequence parallelism of the port (`--sp`:
`models/cogvideox.sequence_parallel_apply`, the 'sp' axis of
`parallel/mesh.py`, the training CLI) against the JAX package on the CPU,
in worlds of gloo processes (`tests/parallel_worker.py`).

* One launch of 4 processes (job `sp`): the tiny CogVideoX (4 latent
  frames, 2 a rank) through `sequence_parallel_apply(..., data_axis='data')`
  on ('data', 'sp') = (2, 2) with the 2B's sin-cos positions and with the
  5B's RoPE, and on ('data', 'sp', 'tp') = (1, 2, 2) with the blocks cut
  for 'tp', each against JAX's `sequence_parallel_apply` on the same mesh
  shape of CPU devices (`tests/test_cogvideox_sp.py`): the output to 3e-5
  (that file's bound), and on ('data', 'sp') every parameter's gradient of
  sum(out·g), summed over the ranks, to 2e-4 against JAX's (its gradient
  bound, between JAX's sp and monolithic gradients). Then
  one dmd TDM step on ('data', 'sp') = (2, 2) through the family's sp
  denoiser and the DataParallel reducer, from the carried JAX state with
  JAX's draws, against JAX's step with its `sequence_parallel_apply`
  denoiser on the same mesh shape (`tests/test_tdm_video.py:64-130`):
  the losses and grad norms to 1e-4 relative and each role's update within
  the port's step bounds (`tests/test_torch_port_train.py`), the ranks'
  students equal bit for bit.
* `train_tdm.main --sp 2 --fsdp 2 --model_family cogvideox --num_frames 5`
  on 4 ranks for 2 steps (`tests/test_cli_train.py:188-225`): metrics and
  `student.safetensors` written; in the same world `--num_frames 9` (3
  latent frames) refused with the JAX CLI's "frame count" ValueError; in
  one process the JAX CLI's refusals in its order (`:228-250`): a family
  other than cogvideox, --sp with --tp, and --quant_forwards."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import parallel_worker
from tdm_tpu.models import cogvideox as jcog
from tdm_tpu.parallel.tp import tp_shardings
from tdm_tpu.train import families as jfamilies, optim as jopt, tdm as jtdm
from tdm_tpu_torch.cli import train_tdm
from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.models import cogvideox as tcog
from tdm_tpu_torch.train import families as tfamilies, tdm as ttdm
from tests.test_torch_port_train import ADAM_EPS, LR, _jax_draws, _update_close

torch.set_num_threads(2)

FRAMES = 4  # latent frames: 2 a rank at sp 2
BATCH = 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _carry(tree, module):
    return from_jax.state_dict_from_jax(from_jax.flatten_tree(tree), module)


def _mesh(shape, names):
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


def _models(use_rotary):
    base = dataclasses.replace(jcog.CogVideoXConfig.tiny(use_rotary=use_rotary),
                               sample_frames=FRAMES)
    spm = jcog.CogVideoXTransformer3D(cfg=dataclasses.replace(base,
                                                              sequence_parallel_axis="sp"))
    return base, jcog.CogVideoXTransformer3D(cfg=base), spm


def _forward_case(use_rotary, mesh_shape, names, seed, grads):
    """JAX's sequence_parallel_apply on a mesh of CPU devices (params 5%
    off their init: zero-initialized gates would hide a wiring fault), its
    output and, with `grads`, the gradients of sum(out·g), carried to the
    port's layout."""
    cfg, mono, spm = _models(use_rotary)
    rng = np.random.default_rng(seed)
    latent = rng.standard_normal((BATCH, cfg.in_channels, FRAMES, cfg.sample_h,
                                  cfg.sample_w)).astype(np.float32)
    t = np.array([700.0, 50.0], np.float32)
    text = rng.standard_normal((BATCH, cfg.max_text_len, cfg.text_dim)).astype(np.float32)
    params = mono.init(jax.random.PRNGKey(seed), jnp.asarray(latent), jnp.asarray(t),
                       jnp.asarray(text))["params"]
    params = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng.standard_normal(a.shape).astype(np.float32)), params)
    mesh = _mesh(mesh_shape, names)
    fn = jcog.sequence_parallel_apply(spm, mesh, data_axis="data")
    placed = jax.device_put(params, tp_shardings(params, mesh)) if "tp" in names else params
    out = jax.jit(fn)(placed, latent, t, text)
    module = tcog.CogVideoXTransformer3D(dataclasses.replace(
        tcog.CogVideoXConfig.tiny(use_rotary), sample_frames=FRAMES), device="cpu")
    case = {"mesh": mesh_shape if "tp" in names else (*mesh_shape, 1),
            "use_rotary": use_rotary, "frames": FRAMES, "params": _carry(params, module),
            "inputs": (_t(latent), _t(t), _t(text)), "out": np.asarray(out)}
    # the port's monolithic forward agrees with JAX's sp one before any rank runs
    module.load_state_dict(case["params"])
    with torch.no_grad():
        np.testing.assert_allclose(module(*case["inputs"]).numpy(), case["out"], atol=3e-5,
                                   rtol=3e-5)
    if grads:  # JAX's monolithic gradients (its sp ones match them to 2e-4)
        g = rng.standard_normal(latent.shape).astype(np.float32)
        jgrads = jax.jit(jax.grad(
            lambda p: jnp.sum(mono.apply({"params": p}, latent, t, text) * g)))(params)
        case["g"] = _t(g)
        case["grads"] = _carry(jgrads, module)
    return case


def _step_case():
    """JAX's dmd step with its sequence_parallel_apply denoiser on a
    ('data', 'sp') = (2, 2) mesh (`tests/test_tdm_video.py:64-130`'s
    setup, cfg 3.0, Adam ε 1e-4 and lr 1e-4 as the port's step parity),
    from a student 5% off the teacher, and its draws."""
    jb = jfamilies.build("cogvideox", tiny=True, num_frames=13)
    assert jb.sample_shape[1] == FRAMES
    rng = np.random.default_rng(61)
    teacher = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        jb.init_params(jax.random.PRNGKey(1)))
    _, _, spm = _models(False)
    mesh = _mesh((2, 2), ("data", "sp"))
    sp_apply = jcog.sequence_parallel_apply(spm, mesh, data_axis="data")
    config = jtdm.TDMConfig(total_steps=1000, num_steps=4, cfg=3.0, use_separate=True)
    tx = jopt.make_optimizer(LR, eps=ADAM_EPS)
    student = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng.standard_normal(a.shape).astype(np.float32)), teacher)
    jstate = jtdm.init_state(student, teacher, tx, tx)
    text = rng.standard_normal((BATCH, jb.seq_len, jb.embed_dim)).astype(np.float32)
    cond = jnp.asarray(text)
    uncond = jnp.zeros_like(cond)
    step = jtdm.build_train_step(lambda p, x, t, c: sp_apply(p, x, t, c), teacher, jb.schedule,
                                 config, tx, tx, sample_shape=jb.sample_shape)
    key = jax.random.PRNGKey(2)
    jnew, jm = jax.block_until_ready(jax.jit(step)(jstate, key, cond, uncond, teacher))
    tb = tfamilies.build("cogvideox", tiny=True, num_frames=13, device="cpu")
    return {
        "num_frames": 13, "lr": LR, "eps": ADAM_EPS,
        "config": {"total_steps": 1000, "num_steps": 4, "cfg": 3.0, "use_separate": True},
        "state": from_jax.train_state_from_jax(jstate, tb.model, device="cpu"),
        "teacher": _carry(teacher, tb.model),
        "draws": _jax_draws(key, config, BATCH, jb.sample_shape),
        "cond": _t(text), "uncond": torch.zeros(text.shape),
    }, {"metrics": {k: float(v) for k, v in jm._asdict().items()},
        "student": _carry(jnew.student, tb.model), "critic": _carry(jnew.critic, tb.model)}


def _pipeline_case(forward_case, mesh, tol):
    """The pipeline's call (cached embeddings, given noise, 4 NFE on the
    trained grid, latents out) and the one-process pipeline's latents."""
    from tdm_tpu_torch.models import vae3d
    from tdm_tpu_torch.pipelines import CogVideoXPipeline

    module = tcog.CogVideoXTransformer3D(dataclasses.replace(
        tcog.CogVideoXConfig.tiny(), sample_frames=FRAMES), device="cpu")
    module.load_state_dict(forward_case["params"])
    vcfg = vae3d.VAE3DConfig.tiny()
    rng = np.random.default_rng(9)
    h, w = module.cfg.sample_h * vcfg.spatial_factor, module.cfg.sample_w * vcfg.spatial_factor
    call = {"prompt_embeds": _t(rng.standard_normal((BATCH, 8, 32)).astype(np.float32)),
            "latents": _t(rng.standard_normal((BATCH, 16, FRAMES, module.cfg.sample_h,
                                               module.cfg.sample_w)).astype(np.float32)),
            "num_frames": 1 + (FRAMES - 1) * vcfg.temporal_factor, "height": h, "width": w,
            "output_type": "latent"}
    ref = CogVideoXPipeline(module, vae_cfg=vcfg, device="cpu")(**call).latents
    return dict(forward_case, mesh=mesh, call=call, ref=ref.float().numpy(), tol=tol)


def test_sp_forward_gradients_and_step_match_jax(tmp_path):
    """One 4-rank launch: the forward cases, the pipeline's and the step
    (module docstring)."""
    forward = {
        "sincos": _forward_case(False, (2, 2), ("data", "sp"), 3, grads=True),
        "rope": _forward_case(True, (2, 2), ("data", "sp"), 4, grads=False),
        "sp_tp": _forward_case(False, (1, 2, 2), ("data", "sp", "tp"), 5, grads=False),
    }
    # the bf16 sampler state: the ring's other order of sums can move a
    # latent across a bf16 rounding edge (one ulp is 2^-8 relative), so
    # each element within 1e-2 relative of the one-process pipeline's
    pipeline = {
        "pipeline": _pipeline_case(forward["sincos"], (2, 2, 1), {"atol": 1e-5, "rtol": 1e-2}),
        "pipeline_tp": _pipeline_case(forward["sincos"], (1, 2, 2),
                                      {"atol": 1e-5, "rtol": 1e-2}),
    }
    step, ref = _step_case()
    inputs, out = tmp_path / "sp.pt", tmp_path / "step.pt"
    torch.save({"forward": forward, "pipeline": pipeline, "step": step}, inputs)
    before = {r: {k: v.clone() for k, v in getattr(step["state"], r).items()}
              for r in ("student", "critic")}
    outs = parallel_worker.launch("sp", {"inputs": str(inputs), "out": str(out)}, 4, tmp_path,
                                  timeout=240)
    for r, o in enumerate(outs):
        for name in (*forward, *pipeline, "step"):
            assert f"sp {name} ok {r}" in o, o[-3000:]
    got = torch.load(out, weights_only=False)
    for name in ttdm.StepMetrics._fields:
        assert np.isfinite(got["metrics"][name]), name
        assert got["metrics"][name] == pytest.approx(ref["metrics"][name], rel=1e-4,
                                                     abs=1e-7), name
    for role in ("student", "critic"):
        _update_close(before[role], ref[role], getattr(got["state"], role), role)


def test_sp_cli_with_fsdp_on_four_ranks(tmp_path):
    """`--sp 2 --fsdp 2` (data 1 x fsdp 2 x sp 2) for 2 steps of the tiny
    cogvideox at 2 latent frames: metrics and `student.safetensors` in the
    JAX layout, written by process 0; then `--num_frames 9` (3 latent
    frames) refused with the JAX CLI's ValueError on every rank."""
    out = tmp_path / "cog_sp"
    argv = ["--output_dir", str(out), "--device", "cpu", "--train_batch_size", "1",
            "--max_train_steps", "2", "--checkpointing_steps", "2", "--learning_rate", "1e-4",
            "--seed", "0", "--model_family", "cogvideox", "--sp", "2", "--fsdp", "2",
            "--export_lora_rank", "0", "--validation_steps", "100"]
    bad = [a if a != "5" else "9" for a in [*argv, "--num_frames", "5"]]
    bad[1] = str(tmp_path / "bad")
    parallel_worker.launch(
        "cli_runs", {"argvs": [[*argv, "--num_frames", "5"]],
                     "refused": [[bad, "does not divide the latent frame count 3"]],
                     "shard_min": 512}, 4, tmp_path, env={"TDM_TINY_MODEL": "1"}, timeout=240)
    run = tmp_path / "cog_sp_cfg4.5_steps900"
    rows = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss_student"] for r in rows if "loss_student" in r]
    assert losses and all(np.isfinite(v) and abs(v) < 1e6 for v in losses)
    assert (run / "student.safetensors").exists() and (run / "checkpoint-2").exists()
    assert not (tmp_path / "bad_cfg4.5_steps900" / "logs" / "metrics.jsonl").exists()


@pytest.mark.parametrize("flags,message", [
    (["--model_family", "pixart", "--sp", "2"], "--model_family cogvideox only"),
    (["--model_family", "cogvideox", "--sp", "2", "--tp", "2"],
     r"--sp composes with --fsdp only \(tp/pp/ep x sp is unsupported\)"),
    (["--model_family", "cogvideox", "--sp", "2", "--quant_forwards"],
     "--sp with --quant_forwards is not supported"),
    (["--model_family", "cogvideox", "--sp", "2"],
     r"--fsdp 1 x --tp 1 x --pp 1 x --ep 1 x --sp 2 does not divide 1 devices"),
])
def test_sp_cli_refusals_in_the_jax_order(tmp_path, monkeypatch, flags, message):
    """In one process, before any model is built: the JAX CLI's --sp
    checks (family, composition, --quant_forwards), then its "does not
    divide N devices"."""
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    with pytest.raises(ValueError, match=message):
        train_tdm.main(["--device", "cpu", "--output_dir", str(tmp_path / "x"), *flags])
    assert not (tmp_path / "x_cfg4.5_steps900" / "logs").exists()
