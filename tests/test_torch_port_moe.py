"""The port's mixture-of-experts PixArt (`tdm_tpu_torch/models/moe.py`)
against the JAX package on the CPU, at tiny sizes, inputs from numpy seeds.

* `MoEFeedForward` forward and gradients (x and every parameter) against
  the JAX module and `jax.grad`: fp32 outputs to 1e-5, gradients to 1e-4
  (rtol and atol), over E=4/k=2 at the default capacity factor, at cf 0.6
  (pairs dropped, asserted), E=1/k=1 (the dense FeedForward), and the
  'gelu' and 'geglu' activations. The port's row route against its own
  one-hot plain version (`plain_moe`, the JAX form), the Switch term
  against JAX's sowed `moe_aux`, ties routed to the lower index.
* The MoE PixArt forward with weights carried from the stacked and the
  unrolled JAX trees; its remat ('full' and 'dots') against plain.
* One MoE TDM step against the JAX step (state carried by
  `train_state_from_jax`), at cf 0.6 with pairs dropped.
* The training CLI: `--moe_experts 4` for 2 steps, its
  `student.safetensors` read back by JAX's `load_params` equal; a
  checkpoint in the JAX layout as a teacher; the JAX CLI's four validation
  errors; LoRA leaves the experts and the router alone.
* Serving: `from_pretrained` of a MoE student the JAX package wrote,
  against the JAX pipeline's batch; `--dp 2` on a MoE student refused.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu.io import params as jparams
from tdm_tpu.models import moe as jmoe, pixart as jpixart
from tdm_tpu.models.layers import FeedForward as JFeedForward
from tdm_tpu.train import families as jfamilies, optim as jopt, tdm as jtdm
from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.models import moe as tmoe, pixart as tpixart
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm
from test_torch_port_train import ADAM_EPS, LR, _jax_draws, _update_close

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _module_pair(e, k, cf, act, mult=2, dim=16, seed=0):
    """A JAX MoE layer's params (perturbed so the biases matter) and the
    port's layer holding them."""
    jm = jmoe.MoEFeedForward(num_experts=e, top_k=k, mult=mult, capacity_factor=cf,
                             activation=act)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, dim)))["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    tm = tmoe.MoEFeedForward(dim, e, k, mult=mult, capacity_factor=cf, activation=act,
                             dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(params), tm))
    return jm, params, tm


def _dropped(idx, e, cap):
    """Pairs past capacity in the slot-major order (numpy)."""
    counts, drops = np.zeros(e, int), 0
    for slot in range(idx.shape[1]):
        for ex in idx[:, slot]:
            drops += counts[ex] >= cap
            counts[ex] += 1
    return drops


@pytest.mark.parametrize("e,k,cf,act", [
    (4, 2, 1.25, "gelu-approximate"),
    (4, 2, 0.6, "gelu-approximate"),
    (1, 1, 1.0, "gelu-approximate"),
    (4, 2, 0.6, "gelu"),
    (4, 2, 0.6, "geglu"),
], ids=["e4k2", "cf0.6-drops", "e1k1-dense", "gelu", "geglu"])
def test_moe_layer_forward_and_grads_match_jax(e, k, cf, act):
    jm, params, tm = _module_pair(e, k, cf, act)
    x = np.random.default_rng(3).standard_normal((2, 12, 16)).astype(np.float32)
    ct = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * ct)

    jout = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out = tm(xt)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((out * _t(ct)).sum(), [xt, *tm.parameters()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)
    want = from_jax.state_dict_from_jax(from_jax.flatten_tree(jgp), tm)
    for (name, _), g in zip(tm.named_parameters(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    # the plain version (one-hot einsums, the JAX form) gives the same output
    with torch.no_grad():
        np.testing.assert_allclose(tmoe.plain_moe(tm, _t(x)).numpy(), jout, rtol=1e-5,
                                   atol=1e-5)
        probs = torch.softmax(_t(x).reshape(-1, 16) @ tm.router.weight.T, -1)
    _, idx = tmoe.top_k(probs, k)
    drops = _dropped(idx.numpy(), e, tmoe.capacity(cf, k, 24, e))
    if cf < 1:
        assert drops > 0
    if e == 1:  # the dense FeedForward with the one expert's weights
        dense = JFeedForward(mult=2, activation="gelu-approximate")
        dp = {"proj_in": {"kernel": params["experts_in"][0], "bias": params["experts_in_bias"][0]},
              "proj_out": {"kernel": params["experts_out"][0],
                           "bias": params["experts_out_bias"][0]}}
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(dense.apply({"params": dp}, jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5)


def test_aux_term_and_ties_match_jax():
    jm, params, tm = _module_pair(4, 2, 1.25, "gelu-approximate")
    x = np.random.default_rng(5).standard_normal((2, 16, 16)).astype(np.float32)
    _, vs = jm.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    with torch.no_grad():
        tm(_t(x))
    assert float(tmoe.moe_aux_loss(tm)) == pytest.approx(float(jmoe.moe_aux_loss(vs)), rel=1e-5)
    # a uniform router: every probability ties, so every token takes experts
    # 0 and 1 (lax.top_k's lower index first) and the term is 1 exactly
    params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
    tm.router.weight.data.zero_()
    jout = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(x)).numpy(), jout, rtol=1e-5, atol=1e-5)
    _, idx = tmoe.top_k(torch.full((3, 4), 0.25), 2)
    assert idx.tolist() == [[0, 1]] * 3
    assert float(tmoe.moe_aux_loss(tm)) == pytest.approx(1.0, abs=1e-6)


def test_invalid_top_k_raises():
    with pytest.raises(ValueError, match="top_k"):
        tmoe.MoEFeedForward(8, 2, 3, dtype=torch.float32, device="cpu")


def _moe_cfg(jcfg, **kw):
    return dataclasses.replace(jcfg, moe_experts=4, moe_top_k=2, **kw)


@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "unrolled"])
def test_moe_pixart_forward_matches_jax(scan):
    jcfg = _moe_cfg(jpixart.PixArtConfig.tiny(), scan_layers=scan, moe_capacity_factor=0.6)
    jm = jpixart.PixArtTransformer2D(cfg=jcfg)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    t = np.array([899, 10])
    text = rng.standard_normal((2, 8, 32)).astype(np.float32)
    mask = np.array([[1] * 8, [1] * 3 + [0] * 5], np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(lat), jnp.asarray(t), jnp.asarray(text),
                     jnp.asarray(mask))["params"]
    key = "blocks" if scan else "blocks_0"
    assert "experts_in" in params[key]["ff"] and "router" in params[key]["ff"]
    flat = from_jax.flatten_tree(params)
    tcfg = _moe_cfg(tpixart.PixArtConfig.tiny(), moe_capacity_factor=0.6)
    tm = tpixart.PixArtTransformer2D(tcfg, device="cpu")
    from_jax.load_from_jax(flat, tm)
    jout = np.asarray(jm.apply({"params": params}, lat, t, text, mask))
    with torch.no_grad():
        out = tm(_t(lat), _t(t), _t(text), _t(mask))
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-4, atol=1e-4)
    # the carry back out: the JAX layout of the same weights, leaf for leaf
    back = from_jax.jax_layout(tm.state_dict(), stacks=from_jax.layer_stacks(jcfg))
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_moe_remat_gives_the_same_gradients(policy):
    """A MoE block under remat recomputes its routing in the backward: the
    gradients equal the plain ones."""
    cfg = _moe_cfg(tpixart.PixArtConfig.tiny(), moe_capacity_factor=0.6)
    torch.manual_seed(0)
    plain = tpixart.PixArtTransformer2D(cfg, device="cpu")
    remat = tpixart.PixArtTransformer2D(
        dataclasses.replace(cfg, remat=True, remat_policy=policy), device="cpu")
    remat.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(1)
    args = (_t(rng.standard_normal((2, 4, 16, 16)).astype(np.float32)), _t(np.array([500, 20])),
            _t(rng.standard_normal((2, 8, 32)).astype(np.float32)),
            torch.ones(2, 8, dtype=torch.int32))
    g = [torch.autograd.grad(m(*args).square().mean(), list(m.parameters()))
         for m in (plain, remat)]
    for a, b in zip(*g):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def tiny_capacity(monkeypatch, cf):
    """Both packages' tiny PixArt configs at MoE capacity factor `cf` (the
    CLIs take no flag for it)."""
    for cls in (jpixart.PixArtConfig, tpixart.PixArtConfig):
        tiny = cls.tiny
        monkeypatch.setattr(cls, "tiny", staticmethod(
            lambda tiny=tiny: dataclasses.replace(tiny(), moe_capacity_factor=cf)))


def test_moe_train_step_matches_jax(monkeypatch):
    """One dmd step (two critic updates, Huber, EMA) of the tiny MoE PixArt
    at capacity factor 0.6, from one state: metrics to 1e-4 relative and
    each role's update within test_train_step_matches_jax's bounds."""
    tiny_capacity(monkeypatch, 0.6)
    jb = jfamilies.build("pixart", tiny=True, moe_experts=4)
    tb = tfamilies.build("pixart", tiny=True, moe_experts=4, device="cpu")
    assert tb.model.blocks[0].ff.capacity_factor == 0.6
    teacher = jb.init_params(jax.random.PRNGKey(0))
    assert teacher["blocks"]["ff"]["experts_in"].shape[:2] == (2, 4)
    config = jtdm.TDMConfig(loss_mode="dmd", critic_updates=2, use_huber=True)
    tconfig = ttdm.TDMConfig(loss_mode="dmd", critic_updates=2, use_huber=True)
    rng = np.random.default_rng(14)
    text = rng.standard_normal((2, 8, jb.embed_dim)).astype(np.float32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    utext, umask = np.zeros_like(text), np.ones_like(mask)
    rng_p = np.random.default_rng(16)
    student = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng_p.standard_normal(a.shape).astype(np.float32)), teacher)
    jtx, ttx = jopt.make_optimizer(LR, eps=ADAM_EPS), topt.make_optimizer(LR, eps=ADAM_EPS)
    jstate = jtdm.init_state(student, teacher, jtx, jtx, use_ema=True)
    tstate = from_jax.train_state_from_jax(jstate, tb.model, device="cpu")
    tteacher = from_jax.state_dict_from_jax(from_jax.flatten_tree(teacher), tb.model)
    before = {role: {k: v.clone() for k, v in getattr(tstate, role).items()}
              for role in ("student", "critic")}
    key = jax.random.PRNGKey(5)
    jstep = jtdm.build_train_step(jb.denoise_fn, teacher, jb.schedule, config, jtx, jtx,
                                  sample_shape=jb.sample_shape)
    jnew, jm = jax.block_until_ready(jstep(jstate, key, (text, mask), (utext, umask), teacher))
    tstep = ttdm.build_train_step(tb.denoise_fn, tteacher, tb.schedule, tconfig, ttx, ttx,
                                  sample_shape=tb.sample_shape)
    tnew, tm = tstep(tstate, _jax_draws(key, config, 2, jb.sample_shape),
                     (_t(text), _t(mask)), (_t(utext), _t(umask)))
    for name in jtdm.StepMetrics._fields:
        assert float(getattr(tm, name)) == pytest.approx(float(getattr(jm, name)), rel=1e-4,
                                                         abs=1e-7), name
    for role in ("student", "critic"):
        ref = from_jax.state_dict_from_jax(from_jax.flatten_tree(getattr(jnew, role)), tb.model)
        _update_close(before[role], ref, getattr(tnew, role), role)
        assert any(float((getattr(tnew, role)[k] - before[role][k]).abs().max()) > 0
                   for k in ref if tmoe.is_expert_key(k)), role


@pytest.fixture
def tiny_env(monkeypatch):
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    for var in ("TDM_EMBEDDING_CACHE", "TDM_TAESD_DIR", "TDM_COORDINATOR", "RANK",
                "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)


def _cli(out, *extra):
    from tdm_tpu_torch.cli import train_tdm

    train_tdm.main(["--device", "cpu", "--output_dir", str(out), "--seed", "0",
                    "--train_batch_size", "2", "--moe_experts", "4", *extra])
    return out.parent / (out.name + "_cfg4.5_steps900")


def test_moe_cli_exports_a_student_jax_reads(tmp_path, tiny_env):
    """2 steps of `--moe_experts 4` with the SVD export at rank 4: the
    fp16 `student.safetensors` read by JAX's `load_params` is the port's
    final student, leaf for leaf in the JAX tree's layout, and runs in the
    JAX MoE PixArt; the kohya LoRA holds no expert or router factor."""
    from tdm_tpu_torch.io import params as tparams

    run = _cli(tmp_path / "run", "--max_train_steps", "2", "--export_lora_rank", "4")
    tree = jparams.load_params(str(run / "student.safetensors"), to_jnp=False)
    init = jfamilies.build("pixart", tiny=True, moe_experts=4).init_params(
        jax.random.PRNGKey(0))
    jflat, tflat = from_jax.flatten_tree(init), from_jax.flatten_tree(tree)
    assert set(tflat) == set(jflat) and "blocks/ff/experts_in" in jflat
    assert all(tflat[k].shape == jflat[k].shape and tflat[k].dtype == np.float16 for k in jflat)
    saved = tparams.load_file(str(run / "checkpoint-2" / "student.safetensors"))
    want = from_jax.jax_layout({k: torch.from_numpy(v) for k, v in saved.items()})
    for k in want:
        np.testing.assert_array_equal(tflat[k], want[k].astype(np.float16), err_msg=k)
    model = jpixart.PixArtTransformer2D(cfg=_moe_cfg(jpixart.PixArtConfig.tiny()))
    out = model.apply({"params": jax.tree.map(lambda a: a.astype(np.float32), tree)},
                      jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)), jnp.ones((1, 8, 32)),
                      jnp.ones((1, 8), jnp.int32))
    assert np.isfinite(np.asarray(out)).all()
    kohya = tparams.load_file(str(run / "tdm_lora.safetensors"))
    assert kohya and not any("expert" in k or "router" in k for k in kohya)


def test_moe_lora_student_leaves_experts_and_router_alone(tiny_env, tmp_path):
    """--train_lora_rank adapts the attention projections: no factor on an
    expert stack or the router; the LoRA student trains over the MoE
    teacher."""
    from tdm_tpu_torch import lora as tlora

    tb = tfamilies.build("pixart", tiny=True, moe_experts=4, device="cpu")
    template = tlora.init_lora(tb.model, 4, generator=torch.Generator().manual_seed(0))
    paths = [p for p, _ in template.alpha]
    assert paths and not any("expert" in p or "router" in p for p in paths)
    run = _cli(tmp_path / "lora", "--max_train_steps", "1", "--train_lora_rank", "4")
    assert (run / "tdm_lora.safetensors").exists()


def test_moe_teacher_from_a_tdm_tpu_layout_directory(tmp_path, tiny_env):
    """A MoE denoiser the JAX package's `save_pretrained` wrote, as the
    teacher: its expert leaves load through the weight carry (the student
    starts as the teacher, and at learning rate 0 stays it)."""
    from tdm_tpu.pipelines import loading as jloading
    from tdm_tpu_torch.io import params as tparams

    cfg = _moe_cfg(jpixart.PixArtConfig.tiny())
    params = jpixart.PixArtTransformer2D(cfg=cfg).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 8, 32)), jnp.ones((1, 8), jnp.int32))["params"]
    teacher_dir = str(tmp_path / "teacher")
    jloading.save_pretrained(teacher_dir, family="pixart", transformer_params=params,
                             model_config=jloading.config_dict(cfg))
    run = _cli(tmp_path / "run", "--max_train_steps", "1", "--export_lora_rank", "0",
               "--learning_rate", "0", "--pretrained_model_name_or_path", teacher_dir)
    saved = tparams.load_file(str(run / "checkpoint-1" / "student.safetensors"))
    got = from_jax.jax_layout({k: torch.from_numpy(v) for k, v in saved.items()})
    want = from_jax.flatten_tree(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("flags,error,message", [
    (["--ep", "2"], ValueError, "--ep requires --moe_experts > 0"),
    (["--moe_experts", "4", "--ep", "2", "--tp", "2"], ValueError,
     "--ep composes with --fsdp only"),
    (["--moe_experts", "3", "--ep", "2"], ValueError, "--moe_experts 3 not divisible by --ep 2"),
    (["--moe_experts", "4", "--model_family", "sd15"], ValueError, "pixart-family extension"),
    (["--moe_experts", "4", "--ep", "2"], ValueError, "does not divide 1 devices"),
    (["--moe_experts", "4", "--ep", "2", "--use_8bit_adam"], NotImplementedError, "slice 6"),
], ids=["ep-needs-moe", "ep-with-tp", "indivisible", "not-pixart", "world-1", "ep-8bit"])
def test_moe_flag_validation(tmp_path, tiny_env, flags, error, message):
    """The JAX CLI's --ep/--moe_experts checks with its messages (the first
    four raised by both CLIs), before any model is built; at world 1
    `--ep 2` does not divide the devices; --ep with 8-bit Adam waits."""
    from tdm_tpu.cli import train_tdm as jcli
    from tdm_tpu_torch.cli import train_tdm

    argv = ["--output_dir", str(tmp_path / "run"), "--max_train_steps", "1", *flags]
    with pytest.raises(error, match=message):
        train_tdm.main(["--device", "cpu", *argv])
    assert not (tmp_path / "run_cfg4.5_steps900" / "logs").exists()
    if message != "does not divide 1 devices" and error is ValueError:
        with pytest.raises(ValueError, match=message):
            jcli.main(argv + ["--train_data_dir", "", "--dataset_name", "unused"])


@pytest.fixture(scope="module")
def moe_pipes(tmp_path_factory):
    """A tiny MoE PixArt pipeline (cf 0.6) the JAX package's
    `save_pretrained` wrote, and the port's `from_pretrained` of it."""
    from tdm_tpu.models import vae as jvae
    from tdm_tpu.pipelines.pixart import PixArtPipeline as JaxPipeline
    from tdm_tpu_torch.pipelines import from_pretrained

    cfg = _moe_cfg(jpixart.PixArtConfig.tiny(), moe_capacity_factor=0.6)
    model = jpixart.PixArtTransformer2D(cfg=cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
                        jnp.zeros((1, 8, 32)), jnp.ones((1, 8), jnp.int32))["params"]
    vcfg = jvae.TAESDConfig(width=8, num_stages=1, blocks_per_stage=1)
    dec = jvae.TAESDDecoder(cfg=vcfg)
    vparams = dec.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, 16, 16)))["params"]
    jpipe = JaxPipeline(model, params, vae_decoder=dec, vae_params=vparams)
    path = str(tmp_path_factory.mktemp("moe_pipe"))
    jpipe.save_pretrained(path)
    assert json.load(open(os.path.join(path, "pipeline.json")))["model"]["moe_experts"] == 4
    return jpipe, from_pretrained(path, device="cpu")


def test_moe_pipeline_from_pretrained_matches_jax(moe_pipes):
    """A batch of 3 at 4 NFE, latents out: within one bf16 ulp of the
    latents' scale (the pipeline parity bound of
    tests/test_torch_port_pipeline.py), images to 2e-3."""
    jpipe, pipe = moe_pipes
    assert isinstance(pipe.transformer.blocks[0].ff, tmoe.MoEFeedForward)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
    text = rng.standard_normal((3, 8, 32)).astype(np.float32)
    mask = (np.arange(8)[None] < np.array([[8], [3], [5]])).astype(np.int32)
    call = dict(num_inference_steps=4, height=128, width=128)
    ref = jpipe(prompt_embeds=(jnp.asarray(text), jnp.asarray(mask)), latents=jnp.asarray(lat),
                **call)
    got = pipe(prompt_embeds=(text, mask), latents=lat, **call)
    ref_lat = np.asarray(ref.latents.astype(jnp.float32))
    diff = np.abs(got.latents.float().numpy() - ref_lat)
    assert diff.max() <= 2**-7 * np.abs(ref_lat).max(), diff.max()
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)


def test_moe_pipeline_refuses_dp(moe_pipes):
    """`--dp 2` would split a batch whose drops depend on all its rows."""
    _, pipe = moe_pipes
    with pytest.raises(NotImplementedError, match="slice 6"):
        pipe.data_parallel_devices = ["cpu", "cpu"]
    pipe.data_parallel_devices = ["cpu"]  # one replica: the batch stays whole
    assert pipe.data_parallel_devices == [torch.device("cpu")]
    pipe.data_parallel_devices = None


def test_moe_tree_through_unstack_layers_and_save_params(tmp_path):
    """A stacked MoE PixArt tree: the port's `unstack_layers` gives the
    JAX package's unrolled tree leaf for leaf (expert stacks [E, ...] a
    layer), its `save_params` file reads back through JAX's `load_params`
    equal, and the diffusers direction raises in both packages (diffusers
    has no MoE PixArt)."""
    from tdm_tpu.io import convert as jconvert
    from tdm_tpu_torch.io import convert as tconvert, params as tparams

    cfg = _moe_cfg(jpixart.PixArtConfig.tiny())
    tree = jpixart.PixArtTransformer2D(cfg=cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 8, 32)), jnp.ones((1, 8), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, tree)
    got = from_jax.flatten_tree(tconvert.unstack_layers(dict(tree)))
    want = from_jax.flatten_tree(jconvert.unstack_layers(dict(tree)))
    assert got.keys() == want.keys() and got["blocks_1/ff/experts_in"].shape == (4, 32, 128)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = str(tmp_path / "moe.safetensors")
    tparams.save_params(tree, path)
    back = from_jax.flatten_tree(jparams.load_params(path, to_jnp=False))
    flat = from_jax.flatten_tree(tree)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with pytest.raises(KeyError):
        jconvert.pixart_to_torch(tree)
    with pytest.raises(KeyError):
        tconvert.pixart_to_torch(tree)
