"""The CogVideoX training slice against the JAX package on the CPU: the
cogvideox family bundle (its schedule tables, geometry and conditioning),
the full size built on the meta device, the tiny 3D DiT's gradients with
and without remat under both position schemes, one cogvideox TDM step
(full weights; a LoRA student under 8-bit Adam and accumulation 2) from
one carried state with the schedule's terminal index among the draws, and
the training CLI: video latents render no validation grid, resume, a
teacher from a diffusers transformer directory and the kohya LoRA loaded
back into the pipeline.

Inputs come from numpy seeds (the step's draws from JAX's own key splits)
and pass between the packages as numpy arrays; everything is fp32, where
the two differ in the order of sums. Each tolerance says how much that
grows through its computation.

Both families feed the 3D DiT the schedule index t, as both CogVideoX
pipelines feed it when sampling, so the JAX step runs the JAX family's own
`denoise_fn`.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tdm_tpu.core import schedules as jsched
from tdm_tpu.lora import adapter as jlora
from tdm_tpu.models import cogvideox as jcog
from tdm_tpu.train import families as jfamilies, optim as jopt, tdm as jtdm
from tdm_tpu_torch import lora as tlora
from tdm_tpu_torch.core import schedules as tsched
from tdm_tpu_torch.io import from_jax, manifest as tmanifest, params as tparams
from tdm_tpu_torch.models import cogvideox as tcog
from tdm_tpu_torch.ops import attention as tattn
from tdm_tpu_torch.pipelines import CogVideoXPipeline
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm
from tests.test_torch_port_sd3_train import (
    _dtype_name, _jax_lora_factors, _moments_close, _taesd3_dir,
)
from tests.test_torch_port_train import ADAM_EPS, LR, _jax_draws, _update_close

torch.set_num_threads(2)

BATCH = 2
TXT = 8  # the tiny config's T5 length
# the schedule's last index, 999, opens the rollout of a 1000-step grid
# ([999, 749, 499, 249]); a segment draw of 1 puts the student's
# grad-carrying forward there too, where α = 0 and x̂₀ = −v
TERMINAL = jtdm.TDMConfig(total_steps=1000)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _carry(tree, module):
    return from_jax.state_dict_from_jax(from_jax.flatten_tree(tree), module)


# --- the cogvideox bundle -------------------------------------------------------------


@pytest.mark.parametrize("tiny,num_frames,ckpt,mp,shape", [
    (True, 0, False, None, (16, 3, 8, 8)),
    (True, 9, True, "no", (16, 3, 8, 8)),
    (False, 49, True, "bf16", (16, 13, 60, 90)),
    (False, 25, False, "no", (16, 7, 60, 90)),
])
def test_cogvideox_bundle_matches_jax(tiny, num_frames, ckpt, mp, shape):
    """Geometry, schedule and model config of the cogvideox bundle as the
    JAX package builds them (num_frames pixel frames → 1 + (n − 1)//4
    latent frames); the full size on the meta device, no parameter
    allocated, at CogVideoX-2B's 1,693,783,872 parameters, fp32 masters.
    The v-prediction tables bit for bit (both built in float64 and rounded
    once to fp32), α = 0 at the terminal index."""
    kw = dict(tiny=tiny, num_frames=num_frames, gradient_checkpointing=ckpt, mixed_precision=mp)
    jb = jfamilies.build("cogvideox", **kw)
    tb = tfamilies.build("cogvideox", **kw, device="cpu" if tiny else "meta")
    assert tb.sample_shape == jb.sample_shape == shape
    assert (tb.seq_len, tb.embed_dim) == (jb.seq_len, jb.embed_dim)
    assert (tb.seq_len, tb.embed_dim) == ((TXT, 32) if tiny else (226, 4096))
    assert tb.schedule.prediction_type == jb.schedule.prediction_type == jsched.V_PREDICTION
    jc, tc = jb.model.cfg, tb.model.cfg
    assert {f.name for f in dataclasses.fields(jc)} == {f.name for f in dataclasses.fields(tc)}
    for f in dataclasses.fields(jc):
        if f.name == "dtype":
            assert _dtype_name(tc.dtype) == _dtype_name(jc.dtype)
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.remat == ckpt
    assert all(p.dtype == torch.float32 for p in tb.model.parameters())
    if not tiny:
        assert sum(p.numel() for p in tb.model.parameters()) == 1_693_783_872
        return
    sched = tsched.cogvideox(device="cpu")
    for name in ("alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(tb.schedule, name).numpy(),
                                      np.asarray(getattr(jb.schedule, name)))
        np.testing.assert_array_equal(getattr(tb.schedule, name).numpy(),
                                      getattr(sched, name).numpy())
    assert float(tb.schedule.alphas[999]) == 0.0 and float(tb.schedule.sigmas[999]) == 1.0


def test_cond_of_zeroes_the_padded_rows_as_jax():
    """cond_of is the T5 tokens with the rows past each mask zeroed (the
    model takes no mask), equal to JAX's bit for bit; a pooled vector is
    ignored, and the whole cond is one tensor."""
    jb = jfamilies.build("cogvideox", tiny=True)
    tb = tfamilies.build("cogvideox", tiny=True, device="cpu")
    rng = np.random.default_rng(50)
    text = rng.standard_normal((3, TXT, 32)).astype(np.float32)
    mask = (np.arange(TXT)[None] < np.array([[8], [3], [0]])).astype(np.int32)
    want = np.asarray(jb.cond_of(jnp.asarray(text), jnp.asarray(mask)))
    got = tb.cond_of(_t(text), _t(mask), _t(np.ones((3, 5), np.float32)))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2].any() and not got[1, 3:].any() and torch.equal(got[0], _t(text[0]))


def test_cat_cond_batches_a_tensor_and_a_tuple():
    """The step's CFG batch: one tensor (cogvideox) or a tuple (the image
    families) concatenated leaf by leaf along the batch, as JAX's
    jax.tree.map does."""
    a, b = torch.arange(6.0).reshape(2, 3), -torch.arange(6.0).reshape(2, 3)
    assert torch.equal(ttdm.cat_cond(a, b), torch.cat([a, b]))
    got = ttdm.cat_cond((a, a[:, 0]), (b, b[:, 0]))
    assert torch.equal(got[0], torch.cat([a, b])) and torch.equal(got[1], torch.cat([a, b])[:, 0])


# --- the tiny 3D DiT under grad ------------------------------------------------------------


def _perturbed(params, rng):
    """Every leaf moved off JAX's init by 5%: zero-initialized gates would
    hide a wiring fault."""
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)), params)


@pytest.mark.parametrize("use_rotary", [False, True], ids=["sincos", "rope"])
def test_tiny_cogvideox_gradients_match_jax(use_rotary, monkeypatch):
    """The port's forward and every parameter's gradient (plain attention
    on the CPU, fp32 masters) against jax.grad of the JAX 3D DiT (impl
    'xla') on the same weights: the output to 1e-4 of its largest value,
    the loss to 1e-4 relative, each gradient to 2e-4 in relative L2 (fp32
    sums in another order through two blocks and their LayerNormZero
    modulations); under sin-cos positions the key norm's bias, whose
    gradient is 0, to 1e-8 of the largest gradient norm. With remat the
    loss and every gradient equal the run without it to 1e-6 (the same
    forward recomputed), and the backward runs each block's attention
    forward with its lse a second time."""
    jcfg = jcog.CogVideoXConfig.tiny(use_rotary=use_rotary)
    jmodel = jcog.CogVideoXTransformer3D(cfg=jcfg)
    rng = np.random.default_rng(51)
    x = rng.standard_normal((BATCH, 16, 3, 8, 8)).astype(np.float32)
    t = np.array([999, 120], np.int64)
    text = rng.standard_normal((BATCH, TXT, 32)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(5), x, t, text)["params"], rng)

    def jloss(p):
        return jnp.sum(jmodel.apply({"params": p}, x, t, text) * g)

    jl, jgrads = jax.value_and_grad(jloss)(params)
    jout = np.asarray(jmodel.apply({"params": params}, x, t, text))
    got = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcog.CogVideoXConfig.tiny(use_rotary=use_rotary), remat=remat)
        model = tcog.CogVideoXTransformer3D(cfg, device="cpu", param_dtype=torch.float32)
        model.requires_grad_(False)
        weights = {k: v.requires_grad_(True) for k, v in _carry(params, model).items()}
        calls = []
        wrapper = tattn.flash_attention_fwd_lse
        monkeypatch.setattr(tattn, "flash_attention_fwd_lse",
                            lambda *a: calls.append(1) or wrapper(*a))
        out = functional_call(model, weights, (_t(x), _t(t), _t(text)))
        loss = (out * _t(g)).sum()
        grads = dict(zip(weights, torch.autograd.grad(loss, list(weights.values()))))
        monkeypatch.setattr(tattn, "flash_attention_fwd_lse", wrapper)
        got[remat] = (out.detach(), loss.detach(), grads, len(calls))
    out, loss, grads, n_plain = got[False]
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-4 * np.abs(jout).max())
    assert float(loss) == pytest.approx(float(jl), rel=1e-4)
    ref = _carry(jgrads, model)
    assert set(ref) == set(grads)
    top = max(float(r.norm()) for r in ref.values())
    for k, r in ref.items():
        if k.endswith("norm_k.bias") and not use_rotary:
            # the same q·b on every logit of a row, which the softmax
            # cancels: 0 but for roundoff on both sides (RoPE rotates b
            # per video row, so there it has a gradient)
            assert max(float(r.norm()), float(grads[k].norm())) <= 1e-8 * top, k
            continue
        assert float(r.norm()) > 0, k
        assert float((grads[k] - r).norm()) <= 2e-4 * float(r.norm()), k
    _, loss_r, grads_r, n_remat = got[True]
    assert (n_plain, n_remat) == (2, 4)  # 2 blocks, each recomputed once under remat
    assert float(loss_r) == pytest.approx(float(loss), rel=1e-6)
    for k in grads:
        torch.testing.assert_close(grads_r[k], grads[k], rtol=1e-6, atol=1e-8)


def test_fp32_masters_leave_the_serving_forward_unchanged():
    """A model holding its parameters in cfg.dtype (serving) and one holding
    fp32 masters of the same bf16 values compute the same bits: every
    Dense and the patchify cast the masters to bf16 at use, the norms are
    fp32 in both."""
    cfg = dataclasses.replace(tcog.CogVideoXConfig.tiny(), dtype=torch.bfloat16)
    torch.manual_seed(3)
    serving = tcog.CogVideoXTransformer3D(cfg, device="cpu")
    masters = tcog.CogVideoXTransformer3D(cfg, device="cpu", param_dtype=torch.float32)
    masters.load_state_dict(serving.state_dict())
    assert serving.blocks[0].to_q.weight.dtype == torch.bfloat16
    assert masters.blocks[0].to_q.weight.dtype == torch.float32
    rng = np.random.default_rng(52)
    lat = _t(rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32))
    text = _t(rng.standard_normal((2, TXT, 32)).astype(np.float32))
    with torch.no_grad():
        a = serving(lat, torch.tensor([999, 10]), text)
        b = masters(lat, torch.tensor([999, 10]), text)
    assert torch.equal(a, b)


def test_denoise_fn_feeds_the_index_as_the_pipeline_does(monkeypatch):
    """The bundle's denoise_fn hands the 3D DiT the schedule index t as it
    is, and the CogVideoX pipeline's sampler feeds the model the int64 grid
    indices themselves: the model sees the same t and gives the same bits
    through both (no σ̂·1000 mapping as SD3's family has, ROADMAP.md §3)."""
    tb = tfamilies.build("cogvideox", tiny=True, device="cpu")
    model = tcog.CogVideoXTransformer3D(tb.model.cfg, device="cpu")
    model.load_state_dict(tb.init_params())
    seen = []
    forward = tcog.CogVideoXTransformer3D.forward

    def spy(self, latent, t, text):
        seen.append(torch.as_tensor(t).clone())
        return forward(self, latent, t, text)

    monkeypatch.setattr(tcog.CogVideoXTransformer3D, "forward", spy)
    rng = np.random.default_rng(56)
    text = rng.standard_normal((2, TXT, 32)).astype(np.float32)
    lat = rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32)
    grid = [999, 749, 499, 249]
    CogVideoXPipeline(model, device="cpu")(
        prompt_embeds=text, latents=lat, num_frames=9, height=64, width=64,
        timesteps=grid, output_type="latent")
    assert [t.tolist() for t in seen] == [[g, g] for g in grid]
    assert all(t.dtype == torch.int64 for t in seen)
    x, t = _t(lat), seen[0]
    with torch.no_grad():
        want = tcog.make_denoise_fn(model)(x, t, _t(text))
        got = tb.denoise_fn(tb.init_params(), x, t, _t(text))
    assert torch.equal(seen[-1], seen[-2]) and torch.equal(got, want)


# --- the cogvideox TDM step against JAX ---------------------------------------------------


@pytest.fixture(scope="module")
def cog_pair():
    """The tiny JAX and port cogvideox bundles, one perturbed teacher (JAX's
    init) and (cond, uncond) as numpy (text, mask), one row padded."""
    jb = jfamilies.build("cogvideox", tiny=True)
    tb = tfamilies.build("cogvideox", tiny=True, device="cpu")
    rng = np.random.default_rng(53)
    teacher = _perturbed(jb.init_params(jax.random.PRNGKey(0)), rng)
    text = rng.standard_normal((BATCH, TXT, 32)).astype(np.float32)
    mask = np.ones((BATCH, TXT), np.int32)
    mask[1, 5:] = 0
    cond = (text, mask)
    uncond = (np.zeros_like(text), np.ones_like(mask))
    return jb, tb, teacher, cond, uncond


def _conds(jb, tb, cond, uncond):
    jc = tuple(jb.cond_of(*(jnp.asarray(a) for a in c)) for c in (cond, uncond))
    tc = tuple(tb.cond_of(*(_t(a) for a in c)) for c in (cond, uncond))
    return jc, tc


def _terminal_draws(key, config, shape):
    """JAX's draws for `key`, checked to hold a segment 1: the student's
    grad forward then runs at index 999 (α = 0) for that row."""
    draws = _jax_draws(jax.random.PRNGKey(key), config, BATCH, shape)
    assert bool((draws.seg == 1).any()), draws.seg
    return draws


@pytest.mark.parametrize("critic_updates,huber,ema", [(1, False, False), (2, True, True)])
def test_cogvideox_dmd_step_matches_jax(cog_pair, critic_updates, huber, ema):
    """One 'dmd' step of the tiny cogvideox family on video latents
    [2, 16, 3, 8, 8] from one state (the JAX state carried by
    train_state_from_jax), JAX's draws, on the 1000-step grid whose first
    index is the terminal one and with a segment draw of 1: both losses and
    grad norms to 1e-4 relative; each role's update to 5e-3 in relative L2
    and each weight to 10% of lr (the bounds of the PixArt step,
    tests/test_torch_port_train.py: Adam ε 1e-4, a weight moves by lr·δg/ε
    where its gradient is a near-cancelling sum); the EMA to 1e-7."""
    jb, tb, teacher, cond, uncond = cog_pair
    config = dataclasses.replace(TERMINAL, critic_updates=critic_updates, use_huber=huber)
    tconfig = ttdm.TDMConfig(total_steps=1000, critic_updates=critic_updates, use_huber=huber)
    assert int(ttdm.segment_levels(tconfig)[0]) == 999
    jtx = jopt.make_optimizer(LR, eps=ADAM_EPS)
    ttx = topt.make_optimizer(LR, eps=ADAM_EPS)
    rng_p = np.random.default_rng(54)
    student = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng_p.standard_normal(a.shape).astype(np.float32)), teacher)
    jstate = jtdm.init_state(student, teacher, jtx, jtx, use_ema=ema)
    tstate = from_jax.train_state_from_jax(jstate, tb.model, device="cpu")
    tteacher = _carry(teacher, tb.model)
    before = {r: {k: v.clone() for k, v in getattr(tstate, r).items()}
              for r in ("student", "critic")}
    (jcond, juncond), (tcond, tuncond) = _conds(jb, tb, cond, uncond)
    jstep = jtdm.build_train_step(jb.denoise_fn, teacher, jb.schedule, config, jtx, jtx,
                                  sample_shape=jb.sample_shape)
    key = 5
    jnew, jm = jax.block_until_ready(jstep(jstate, jax.random.PRNGKey(key), jcond, juncond,
                                           teacher))
    tstep = ttdm.build_train_step(tb.denoise_fn, tteacher, tb.schedule, tconfig, ttx, ttx,
                                  sample_shape=tb.sample_shape)
    tnew, tm = tstep(tstate, _terminal_draws(key, config, jb.sample_shape), tcond, tuncond)
    for name in jtdm.StepMetrics._fields:
        assert np.isfinite(float(getattr(tm, name))), name
        assert float(getattr(tm, name)) == pytest.approx(
            float(getattr(jm, name)), rel=1e-4, abs=1e-7), name
    assert tnew.critic_opt.count == critic_updates
    for role in ("student", "critic"):
        _update_close(before[role], _carry(getattr(jnew, role), tb.model),
                      getattr(tnew, role), role)
    if ema:
        for k, v in _carry(jnew.ema, tb.model).items():
            np.testing.assert_allclose(tnew.ema[k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                       err_msg=k)


def test_cogvideox_lora_targets_match_jax(cog_pair):
    """The LoRA student's targets over the 3D DiT, the JAX package's own:
    to_q/to_k/to_v/to_out and the feed-forward's proj_in/proj_out of the
    stacked 'blocks' tree (all 30 blocks in one stack at full size, as JAX
    writes it under scan_layers), and the head's proj_out, with the same
    shapes."""
    jb, tb, teacher, _, _ = cog_pair
    assert from_jax.layer_stacks(tb.model.cfg) == (("blocks", 0, 2),)
    assert from_jax.layer_stacks(tcog.CogVideoXConfig()) == (("blocks", 0, 30),)
    jt = jlora.init_lora(teacher, jax.random.PRNGKey(0), rank=4)
    tt = tlora.init_lora(tb.model, 4)
    want = {k: tuple(np.shape(v)) for k, v in from_jax.flatten_tree(jt.params).items()}
    assert {k: tuple(v.shape) for k, v in tlora.factors(tt).items()} == want
    assert {k.rsplit("/", 1)[0] for k in want} == {
        "blocks/to_q", "blocks/to_k", "blocks/to_v", "blocks/to_out", "blocks/ff/proj_in",
        "blocks/ff/proj_out", "proj_out"}


def test_cogvideox_lora_8bit_accumulated_step_matches_jax(cog_pair, monkeypatch):
    """A rank-4 LoRA student over the cogvideox teacher under 8-bit Adam and
    accumulation 2, both sides from one state carried by
    train_state_from_jax(lora=True, eight_bit=True), two micro-steps with
    JAX's draws on the terminal grid. Micro-step 1: metrics to 1e-4, every
    tensor keeps its bits. Micro-step 2, from the port's own state and from
    JAX's state after micro-step 1 carried afresh (its accumulated
    gradient): metrics to 1e-4, the accumulated critic gradient to 1e-4
    of each leaf's largest value (the key norm's bias, whose gradient is 0
    under sin-cos positions, to 1e-8 of the largest leaf's), the factors'
    and the critic's updates to the bounds of the full-weight step, each
    quantized critic moment within one code step of JAX's
    (tests/test_torch_port_sd3_train.py's `_moments_close`); the teacher is
    untouched. MSE, as the 8-bit PixArt and SD3 steps."""
    monkeypatch.setattr(topt, "_SLICE", 40 * 256)
    jb, tb, teacher, cond, uncond = cog_pair
    config = dataclasses.replace(TERMINAL, use_huber=False)
    tconfig = ttdm.TDMConfig(total_steps=1000, use_huber=False)
    jtx = jopt.make_optimizer(LR, eps=ADAM_EPS, eight_bit=True, accumulation_steps=2)
    ttx = topt.make_optimizer(LR, eps=ADAM_EPS, eight_bit=True, accumulation_steps=2)
    template, jfactors = _jax_lora_factors(teacher)
    jstate = jtdm.init_state(jfactors, teacher, jtx, jtx)
    tstate = from_jax.train_state_from_jax(jstate, tb.model, device="cpu", lora=True,
                                            eight_bit=True)
    assert set(tstate.student) == set(from_jax.flatten_tree(template.params))
    tteacher = _carry(teacher, tb.model)
    pristine = {k: v.clone() for k, v in tteacher.items()}
    before = {r: {k: v.clone() for k, v in getattr(tstate, r).items()}
              for r in ("student", "critic")}
    stacks = from_jax.layer_stacks(tb.model.cfg)
    student_fn = tlora.wrap_denoise_fn(tb.denoise_fn, tlora.LoRA({}, template.alpha),
                                       stacks=stacks)
    jstep = jtdm.build_train_step(
        jb.denoise_fn, teacher, jb.schedule, config, jtx, jtx, sample_shape=jb.sample_shape,
        student_denoise_fn=jlora.wrap_denoise_fn(jb.denoise_fn, template))
    tstep = ttdm.build_train_step(tb.denoise_fn, tteacher, tb.schedule, tconfig, ttx, ttx,
                                  sample_shape=tb.sample_shape, student_denoise_fn=student_fn)
    (jcond, juncond), (tcond, tuncond) = _conds(jb, tb, cond, uncond)
    shapes = {k: v.shape for k, v in from_jax.flatten_tree(teacher).items()}

    def metrics_close(jm, tm, micro):
        for name in jtdm.StepMetrics._fields:
            assert float(getattr(tm, name)) == pytest.approx(
                float(getattr(jm, name)), rel=1e-4, abs=1e-7), (micro, name)

    key = 5
    jstate, jm = jax.block_until_ready(jstep(jstate, jax.random.PRNGKey(key), jcond, juncond,
                                             teacher))
    tstate, tm = tstep(tstate, _terminal_draws(key, config, jb.sample_shape), tcond, tuncond)
    metrics_close(jm, tm, 1)
    for role in ("student", "critic"):
        opt = getattr(tstate, f"{role}_opt")
        assert (opt.mini_step, opt.gradient_step) == (1, 0)
        assert all(torch.equal(v, before[role][k]) for k, v in getattr(tstate, role).items())
    carried = from_jax.train_state_from_jax(jstate, tb.model, device="cpu", lora=True,
                                             eight_bit=True)
    assert carried.critic_opt.mini_step == 1
    acc_top = max(float(v.abs().max()) for v in tstate.critic_opt.acc.values())
    for k, v in tstate.critic_opt.acc.items():  # the window's running mean
        if k.endswith("norm_k.bias"):  # a gradient of 0 (sin-cos): roundoff on both sides
            assert float((carried.critic_opt.acc[k] - v).abs().max()) <= 1e-8 * acc_top, k
            continue
        torch.testing.assert_close(carried.critic_opt.acc[k], v, rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()))

    key = 11
    jstate, jm = jax.block_until_ready(jstep(jstate, jax.random.PRNGKey(key), jcond, juncond,
                                             teacher))
    draws = _terminal_draws(key, config, jb.sample_shape)
    for name, state in (("own", tstate), ("carried", carried)):
        new, tm = tstep(state, draws, tcond, tuncond)
        metrics_close(jm, tm, f"2 {name}")
        ref = {k: _t(v) for k, v in from_jax.flatten_tree(jstate.student).items()}
        _update_close(before["student"], ref, new.student, f"student {name}")
        _update_close(before["critic"], _carry(jstate.critic, tb.model), new.critic,
                      f"critic {name}")
        assert new.critic_opt.inner.count == 1 and new.critic_opt.gradient_step == 1
        _moments_close(new.critic_opt, jstate.critic_opt, new.critic, tb.model, shapes, name)
    assert all(torch.equal(tteacher[k], pristine[k]) for k in pristine)


# --- the CLI -----------------------------------------------------------------------------------


def _cli(tmp_path, *extra):
    from tdm_tpu_torch.cli import train_tdm

    train_tdm.main(["--device", "cpu", "--model_family", "cogvideox",
                    "--output_dir", str(tmp_path / "run"), "--seed", "0",
                    "--train_batch_size", "2", "--lr_warmup_steps", "0", *extra])
    return tmp_path / "run_cfg4.5_steps900"


def test_cli_trains_cogvideox_without_video_grids_and_resumes(tmp_path, monkeypatch):
    """TDM_TINY_MODEL=1 --model_family cogvideox --max_train_steps 2 with
    $TDM_TAESD_DIR set and --validation_steps 1: the TAESD directory is
    never read and no grid is written (TAESD decodes no video latent, as
    the JAX CLI's gate at len(sample_shape) == 3), and the run writes its
    metrics, a checkpoint, student.safetensors in the JAX package's layout
    (the stacked 'blocks' tree) and the rank-32 kohya export; --num_frames
    5 reaches the bundle as 2 latent frames; a resume from 'latest' with
    nothing left to run exports the same files."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.train import tdm as tdm_mod

    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.delenv("TDM_EMBEDDING_CACHE", raising=False)
    monkeypatch.setenv("TDM_TAESD_DIR", _taesd3_dir(tmp_path))

    def no_taesd(*a, **kw):
        raise AssertionError("a video run read the TAESD decoder")

    monkeypatch.setattr(train_tdm, "_load_taesd", no_taesd)
    shapes = []
    build = tdm_mod.build_train_step

    def spy(*a, **kw):
        shapes.append(kw["sample_shape"])
        return build(*a, **kw)

    monkeypatch.setattr(tdm_mod, "build_train_step", spy)
    out = _cli(tmp_path, "--max_train_steps", "2", "--validation_steps", "1",
               "--num_frames", "5", "--gradient_checkpointing")
    assert shapes == [(16, 2, 8, 8)]
    assert not list(out.glob("validation_*"))
    logs = [json.loads(line) for line in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert logs and all(np.isfinite(v) for rec in logs for v in rec.values()
                        if isinstance(v, float))
    student = tparams.load_file(str(out / "student.safetensors"))
    assert student["blocks/to_q/kernel"].shape == (2, 32, 32)
    assert student["blocks/ff/proj_in/kernel"].shape == (2, 32, 128)
    assert student["patch_proj/kernel"].shape == (2, 2, 16, 32)
    lora = tparams.load_file(str(out / "tdm_lora.safetensors"))
    assert "lora_transformer_blocks_1_to_q.lora_down.weight" in lora
    assert "lora_transformer_proj_out.lora_up.weight" in lora
    files = {f: (out / f).read_bytes() for f in ("student.safetensors", "tdm_lora.safetensors")}
    _cli(tmp_path, "--max_train_steps", "2", "--num_frames", "5",
         "--resume_from_checkpoint", "latest")
    assert all((out / f).read_bytes() == b for f, b in files.items())
    assert not list(out.glob("validation_*"))


def _tiny_transformer_dir(tmp_path):
    """A tiny diffusers CogVideoX transformer directory: its config and one
    fp16 safetensors file of seeded weights in the released key layout
    (io/manifest.write_synthetic)."""
    cfg = tcog.CogVideoXConfig.tiny()
    d = tmp_path / "transformer"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "_class_name": "CogVideoXTransformer3DModel", "num_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "attention_head_dim": cfg.head_dim}))
    tmanifest.write_synthetic("cogvideox", str(d / "diffusion_pytorch_model.safetensors"),
                              cfg, seed=7, scale=0.1)
    return str(d)


def test_cli_cogvideox_lora_from_a_teacher_dir_loads_into_the_pipeline(tmp_path, monkeypatch):
    """--model_family cogvideox with the recipe's LoRA student (rank 4,
    8-bit Adam, accumulation 2, --gradient_checkpointing), the teacher read
    from a tiny diffusers transformer directory: two optimizer steps with a
    checkpoint at each and int8 critic moments, a resume from 'latest' that
    continues to step 3; the kohya file loads into the port's CogVideoX
    pipeline holding that teacher (every key resolved to a kernel of the
    3D DiT), and merged at 1.0 it gives the exported student to fp16
    rounding; a 4-NFE latent sampled with it is finite and differs from
    the teacher's."""
    from tdm_tpu_torch.io import convert

    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.delenv("TDM_EMBEDDING_CACHE", raising=False)
    monkeypatch.delenv("TDM_TAESD_DIR", raising=False)
    teacher_dir = _tiny_transformer_dir(tmp_path)
    flags = ["--pretrained_model_name_or_path", teacher_dir, "--train_lora_rank", "4",
             "--use_8bit_adam", "--gradient_accumulation_steps", "2", "--checkpointing_steps",
             "1", "--gradient_checkpointing"]
    out = _cli(tmp_path, "--max_train_steps", "2", *flags)
    assert sorted(p.name for p in out.iterdir() if p.name.startswith("checkpoint")) == [
        "checkpoint-1", "checkpoint-2"]
    critic_opt = tparams.load_file(str(out / "checkpoint-2" / "critic_opt.safetensors"))
    assert critic_opt["inner/mu/codes"].dtype == np.int8
    _cli(tmp_path, "--max_train_steps", "3", *flags, "--resume_from_checkpoint", "latest")
    meta = json.loads((out / "checkpoint-3" / "state.json").read_text())
    assert meta["step"] == 3 and meta["critic_inner_count"] == 3

    cfg = tcog.CogVideoXConfig.tiny()
    model = tcog.CogVideoXTransformer3D(cfg, device="cpu")
    model.load_state_dict(from_jax.state_dict_from_jax(convert.flatten(
        convert.cogvideox_params(convert.load_torch_state_dict(teacher_dir))), model))
    teacher = from_jax.jax_layout(model.state_dict(), stacks=from_jax.layer_stacks(cfg))
    pipe = CogVideoXPipeline(model, device="cpu")
    rng = np.random.default_rng(55)
    call = dict(prompt_embeds=rng.standard_normal((1, TXT, 32)).astype(np.float32),
                latents=rng.standard_normal((1, 16, 3, 8, 8)).astype(np.float32),
                num_frames=9, height=64, width=64, output_type="latent")
    base = pipe(**call).latents
    pipe.load_lora_weights(str(out / "tdm_lora.safetensors"), adapter_name="tdm")
    pipe.set_adapters(["tdm"], [1.0])
    merged = from_jax.jax_layout(pipe.transformer.state_dict(),
                                 stacks=from_jax.layer_stacks(cfg))
    student = tparams.load_file(str(out / "student.safetensors"))
    assert set(student) == set(merged)
    moved = 0
    for k, v in student.items():
        ref = merged[k].astype(np.float16).astype(np.float32)
        np.testing.assert_allclose(v.astype(np.float32), ref, rtol=1e-3, atol=1e-3, err_msg=k)
        moved += int(not np.array_equal(merged[k], teacher[k]))
    assert moved > 0
    tuned = pipe(**call).latents
    assert torch.isfinite(tuned).all() and not torch.equal(tuned, base)
