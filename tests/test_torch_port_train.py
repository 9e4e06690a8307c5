"""The port's training path against the JAX package on the CPU: the schedule
additions and the trajectory gather, the LR schedules and clip → AdamW →
EMA, one whole TDM step of the tiny PixArt in both loss modes, and the
training CLI (checkpoint, resume, rotation, metrics, the exported student,
the refused flags).

Inputs come from numpy seeds (and, for the train step, from JAX's own key
splits) and pass between the packages as numpy arrays. Everything is fp32,
where the two differ in the order of sums and in exp/log/sqrt: each
tolerance below says how much that grows through its computation.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tdm_tpu.core import sampling as jsampling, schedules as jsched
from tdm_tpu.train import families as jfamilies, optim as jopt, tdm as jtdm
from tdm_tpu_torch.core import sampling as tsampling, schedules as tsched
from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy (JAX's buffers are read-only)


# --- (c) schedules and the trajectory gather --------------------------------


@pytest.mark.parametrize("pt", [jsched.EPSILON, jsched.V_PREDICTION, jsched.FLOW])
def test_schedule_training_math_matches(pt):
    js = jsched.ddpm_linear(prediction_type=pt)
    ts = tsched.ddpm_linear(prediction_type=pt, device="cpu")
    rng = np.random.default_rng(11)
    x0, eps, fresh = (rng.standard_normal((4, 4, 8, 8)).astype(np.float32) for _ in range(3))
    t1 = np.array([224, 449, 0, 899])
    t2 = np.array([500, 449, 7, 100])  # the last pair has t2 < t1
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tsched.native_target(ts, _t(x0), _t(eps), _t(t1)).numpy(),
        np.asarray(jsched.native_target(js, x0, eps, jnp.asarray(t1))), **tol)
    got = tsched.transport(ts, _t(x0), _t(fresh), _t(t1), _t(t2)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jsched.transport(js, x0, fresh, jnp.asarray(t1), jnp.asarray(t2))), **tol)
    assert np.isfinite(got).all()  # t2 < t1 stays finite (the reference NaNs)
    got = tsched.mixed_noise(ts, _t(eps), _t(fresh), _t(t1), _t(t2)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jsched.mixed_noise(js, eps, fresh, jnp.asarray(t1), jnp.asarray(t2))),
        **tol)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(tsched.snr(ts, _t(t1)).numpy(),
                               np.asarray(jsched.snr(js, jnp.asarray(t1))), rtol=1e-5)


def test_gather_trajectory_states_matches():
    rng = np.random.default_rng(12)
    states = rng.standard_normal((5, 4, 4, 8, 8)).astype(np.float32)
    seg = np.array([0, 4, 2, 3])
    grid = jsched.fewstep_grid(900, 4)
    jt = jsampling.Trajectory(final=states[-1], states=jnp.asarray(states),
                              x0s=states[:4], noise_preds=states[:4])
    tt = tsampling.Trajectory(final=_t(states[-1]), states=_t(states),
                              x0s=_t(states[:4]), noise_preds=_t(states[:4]))
    js, jl = jsampling.gather_trajectory_states(jt, grid, jnp.asarray(seg))
    ts, tl = tsampling.gather_trajectory_states(tt, tsched.fewstep_grid(900, 4), _t(seg))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# --- (d) LR schedules, clip → AdamW → EMA ------------------------------------


@pytest.mark.parametrize("name", topt.LR_SCHEDULES)
def test_lr_schedules_match(name):
    kw = dict(warmup_steps=5, total_steps=40, num_cycles=2.0, power=2.0)
    j = jopt.make_lr_schedule(name, 3e-4, **kw)
    t = topt.make_lr_schedule(name, 3e-4, **kw)
    for step in (0, 1, 4, 5, 6, 17, 39, 40, 41, 100):
        assert t(step) == pytest.approx(float(j(step)), rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("low_precision", [False, True])
def test_clip_adamw_ema_match_optax_over_three_steps(low_precision):
    """Three updates of two leaves, the second step's gradient large enough
    to be clipped; params, both moments, the count and the EMA after each
    step agree to 1e-6 relative (fp32 roundoff of the same formulas; with
    bf16 first moments too, since both round β₁ to bf16 before β₁·μ)."""
    rng = np.random.default_rng(13)
    params = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (s * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (0.1, 30.0, 0.5)]
    lr = jopt.make_lr_schedule("cosine_with_restarts", 1e-2, warmup_steps=1, total_steps=10)
    jtx = jopt.make_optimizer(lr, low_precision_moments=low_precision)
    ttx = topt.make_optimizer(topt.make_lr_schedule(
        "cosine_with_restarts", 1e-2, warmup_steps=1, total_steps=10),
        low_precision_moments=low_precision)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate, jema = jtx.init(jp), jp
    tp = {k: _t(v).clone() for k, v in params.items()}
    tstate, tema = ttx.init(tp), {k: v.clone() for k, v in tp.items()}
    for g in grads:
        ju, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        jema = jopt.ema_update(jema, jp, 0.9)
        tu, tstate = ttx.update({k: _t(v) for k, v in g.items()}, tstate, tp)
        topt.apply_updates(tp, tu)
        topt.ema_update(tema, tp, 0.9)
        adam = from_jax._adam_state(jstate)
        assert tstate.count == int(adam.count)
        p_tol = dict(rtol=1e-6, atol=1e-7)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **p_tol)
            np.testing.assert_allclose(tema[k].numpy(), np.asarray(jema[k]), **p_tol)
            assert tstate.mu[k].dtype == (torch.bfloat16 if low_precision else torch.float32)
            np.testing.assert_allclose(tstate.mu[k].float().numpy(),
                                       np.asarray(adam.mu[k], np.float32), rtol=1e-6)
            np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6)
    assert float(topt.global_norm({k: _t(v) for k, v in grads[1].items()})) == pytest.approx(
        float(jopt.global_norm({k: jnp.asarray(v) for k, v in grads[1].items()})), rel=1e-6)


# --- (e) one TDM step of the tiny PixArt -------------------------------------

BATCH = 2
LR = 1e-4
ADAM_EPS = 1e-4


def _jax_draws(rng, config, batch, shape):
    """The draws the JAX step makes inside itself, by its own key splits."""
    r_noise, r_seg, r_fresh = jax.random.split(rng, 3)
    z = jax.random.normal(r_noise, (batch, *shape), jnp.float32)
    r_seg2, r_t = jax.random.split(r_seg)
    seg = jax.random.randint(r_seg2, (batch,), config.min_seg, config.num_steps + 1)
    u = jax.random.uniform(r_t, (batch,))
    fresh = jax.random.normal(r_fresh, z.shape, jnp.float32)
    cu, ce = [], []
    for i in range(config.critic_updates - 1):
        r_t_i, r_e_i = jax.random.split(jax.random.fold_in(r_fresh, i + 1))
        cu.append(jax.random.uniform(r_t_i, (batch,)))
        ce.append(jax.random.normal(r_e_i, z.shape, jnp.float32))
    n = config.critic_updates - 1
    return ttdm.StepDraws(
        z=_t(z), seg=_t(seg).long(), u=_t(u), fresh=_t(fresh),
        critic_u=_t(np.stack(cu)) if n else torch.zeros(0, batch),
        critic_eps=_t(np.stack(ce)) if n else torch.zeros(0, batch, *shape),
    )


@pytest.fixture(scope="module")
def tiny_pair():
    jb = jfamilies.build("pixart", tiny=True)
    tb = tfamilies.build("pixart", tiny=True, device="cpu")
    teacher = jb.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(14)
    text = rng.standard_normal((BATCH, 8, jb.embed_dim)).astype(np.float32)
    mask = np.ones((BATCH, 8), np.int32)
    mask[1, 5:] = 0
    utext = np.zeros_like(text)
    umask = np.ones_like(mask)
    return jb, tb, teacher, (text, mask), (utext, umask)


@pytest.mark.parametrize("mode,critic_updates,huber,ema", [
    ("dmd", 1, False, False), ("instruct", 1, True, False), ("dmd", 2, True, True),
])
def test_train_step_matches_jax(tiny_pair, mode, critic_updates, huber, ema):
    """One step from one state (carried by io/from_jax): both losses, both
    grad norms, and the updated student and critic. Constant lr 1e-4 so
    the update is visible. Losses and norms to 1e-4 relative (fp32 through
    two layers, the trajectory's 1/α ≈ 60× amplification at t=899 and the
    CFG mix). The update of each role (new − old params): to 5e-3 in
    relative L2 over all its weights (measured up to 1.8e-3), and each
    weight to 10% of lr (measured up to 7.5%). A weight moves by
    lr·g/(|g|+ε), so a gradient error δg moves it by up to lr·δg/ε; the
    largest elementwise errors sit where a gradient is a near-cancelling sum
    (the key projections, whose gradient is orthogonal to the direction
    softmax ignores) and, with two critic updates, where the student's
    target x0_fake carries the critic's difference through 1/α ≈ 60. A
    wrong term or sign in the step moves the update by O(1)."""
    jb, tb, teacher, cond, uncond = tiny_pair
    config = jtdm.TDMConfig(loss_mode=mode, critic_updates=critic_updates, use_huber=huber)
    tconfig = ttdm.TDMConfig(loss_mode=mode, critic_updates=critic_updates, use_huber=huber)
    # Adam's ε at 1e-4 (both sides): with the default 1e-8 the first step
    # moves every weight by lr·g/(|g|+ε) ≈ lr·sign(g), so where a gradient
    # is at roundoff level (the key bias's is exactly 0 in exact arithmetic:
    # softmax ignores a constant added to a row's logits) the two sides'
    # roundoff picks the sign; a larger ε keeps the update a smooth function
    # of the gradient, so the comparison sees the gradients themselves
    jtx = jopt.make_optimizer(LR, eps=ADAM_EPS)
    ttx = topt.make_optimizer(LR, eps=ADAM_EPS)
    # a student 5% away from the teacher: at the recipe's start (student =
    # teacher) 'instruct' regresses the student onto itself, and its loss is
    # a ratio of roundoff terms
    rng_p = np.random.default_rng(16)
    student = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng_p.standard_normal(a.shape).astype(np.float32)), teacher)
    jstate = jtdm.init_state(student, teacher, jtx, jtx, use_ema=ema)
    tstate = from_jax.train_state_from_jax(jstate, tb.model, device="cpu")
    tteacher = from_jax.state_dict_from_jax(from_jax.flatten_tree(teacher), tb.model)
    before = {role: {k: v.clone() for k, v in getattr(tstate, role).items()}
              for role in ("student", "critic")}

    jstep = jtdm.build_train_step(jb.denoise_fn, teacher, jb.schedule, config, jtx, jtx,
                                  sample_shape=jb.sample_shape)
    rng = jax.random.PRNGKey(5)
    jcond = tuple(jnp.asarray(x) for x in cond)
    juncond = tuple(jnp.asarray(x) for x in uncond)
    jnew, jm = jax.block_until_ready(jstep(jstate, rng, jcond, juncond, teacher))

    tstep = ttdm.build_train_step(tb.denoise_fn, tteacher, tb.schedule, tconfig, ttx, ttx,
                                  sample_shape=tb.sample_shape)
    draws = _jax_draws(rng, config, BATCH, jb.sample_shape)
    tnew, tm = tstep(tstate, draws, tuple(_t(x) for x in cond), tuple(_t(x) for x in uncond))

    for name in jtdm.StepMetrics._fields:
        j, t = float(getattr(jm, name)), float(getattr(tm, name))
        assert t == pytest.approx(j, rel=1e-4, abs=1e-7), name
    assert tnew.step == 1 and tnew.student_opt.count == 1
    assert tnew.critic_opt.count == critic_updates
    if ema:  # e ← d·e + (1−d)·p with d = 0.9999, so it follows the update
        ref = from_jax.state_dict_from_jax(from_jax.flatten_tree(jnew.ema), tb.model)
        for k, v in ref.items():
            np.testing.assert_allclose(tnew.ema[k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                       err_msg=f"ema {k}")
    for role in ("student", "critic"):
        ref = from_jax.state_dict_from_jax(
            from_jax.flatten_tree(getattr(jnew, role)), tb.model)
        got = getattr(tnew, role)
        d_ref = torch.cat([(v - before[role][k]).flatten() for k, v in ref.items()])
        d_got = torch.cat([(got[k] - before[role][k]).flatten() for k in ref])
        assert float(d_ref.abs().max()) > 0.5 * LR, role  # the update moved the weights
        assert float((d_got - d_ref).norm()) <= 5e-3 * float(d_ref.norm()), role
        assert float((d_got - d_ref).abs().max()) <= 0.1 * LR, role


def _update_close(before, ref, got, role):
    """The update of one role (new − old params) against JAX's: the bounds
    of test_train_step_matches_jax."""
    d_ref = torch.cat([(v - before[k]).flatten() for k, v in ref.items()])
    d_got = torch.cat([(got[k] - before[k]).flatten() for k in ref])
    assert float(d_ref.abs().max()) > 0.5 * LR, role  # the update moved the weights
    assert float((d_got - d_ref).norm()) <= 5e-3 * float(d_ref.norm()), role
    assert float((d_got - d_ref).abs().max()) <= 0.1 * LR, role


def _factors(template):
    """A JAX LoRA template's factors, flat, with b drawn nonzero from a
    numpy seed (peft's b = 0 would leave a without a gradient)."""
    rng = np.random.default_rng(25)
    flat = {k: np.array(v) for k, v in from_jax.flatten_tree(template.params).items()}
    for k in flat:
        if k.endswith("/b"):
            flat[k] = (0.1 * rng.standard_normal(flat[k].shape)).astype(np.float32)
    return flat


def _q8_decoded(q, shape):
    """A Q8Moment's fp32 tensor of `shape` and each element's bound on its
    quantization error, one int8 code step at its magnitude (the JAX
    package's test_q8_roundtrip): (2√(|x|/s) + 1/254)·s/254, s the block's
    absmax."""
    n = int(np.prod(shape))
    x = topt.q8_dequantize(q, shape)
    s = q.scales.repeat_interleave(256)[:n].reshape(shape)
    err = (2 * torch.sqrt(x.abs() / s.clamp(min=1e-30)) + 1 / 254) * s / 254
    return x, err


def _q8_leaves(tree, prefix=""):
    """'/'-joined path → the JAX package's quantized moments (values,
    scales) in a nested dict of its adam8bit state."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_q8_leaves(v, key))
        elif hasattr(v, "values") and hasattr(v, "scales"):
            out[key] = (v.values, v.scales)
    return out


@pytest.mark.parametrize("mode,huber,ema", [("dmd", False, False), ("instruct", True, True)])
def test_lora_train_step_matches_jax(tiny_pair, mode, huber, ema):
    """One step with a rank-4 LoRA student over the frozen teacher (the JAX
    step's `student_denoise_fn` = `lora.wrap_denoise_fn`), from the same
    factors carried across: both losses and grad norms to 1e-4 relative, the
    factors' update and the critic's to the bounds of the full-student step,
    the EMA of the factors to 1e-7; the teacher is untouched."""
    from tdm_tpu.lora import adapter as jlora
    from tdm_tpu_torch import lora as tlora

    jb, tb, teacher, cond, uncond = tiny_pair
    config = jtdm.TDMConfig(loss_mode=mode, use_huber=huber)
    tconfig = ttdm.TDMConfig(loss_mode=mode, use_huber=huber)
    template = jlora.init_lora(teacher, jax.random.PRNGKey(99), rank=4)
    flat = _factors(template)
    jtx = jopt.make_optimizer(LR, eps=ADAM_EPS)
    ttx = topt.make_optimizer(LR, eps=ADAM_EPS)
    jfactors = jax.tree.map(jnp.asarray, template.params)
    for k, v in flat.items():
        node = jfactors
        *parents, leaf = k.split("/")
        for p in parents:
            node = node[p]
        node[leaf] = jnp.asarray(v)
    jstate = jtdm.init_state(jfactors, teacher, jtx, jtx, use_ema=ema)
    jstep = jtdm.build_train_step(
        jb.denoise_fn, teacher, jb.schedule, config, jtx, jtx, sample_shape=jb.sample_shape,
        student_denoise_fn=jlora.wrap_denoise_fn(jb.denoise_fn, template))
    rng = jax.random.PRNGKey(5)
    jcond = tuple(jnp.asarray(x) for x in cond)
    juncond = tuple(jnp.asarray(x) for x in uncond)
    jnew, jm = jax.block_until_ready(jstep(jstate, rng, jcond, juncond, teacher))

    tteacher = from_jax.state_dict_from_jax(from_jax.flatten_tree(teacher), tb.model)
    pristine = {k: v.clone() for k, v in tteacher.items()}
    tstate = ttdm.init_state({k: _t(v) for k, v in flat.items()}, tteacher, ttx, ttx,
                             use_ema=ema)
    before = {"student": {k: v.clone() for k, v in tstate.student.items()},
              "critic": {k: v.clone() for k, v in tstate.critic.items()}}
    student_fn = tlora.wrap_denoise_fn(tb.denoise_fn, tlora.LoRA({}, template.alpha),
                                       stacks=from_jax.layer_stacks(tb.model.cfg))
    tstep = ttdm.build_train_step(tb.denoise_fn, tteacher, tb.schedule, tconfig, ttx, ttx,
                                  sample_shape=tb.sample_shape, student_denoise_fn=student_fn)
    draws = _jax_draws(rng, config, BATCH, jb.sample_shape)
    tnew, tm = tstep(tstate, draws, tuple(_t(x) for x in cond), tuple(_t(x) for x in uncond))

    for name in jtdm.StepMetrics._fields:
        j, t = float(getattr(jm, name)), float(getattr(tm, name))
        assert t == pytest.approx(j, rel=1e-4, abs=1e-7), name
    ref = {k: _t(v) for k, v in from_jax.flatten_tree(jnew.student).items()}
    assert set(ref) == set(tnew.student)
    _update_close(before["student"], ref, tnew.student, "student")
    _update_close(before["critic"], from_jax.state_dict_from_jax(
        from_jax.flatten_tree(jnew.critic), tb.model), tnew.critic, "critic")
    if ema:
        for k, v in from_jax.flatten_tree(jnew.ema).items():
            np.testing.assert_allclose(tnew.ema[k].numpy(), v, rtol=0, atol=1e-7, err_msg=k)
    assert all(torch.equal(tteacher[k], pristine[k]) for k in pristine)


def test_eight_bit_accumulated_train_step_matches_jax(tiny_pair, monkeypatch):
    """Two micro-steps under 8-bit Adam and accumulation 2 (the JAX step
    with `make_optimizer(eight_bit=True, accumulation_steps=2)`), each with
    JAX's draws, the packed update cut into slices of 40 blocks (several,
    some holding two leaves, on the tiny model): after the first both roles
    keep their bits and the counters say one micro-step; after the second
    the updates of the window's mean gradient meet the bounds of the
    full-student step (the first 8-bit update reads zero moments, so no int8
    code enters it), and each stored moment decodes to JAX's within one int8 code step of each
    side (`_q8_decoded`): the port's blocks run over its [out, in] weights
    and the JAX package's over its [in, out] kernels (stacked flat), so the
    codes themselves group other elements.
    MSE, as the first case of test_train_step_matches_jax: with 'dmd' and
    one critic update the Huber loss (c = 1e-3) moves the student's grad
    norm by up to 3.7e-4 relative under a 1e-7 relative change of the
    weights, which no 1e-4 comparison of two fp32 programs can hold."""
    monkeypatch.setattr(topt, "_SLICE", 40 * 256)
    jb, tb, teacher, cond, uncond = tiny_pair
    config, tconfig = jtdm.TDMConfig(use_huber=False), ttdm.TDMConfig(use_huber=False)
    jtx = jopt.make_optimizer(LR, eps=ADAM_EPS, eight_bit=True, accumulation_steps=2)
    ttx = topt.make_optimizer(LR, eps=ADAM_EPS, eight_bit=True, accumulation_steps=2)
    rng_p = np.random.default_rng(16)
    student = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng_p.standard_normal(a.shape).astype(np.float32)), teacher)
    jstate = jtdm.init_state(student, teacher, jtx, jtx)
    tteacher = from_jax.state_dict_from_jax(from_jax.flatten_tree(teacher), tb.model)
    tstate = ttdm.init_state(
        from_jax.state_dict_from_jax(from_jax.flatten_tree(student), tb.model), tteacher,
        ttx, ttx)
    before = {role: {k: v.clone() for k, v in getattr(tstate, role).items()}
              for role in ("student", "critic")}
    jstep = jtdm.build_train_step(jb.denoise_fn, teacher, jb.schedule, config, jtx, jtx,
                                  sample_shape=jb.sample_shape)
    tstep = ttdm.build_train_step(tb.denoise_fn, tteacher, tb.schedule, tconfig, ttx, ttx,
                                  sample_shape=tb.sample_shape)
    jcond = tuple(jnp.asarray(x) for x in cond)
    juncond = tuple(jnp.asarray(x) for x in uncond)
    tcond, tuncond = tuple(_t(x) for x in cond), tuple(_t(x) for x in uncond)
    jax_shapes = {k: v.shape for k, v in from_jax.flatten_tree(teacher).items()}
    for micro in (1, 2):
        rng = jax.random.PRNGKey(4 + micro)
        jstate, jm = jax.block_until_ready(jstep(jstate, rng, jcond, juncond, teacher))
        draws = _jax_draws(rng, config, BATCH, jb.sample_shape)
        tstate, tm = tstep(tstate, draws, tcond, tuncond)
        for name in jtdm.StepMetrics._fields:
            j, t = float(getattr(jm, name)), float(getattr(tm, name))
            assert t == pytest.approx(j, rel=1e-4, abs=1e-7), (micro, name)
        for role in ("student", "critic"):
            opt = getattr(tstate, f"{role}_opt")
            assert (opt.mini_step, opt.gradient_step) == ((1, 0) if micro == 1 else (0, 1))
            if micro == 1:
                assert all(torch.equal(v, before[role][k])
                           for k, v in getattr(tstate, role).items()), role
                continue
            ref = from_jax.state_dict_from_jax(
                from_jax.flatten_tree(getattr(jstate, role)), tb.model)
            _update_close(before[role], ref, getattr(tstate, role), role)
            jinner = from_jax._adam_state(getattr(jstate, f"{role}_opt"))
            assert opt.inner.count == int(jinner.count) == 1
            jq = {m: _q8_leaves(getattr(jinner, m)) for m in ("mu", "nu")}
            stacks = from_jax.layer_stacks(tb.model.cfg)
            params = getattr(tstate, role)
            for m in ("mu", "nu"):
                views = topt.leaf_moments(getattr(opt.inner, m), params)
                quantized = [k for k, v in views.items() if isinstance(v, topt.Q8Moment)]
                assert {from_jax.jax_name(k, stacks)[0] for k in quantized} == set(jq[m]), role
                for k in quantized:
                    path, layer = from_jax.jax_name(k, stacks)
                    values, scales = jq[m][path]
                    shape = tuple(jax_shapes[path])
                    want, want_err = _q8_decoded(topt.Q8Moment(_t(values), _t(scales)), shape)
                    got, got_err = _q8_decoded(views[k], params[k].shape)
                    if layer is not None:
                        want, want_err = want[layer], want_err[layer]
                    if got.dim() == 2:  # the port's [out, in] against the kernel's [in, out]
                        got, got_err = got.T, got_err.T
                    assert float(got.abs().max()) > 0, (role, m, k)
                    bound = 1.01 * (got_err + want_err) + 1e-6 * float(want.abs().max())
                    assert bool(((got - want).abs() <= bound).all()), (role, m, k)


def test_train_step_refuses_unported():
    """Nothing of the step is refused any more: quant_forwards builds (its
    step is held against JAX in tests/test_torch_port_quant.py), and an
    unknown loss mode still raises."""
    tb = tfamilies.build("pixart", tiny=True, device="cpu")
    tx = topt.make_optimizer(1e-4)
    assert callable(ttdm.build_train_step(
        tb.denoise_fn, {}, tb.schedule, ttdm.TDMConfig(quant_forwards=True),
        tx, tx, sample_shape=tb.sample_shape))
    with pytest.raises(ValueError, match="loss_mode"):
        ttdm.build_train_step(tb.denoise_fn, {}, tb.schedule, ttdm.TDMConfig(loss_mode="x"),
                              tx, tx, sample_shape=tb.sample_shape)
    assert tfamilies.build("cogvideox", tiny=True, device="cpu").name == "cogvideox"  # ported
    assert tfamilies.build("sd15", tiny=True, device="cpu").name == "sd15"  # ported


def test_segment_draws_match_jax_sampler():
    """sample_segment_and_t from JAX's draws gives JAX's (seg, lo, t_fake),
    in both interval modes."""
    for sep in (True, False):
        jc = jtdm.TDMConfig(use_separate=sep)
        tc = ttdm.TDMConfig(use_separate=sep)
        rng = jax.random.PRNGKey(9)
        jseg, jlo, jt = jtdm.sample_segment_and_t(rng, jc, 64)
        r_seg, r_t = jax.random.split(rng)
        u = jax.random.uniform(r_t, (64,))
        seg, lo, t = ttdm.sample_segment_and_t(tc, _t(jseg).long(), _t(u))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


# --- (f) the training CLI ----------------------------------------------------


def _cli(tmp_path, *extra):
    from tdm_tpu_torch.cli import train_tdm

    train_tdm.main(["--device", "cpu", "--output_dir", str(tmp_path / "run"),
                    "--seed", "0", "--export_lora_rank", "0", "--train_batch_size", "2",
                    *extra])
    return tmp_path / "run_cfg4.5_steps900"


def test_cli_trains_checkpoints_resumes_and_exports(tmp_path, monkeypatch):
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.delenv("TDM_EMBEDDING_CACHE", raising=False)
    monkeypatch.delenv("TDM_TAESD_DIR", raising=False)
    out = _cli(tmp_path, "--max_train_steps", "2", "--checkpointing_steps", "1",
               "--checkpoints_total_limit", "1", "--lr_warmup_steps", "0")
    # rotation keeps the newest checkpoint only
    assert sorted(p.name for p in out.iterdir() if p.name.startswith("checkpoint")) == [
        "checkpoint-2"]
    meta = json.loads((out / "checkpoint-2" / "state.json").read_text())
    assert meta == {"step": 2, "student_count": 2, "critic_count": 2, "ema": False}
    lines = [json.loads(s) for s in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1]
    assert {"loss_student", "loss_critic", "grad_norm_student", "grad_norm_critic",
            "t_fake_mean"} <= set(lines[0])
    assert all(np.isfinite(v) for v in lines[0].values())

    # the exported student loads through the JAX package's reader into the
    # tiny PixArt's own parameter tree
    from tdm_tpu.io import params as jparams

    tree = jparams.load_params(str(out / "student.safetensors"), to_jnp=False)
    init = jfamilies.build("pixart", tiny=True).init_params(jax.random.PRNGKey(0))
    jflat, tflat = from_jax.flatten_tree(init), from_jax.flatten_tree(tree)
    assert set(tflat) == set(jflat)
    assert all(tflat[k].shape == jflat[k].shape and tflat[k].dtype == np.float16
               for k in jflat)
    exported = tflat

    # resume from the latest checkpoint: step 3 starts from checkpoint-2's
    # state, and its student is what checkpoint-2 holds before the update
    from tdm_tpu_torch.io import params as tparams

    saved = tparams.load_file(str(out / "checkpoint-2" / "student.safetensors"))
    jl = from_jax.jax_layout({k: torch.from_numpy(v) for k, v in saved.items()})
    assert all(np.array_equal(jl[k].astype(np.float16), exported[k]) for k in jl)
    _cli(tmp_path, "--max_train_steps", "3", "--checkpointing_steps", "1",
         "--checkpoints_total_limit", "1", "--lr_warmup_steps", "0",
         "--resume_from_checkpoint", "latest")
    assert sorted(p.name for p in out.iterdir() if p.name.startswith("checkpoint")) == [
        "checkpoint-3"]
    meta = json.loads((out / "checkpoint-3" / "state.json").read_text())
    assert meta["student_count"] == 3 and meta["critic_count"] == 3
    lines = (out / "logs" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in lines] == [1]  # steps 1, 10, 20, ... only


def test_cli_reads_an_embedding_cache(tmp_path, monkeypatch):
    from tdm_tpu_torch.data.prompts import EmbeddingCache

    rng = np.random.default_rng(15)
    cache = tmp_path / "cache.npz"
    EmbeddingCache(
        rng.standard_normal((6, 8, 32)).astype(np.float16),
        (np.arange(8)[None] < np.array([8, 3, 1, 8, 5, 2])[:, None]).astype(np.int32),
        [f"p{i}" for i in range(6)],
        uncond_embed=np.zeros((8, 32), np.float16), uncond_mask=np.ones(8, np.int32),
    ).save(str(cache))
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.setenv("TDM_EMBEDDING_CACHE", str(cache))
    out = _cli(tmp_path, "--max_train_steps", "1", "--loss_mode", "instruct")
    assert (out / "student.safetensors").exists()
    assert (out / "checkpoint-1" / "state.json").exists()


@pytest.mark.parametrize("flags,where", [
    # its id kept from before --tp was ported (tests/test_torch_port_tp.py):
    # in a world of one process --tp 2 raises the JAX CLI's ValueError
    pytest.param(["--tp", "2"], "does not divide 1 devices", id="flags0-slice 6"),
    # its id kept from before --fsdp was ported (tests/test_torch_port_parallel.py):
    # in a world of one process --fsdp 2 raises the JAX CLI's ValueError
    pytest.param(["--fsdp", "2"], "does not divide 1 devices", id="flags1-slice 6"),
    # its id kept from before --sp was ported (tests/test_torch_port_sp.py):
    # --sp on the default pixart family raises the JAX CLI's ValueError
    pytest.param(["--sp", "2"], "--model_family cogvideox only", id="flags2-slice 6"),
    # the ids of these two cases are kept stable; --quant_forwards is
    # ported, and with --sp on pixart the JAX CLI's family check comes first
    pytest.param(["--quant_forwards", "--sp", "2"], "--model_family cogvideox only",
                 id="flags4-slice 4"),
    pytest.param(["--model_family", "sd15", "--quant_forwards", "--tp", "2"],
                 "does not divide 1 devices", id="flags5-slice 4"),
    # its id kept from before --moe_experts and --ep were ported
    # (tests/test_torch_port_moe.py): --ep without experts raises the JAX
    # CLI's ValueError
    pytest.param(["--ep", "2"], "--ep requires --moe_experts > 0", id="flags6-slice 6"),
])
def test_cli_refuses_unported_flags_before_the_first_step(tmp_path, monkeypatch, flags, where):
    from tdm_tpu_torch.cli import train_tdm

    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    argv = ["--device", "cpu", "--output_dir", str(tmp_path / "run"), *flags]
    error = (ValueError if where.startswith(("does not divide", "--ep requires", "--model"))
             else NotImplementedError)
    with pytest.raises(error, match=where):
        train_tdm.main(argv)
    assert not (tmp_path / "run_cfg4.5_steps900" / "logs").exists()


def test_tdm_config_defaults_match():
    j, t = jtdm.TDMConfig(), ttdm.TDMConfig()
    assert {f.name: getattr(j, f.name) for f in dataclasses.fields(j)} == {
        f.name: getattr(t, f.name) for f in dataclasses.fields(t)}


def test_train_config_flags_and_defaults_match():
    from tdm_tpu.utils import config as jconfig
    from tdm_tpu_torch.utils import config as tconfig

    j, t = jconfig.parse_args([]), tconfig.parse_args([])
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert td.pop("device") is None
    assert jd == td
    argv = ["--cfg", "3.0", "--loss_mode", "instruct", "--critic_updates", "2",
            "--use_huber", "--validation_prompts", "a", "b", "--seed", "3"]
    jd, td = dataclasses.asdict(jconfig.parse_args(argv)), dataclasses.asdict(
        tconfig.parse_args(argv))
    assert td.pop("device") is None
    assert jd == td
    assert t.resolved_output_dir() == j.resolved_output_dir()


# --- validation grids ---------------------------------------------------------


def test_make_grid_matches_jax():
    from tdm_tpu.train import validation as jval
    from tdm_tpu_torch.train import validation as tval

    imgs = np.random.default_rng(17).uniform(-0.2, 1.2, (5, 6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tval.make_grid(imgs), jval.make_grid(imgs))
    np.testing.assert_array_equal(tval.make_grid(imgs, cols=5), jval.make_grid(imgs, cols=5))


def _png_size(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")


def test_cli_writes_validation_grids_and_log_validation(tmp_path, monkeypatch):
    """--validation_steps 1 with $TDM_TAESD_DIR naming a diffusers
    AutoencoderTiny directory (config.json and seeded weights in the
    released TAESD's key layout): the CLI's decoder is the JAX CLI's
    (`taesd_params` of the directory into TAESDConfig(), TAESD3 for 16
    latent channels) and decodes as the JAX TAESDDecoder does, within 1e-5
    of the largest output (fp32, sums in another order); the 4- and 1-NFE
    grids of the 4 validation prompts (2 x 2 tiles of 128 x 128 from the
    tiny 16 x 16 latents); log_validation's student/teacher pair likewise.
    The JAX CLI hands the whole {encoder, decoder} tree to its decoder
    (tdm_tpu/cli/train_tdm.py:593-597), which Flax refuses; the decode
    compared here is its decoder half."""
    from tdm_tpu.io import convert as jconvert
    from tdm_tpu.models import vae as jvae
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.io import manifest as tmanifest
    from tdm_tpu_torch.models import vae as tvae
    from tdm_tpu_torch.train import validation as tval

    dirs = {}
    for ch, vcfg in ((4, tvae.TAESDConfig()), (16, tvae.TAESDConfig.taesd3())):
        d = tmp_path / f"taesd{ch}"
        d.mkdir()
        (d / "config.json").write_text(json.dumps({
            "_class_name": "AutoencoderTiny", "latent_channels": ch,
            "decoder_block_out_channels": [64] * 4, "num_decoder_blocks": [3, 3, 3, 1]}))
        tmanifest.write_synthetic("taesd", str(d / "diffusion_pytorch_model.safetensors"),
                                  vcfg, seed=ch, scale=0.05)
        dirs[ch] = str(d)
    z = np.random.default_rng(18).standard_normal((2, 16, 4, 5)).astype(np.float32)
    for ch, d in dirs.items():
        dec = train_tdm._load_taesd(d, ch, "cpu")
        jcfg = jvae.TAESDConfig.taesd3() if ch == 16 else jvae.TAESDConfig()
        assert dataclasses.asdict(dec.cfg) | {"dtype": None} == dataclasses.asdict(
            jcfg) | {"dtype": None}
        jparams = jconvert.to_jax(jconvert.taesd_params(jconvert.load_torch_state_dict(d)))
        ref = np.asarray(jvae.TAESDDecoder(cfg=jcfg).apply(
            {"params": jparams["decoder"]}, jnp.asarray(z[:, :ch]) / jcfg.scaling_factor))
        with torch.no_grad():
            got = dec(_t(z[:, :ch]) / dec.cfg.scaling_factor).numpy()
        assert got.shape == ref.shape == (2, 3, 32, 40)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()

    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.setenv("TDM_TAESD_DIR", dirs[4])
    monkeypatch.delenv("TDM_EMBEDDING_CACHE", raising=False)
    out = _cli(tmp_path, "--max_train_steps", "1", "--validation_steps", "1")
    for k in (4, 1):
        assert _png_size(out / f"validation_step1_{k}nfe.png") == (256, 256)

    tb = tfamilies.build("pixart", tiny=True, device="cpu")
    dec = tvae.TAESDDecoder(tvae.TAESDConfig(width=8), device="cpu")
    params = tb.init_params()
    rng = np.random.default_rng(18)
    cond = (_t(rng.standard_normal((2, 8, 32)).astype(np.float32)),
            torch.ones(2, 8, dtype=torch.int32))
    uncond = (torch.zeros(2, 8, 32), torch.ones(2, 8, dtype=torch.int32))
    grids = tval.log_validation(
        tb.denoise_fn, params, params, tb.schedule, cond, uncond, dec,
        output_dir=str(tmp_path / "cmp"), step=3, sample_shape=tb.sample_shape,
        teacher_steps=4)
    assert set(grids) == {"student", "teacher"}
    for name in grids:
        assert grids[name].shape == (128, 256, 3) and grids[name].dtype == np.uint8
        assert _png_size(tmp_path / "cmp" / f"compare_step3_{name}.png") == (256, 128)


def test_cli_runs_on_cuda_unless_told_otherwise(tmp_path, monkeypatch):
    """Without --device the CLI asks for the CUDA device and, on a machine
    without one, raises before any model is built."""
    from tdm_tpu_torch.cli import train_tdm

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_tdm.main(["--output_dir", str(tmp_path / "run"), "--export_lora_rank", "0"])
    assert not (tmp_path / "run_cfg4.5_steps900").exists()


def test_remat_gives_the_same_gradients():
    """cfg.remat recomputes each block in the backward
    (torch.utils.checkpoint): the loss and every gradient equal the run
    without it, and the recompute goes through the lse forward again."""
    from tdm_tpu_torch.ops import attention as tattn

    grads = {}
    for remat in (False, True):
        tb = tfamilies.build("pixart", tiny=True, gradient_checkpointing=remat, device="cpu")
        params = {k: v.detach().requires_grad_(True) for k, v in tb.init_params().items()}
        rng = np.random.default_rng(19)
        x = _t(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
        cond = (_t(rng.standard_normal((2, 8, 32)).astype(np.float32)),
                torch.ones(2, 8, dtype=torch.int32))
        calls = []
        wrapper = tattn.flash_attention_fwd_lse
        tattn.flash_attention_fwd_lse = lambda *a: calls.append(1) or wrapper(*a)
        try:
            loss = (tb.denoise_fn(params, x, torch.tensor([300, 700]), cond) ** 2).mean()
            g = torch.autograd.grad(loss, list(params.values()))
        finally:
            tattn.flash_attention_fwd_lse = wrapper
        grads[remat] = (loss, g, len(calls))
    (l0, g0, n0), (l1, g1, n1) = grads[False], grads[True]
    assert float(l0.detach()) == float(l1.detach())
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
    assert (n0, n1) == (4, 8)  # 2 layers x (self, cross), twice with remat


def test_prompt_sources_and_batcher_match_jax(tmp_path, monkeypatch):
    from tdm_tpu.data import prompts as jprompts, tokenizer as jtok
    from tdm_tpu_torch.data import prompts as tprompts, tokenizer as ttok

    txt = tmp_path / "p.txt"
    txt.write_text("a red cube\n\nthe sea at night\n  two cats  \nx\n")
    jsonl = tmp_path / "p.jsonl"
    jsonl.write_text("\n".join(json.dumps({"caption": f"prompt {i}"}) for i in range(7)))
    for src, kw in ((str(txt), {}), (str(jsonl), {"caption_column": "caption"}),
                    (["one", "two", "three"], {"max_samples": 2})):
        assert tprompts.load_prompts(src, **kw) == jprompts.load_prompts(src, **kw)
    import sys
    import types

    calls = []

    class _DS:
        column_names = ["prompt"]

        def __getitem__(self, k):
            return ["a", "b"]

    fake = types.ModuleType("datasets")
    fake.load_dataset = lambda name, config=None, split=None: calls.append(
        (name, config, split)) or _DS()
    monkeypatch.setitem(sys.modules, "datasets", fake)
    # a hub name reaches datasets.load_dataset with JAX's arguments
    got = tprompts.load_prompts("JourneyDB/JourneyDB", dataset_config_name="c")
    assert got == jprompts.load_prompts("JourneyDB/JourneyDB", dataset_config_name="c")
    assert got == ["a", "b"] and calls == [("JourneyDB/JourneyDB", "c", "train")] * 2
    prompts = tprompts.load_prompts(str(jsonl), caption_column="caption")
    jb = iter(jprompts.PromptBatcher(prompts, 3, tokenizer=jtok.HashTokenizer(),
                                     max_length=6, seed=4))
    tb = iter(tprompts.PromptBatcher(prompts, 3, tokenizer=ttok.HashTokenizer(),
                                     max_length=6, seed=4))
    for _ in range(5):  # across an epoch boundary (7 prompts, 2 batches each)
        a, b = next(jb), next(tb)
        assert a["prompts"] == b["prompts"]
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
