"""The SD3 training slice against the JAX package on the CPU: the flow
schedule's tables, the sd3 family bundle and its pooled conditioning, the
tiny MMDiT's gradients with and without remat, PixArt's 'dots' remat, one
sd3 TDM step (full weights; a LoRA student under 8-bit Adam and
accumulation 2) from one carried state, the validation grids, and the
training CLI with a pooled cache and with the stand-in.

Inputs come from numpy seeds (the step's draws from JAX's own key splits)
and pass between the packages as numpy arrays; everything is fp32, where
the two differ in the order of sums. Each tolerance says how much that
grows through its computation.

The JAX sd3 family hands the MMDiT the schedule index t (0..999) where the
model is conditioned on the flow timestep σ̂(t)·1000; the port feeds
σ̂(t)·1000 (ROADMAP.md §3). The step comparisons give the JAX step a
`denoise_fn` that maps t the port's way, and
`test_jax_family_feeds_the_raw_index` shows the difference.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode

from tdm_tpu.core import schedules as jsched
from tdm_tpu.lora import adapter as jlora, io as jlora_io
from tdm_tpu.train import families as jfamilies, optim as jopt, tdm as jtdm
from tdm_tpu_torch import lora as tlora
from tdm_tpu_torch.core import schedules as tsched
from tdm_tpu_torch.data.prompts import EmbeddingCache
from tdm_tpu_torch.io import from_jax, params as tparams
from tdm_tpu_torch.models import mmdit_sd3 as tmmdit, pixart as tpixart
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm
from tests.test_torch_port_recipe import _nest
from tests.test_torch_port_train import (
    ADAM_EPS, LR, _factors, _jax_draws, _q8_decoded, _q8_leaves, _update_close,
)

torch.set_num_threads(2)

BATCH = 2


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) else jnp.dtype(dt).name


# --- the flow schedule ---------------------------------------------------------


@pytest.mark.parametrize("shift", [1.0, 3.0, 6.0])
def test_flow_match_tables_match_jax(shift):
    """The α = 1 − σ̂ and σ̂ tables, bit for bit (both built in float64 and
    rounded once to fp32), and shift_sigma on arrays and tensors."""
    j = jsched.flow_match(shift=shift)
    t = tsched.flow_match(shift=shift, device="cpu")
    np.testing.assert_array_equal(t.alphas.numpy(), np.asarray(j.alphas))
    np.testing.assert_array_equal(t.sigmas.numpy(), np.asarray(j.sigmas))
    assert (t.prediction_type, t.num_train_timesteps) == (j.prediction_type, 1000)
    assert t.prediction_type == tsched.FLOW
    sig = np.linspace(0.0, 1.0, 101)
    np.testing.assert_array_equal(tsched.shift_sigma(sig, shift),
                                  np.asarray(jsched.shift_sigma(sig, shift)))
    np.testing.assert_array_equal(tsched.shift_sigma(torch.from_numpy(sig), shift).numpy(),
                                  tsched.shift_sigma(sig, shift))


# --- the sd3 bundle --------------------------------------------------------------


@pytest.mark.parametrize("tiny,resolution,ckpt,mp", [
    (True, 512, False, None), (False, 512, True, "bf16"), (False, 1024, False, "no"),
])
def test_sd3_bundle_matches_jax(tiny, resolution, ckpt, mp):
    """Geometry, schedule and model config of the sd3 bundle as the JAX
    package builds them; the full size on the meta device (no parameter is
    allocated)."""
    kw = dict(tiny=tiny, resolution=resolution, gradient_checkpointing=ckpt, mixed_precision=mp)
    jb = jfamilies.build("sd3", **kw)
    tb = tfamilies.build("sd3", **kw, device="cpu" if tiny else "meta")
    assert tb.sample_shape == jb.sample_shape
    assert (tb.seq_len, tb.embed_dim) == (jb.seq_len, jb.embed_dim)
    assert tb.schedule.prediction_type == jb.schedule.prediction_type == jsched.FLOW
    if tiny:
        np.testing.assert_array_equal(tb.schedule.sigmas.numpy(), np.asarray(jb.schedule.sigmas))
    jc, tc = jb.model.cfg, tb.model.cfg
    for f in dataclasses.fields(jc):
        if f.name == "dtype":
            assert _dtype_name(getattr(tc, "dtype")) == _dtype_name(jc.dtype)
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.remat == ckpt


def test_pooled_standin_matches_jax():
    """The masked-mean stand-in of a batch without pooled vectors (a row
    with no live token included) as JAX's `_pooled_of`, to fp32 roundoff
    of a mean; explicit pooled vectors pass through; the tiling beyond the
    token width as jnp.tile; the pixart family accepts and ignores pooled."""
    jb = jfamilies.build("sd3", tiny=True)
    tb = tfamilies.build("sd3", tiny=True, device="cpu")
    rng = np.random.default_rng(30)
    text = rng.standard_normal((3, 8, jb.embed_dim)).astype(np.float32)
    mask = (np.arange(8)[None] < np.array([[8], [3], [0]])).astype(np.int32)
    pooled = rng.standard_normal((3, 24)).astype(np.float32)
    jc = jb.cond_of(jnp.asarray(text), jnp.asarray(mask))
    tc = tb.cond_of(_t(text), _t(mask))
    np.testing.assert_array_equal(tc[0].numpy(), text)
    np.testing.assert_allclose(tc[1].numpy(), np.asarray(jc[1]), rtol=1e-6, atol=1e-7)
    assert tc[1].shape == (3, 24) and not tc[1][2].any()
    tc = tb.cond_of(_t(text), _t(mask), _t(pooled))
    np.testing.assert_array_equal(tc[1].numpy(), pooled)
    wide = tfamilies.pooled_standin(_t(text), _t(mask), 100).numpy()
    mean = (text * mask[..., None]).sum(1) / np.maximum(mask.sum(1), 1)[:, None]
    np.testing.assert_allclose(wide, np.tile(mean, (1, 3))[:, :100], rtol=1e-6, atol=1e-7)
    pb = tfamilies.build("pixart", tiny=True, device="cpu")
    got = pb.cond_of(_t(text), _t(mask), _t(pooled))
    assert len(got) == 2 and torch.equal(got[1], _t(mask))


def test_full_size_sd3_refuses_the_standin():
    """Without pooled vectors and without allow_pooled_standin a full-size
    sd3 run raises JAX's ValueError: the check before any model is built,
    and the bundle's cond_of (on the meta device); allowed, it folds."""
    jb = jfamilies.build("sd3")  # a Flax definition: no parameters
    with pytest.raises(ValueError) as jerr:
        jb.cond_of(np.zeros((1, 2, 4096), np.float32), np.ones((1, 2), np.int32))
    with pytest.raises(ValueError) as terr:
        tfamilies.check_pooled_source("sd3", tiny=False, allow_pooled_standin=False,
                                      has_pooled=False)
    assert str(terr.value) == str(jerr.value)
    text, mask = torch.zeros(1, 2, 4096, device="meta"), torch.ones(1, 2, device="meta")
    with pytest.raises(ValueError, match="--allow_pooled_standin"):
        tfamilies.build("sd3", device="meta").cond_of(text, mask)
    opted = tfamilies.build("sd3", device="meta", allow_pooled_standin=True)
    assert opted.cond_of(text, mask)[1].shape == (1, 2048)
    for kw in ({"tiny": True, "allow_pooled_standin": False, "has_pooled": False},
               {"tiny": False, "allow_pooled_standin": True, "has_pooled": False},
               {"tiny": False, "allow_pooled_standin": False, "has_pooled": True}):
        tfamilies.check_pooled_source("sd3", **kw)
    tfamilies.check_pooled_source("pixart", tiny=False, allow_pooled_standin=False,
                                  has_pooled=False)
    for fam, where in (("sd15", "slice 4"), ("cogvideox", "slice 5")):
        with pytest.raises(NotImplementedError, match=where):
            tfamilies.build(fam, tiny=True, device="cpu")


# --- the tiny MMDiT under grad ------------------------------------------------------


@pytest.fixture(scope="module")
def sd3_pair():
    """The tiny JAX and port sd3 bundles, one teacher (JAX's init, every
    leaf moved off it by 5%: AdaLN-zero gates would hide a wiring fault),
    and (cond, uncond) as numpy (text, mask, pooled)."""
    jb = jfamilies.build("sd3", tiny=True)
    tb = tfamilies.build("sd3", tiny=True, device="cpu")
    rng = np.random.default_rng(31)
    teacher = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32)), jb.init_params(jax.random.PRNGKey(0)))
    text = rng.standard_normal((BATCH, 8, jb.embed_dim)).astype(np.float32)
    mask = np.ones((BATCH, 8), np.int32)
    mask[1, 5:] = 0
    pooled = rng.standard_normal((BATCH, 24)).astype(np.float32)
    cond = (text, mask, pooled)
    uncond = (np.zeros_like(text), np.ones_like(mask), np.zeros_like(pooled))
    return jb, tb, teacher, cond, uncond


def _sigma_denoise(jb):
    """The JAX family's denoise_fn with the port's timestep: the MMDiT given
    σ̂(t)·1000 of the index t."""
    sigmas, n = jb.schedule.sigmas, jb.schedule.num_train_timesteps

    def fn(params, x, t, cond):
        ctx, pooled = cond
        return jb.model.apply({"params": params}, x, sigmas[t] * n, ctx, pooled)

    return fn


def _carry(tree, module):
    return from_jax.state_dict_from_jax(from_jax.flatten_tree(tree), module)


def test_tiny_mmdit_gradients_match_jax(sd3_pair):
    """The port's forward and every parameter's gradient (plain attention
    on the CPU) against jax.grad of the JAX MMDiT (impl 'xla') on the same
    weights: the output to 1e-4 of its largest value, each gradient to
    2e-4 in relative L2 (fp32 sums in another order through two joint
    blocks and the modulation MLPs). With remat the loss and every gradient
    equal the run without it to 1e-6 (the same forward recomputed)."""
    jb, tb0, teacher, _, _ = sd3_pair
    rng = np.random.default_rng(32)
    x = rng.standard_normal((BATCH, *jb.sample_shape)).astype(np.float32)
    t = np.array([750.0, 120.0], np.float32)
    ctx = rng.standard_normal((BATCH, 8, jb.embed_dim)).astype(np.float32)
    pooled = rng.standard_normal((BATCH, 24)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p):
        return jnp.sum(jb.model.apply({"params": p}, x, t, ctx, pooled) * g)

    jl, jgrads = jax.value_and_grad(jloss)(teacher)
    jout = np.asarray(jb.model.apply({"params": teacher}, x, t, ctx, pooled))
    got = {}
    for remat in (False, True):
        tb = tfamilies.build("sd3", tiny=True, gradient_checkpointing=remat, device="cpu")
        params = {k: v.requires_grad_(True) for k, v in _carry(teacher, tb.model).items()}
        out = functional_call(tb.model, params, (_t(x), _t(t), _t(ctx), _t(pooled)))
        loss = (out * _t(g)).sum()
        got[remat] = (out.detach(), loss.detach(),
                      dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
    out, loss, grads = got[False]
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-4 * np.abs(jout).max())
    assert float(loss) == pytest.approx(float(jl), rel=1e-4)
    ref = _carry(jgrads, tb0.model)
    assert set(ref) == set(grads)
    for k, r in ref.items():
        # the last block's text queries reach no output (context_pre_only):
        # their projection's gradient is exactly 0 on both sides
        assert float((grads[k] - r).norm()) <= 2e-4 * float(r.norm()), k
    assert sum(float(r.norm()) == 0 for r in ref.values()) == 2  # add_q_proj's weight, bias
    _, loss_r, grads_r = got[True]
    assert float(loss_r) == pytest.approx(float(loss), rel=1e-6)
    for k in grads:
        torch.testing.assert_close(grads_r[k], grads[k], rtol=1e-6, atol=1e-8)


class _CountDots(TorchDispatchMode):
    """Counts the matmuls (mm, addmm) the dispatcher runs."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_pixart_dots_remat_matches_full_and_none():
    """remat_policy='dots' runs (it raised before) and gives the loss and
    gradients of 'full' and of no remat to 1e-6; its backward recomputes no
    Dense matmul (their outputs are saved) where 'full' recomputes every
    one; an unknown policy raises ValueError, as in JAX."""
    rng = np.random.default_rng(33)
    x = _t(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    text = _t(rng.standard_normal((2, 8, 32)).astype(np.float32))
    mask = torch.ones(2, 8, dtype=torch.int32)
    runs = {}
    for name, kw in (("none", {}), ("full", {"remat": True}),
                     ("dots", {"remat": True, "remat_policy": "dots"})):
        torch.manual_seed(0)
        model = tpixart.PixArtTransformer2D(
            dataclasses.replace(tpixart.PixArtConfig.tiny(), **kw), device="cpu",
            param_dtype=torch.float32)
        params = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
        loss = (functional_call(model, params, (x, torch.tensor([300, 700]), text, mask))
                ** 2).mean()
        with _CountDots() as dots:
            grads = torch.autograd.grad(loss, list(params.values()))
        runs[name] = (float(loss.detach()), grads, dots.n)
    for name in ("full", "dots"):
        assert runs[name][0] == pytest.approx(runs["none"][0], rel=1e-6)
        for a, b in zip(runs[name][1], runs["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
    # 2 blocks x (4 + 4 attention projections + 2 feed-forward) Dense layers
    assert runs["dots"][2] == runs["none"][2]
    assert runs["full"][2] == runs["none"][2] + 2 * 10
    with pytest.raises(ValueError, match="remat_policy"):
        tpixart.PixArtTransformer2D(
            dataclasses.replace(tpixart.PixArtConfig.tiny(), remat=True, remat_policy="x"),
            device="cpu")


# --- the sd3 TDM step against JAX ------------------------------------------------------


def _conds(jb, tb, cond, uncond):
    jc = tuple(jb.cond_of(*(jnp.asarray(a) for a in c)) for c in (cond, uncond))
    tc = tuple(tb.cond_of(*(_t(a) for a in c)) for c in (cond, uncond))
    return jc, tc


@pytest.mark.parametrize("critic_updates,huber,ema", [(1, False, False), (2, True, True)])
def test_sd3_dmd_step_matches_jax(sd3_pair, critic_updates, huber, ema):
    """One 'dmd' step of the tiny sd3 family from one state (the JAX state
    carried by train_state_from_jax), JAX's draws: both losses and grad
    norms to 1e-4 relative; each role's update to 5e-3 in relative L2 and
    each weight to 10% of lr (the bounds of the PixArt step,
    tests/test_torch_port_train.py, whose reasons hold here: Adam ε 1e-4,
    a weight moves by lr·δg/ε where its gradient is a near-cancelling sum);
    the EMA to 1e-7."""
    jb, tb, teacher, cond, uncond = sd3_pair
    config = jtdm.TDMConfig(critic_updates=critic_updates, use_huber=huber)
    tconfig = ttdm.TDMConfig(critic_updates=critic_updates, use_huber=huber)
    jtx = jopt.make_optimizer(LR, eps=ADAM_EPS)
    ttx = topt.make_optimizer(LR, eps=ADAM_EPS)
    rng_p = np.random.default_rng(34)
    student = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng_p.standard_normal(a.shape).astype(np.float32)), teacher)
    jstate = jtdm.init_state(student, teacher, jtx, jtx, use_ema=ema)
    tstate = from_jax.train_state_from_jax(jstate, tb.model, device="cpu")
    tteacher = _carry(teacher, tb.model)
    before = {r: {k: v.clone() for k, v in getattr(tstate, r).items()}
              for r in ("student", "critic")}
    (jcond, juncond), (tcond, tuncond) = _conds(jb, tb, cond, uncond)
    jstep = jtdm.build_train_step(_sigma_denoise(jb), teacher, jb.schedule, config, jtx, jtx,
                                  sample_shape=jb.sample_shape)
    rng = jax.random.PRNGKey(6)
    jnew, jm = jax.block_until_ready(jstep(jstate, rng, jcond, juncond, teacher))
    tstep = ttdm.build_train_step(tb.denoise_fn, tteacher, tb.schedule, tconfig, ttx, ttx,
                                  sample_shape=tb.sample_shape)
    tnew, tm = tstep(tstate, _jax_draws(rng, config, BATCH, jb.sample_shape), tcond, tuncond)
    for name in jtdm.StepMetrics._fields:
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


def _jax_lora_factors(teacher, seed=99, rank=4):
    """A JAX LoRA template over the sd3 teacher and its factors, b drawn
    nonzero from a numpy seed (`_factors`), as a nested JAX tree."""
    template = jlora.init_lora(teacher, jax.random.PRNGKey(seed), rank=rank)
    tree = jax.tree.map(jnp.asarray, template.params)
    for k, v in _factors(template).items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node[p]
        node[leaf] = jnp.asarray(v)
    return template, tree


def _moments_close(tstate_role_opt, jopt_state, params, module, shapes, role):
    """Each quantized moment of the port within one int8 code step (each
    side's) of JAX's, decoded and carried to the port's layout."""
    jinner = from_jax._adam_state(jopt_state)
    for m in ("mu", "nu"):
        views = topt.leaf_moments(getattr(tstate_role_opt.inner, m), params)
        jflat = _q8_leaves(getattr(jinner, m))
        want_all = {}
        for path, (values, scales) in jflat.items():
            want_all[path] = _q8_decoded(topt.Q8Moment(_t(values), _t(scales)), shapes[path])
        quantized = [k for k, v in views.items() if isinstance(v, topt.Q8Moment)]
        stacks = from_jax.layer_stacks(module.cfg)
        assert quantized, role
        for k in quantized:
            path, layer = from_jax.jax_name(k, stacks)
            want, want_err = want_all[path]
            got, got_err = _q8_decoded(views[k], params[k].shape)
            if layer is not None:
                want, want_err = want[layer], want_err[layer]
            if got.dim() == 2:
                got, got_err = got.T, got_err.T
            assert float(got.abs().max()) > 0, (role, m, k)
            bound = 1.01 * (got_err + want_err) + 1e-6 * float(want.abs().max())
            assert bool(((got - want).abs() <= bound).all()), (role, m, k)


def test_sd3_lora_8bit_accumulated_step_matches_jax(sd3_pair, monkeypatch):
    """A rank-4 LoRA student over the sd3 teacher under 8-bit Adam and
    accumulation 2, both sides from one state carried by
    train_state_from_jax(lora=True), two micro-steps with JAX's draws.
    Micro-step 1: metrics to 1e-4, every tensor keeps its bits. Micro-step
    2, run both from the port's own state and from JAX's state after
    micro-step 1 carried afresh (its accumulated gradient): metrics to 1e-4,
    the factors' and the critic's updates to the bounds of the full-weight
    step, each quantized critic moment within one code step of JAX's (the
    port quantizes its [out, in] weights, JAX its [in, out] kernels); the
    teacher is untouched. MSE, as the 8-bit PixArt step (Huber's grad norm
    is ill-conditioned at one critic update)."""
    monkeypatch.setattr(topt, "_SLICE", 40 * 256)
    jb, tb, teacher, cond, uncond = sd3_pair
    config, tconfig = jtdm.TDMConfig(use_huber=False), ttdm.TDMConfig(use_huber=False)
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
        _sigma_denoise(jb), teacher, jb.schedule, config, jtx, jtx, sample_shape=jb.sample_shape,
        student_denoise_fn=jlora.wrap_denoise_fn(_sigma_denoise(jb), template))
    tstep = ttdm.build_train_step(tb.denoise_fn, tteacher, tb.schedule, tconfig, ttx, ttx,
                                  sample_shape=tb.sample_shape, student_denoise_fn=student_fn)
    (jcond, juncond), (tcond, tuncond) = _conds(jb, tb, cond, uncond)
    shapes = {"critic": {k: v.shape for k, v in from_jax.flatten_tree(teacher).items()}}

    def metrics_close(jm, tm, micro):
        for name in jtdm.StepMetrics._fields:
            assert float(getattr(tm, name)) == pytest.approx(
                float(getattr(jm, name)), rel=1e-4, abs=1e-7), (micro, name)

    rng = jax.random.PRNGKey(5)
    jstate, jm = jax.block_until_ready(jstep(jstate, rng, jcond, juncond, teacher))
    tstate, tm = tstep(tstate, _jax_draws(rng, config, BATCH, jb.sample_shape), tcond, tuncond)
    metrics_close(jm, tm, 1)
    for role in ("student", "critic"):
        opt = getattr(tstate, f"{role}_opt")
        assert (opt.mini_step, opt.gradient_step) == (1, 0)
        assert all(torch.equal(v, before[role][k]) for k, v in getattr(tstate, role).items())
    carried = from_jax.train_state_from_jax(jstate, tb.model, device="cpu", lora=True,
                                             eight_bit=True)
    assert carried.critic_opt.mini_step == 1
    for k, v in tstate.critic_opt.acc.items():  # the window's running mean
        torch.testing.assert_close(carried.critic_opt.acc[k], v, rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()))

    rng = jax.random.PRNGKey(7)
    jstate, jm = jax.block_until_ready(jstep(jstate, rng, jcond, juncond, teacher))
    draws = _jax_draws(rng, config, BATCH, jb.sample_shape)
    for name, state in (("own", tstate), ("carried", carried)):
        new, tm = tstep(state, draws, tcond, tuncond)
        metrics_close(jm, tm, f"2 {name}")
        ref = {k: _t(v) for k, v in from_jax.flatten_tree(jstate.student).items()}
        _update_close(before["student"], ref, new.student, f"student {name}")
        _update_close(before["critic"], _carry(jstate.critic, tb.model), new.critic,
                      f"critic {name}")
        assert new.critic_opt.inner.count == 1 and new.critic_opt.gradient_step == 1
        _moments_close(new.critic_opt, jstate.critic_opt, new.critic, tb.model,
                       shapes["critic"], name)
    assert all(torch.equal(tteacher[k], pristine[k]) for k in pristine)


def test_train_state_from_jax_carries_zero_8bit_moments_exactly(sd3_pair):
    """A fresh 8-bit state (zero moments) carries to the packed layout the
    port's own init makes, code for code, and is refused without
    eight_bit; AdamW moments in bf16 keep mu_dtype."""
    jb, tb, teacher, _, _ = sd3_pair
    jtx = jopt.make_optimizer(LR, eight_bit=True)
    tx = topt.make_optimizer(LR, eight_bit=True)
    jstate = jtdm.init_state(teacher, teacher, jtx, jtx)
    with pytest.raises(ValueError, match="eight_bit"):
        from_jax.train_state_from_jax(jstate, tb.model, device="cpu")
    carried = from_jax.train_state_from_jax(jstate, tb.model, device="cpu", eight_bit=True)
    own = tx.init(carried.critic)
    for m in ("mu", "nu"):
        for f in topt.Q8Moments._fields:
            assert torch.equal(getattr(getattr(carried.critic_opt, m), f),
                               getattr(getattr(own, m), f)), (m, f)
    jtx = jopt.make_optimizer(LR, low_precision_moments=True)
    carried = from_jax.train_state_from_jax(jtdm.init_state(teacher, teacher, jtx, jtx),
                                            tb.model, device="cpu", mu_dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in carried.student_opt.mu.values())


def test_jax_family_feeds_the_raw_index(sd3_pair):
    """The reference's defect: under shift 3 the JAX sd3 family's denoise_fn
    gives the MMDiT the index t itself (index 499 → "499", where the flow
    noised the sample to σ̂ = 0.75, "750"), and its output differs from the
    model's at σ̂(t)·1000; the port's denoise_fn equals the latter to 1e-4
    of its largest value (fp32, two joint blocks)."""
    jb, tb, teacher, cond, _ = sd3_pair
    assert float(jb.schedule.sigmas[499]) == pytest.approx(0.75)
    rng = np.random.default_rng(35)
    x = rng.standard_normal((BATCH, *jb.sample_shape)).astype(np.float32)
    t = np.array([499, 200])
    ctx, pooled = cond[0], cond[2]
    raw = np.asarray(jb.denoise_fn(teacher, x, jnp.asarray(t), (ctx, pooled)))
    at_index = np.asarray(jb.model.apply({"params": teacher}, x, t.astype(np.float32), ctx,
                                         pooled))
    at_sigma = np.asarray(_sigma_denoise(jb)(teacher, x, jnp.asarray(t), (ctx, pooled)))
    np.testing.assert_array_equal(raw, at_index)
    assert np.abs(raw - at_sigma).max() > 0.01 * np.abs(at_sigma).max()
    with torch.no_grad():
        got = tb.denoise_fn(_carry(teacher, tb.model), _t(x), _t(t), (_t(ctx), _t(pooled)))
    np.testing.assert_allclose(got.numpy(), at_sigma, rtol=0,
                               atol=1e-4 * np.abs(at_sigma).max())


# --- validation grids and the CLI ------------------------------------------------------


def _taesd3_dir(tmp_path):
    """A seeded diffusers AutoencoderTiny directory with 16 latent
    channels (TAESD3)."""
    from tdm_tpu_torch.io import manifest as tmanifest
    from tdm_tpu_torch.models import vae as tvae

    d = tmp_path / "taesd3"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "_class_name": "AutoencoderTiny", "latent_channels": 16,
        "decoder_block_out_channels": [64] * 4, "num_decoder_blocks": [3, 3, 3, 1]}))
    tmanifest.write_synthetic("taesd", str(d / "diffusion_pytorch_model.safetensors"),
                              tvae.TAESDConfig.taesd3(), seed=16, scale=0.05)
    return str(d)


def test_validation_grids_match_jax(sd3_pair, tmp_path):
    """The 4- and 1-NFE validation grids of the sd3 student under the flow
    schedule with the (ctx, pooled) cond, decoded by one TAESD3, as the JAX
    package's save_validation_images renders them (its denoise_fn given
    σ̂(t)·1000): within one of 255 levels (fp32 sums in another order can
    round a pixel across a level)."""
    from tdm_tpu.io import convert as jconvert
    from tdm_tpu.models import vae as jvae
    from tdm_tpu.train import validation as jval
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.train import validation as tval

    jb, tb, teacher, cond, _ = sd3_pair
    d = _taesd3_dir(tmp_path)
    dec = train_tdm._load_taesd(d, 16, "cpu")
    jcfg = jvae.TAESDConfig.taesd3()
    jparams = jconvert.to_jax(jconvert.taesd_params(jconvert.load_torch_state_dict(d)))
    jdec = jvae.TAESDDecoder(cfg=jcfg)
    noise = np.random.default_rng(36).standard_normal(
        (BATCH, *jb.sample_shape)).astype(np.float32)
    (jcond, _), (tcond, _) = _conds(jb, tb, cond, cond)
    want = jval.save_validation_images(
        _sigma_denoise(jb), teacher, jb.schedule, jcond, jnp.asarray(noise),
        lambda z: jdec.apply({"params": jparams["decoder"]}, z / jcfg.scaling_factor),
        output_dir=str(tmp_path / "jax"), step=1)
    got = tval.save_validation_images(
        tb.denoise_fn, _carry(teacher, tb.model), tb.schedule, tcond, _t(noise),
        lambda z: dec(z.float() / dec.cfg.scaling_factor), output_dir=str(tmp_path / "port"),
        step=1)
    assert set(got) == set(want) == {4, 1}
    for k in got:
        assert got[k].shape == want[k].shape == (64, 128, 3)
        assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1, k
        assert (tmp_path / "port" / f"validation_step1_{k}nfe.png").exists()


def _cli(tmp_path, *extra):
    from tdm_tpu_torch.cli import train_tdm

    train_tdm.main(["--device", "cpu", "--model_family", "sd3",
                    "--output_dir", str(tmp_path / "run"), "--seed", "0",
                    "--train_batch_size", "2", *extra])
    return tmp_path / "run_cfg4.5_steps900"


def _pooled_cache(path, *, uncond_pooled=True):
    """A tiny sd3 cache: 6 prompts of 8 tokens at 48 with pooled vectors,
    the empty prompt, and dedicated validation rows for 2 of the 4 default
    validation prompts (the other 2 are main rows)."""
    rng = np.random.default_rng(37)
    prompts = ["a photo of a panda", "a photo of a pikachu", "a", "b", "c", "d"]
    EmbeddingCache(
        rng.standard_normal((6, 8, 48)).astype(np.float16),
        (np.arange(8)[None] < np.array([8, 5, 8, 2, 7, 8])[:, None]).astype(np.int32),
        prompts,
        uncond_embed=(0.1 * rng.standard_normal((8, 48))).astype(np.float16),
        uncond_mask=(np.arange(8) < 1).astype(np.int32),
        pooled=rng.standard_normal((6, 24)).astype(np.float16),
        uncond_pooled=(0.1 * rng.standard_normal(24)).astype(np.float16) if uncond_pooled
        else None,
        val_prompts=["a photo of a cat", "a photo of a dog"],
        val_embeds=rng.standard_normal((2, 8, 48)).astype(np.float16),
        val_masks=np.ones((2, 8), np.int32),
        val_pooled=rng.standard_normal((2, 24)).astype(np.float16),
    ).save(path)


def test_cli_trains_sd3_from_a_pooled_cache(tmp_path, monkeypatch):
    """TDM_TINY_MODEL=1 --model_family sd3 from a cache with pooled vectors
    and the empty prompt's: 2 steps with validation grids through a TAESD3
    directory, metrics.jsonl, a checkpoint, student.safetensors in the JAX
    package's sd3 layout (stacked blocks, the last unrolled) and the rank-32
    kohya LoRA, which is the JAX package's export of the same weights; the
    batches and the CFG null branch carry the cache's pooled vectors; a
    resume from 'latest' with nothing left to run exports the same files."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.train import tdm as tdm_mod

    cache = str(tmp_path / "cache.npz")
    _pooled_cache(cache)
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.setenv("TDM_EMBEDDING_CACHE", cache)
    monkeypatch.setenv("TDM_TAESD_DIR", _taesd3_dir(tmp_path))
    seen = []
    build = tdm_mod.build_train_step

    def spy(*a, **kw):
        step = build(*a, **kw)

        def run(state, draws, cond, uncond, teacher=None):
            seen.append((cond, uncond))
            return step(state, draws, cond, uncond, teacher)
        return run

    monkeypatch.setattr(tdm_mod, "build_train_step", spy)
    out = _cli(tmp_path, "--max_train_steps", "2", "--validation_steps", "2",
               "--lr_warmup_steps", "0")
    monkeypatch.setattr(tdm_mod, "build_train_step", build)
    z = np.load(cache, allow_pickle=True)
    pooled_rows = {tuple(np.round(r.astype(np.float32), 3)) for r in z["pooled"]}
    for cond, uncond in seen:
        assert cond[1].shape == (2, 24)
        assert {tuple(np.round(r, 3)) for r in cond[1].numpy()} <= pooled_rows
        np.testing.assert_array_equal(uncond[1].numpy()[0], z["uncond_pooled"].astype(np.float32))
    logs = [json.loads(line) for line in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert logs and all(np.isfinite(v) for rec in logs for v in rec.values()
                        if isinstance(v, float))
    for k in (4, 1):
        assert (out / f"validation_step2_{k}nfe.png").exists()
    student = tparams.load_file(str(out / "student.safetensors"))
    assert "blocks/to_q/kernel" in student and "blocks_1/to_q/kernel" in student
    assert student["blocks/to_q/kernel"].shape == (1, 32, 32)
    lora = tparams.load_file(str(out / "tdm_lora.safetensors"))
    assert "lora_transformer_blocks_1_to_q.lora_down.weight" in lora
    # the full-weight run's export: the JAX package's extract_lora and
    # save_kohya on the same fp32 trees give the same keys, and the
    # up·down products agree per piece to 1e-4 relative (fp16 factors of
    # the same rank-32 SVD)
    teacher = tfamilies.build("sd3", tiny=True, seed=0, device="cpu").init_params()
    trained = {k: torch.from_numpy(v) for k, v in tparams.load_file(
        str(out / "checkpoint-2" / "student.safetensors")).items()}
    stacks = from_jax.layer_stacks(tmmdit.MMDiTConfig.tiny())
    ref_path = str(tmp_path / "jax_lora.safetensors")
    jlora_io.save_kohya(jlora.extract_lora(_nest(from_jax.jax_layout(teacher, stacks=stacks)),
                                           _nest(from_jax.jax_layout(trained, stacks=stacks)),
                                           32), ref_path, prefix="lora_transformer")
    want = tparams.load_file(ref_path)
    assert set(lora) == set(want)
    for key in (k for k in want if k.endswith(".lora_up.weight")):
        down = key.replace(".lora_up.", ".lora_down.")
        prod = lora[key].astype(np.float64) @ lora[down].astype(np.float64)
        ref = want[key].astype(np.float64) @ want[down].astype(np.float64)
        assert np.linalg.norm(prod - ref) <= 1e-4 * np.linalg.norm(ref) + 1e-12, key
    files = {f: (out / f).read_bytes() for f in ("student.safetensors", "tdm_lora.safetensors")}
    _cli(tmp_path, "--max_train_steps", "2", "--lr_warmup_steps", "0",
         "--resume_from_checkpoint", "latest")
    assert all((out / f).read_bytes() == b for f, b in files.items())
    del train_tdm


def test_cli_sd3_lora_with_the_standin_resumes_and_loads_into_the_pipeline(
        tmp_path, monkeypatch):
    """--model_family sd3 from hash embeddings with --allow_pooled_standin
    and the recipe's LoRA student (rank 4, 8-bit Adam, accumulation 2): two
    optimizer steps with a checkpoint at each, a resume from 'latest' that
    continues to step 3; the kohya file loads into the port's SD3 pipeline
    (every key resolved to a kernel of SD3's module names), and merged at
    1.0 into the teacher it gives the exported student to fp16 rounding.
    Without the flag, a full-size run without pooled vectors raises
    ValueError before any model is built."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.pipelines.sd3 import default_sd3_pipeline

    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.delenv("TDM_EMBEDDING_CACHE", raising=False)
    monkeypatch.delenv("TDM_TAESD_DIR", raising=False)
    flags = ["--allow_pooled_standin", "--train_lora_rank", "4", "--use_8bit_adam",
             "--gradient_accumulation_steps", "2", "--checkpointing_steps", "1",
             "--lr_warmup_steps", "0"]
    out = _cli(tmp_path, "--max_train_steps", "2", *flags)
    assert sorted(p.name for p in out.iterdir() if p.name.startswith("checkpoint")) == [
        "checkpoint-1", "checkpoint-2"]
    critic_opt = tparams.load_file(str(out / "checkpoint-2" / "critic_opt.safetensors"))
    assert critic_opt["inner/mu/codes"].dtype == np.int8
    _cli(tmp_path, "--max_train_steps", "3", *flags, "--resume_from_checkpoint", "latest")
    meta = json.loads((out / "checkpoint-3" / "state.json").read_text())
    assert meta["step"] == 3 and meta["critic_inner_count"] == 3

    pipe = default_sd3_pipeline(cfg=tmmdit.MMDiTConfig.tiny(), device="cpu")
    teacher = tfamilies.build("sd3", tiny=True, seed=0, device="cpu").init_params()
    pipe.transformer.load_state_dict(teacher)
    pipe.load_lora_weights(str(out / "tdm_lora.safetensors"), adapter_name="tdm")
    pipe.set_adapters(["tdm"], [1.0])
    merged = from_jax.jax_layout(pipe.transformer.state_dict(),
                                 stacks=from_jax.layer_stacks(pipe.transformer.cfg))
    student = tparams.load_file(str(out / "student.safetensors"))
    assert set(student) == set(merged)
    moved = 0
    for k, v in student.items():
        ref = merged[k].astype(np.float16).astype(np.float32)
        np.testing.assert_allclose(v.astype(np.float32), ref, rtol=1e-3, atol=1e-3, err_msg=k)
        moved += int(not np.array_equal(merged[k], from_jax.jax_layout(
            teacher, stacks=from_jax.layer_stacks(pipe.transformer.cfg))[k]))
    assert moved > 0

    monkeypatch.delenv("TDM_TINY_MODEL")
    built = []
    monkeypatch.setattr(tfamilies, "build", lambda *a, **kw: built.append(1))
    with pytest.raises(ValueError, match="--allow_pooled_standin"):
        train_tdm.main(["--device", "cpu", "--model_family", "sd3",
                        "--output_dir", str(tmp_path / "full")])
    assert not built
