"""The port's distill probe (`tdm_tpu_torch/eval/distill_probe.py`) against
the JAX package's (`tdm_tpu/eval/distill_probe.py`) on the CPU.

The port carries the JAX basis as constants and draws everything else from
torch generators, so every stage here is fed the JAX module's own starting
weights (carried by `io/from_jax`) and the draws its key splits make. Each
tolerance says how far fp32 rounding grows through its computation. The
quality bars of `tests/test_tdm_image_e2e.py` belong to the full-length run
on the card (`chip_smoke.py`); `run_probe` runs here at a few steps per
stage, for its plumbing only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu.eval import distill_probe as jprobe
from tdm_tpu.train import tdm as jtdm
from tdm_tpu_torch.eval import distill_probe as tprobe
from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.models import vae as tvae
from tdm_tpu_torch.train import tdm as ttdm

torch.set_num_threads(2)

# run_probe's keys in the JAX module (its return statement)
JAX_KEYS = {"err_teacher_50nfe", "err_student_4nfe_before", "err_student_4nfe_after",
            "gap_closure", "decoder_loss", "teacher_dsm_loss", "loss_student_final",
            "distill_steps"}


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _jax_teacher_init():
    return jprobe.ToyLatentDenoiser().init(
        jax.random.PRNGKey(3), jnp.zeros((1, *jprobe.LAT_SHAPE)), jnp.zeros((1,)),
        jnp.zeros((1, 1)))["params"]


def _jax_decoder_init():
    return jprobe.vae.TAESDDecoder(jprobe.DEC_CFG).init(
        jax.random.PRNGKey(1), jnp.zeros((1, *jprobe.LAT_SHAPE)))["params"]


def _carried(tree, module):
    return from_jax.state_dict_from_jax(from_jax.flatten_tree(tree), module)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_basis_is_jax_exactly():
    np.testing.assert_array_equal(tprobe._A, np.asarray(jprobe._A))
    np.testing.assert_array_equal(tprobe._B, np.asarray(jprobe._B))
    assert tprobe._A.dtype == np.float32 and tprobe._A.shape == jprobe.LAT_SHAPE


def test_manifold_latents_and_images_match():
    theta = np.random.default_rng(0).uniform(0, 2 * np.pi, 64).astype(np.float32)
    for name in ("manifold_latents", "manifold_images"):
        ref = np.asarray(getattr(jprobe, name)(jnp.asarray(theta)))
        got = getattr(tprobe, name)(_t(theta)).numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=name)


def test_denoiser_and_decoder_with_carried_weights_match():
    """The toy ε-model and the probe's TAESD from the JAX init, to 1e-5 of
    the output's scale (fp32 through five Dense layers, or the decoder's
    twelve 3×3 convolutions)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, *jprobe.LAT_SHAPE)).astype(np.float32)
    t = rng.integers(0, 1000, 8).astype(np.int32)
    cond = np.ones((8, 1), np.float32)
    jparams = _jax_teacher_init()
    ref = np.asarray(jprobe.ToyLatentDenoiser().apply({"params": jparams}, x, t, cond))
    model = tprobe.ToyLatentDenoiser(device="cpu")
    model.load_state_dict(_carried(jparams, model))
    got = model(_t(x), _t(t), _t(cond)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    dparams = _jax_decoder_init()
    ref = np.asarray(jprobe.vae.TAESDDecoder(jprobe.DEC_CFG).apply({"params": dparams}, x))
    dec = tvae.TAESDDecoder(tprobe.DEC_CFG, device="cpu")
    dec.load_state_dict(_carried(dparams, dec))
    got = dec(_t(x)).detach().numpy()
    assert got.shape == (8, 3, tprobe.IMG, tprobe.IMG)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_flax_init_statistics():
    """flax's lecun_normal: zero biases, kernels inside ±2σ with σ² =
    1/fan_in of the truncated normal (unit normal truncated at ±2, then
    rescaled by 1/0.8796); the std over 256×256 draws within 2%."""
    model = tprobe.ToyLatentDenoiser(device="cpu")
    tprobe.flax_init_(model, torch.Generator().manual_seed(3))
    w = model.d1.weight.detach()
    std = (1 / 256) ** 0.5
    assert float(w.std()) == pytest.approx(std, rel=0.02)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert float(model.out.bias.abs().max()) == 0.0


def test_one_dsm_step_matches_jax():
    """`train_teacher(steps=1)` from the JAX init with the JAX draws (its
    own key splits): the loss and the updated weights to 1e-4 relative
    (Adam's first step moves each weight by lr·g/(|g|+ε) ≈ lr·sign(g), so
    a roundoff-level gradient can take the other sign: relative L2 over
    the whole tree)."""
    _, jparams, _, _, jloss = jprobe.train_teacher(steps=1)
    key = jax.random.split(jax.random.PRNGKey(4))[1]
    kd, kt, ke, kj = jax.random.split(key, 4)
    draws = tprobe.DSMDraws(
        theta=_t(jax.random.uniform(kd, (512,), maxval=2 * np.pi)),
        jitter=_t(jax.random.normal(kj, (512, *jprobe.LAT_SHAPE))),
        t=_t(jax.random.randint(kt, (512,), 0, 1000)).long(),
        eps=_t(jax.random.normal(ke, (512, *jprobe.LAT_SHAPE))))
    model = tprobe.ToyLatentDenoiser(device="cpu")
    _, params, _, _, loss = tprobe.train_teacher(
        1, device="cpu", params=_carried(_jax_teacher_init(), model), draws=[draws])
    assert loss == pytest.approx(jloss, rel=1e-4)
    ref = _carried(jparams, model)
    for k, v in ref.items():
        assert _rel(params[k], v) <= 1e-4, k


def test_one_decoder_step_matches_jax():
    """`train_decoder(steps=1)` from the JAX init with the JAX θ: the loss
    (computed before the update) and the decoded images after it, to 1e-4
    relative."""
    jdecode, jloss = jprobe.train_decoder(steps=1)
    theta = _t(jax.random.uniform(jax.random.split(jax.random.PRNGKey(2))[1], (128,),
                                  maxval=2 * np.pi))
    dec = tvae.TAESDDecoder(tprobe.DEC_CFG, device="cpu")
    decode, loss = tprobe.train_decoder(
        1, device="cpu", params=_carried(_jax_decoder_init(), dec), draws=[theta])
    assert loss == pytest.approx(jloss, rel=1e-4)
    z = np.random.default_rng(2).standard_normal((16, *jprobe.LAT_SHAPE)).astype(np.float32)
    assert _rel(decode(_t(z)).numpy(), np.asarray(jdecode(jnp.asarray(z)))) <= 1e-4


def _jax_tdm_draws(rng, config, batch, shape):
    """The draws the JAX TDM step makes inside itself, by its key splits."""
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
    return ttdm.StepDraws(z=_t(z), seg=_t(seg).long(), u=_t(u), fresh=_t(fresh),
                          critic_u=_t(np.stack(cu)), critic_eps=_t(np.stack(ce)))


def test_distill_config_matches_jax():
    import dataclasses

    jc = jtdm.TDMConfig(total_steps=900, num_steps=4, cfg=1.0, use_huber=True,
                        use_separate=True, student_cfg_in_loss=False, critic_updates=5)
    assert dataclasses.asdict(tprobe.distill_config()) == dataclasses.asdict(jc)


def test_one_distill_step_matches_jax():
    """One `distill` step (4-NFE rollout, five critic updates, the student
    update) from the JAX teacher's init, with the draws of JAX's key 7:
    the step's metrics and the updated student and critic to 1e-4
    relative (relative L2 over each tree; the losses pass through the
    trajectory's 1/α ≈ 60× at t = 899)."""
    jteacher = _jax_teacher_init()
    model = jprobe.ToyLatentDenoiser()

    def jdenoise(p, x, t, cond):
        return model.apply({"params": p}, x, t, cond)

    jstate, jm = jprobe.distill(jdenoise, jteacher, jprobe.sched.ddpm_linear(), steps=1)
    ks = jax.random.split(jax.random.PRNGKey(7))[1]
    draws = _jax_tdm_draws(ks, tprobe.distill_config(), 128, jprobe.LAT_SHAPE)
    tmodel = tprobe.ToyLatentDenoiser(device="cpu")
    teacher = _carried(jteacher, tmodel)
    tmodel.requires_grad_(False)
    state, tm = tprobe.distill(tprobe.toy_denoise_fn(tmodel), teacher,
                               tprobe.sched.ddpm_linear(device="cpu"), 1, draws=[draws])
    for name in jtdm.StepMetrics._fields:
        assert float(getattr(tm, name)) == pytest.approx(float(getattr(jm, name)), rel=1e-4), name
    assert state.critic_opt.count == 5 and state.student_opt.count == 1
    for role in ("student", "critic"):
        ref = _carried(getattr(jstate, role), tmodel)
        got = getattr(state, role)
        moved = max(float((ref[k] - teacher[k]).abs().max()) for k in ref)
        assert moved > 1e-4, role  # the update reached the weights
        for k, v in ref.items():
            assert _rel(got[k], v) <= 1e-4, (role, k)


def test_decoded_manifold_error_matches_jax():
    """The same decoder (the JAX init, carried) on both sides and latents
    off the ring: the error to 1e-5 relative (the ‖a‖² − 2a·b + ‖b‖²
    expansion cancels to the distance's square, so a sample well off the
    manifold keeps fp32's relative error small)."""
    dparams = _jax_decoder_init()
    jdec = jprobe.vae.TAESDDecoder(jprobe.DEC_CFG)
    dec = tvae.TAESDDecoder(tprobe.DEC_CFG, device="cpu")
    dec.load_state_dict(_carried(dparams, dec))
    rng = np.random.default_rng(3)
    theta = rng.uniform(0, 2 * np.pi, 32).astype(np.float32)
    z = (np.asarray(jprobe.manifold_latents(jnp.asarray(theta)))
         + 0.5 * rng.standard_normal((32, *jprobe.LAT_SHAPE))).astype(np.float32)
    ref = jprobe.decoded_manifold_error(lambda v: jdec.apply({"params": dparams}, v),
                                        jnp.asarray(z))
    with torch.no_grad():
        got = tprobe.decoded_manifold_error(dec, _t(z))
    assert got == pytest.approx(ref, rel=1e-5)


def test_sample_grid_matches_jax():
    """The few-step sampler at 4 and 50 NFE from one noise draw through the
    carried teacher init: to 1e-4 of the sample's scale."""
    jteacher = _jax_teacher_init()
    model = jprobe.ToyLatentDenoiser()

    def jdenoise(p, x, t, cond):
        return model.apply({"params": p}, x, t, cond)

    key = jax.random.PRNGKey(42)
    noise = _t(jax.random.normal(key, (16, *jprobe.LAT_SHAPE)))
    tmodel = tprobe.ToyLatentDenoiser(device="cpu")
    teacher = _carried(jteacher, tmodel)
    for steps in (4, 50):
        ref = np.asarray(jprobe.sample_grid(jdenoise, jteacher, jprobe.sched.ddpm_linear(),
                                            key, 16, steps))
        got = tprobe.sample_grid(tprobe.toy_denoise_fn(tmodel), teacher,
                                 tprobe.sched.ddpm_linear(device="cpu"), noise, steps).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_run_probe_end_to_end_at_a_few_steps(monkeypatch):
    import functools

    for name in ("train_decoder", "train_teacher"):
        monkeypatch.setattr(tprobe, name, functools.partial(getattr(tprobe, name), 3))
    timings = {}
    out = tprobe.run_probe(distill_steps=2, n_eval=16, device="cpu", timings=timings)
    assert set(out) == JAX_KEYS
    assert out["distill_steps"] == 2
    assert all(np.isfinite(v) for v in out.values())
    assert set(timings) == {"decoder_s", "teacher_s", "eval_before_s", "distill_s",
                            "eval_after_s"}
    assert out["gap_closure"] == pytest.approx(
        1 - (out["err_student_4nfe_after"] - out["err_teacher_50nfe"])
        / (out["err_student_4nfe_before"] - out["err_teacher_50nfe"]))
