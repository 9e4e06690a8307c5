"""The SD1.5 training slice against the JAX package on the CPU: the sd15
family bundle, the UNet's im2col convolution route, the tiny UNet's
gradients with and without remat, the weight and optimizer carry of a
UNet's train state, the port's own tiny sd15 step under remat, the
training CLI (`--model_family sd15`), the precision the server and the
trainer set, and (marked slow, outside tier-1) one sd15 TDM step from one
carried state.

Inputs come from numpy seeds and pass between the packages as numpy
arrays; everything is fp32, where the two differ in the order of sums.
Each tolerance says how much that grows through its computation.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode

from tdm_tpu.core import schedules as jsched
from tdm_tpu.lora import adapter as jlora, io as jlora_io
from tdm_tpu.train import families as jfamilies, optim as jopt, tdm as jtdm
from tdm_tpu_torch import device as tdevice
from tdm_tpu_torch.data.prompts import EmbeddingCache
from tdm_tpu_torch.io import from_jax, params as tparams
from tdm_tpu_torch.models import layers as tlayers, unet_sd15 as tunet
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm
from tests.test_torch_port_recipe import _nest
from tests.test_torch_port_train import (
    ADAM_EPS, LR, _jax_draws, _q8_decoded, _q8_leaves, _update_close,
)

torch.set_num_threads(2)

BATCH = 2


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) else jnp.dtype(dt).name


def _carry(tree, module):
    return from_jax.state_dict_from_jax(from_jax.flatten_tree(tree), module)


# --- the sd15 bundle -----------------------------------------------------------------


@pytest.mark.parametrize("tiny,resolution,ckpt,mp", [
    (True, 512, False, None), (True, 512, True, "bf16"), (False, 512, True, "bf16"),
    (False, 768, False, "no"), (False, 512, False, None),
])
def test_sd15_bundle_matches_jax(tiny, resolution, ckpt, mp):
    """Geometry, schedule, conditioning and model config of the sd15 bundle
    as the JAX package builds them (the scaled-linear tables bit for bit,
    77 CLIP tokens at 768 full size, 8 at 32 tiny, the latent side of
    --resolution); the full size on the meta device (no parameter is
    allocated). --mixed_precision bf16 computes in bf16 at full size and
    leaves the tiny config in fp32; the masters are fp32 either way."""
    kw = dict(tiny=tiny, resolution=resolution, gradient_checkpointing=ckpt, mixed_precision=mp)
    jb = jfamilies.build("sd15", **kw)
    tb = tfamilies.build("sd15", **kw, device="cpu" if tiny else "meta")
    assert tb.name == "sd15" and tb.sample_shape == jb.sample_shape
    assert (tb.seq_len, tb.embed_dim) == (jb.seq_len, jb.embed_dim)
    assert tb.schedule.prediction_type == jb.schedule.prediction_type == jsched.EPSILON
    if tiny:
        j = jsched.ddpm_scaled_linear()
        np.testing.assert_array_equal(tb.schedule.alphas.numpy(), np.asarray(j.alphas))
        np.testing.assert_array_equal(tb.schedule.sigmas.numpy(), np.asarray(j.sigmas))
    assert tb.schedule.alphas.shape == np.shape(jb.schedule.alphas)
    jc, tc = jb.model.cfg, tb.model.cfg
    for f in dataclasses.fields(jc):
        if f.name == "dtype":
            assert _dtype_name(tc.dtype) == _dtype_name(jc.dtype)
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.remat == ckpt
    assert all(p.dtype == torch.float32 for p in tb.model.parameters())
    text = torch.zeros(2, tb.seq_len, tb.embed_dim, device=tb.schedule.alphas.device)
    mask = torch.ones(2, tb.seq_len, device=text.device)
    assert tb.cond_of(text, mask) == (text, mask)
    assert tb.cond_of(text, mask, torch.ones(2, 5)) == (text, mask)  # pooled is ignored
    assert len(jb.cond_of(np.zeros((2, 3)), np.ones(2))) == 2


def test_sd15_bundle_converts_a_diffusers_unet_as_jax():
    """The bundle's `convert` loads a diffusers SD1.5 UNet state dict (the
    teacher directory's layout) into the tiny UNet: every parameter equals
    the JAX converter's tree carried by the weight carry."""
    from tdm_tpu.io import convert as jconvert
    from tdm_tpu_torch.io import manifest as tmanifest

    tb = tfamilies.build("sd15", tiny=True, device="cpu")
    shapes = tmanifest.expected_manifest("unet_sd15", tb.model.cfg)
    rng = np.random.default_rng(40)
    sd = {k: (0.05 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    got = tb.convert(sd)
    want = _carry(jconvert.unet_sd15_params(dict(sd), layers_per_block=1, n_stages=2),
                  tb.model)
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


# --- the convolution route --------------------------------------------------------------


class _CountConvolutions(TorchDispatchMode):
    """Counts the convolution operators (cuDNN's or PyTorch's own) the
    dispatcher runs."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "convolution" in func.__name__:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cin,cout,k,stride,pad,hw", [
    (6, 8, 3, 1, 1, 9),  # the ResBlocks' 3x3 convs, conv_in, conv_out, upsample
    (6, 8, 3, 2, 1, 9),  # the stride-2 downsample (odd side)
    (6, 8, 3, 2, 1, 8),
    (6, 8, 1, 1, 0, 7),  # the 1x1 conv_shortcut
])
def test_im2col_conv_matches_conv2d_and_its_gradients(cin, cout, k, stride, pad, hw):
    """`GemmConv2d` against `F.conv2d` in fp32 for every kernel, stride and
    padding the UNet uses: the output and the input, weight and bias
    gradients to 1e-5 (fp32 sums of the same products in another order);
    no convolution operator runs in its forward or backward."""
    rng = np.random.default_rng(hw + k + stride)
    conv = tlayers.GemmConv2d(cin, cout, k, stride=stride, padding=pad, dtype=torch.float32)
    with torch.no_grad():
        conv.weight.copy_(_t(rng.standard_normal(conv.weight.shape).astype(np.float32)))
        conv.bias.copy_(_t(rng.standard_normal(cout).astype(np.float32)))
    x = _t(rng.standard_normal((3, cin, hw, hw)).astype(np.float32)).requires_grad_(True)
    with _CountConvolutions() as counted:
        out = conv(x)
        g = _t(rng.standard_normal(out.shape).astype(np.float32))
        got = torch.autograd.grad(out, (x, conv.weight, conv.bias), g)
    assert counted.n == 0
    ref_out = F.conv2d(x, conv.weight, conv.bias, stride=stride, padding=pad)
    ref = torch.autograd.grad(ref_out, (x, conv.weight, conv.bias), g)
    assert out.shape == ref_out.shape
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    for name, a, b in zip(("dx", "dw", "db"), got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(1.0, float(b.abs().max())),
                                   msg=name)


def test_unet_never_writes_the_cudnn_switch(monkeypatch):
    """The tiny UNet under remat, forward and backward: every convolution
    module is a GemmConv2d, no convolution operator runs, and
    `torch.backends.cudnn.enabled` is read as it was before and never
    written (a property that records writes)."""
    cudnn_cls = type(torch.backends.cudnn)
    writes = []
    real = cudnn_cls.__dict__["enabled"]  # the descriptor itself
    monkeypatch.setattr(cudnn_cls, "enabled", property(
        lambda self: real.__get__(self, cudnn_cls),
        lambda self, v: writes.append(v)))
    before = torch.backends.cudnn.enabled
    cfg = dataclasses.replace(tunet.UNetConfig.tiny(), remat=True)
    unet = tunet.UNet2DCondition(cfg, device="cpu")
    convs = [m for m in unet.modules() if isinstance(m, torch.nn.Conv2d)]
    assert convs and all(isinstance(m, tlayers.GemmConv2d) for m in convs)
    rng = np.random.default_rng(41)
    lat = _t(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    ctx = _t(rng.standard_normal((2, 8, 32)).astype(np.float32))
    with _CountConvolutions() as counted:
        out = unet(lat, torch.tensor([10, 900]), ctx, torch.ones(2, 8, dtype=torch.int32))
        out.square().sum().backward()
    assert counted.n == 0 and not writes
    assert torch.backends.cudnn.enabled == before


# --- the tiny UNet under grad ------------------------------------------------------------


@pytest.fixture(scope="module")
def sd15_pair():
    """The tiny JAX and port sd15 bundles, one teacher (JAX's init, every
    leaf moved off it by 5%: zero-initialised output layers would hide a
    wiring fault), and (cond, uncond) as numpy (text, mask)."""
    jb = jfamilies.build("sd15", tiny=True)
    tb = tfamilies.build("sd15", tiny=True, device="cpu")
    rng = np.random.default_rng(42)
    teacher = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32)), jb.init_params(jax.random.PRNGKey(0)))
    text = rng.standard_normal((BATCH, 8, jb.embed_dim)).astype(np.float32)
    mask = np.ones((BATCH, 8), np.int32)
    mask[1, 5:] = 0
    cond = (text, mask)
    uncond = (np.zeros_like(text), np.ones_like(mask))
    return jb, tb, teacher, cond, uncond


def test_tiny_unet_gradients_match_jax(sd15_pair):
    """The port's forward and every parameter's gradient (plain attention
    and the im2col convolutions on the CPU) against jax.grad of the JAX
    UNet on the same weights, with remat off and on: the output to 1e-4 of
    its largest value, each gradient to 1e-4 of its largest value (fp32
    sums in another order through 4 ResBlocks and 4 transformers a side).
    The remat forward and gradients equal the plain ones to 1e-5."""
    jb, _, teacher, cond, _ = sd15_pair
    rng = np.random.default_rng(43)
    x = rng.standard_normal((BATCH, *jb.sample_shape)).astype(np.float32)
    t = np.array([750.0, 120.0], np.float32)
    text, mask = cond
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p):
        return jnp.sum(jb.model.apply({"params": p}, x, t, text, mask) * g)

    jl, jgrads = jax.value_and_grad(jloss)(teacher)
    jout = np.asarray(jb.model.apply({"params": teacher}, x, t, text, mask))
    got = {}
    for remat in (False, True):
        tb = tfamilies.build("sd15", tiny=True, gradient_checkpointing=remat, device="cpu")
        assert tb.model.cfg.remat == remat
        params = {k: v.requires_grad_(True) for k, v in _carry(teacher, tb.model).items()}
        out = functional_call(tb.model, params, (_t(x), _t(t), _t(text), _t(mask)))
        loss = (out * _t(g)).sum()
        got[remat] = (out.detach(), loss.detach(),
                      dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
        ref = _carry(jgrads, tb.model)
    for remat, (out, loss, grads) in got.items():
        np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-4 * np.abs(jout).max())
        assert float(loss) == pytest.approx(float(jl), rel=1e-4)
        assert set(ref) == set(grads)
        for k, r in ref.items():
            top = float(r.abs().max())
            assert float((grads[k] - r).abs().max()) <= 1e-4 * max(top, 1e-12), (remat, k)
    (out0, loss0, g0), (out1, loss1, g1) = got[False], got[True]
    torch.testing.assert_close(out1, out0, rtol=0, atol=1e-5)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0,
                                   atol=1e-5 * max(float(g0[k].abs().max()), 1e-12), msg=k)


# --- the UNet's train state carried from JAX -------------------------------------------------


def _random_moments(opt_state, params, rng, eight_bit):
    """`opt_state` with Adam's mu and nu drawn from `rng` (nu ≥ 0); an
    8-bit state's quantized leaves are quantized by the JAX package's own
    code."""
    if all(hasattr(opt_state, a) for a in ("mu", "nu", "count")):
        def draw(p, m, square):
            x = rng.standard_normal(np.shape(p)).astype(np.float32) * 1e-2
            x = x * x if square else x
            if eight_bit and isinstance(m, jopt._Q8Moment):
                return jopt._q8_quantize(jnp.asarray(x))
            return jnp.asarray(x)

        is_q = lambda v: isinstance(v, jopt._Q8Moment)  # noqa: E731
        mu = jax.tree.map(lambda p, m: draw(p, m, False), params, opt_state.mu, is_leaf=is_q)
        nu = jax.tree.map(lambda p, m: draw(p, m, True), params, opt_state.nu, is_leaf=is_q)
        return opt_state._replace(mu=mu, nu=nu, count=jnp.asarray(3, jnp.int32))
    if isinstance(opt_state, tuple):
        children = [_random_moments(c, params, rng, eight_bit) for c in opt_state]
        return type(opt_state)(*children) if hasattr(opt_state, "_fields") else tuple(children)
    return opt_state


def _to_port_layout(path, arr):
    """A JAX leaf in the port's layout: Dense kernels [in, out] → [out, in],
    conv kernels [kh, kw, in, out] → [out, in, kh, kw]."""
    arr = np.asarray(arr, np.float32)
    if path.endswith("/kernel"):
        return arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
    return arr


@pytest.mark.parametrize("eight_bit", [False, True], ids=["adamw", "adam8bit"])
def test_train_state_from_jax_carries_the_unet(sd15_pair, eight_bit):
    """A JAX TrainState of the tiny sd15 family with nonzero moments,
    AdamW and 8-bit Adam, carried leaf by leaf: every parameter and every
    moment in the port's layout, a conv kernel's moments transposed
    [kh,kw,in,out] → [out,in,kh,kw] as the kernel itself (checked against
    the transpose by hand); the 8-bit moments decoded, carried and
    quantized again over the port's leaves, each within one int8 code step
    (each side's) of JAX's decoded value."""
    jb, tb, teacher, _, _ = sd15_pair
    rng = np.random.default_rng(44)
    student = jax.tree.map(lambda a: a * 1.01, teacher)
    jtx = jopt.make_optimizer(LR, eight_bit=eight_bit)
    jstate = jtdm.init_state(student, teacher, jtx, jtx)
    jstate = jstate._replace(
        student_opt=_random_moments(jstate.student_opt, student, rng, eight_bit),
        critic_opt=_random_moments(jstate.critic_opt, teacher, rng, eight_bit))
    tstate = from_jax.train_state_from_jax(jstate, tb.model, device="cpu", eight_bit=eight_bit)
    convs = 0
    for role, jparams, jopt_state, tparams_, topt_state in (
            ("student", student, jstate.student_opt, tstate.student, tstate.student_opt),
            ("critic", teacher, jstate.critic_opt, tstate.critic, tstate.critic_opt)):
        flat = from_jax.flatten_tree(jparams)
        assert set(tparams_) == set(dict(tb.model.named_parameters()))
        adam = from_jax._adam_state(jopt_state)
        shapes = {k: np.shape(v) for k, v in flat.items()}
        for m in ("mu", "nu"):
            moments = getattr(adam, m)
            if eight_bit:
                views = topt.leaf_moments(getattr(topt_state, m), tparams_)
                jflat = from_jax._flat_moments(moments, shapes)
            else:
                views = getattr(topt_state, m)
                jflat = from_jax.flatten_tree(moments)
            for path, want in jflat.items():
                key = from_jax.port_key(path, None, ())
                want = _to_port_layout(path, want)
                assert tuple(tparams_[key].shape) == want.shape, (role, m, path)
                got = views[key]
                if isinstance(got, topt.Q8Moment):
                    got, err = _q8_decoded(got, want.shape)
                    values, scales = _q8_leaves(moments)[path]  # JAX quantized it too
                    _, jerr = _q8_decoded(topt.Q8Moment(_t(values), _t(scales)), shapes[path])
                    jerr = _t(_to_port_layout(path, jerr.numpy()))
                    bound = 1.01 * (err + jerr) + 1e-7
                    assert bool(((got - _t(want)).abs() <= bound).all()), (role, m, path)
                else:
                    np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{role} {m} {path}")
                if want.ndim == 4:
                    convs += 1
                    np.testing.assert_allclose(
                        want, np.asarray(jflat[path], np.float32).transpose(3, 2, 0, 1))
        for path, arr in flat.items():
            np.testing.assert_array_equal(
                tparams_[from_jax.port_key(path, None, ())].numpy(), _to_port_layout(path, arr))
    assert convs >= 4 * 11  # mu and nu of every conv kernel of both roles


# --- the port's own tiny sd15 step ------------------------------------------------------------


def test_tiny_sd15_step_is_the_same_under_remat():
    """The port's tiny sd15 'dmd' step with and without
    --gradient_checkpointing from one state, one set of draws: finite
    losses, and the same metrics and update of each role to 1e-5 (the
    remat recompute runs the same forward)."""
    gen = torch.Generator().manual_seed(45)
    results = {}
    teacher = None
    for remat in (False, True):
        tb = tfamilies.build("sd15", tiny=True, gradient_checkpointing=remat, seed=0,
                             device="cpu")
        teacher = teacher or tb.init_params()
        config = ttdm.TDMConfig()
        if remat is False:
            draws = ttdm.make_draws(config, BATCH, tb.sample_shape, gen, "cpu")
            text = torch.randn(BATCH, 8, tb.embed_dim, generator=gen)
            mask = torch.ones(BATCH, 8, dtype=torch.int32)
            mask[1, 3:] = 0
        tx = topt.make_optimizer(LR, eps=ADAM_EPS)
        state = ttdm.init_state(teacher, teacher, tx, tx)
        step = ttdm.build_train_step(tb.denoise_fn, teacher, tb.schedule, config, tx, tx,
                                     sample_shape=tb.sample_shape)
        new, metrics = step(state, draws, (text, mask),
                            (torch.zeros_like(text), torch.ones_like(mask)))
        results[remat] = (new, metrics)
    (plain, mp), (remat, mr) = results[False], results[True]
    for name in ttdm.StepMetrics._fields:
        a, b = float(getattr(mp, name)), float(getattr(mr, name))
        assert np.isfinite(a) and np.isfinite(b), name
        assert b == pytest.approx(a, rel=1e-5, abs=1e-7), name
    for role in ("student", "critic"):
        d_plain = torch.cat([(getattr(plain, role)[k] - teacher[k]).flatten() for k in teacher])
        d_remat = torch.cat([(getattr(remat, role)[k] - teacher[k]).flatten() for k in teacher])
        assert float(d_plain.abs().max()) > 0.5 * LR, role
        assert float((d_remat - d_plain).abs().max()) <= 1e-5 * float(d_plain.abs().max()), role


# --- the CLI ------------------------------------------------------------------------------------


def _taesd_dir(tmp_path):
    """A seeded diffusers AutoencoderTiny directory with 4 latent channels."""
    from tdm_tpu_torch.io import manifest as tmanifest
    from tdm_tpu_torch.models import vae as tvae

    d = tmp_path / "taesd"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"_class_name": "AutoencoderTiny",
                                               "latent_channels": 4}))
    tmanifest.write_synthetic("taesd", str(d / "diffusion_pytorch_model.safetensors"),
                              tvae.TAESDConfig(), seed=15, scale=0.05)
    return str(d)


def _clip_cache(path):
    """A tiny sd15 cache: 6 prompts of 8 tokens at 32 with ragged masks, the
    empty prompt, and dedicated rows for 2 of the 4 default validation
    prompts (the other 2 are main rows)."""
    rng = np.random.default_rng(46)
    EmbeddingCache(
        rng.standard_normal((6, 8, 32)).astype(np.float16),
        (np.arange(8)[None] < np.array([8, 5, 8, 2, 7, 8])[:, None]).astype(np.int32),
        ["a photo of a panda", "a photo of a pikachu", "c", "d", "e", "f"],
        uncond_embed=(0.1 * rng.standard_normal((8, 32))).astype(np.float16),
        uncond_mask=np.ones(8, np.int32),
        val_prompts=["a photo of a cat", "a photo of a dog"],
        val_embeds=rng.standard_normal((2, 8, 32)).astype(np.float16),
        val_masks=np.ones((2, 8), np.int32),
    ).save(path)


def _cli(tmp_path, *extra):
    from tdm_tpu_torch.cli import train_tdm

    train_tdm.main(["--device", "cpu", "--model_family", "sd15",
                    "--output_dir", str(tmp_path / "run"), "--seed", "0",
                    "--train_batch_size", "2", *extra])
    return tmp_path / "run_cfg4.5_steps900"


def test_cli_trains_sd15_checkpoints_resumes_and_exports(tmp_path, monkeypatch):
    """TDM_TINY_MODEL=1 --model_family sd15 --gradient_checkpointing from a
    CLIP cache: 2 steps with validation grids through a 4-channel TAESD,
    metrics.jsonl, a checkpoint that --resume_from_checkpoint latest takes,
    student.safetensors in the JAX package's UNet layout, and the rank-32
    kohya LoRA whose keys are the JAX exporter's for the same tiny UNet
    (save_kohya(extract_lora(teacher, student, 32)), prefix
    lora_transformer, as the JAX CLI writes for every family)."""
    from tdm_tpu.io import params as jparams

    cache = str(tmp_path / "cache.npz")
    _clip_cache(cache)
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.setenv("TDM_EMBEDDING_CACHE", cache)
    monkeypatch.setenv("TDM_TAESD_DIR", _taesd_dir(tmp_path))
    out = _cli(tmp_path, "--max_train_steps", "2", "--validation_steps", "2",
               "--gradient_checkpointing", "--lr_warmup_steps", "0", "--learning_rate", "1e-3")
    for k in (4, 1):  # 4 validation prompts at 64²: a 2 x 2 grid
        assert (out / f"validation_step2_{k}nfe.png").exists()
    lines = [json.loads(s) for s in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1]
    assert all(np.isfinite(v) for v in lines[0].values())
    meta = json.loads((out / "checkpoint-2" / "state.json").read_text())
    assert meta["student_count"] == 2 and meta["critic_count"] == 2

    tree = jparams.load_params(str(out / "student.safetensors"), to_jnp=False)
    init = jfamilies.build("sd15", tiny=True).init_params(jax.random.PRNGKey(0))
    jflat, tflat = from_jax.flatten_tree(init), from_jax.flatten_tree(tree)
    assert set(tflat) == set(jflat)
    assert all(tflat[k].shape == jflat[k].shape for k in jflat)

    teacher = tfamilies.build("sd15", tiny=True, seed=0, device="cpu").init_params()
    student = {k: torch.from_numpy(v) for k, v in tparams.load_file(
        str(out / "checkpoint-2" / "student.safetensors")).items()}
    ref_path = str(tmp_path / "jax_lora.safetensors")
    jlora_io.save_kohya(
        jlora.extract_lora(_nest(from_jax.jax_layout(teacher, stacks=())),
                           _nest(from_jax.jax_layout(student, stacks=())), 32),
        ref_path, prefix="lora_transformer")
    got = tparams.load_file(str(out / "tdm_lora.safetensors"))
    want = tparams.load_file(ref_path)
    assert set(got) == set(want)
    assert any(k.startswith("lora_transformer_mid_attn_transformer_blocks_0_attn2_to_q.")
               for k in got)

    _cli(tmp_path, "--max_train_steps", "3", "--gradient_checkpointing", "--lr_warmup_steps",
         "0", "--resume_from_checkpoint", "latest")
    meta = json.loads((out / "checkpoint-3" / "state.json").read_text())
    assert meta["student_count"] == 3 and meta["critic_count"] == 3


# --- precision ---------------------------------------------------------------------------------


class _Stop(Exception):
    pass


def test_server_and_trainer_set_fp32_precision(tmp_path, monkeypatch):
    """Before any model is built, the server's set-up and the trainer's set
    the fp32 precision of cuBLAS and cuDNN themselves: TF32 off (whatever
    the process had), on only under the trainer's --allow_tf32."""
    from tdm_tpu_torch import pipelines
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.serve import server as tserver

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    def set_flags(on):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on

    saved = flags()
    seen = {}

    def record(name):
        def stop(*a, **kw):
            seen[name] = flags()
            raise _Stop
        return stop

    try:
        monkeypatch.setattr(pipelines, "from_pretrained", record("server"))
        set_flags(True)
        with pytest.raises(_Stop):
            tserver.build_server(tserver.parse_args(["--model", str(tmp_path), "--device",
                                                     "cpu"]))
        assert seen["server"] == (False, False)
        monkeypatch.setattr(tfamilies, "build", record("train"))
        for extra, want in (([], (False, False)), (["--allow_tf32"], (True, True))):
            set_flags(not want[0])
            with pytest.raises(_Stop):
                train_tdm.main(["--device", "cpu", "--model_family", "sd15", "--output_dir",
                                str(tmp_path / "run"), *extra])
            assert seen["train"] == want
        tdevice.set_fp32_precision()
        assert flags() == (False, False)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# --- one sd15 TDM step against JAX (slow: the JAX step's compile) -------------------------------


@pytest.mark.slow
def test_sd15_dmd_step_matches_jax(sd15_pair):
    """One 'dmd' step of the tiny sd15 family (critic_updates 1, MSE) from
    one state (the JAX state carried by train_state_from_jax), JAX's
    draws: both losses and grad norms to 1e-4 relative; each role's update
    to the bounds of the sd3 step (tests/test_torch_port_sd3_train.py).
    Marked slow: the JAX step's compile alone takes about 108 s on one CPU
    process, where the rest of this file takes seconds."""
    jb, tb, teacher, cond, uncond = sd15_pair
    config = jtdm.TDMConfig(critic_updates=1, use_huber=False)
    tconfig = ttdm.TDMConfig(critic_updates=1, use_huber=False)
    jtx = jopt.make_optimizer(LR, eps=ADAM_EPS)
    ttx = topt.make_optimizer(LR, eps=ADAM_EPS)
    rng_p = np.random.default_rng(47)
    student = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng_p.standard_normal(a.shape).astype(np.float32)), teacher)
    jstate = jtdm.init_state(student, teacher, jtx, jtx)
    tstate = from_jax.train_state_from_jax(jstate, tb.model, device="cpu")
    tteacher = _carry(teacher, tb.model)
    before = {r: {k: v.clone() for k, v in getattr(tstate, r).items()}
              for r in ("student", "critic")}
    jcond, juncond = (tuple(jnp.asarray(a) for a in c) for c in (cond, uncond))
    tcond, tuncond = (tuple(_t(a) for a in c) for c in (cond, uncond))
    jstep = jtdm.build_train_step(jb.denoise_fn, teacher, jb.schedule, config, jtx, jtx,
                                  sample_shape=jb.sample_shape)
    rng = jax.random.PRNGKey(8)
    jnew, jm = jax.block_until_ready(jstep(jstate, rng, jcond, juncond, teacher))
    tstep = ttdm.build_train_step(tb.denoise_fn, tteacher, tb.schedule, tconfig, ttx, ttx,
                                  sample_shape=tb.sample_shape)
    tnew, tm = tstep(tstate, _jax_draws(rng, config, BATCH, jb.sample_shape), tcond, tuncond)
    for name in jtdm.StepMetrics._fields:
        assert float(getattr(tm, name)) == pytest.approx(
            float(getattr(jm, name)), rel=1e-4, abs=1e-7), name
    for role in ("student", "critic"):
        _update_close(before[role], _carry(getattr(jnew, role), tb.model),
                      getattr(tnew, role), role)
