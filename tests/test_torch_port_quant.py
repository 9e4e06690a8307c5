"""int8: the port's `ops/quant.py`, the rerouted `Dense`, `pipe.quant` in the
pipelines and the server, and `quant_forwards` in the TDM step, against the
JAX package's `tdm_tpu/ops/quant.py` on the same numpy inputs at tiny sizes.

Tolerances: `int8_dot` gives the JAX function's int8 codes exactly and its
outputs within one ulp of the output dtype (the same fp32 rescale; the two
packages' int32 products are exact). The gate decides as the JAX
interceptor on every (tokens, K, N) tried, and the set of rerouted calls of
each tiny family equals JAX's. The tiny int8 rollouts meet the committed
goldens at tests/test_golden_grids.py's own 5e-3 and stay within a relative
L2 of 0.15 of the bf16 goldens (tests/test_quant.py's bound). Both tests
lower the gates, in both packages, so the tiny models' layers reroute, as
the JAX tests do.
"""

import dataclasses
import math
import os
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu.core import sampling as jsampling, schedules as jsched, solvers as jsolvers
from tdm_tpu.models import (
    cogvideox as jcog, mmdit_sd3 as jmmdit, pixart as jpixart, t5 as jt5, unet_sd15 as junet,
)
from tdm_tpu.ops import quant as jq
from tdm_tpu.train import families as jfamilies, optim as jopt, tdm as jtdm
from tdm_tpu_torch.core import sampling as tsampling, schedules as tsched, solvers as tsolvers
from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.models import (
    cogvideox as tcog, layers as TL, mmdit_sd3 as tmmdit, pixart as tpixart, t5 as tt5,
    unet_sd15 as tunet,
)
from tdm_tpu_torch.ops import quant as tq
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ATOL_INT8 = 5e-3  # tests/test_golden_grids.py's int8 tolerance
REL_BF16 = 0.15  # tests/test_quant.py's bound of int8 against bf16


def set_gates(monkeypatch, tokens: int, min_dim: int, wide: int) -> None:
    """The same gates in both packages."""
    for mod in (jq, tq):
        monkeypatch.setattr(mod, "MIN_TOKENS", tokens)
        monkeypatch.setattr(mod, "MIN_DIM", min_dim)
        monkeypatch.setattr(mod, "WIDE_DIM", wide)


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x, np.float32)) for x in xs)


def jax_codes(monkeypatch, x, w):
    """JAX's int8_dot(x, w) and the int8 codes it hands its dot_general."""
    seen = []
    real = jq.jax.lax.dot_general

    def spy(a, b, *args, **kw):
        seen.append((np.asarray(a), np.asarray(b)))
        return real(a, b, *args, **kw)

    monkeypatch.setattr(jq.jax.lax, "dot_general", spy)
    out = jq.int8_dot(x, w)
    monkeypatch.setattr(jq.jax.lax, "dot_general", real)
    return np.asarray(out.astype(jnp.float32)), seen[0]


def ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    """One ulp of each value in `dtype` (fp32 or bf16)."""
    mant = 23 if dtype == "float32" else 7
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - mant)


# --- int8_dot and the gates ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["normal", "outlier_rows", "zero_input", "ragged_dims"])
def test_int8_dot_matches_jax(monkeypatch, case, dtype):
    """Equal int8 codes of both operands (the port's weight is the JAX
    kernel transposed) and outputs within one ulp of the output dtype."""
    rng = np.random.default_rng(3)
    k, n = (100, 36) if case == "ragged_dims" else (256, 128)
    x = rng.standard_normal((2, 33, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    if case == "outlier_rows":
        x[0, 0] *= 1e4
        x[1, :4] *= 1e-3
    if case == "zero_input":
        x[:] = 0
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    ref, (jxq, jwq) = jax_codes(monkeypatch, jx, jw)
    tdt = getattr(torch, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(np.ascontiguousarray(w.T)).to(tdt)
    xq, _ = tq.quantize_rows(tx)
    wq, _ = tq.quantize_rows(tw)
    np.testing.assert_array_equal(xq.numpy(), jxq)
    np.testing.assert_array_equal(wq.numpy().T, jwq)
    got = tq.int8_dot(tx, tw)
    assert got.dtype == tdt and got.shape == (2, 33, n)
    got = got.float().numpy()
    assert (np.abs(got - ref) <= ulp(ref, dtype)).all()
    if case == "zero_input":
        assert (got == 0).all()
    before = tq.int8_dot.launches
    assert tq.plain_int8_mm(xq.reshape(-1, k), wq).dtype == torch.int32
    assert tq.int8_dot.launches == before  # the CPU counts no launch


class _JDense(fnn.Module):
    n: int
    use_bias: bool = True

    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(self.n, use_bias=self.use_bias, dtype=jnp.bfloat16, name="d")(x)


@pytest.mark.parametrize("gates", ["production", "lowered"])
def test_gate_and_dense_match_jax(monkeypatch, gates):
    """For each (tokens, K, N, bias): whether the JAX interceptor reroutes a
    bf16 flax Dense and whether the port reroutes its bf16 Dense; where both
    do, their outputs (the bias added after the rescale, in bf16) within one
    bf16 ulp; a Dense left alone gives the plain product's bits."""
    if gates == "lowered":
        set_gates(monkeypatch, 64, 16, 48)
    shapes = [(256, 512, 512), (255, 512, 512), (300, 511, 1024), (300, 512, 16),
              (4, 2048, 2048), (64, 16, 48), (64, 48, 16), (63, 48, 48), (64, 16, 47)]
    rng = np.random.default_rng(5)
    for tokens, k, n in shapes:
        for bias in (True, False):
            x = rng.standard_normal((1, tokens, k)).astype(np.float32)
            jm = _JDense(n, bias)
            params = jax.tree.map(
                lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, k))))
            calls = []
            real = jq.int8_dot
            monkeypatch.setattr(jq, "int8_dot", lambda a, b: calls.append(1) or real(a, b))
            with jq.quantize_int8():
                ref = np.asarray(jm.apply(params, jnp.asarray(x).astype(jnp.bfloat16)),
                                 np.float32)
            monkeypatch.setattr(jq, "int8_dot", real)
            dense = TL.Dense(k, n, bias=bias, dtype=torch.bfloat16, param_dtype=torch.float32,
                             device="cpu")
            with torch.no_grad():
                dense.weight.copy_(torch.from_numpy(np.asarray(params["params"]["d"]["kernel"]).T))
                if bias:
                    dense.bias.copy_(torch.from_numpy(np.asarray(params["params"]["d"]["bias"])))
                tx = torch.from_numpy(x).to(torch.bfloat16)
                plain = dense(tx)
                with tq.quant_scope("int8"):
                    got = dense(tx)
            want = tq.gate(tokens, k, n)
            assert want == bool(calls), (tokens, k, n)
            assert torch.equal(got, plain) != want, (tokens, k, n)
            if want:
                got = got.float().numpy()
                assert (np.abs(got - ref) <= ulp(ref, "bfloat16")).all(), (tokens, k, n, bias)


def test_quant_scope_modes_match_jax():
    for mod in (jq, tq):
        with pytest.raises(ValueError, match="int8"):
            mod.quant_scope("fp4")
        with mod.quant_scope(None), mod.quant_scope("none"):
            pass
    with tq.quant_scope("int8"):
        assert tq.active()
        with tq.quant_scope("int8"):
            assert tq.active()
        assert tq.active()
    assert not tq.active()


def test_scope_is_the_calling_threads():
    """With the scope open on one thread, a T5 encode on another thread (as
    the server's handler threads encode while its worker samples) gives the
    bits it gives with no scope at all; on the scope's own thread it
    reroutes."""
    cfg = dataclasses.replace(tt5.T5Config.tiny(), dtype=torch.bfloat16)
    enc = tt5.T5Encoder(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / p.shape[-1] ** 0.5)
    ids = torch.randint(1, cfg.vocab_size, (4, 96))
    mask = torch.ones_like(ids)
    gates = (tq.MIN_TOKENS, tq.MIN_DIM, tq.WIDE_DIM)
    tq.MIN_TOKENS, tq.MIN_DIM, tq.WIDE_DIM = 1, 1, 1
    try:
        with torch.no_grad():
            plain = enc(ids, mask)
            opened, release, out = threading.Event(), threading.Event(), {}

            def sampler():
                with torch.no_grad(), tq.quant_scope("int8"):
                    opened.set()
                    out["int8"] = enc(ids, mask)
                    release.wait(30)

            th = threading.Thread(target=sampler)
            th.start()
            assert opened.wait(30)
            out["other"] = enc(ids, mask)
            release.set()
            th.join(30)
    finally:
        tq.MIN_TOKENS, tq.MIN_DIM, tq.WIDE_DIM = gates
    assert torch.equal(out["other"], plain)
    assert not torch.equal(out["int8"], plain)


# --- the rerouted calls of each tiny family ------------------------------------


def _family(name: str, b: int):
    """(jax denoise fn, port denoise fn, x, t, cond) of a tiny family on
    one JAX init, with `b` rows."""
    rng = np.random.default_rng(8)
    if name == "pixart":
        jcfg, tcfg = jpixart.PixArtConfig.tiny(), tpixart.PixArtConfig.tiny()
        jm = jpixart.PixArtTransformer2D(cfg=jcfg)
        x = rng.standard_normal((b, 4, 16, 16))
        cond = (rng.standard_normal((b, 8, jcfg.caption_dim)), np.ones((b, 8), np.int32))
        params = jm.init(jax.random.PRNGKey(0), x, np.zeros(b), *cond)["params"]
        tm = tpixart.PixArtTransformer2D(tcfg, device="cpu")
        jfn, tfn = jpixart.make_denoise_fn(jm, params), tpixart.make_denoise_fn(tm)
    elif name == "sd3":
        jcfg, tcfg = jmmdit.MMDiTConfig.tiny(), tmmdit.MMDiTConfig.tiny()
        jm = jmmdit.SD3Transformer2D(cfg=jcfg)
        x = rng.standard_normal((b, 16, 8, 8))
        cond = (rng.standard_normal((b, 6, jcfg.context_dim)),
                rng.standard_normal((b, jcfg.pooled_dim)))
        params = jm.init(jax.random.PRNGKey(0), x, np.zeros(b), *cond)["params"]
        tm = tmmdit.SD3Transformer2D(tcfg, device="cpu")
        jfn, tfn = jmmdit.make_denoise_fn(jm, params), tmmdit.make_denoise_fn(tm)
    elif name == "sd15":
        jcfg, tcfg = junet.UNetConfig.tiny(), tunet.UNetConfig.tiny()
        jm = junet.UNet2DCondition(cfg=jcfg)
        x = rng.standard_normal((b, 4, 16, 16))
        cond = (rng.standard_normal((b, 6, jcfg.context_dim)), np.ones((b, 6), np.int32))
        params = jm.init(jax.random.PRNGKey(0), x, np.zeros(b), *cond)["params"]
        tm = tunet.UNet2DCondition(tcfg, device="cpu")
        jfn, tfn = junet.make_denoise_fn(jm, params), tunet.make_denoise_fn(tm)
    else:
        jcfg, tcfg = jcog.CogVideoXConfig.tiny(), tcog.CogVideoXConfig.tiny()
        jm = jcog.CogVideoXTransformer3D(cfg=jcfg)
        x = rng.standard_normal((b, jcfg.in_channels, 3, 8, 8))
        cond = rng.standard_normal((b, jcfg.max_text_len, jcfg.text_dim))
        params = jm.init(jax.random.PRNGKey(0), x, np.zeros(b), cond)["params"]
        tm = tcog.CogVideoXTransformer3D(tcfg, device="cpu")
        jfn, tfn = jcog.make_denoise_fn(jm, params), tcog.make_denoise_fn(tm)
    tm.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(params), tm))
    x = x.astype(np.float32)
    t = np.full((b,), 500.0 if name != "sd3" else 0.5, np.float32)
    return jfn, tfn, x, t, cond


def _as_torch(cond):
    """A family's numpy conditioning as tensors: floats in fp32, masks as
    they are."""
    if isinstance(cond, tuple):
        return tuple(_as_torch(c) for c in cond)
    a = np.asarray(cond)
    return torch.from_numpy(a if a.dtype == np.int32 else a.astype(np.float32))


def rerouted_calls(monkeypatch, name: str, b: int):
    """The (tokens, K, N) of every call the JAX interceptor and the port's
    Dense reroute in one forward of the tiny family, as two sets."""
    jfn, tfn, x, t, cond = _family(name, b)
    jset, tset = set(), set()
    jreal, treal = jq.int8_dot, tq.int8_dot

    def jspy(a, w):
        jset.add((math.prod(a.shape[:-1]), w.shape[0], w.shape[1]))
        return jreal(a, w)

    def tspy(a, w):
        tset.add((math.prod(a.shape[:-1]), w.shape[1], w.shape[0]))
        return treal(a, w)

    monkeypatch.setattr(jq, "int8_dot", jspy)
    monkeypatch.setattr(tq, "int8_dot", tspy)
    jcond = tuple(jnp.asarray(c) for c in cond) if isinstance(cond, tuple) else jnp.asarray(cond)
    with jq.quantize_int8():
        jfn(jnp.asarray(x), jnp.asarray(t), jcond)
    with torch.no_grad(), tq.quant_scope("int8"):
        tfn(*_t(x, t), _as_torch(cond))
    monkeypatch.setattr(jq, "int8_dot", jreal)
    monkeypatch.setattr(tq, "int8_dot", treal)
    return jset, tset


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("family", ["pixart", "sd3", "sd15", "cogvideox"])
def test_rerouted_calls_match_jax(monkeypatch, family, b):
    """Gates lowered to the tiny widths (tokens 16, min and max dim 32): the
    token gate cuts across PixArt's caption K/V projections (8 tokens a
    row) between batch 1 and 2, as 256 rows do at full size between batch 2
    and 4, and admits the MLPs and the patch-token projections."""
    set_gates(monkeypatch, 16, 32, 32)
    jset, tset = rerouted_calls(monkeypatch, family, b)
    assert jset  # the gates admit some of the tiny layers...
    assert tset == jset


def test_zoo_widths_take_int_mm_unpadded():
    """Every width of the zoo's gated layers is a multiple of 8, so
    `torch._int_mm` takes them with no padding (the pad to 8 is for widths
    outside the zoo)."""
    widths = {
        "pixart": (1152, 4608, 4096),  # hidden, MLP, T5 caption
        "sd3": (1536, 6144, 4096),
        "sd15": (320, 640, 1280, 2560, 5120, 10240, 768),
        "cogvideox": (1920, 7680, 4096, 3840),
    }
    for fam, ws in widths.items():
        assert all(w % 8 == 0 for w in ws), fam


# --- the tiny int8 rollouts against the committed goldens ----------------------


def _pixart_golden_tuple():
    """tests/test_golden_grids.py's PixArt tuple (seeds 42, 43, 7)."""
    cfg = jpixart.PixArtConfig.tiny()
    model = jpixart.PixArtTransformer2D(cfg=cfg)
    b, seq = 2, 8
    noise = jax.random.normal(jax.random.PRNGKey(42), (b, 4, 16, 16))
    text = jax.random.normal(jax.random.PRNGKey(43), (b, seq, cfg.caption_dim)) * 0.1
    mask = jnp.ones((b, seq), jnp.int32)
    params = model.init(jax.random.PRNGKey(7), noise, jnp.zeros((b,)), text, mask)["params"]
    tm = tpixart.PixArtTransformer2D(tpixart.PixArtConfig.tiny(), device="cpu")
    tm.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(params), tm))
    return tm, _t(noise, text) + (torch.from_numpy(np.asarray(mask)),)


def _sd3_golden_tuple():
    """tests/test_golden_grids.py's SD3 tuple (seeds 8888, 44, 45, 9)."""
    cfg = jmmdit.MMDiTConfig.tiny()
    model = jmmdit.SD3Transformer2D(cfg=cfg)
    b = 2
    noise = jax.random.normal(jax.random.PRNGKey(8888),
                              (b, cfg.in_channels, cfg.sample_size, cfg.sample_size))
    ctx = jax.random.normal(jax.random.PRNGKey(44), (b, 6, cfg.context_dim)) * 0.1
    pooled = jax.random.normal(jax.random.PRNGKey(45), (b, cfg.pooled_dim)) * 0.1
    params = model.init(jax.random.PRNGKey(9), noise, jnp.zeros((b,)), ctx, pooled)["params"]
    tm = tmmdit.SD3Transformer2D(tmmdit.MMDiTConfig.tiny(), device="cpu")
    tm.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(params), tm))
    return tm, _t(noise, ctx, pooled)


def int8_rollout(family: str) -> torch.Tensor:
    """The tiny family's golden rollout, in fp32 under the int8 scope."""
    if family == "pixart":
        tm, (noise, text, mask) = _pixart_golden_tuple()
        with torch.no_grad(), tq.quant_scope("int8"):
            return tsampling.sample_fewstep(
                tpixart.make_denoise_fn(tm), tsched.ddpm_linear(device="cpu"), noise,
                (text, mask), timestep_grid=tsched.fewstep_grid(900, 4))
    tm, (noise, ctx, pooled) = _sd3_golden_tuple()
    with torch.no_grad(), tq.quant_scope("int8"):
        return tsolvers.sample_dpm_solver(tmmdit.make_denoise_fn(tm),
                                          tsolvers.flow_grid(4, flow_shift=6.0), noise,
                                          (ctx, pooled))


GOLDENS = {"pixart": ("pixart_tiny_4nfe_int8", "pixart_tiny_4nfe"),
           "sd3": ("sd3_tiny_4nfe_dpm_int8", "sd3_tiny_4nfe_dpm")}


@pytest.mark.parametrize("family", ["pixart", "sd3"])
def test_tiny_int8_rollout_matches_the_golden(monkeypatch, family):
    """Every gate at 1, as tests/test_golden_grids.py builds the int8
    goldens: the port's rollout meets the int8 golden at 5e-3 on all but
    0.1% of the elements; those few lie where an int8 code on a
    half-integer edge rounded the other way from the packages' fp32 inputs
    (one product moves by a quantum of its row's scale, and the later steps
    carry it), and are held to 1e-3 of the largest |golden| (measured: one
    element of 2048 in PixArt's, at 4e-4). The rollout differs from the
    bf16 golden (the route engaged) and stays within 0.15 of it."""
    set_gates(monkeypatch, 1, 1, 1)
    got = int8_rollout(family).numpy()
    q8, plain = (np.load(os.path.join(GOLDEN, f"{n}.npz"))["latents"] for n in GOLDENS[family])
    off = np.abs(got - q8) > ATOL_INT8 + ATOL_INT8 * np.abs(q8)
    assert off.mean() <= 1e-3, off.sum()
    assert np.abs(got - q8).max() <= 1e-3 * np.abs(q8).max()
    assert np.abs(got - plain).max() > 5e-4
    assert np.linalg.norm(got - plain) / np.linalg.norm(plain) < REL_BF16


# --- pipe.quant ---------------------------------------------------------------


def test_pipeline_quant_switch_scopes_the_sampler_only(monkeypatch):
    """pipe.quant = 'int8': the latents move off the plain ones but stay
    close, the decode runs outside the scope, None gives the plain bits back,
    and an unknown mode raises at the call (as tests/test_quant.py holds the
    JAX pipeline)."""
    from tdm_tpu_torch.models import vae as tvae
    from tdm_tpu_torch.pipelines import PixArtPipeline

    set_gates(monkeypatch, 1, 1, 1)
    tm, (noise, text, mask) = _pixart_golden_tuple()
    dec = tvae.TAESDDecoder(tvae.TAESDConfig(width=8, num_stages=1, blocks_per_stage=1),
                            device="cpu")
    pipe = PixArtPipeline(tm, vae_decoder=dec, device="cpu")
    kw = dict(prompt_embeds=(text, mask), latents=noise, height=128, width=128,
              num_inference_steps=2)
    base = pipe(**kw)
    seen = []
    real_fwd = tvae.TAESDDecoder.forward

    def spy(self, z):
        seen.append(tq.active())
        return real_fwd(self, z)

    monkeypatch.setattr(tvae.TAESDDecoder, "forward", spy)
    pipe.quant = "int8"
    q = pipe(**kw)
    assert seen == [False]
    assert not torch.equal(q.latents, base.latents)
    a, b_ = q.latents.float(), base.latents.float()
    assert float((a - b_).norm() / b_.norm()) < REL_BF16
    pipe.quant = None
    assert torch.equal(pipe(**kw).latents, base.latents)
    pipe.quant = "fp4"
    with pytest.raises(ValueError, match="int8"):
        pipe(**kw)


# --- quant_forwards -----------------------------------------------------------

BATCH, LR, ADAM_EPS = 2, 1e-4, 1e-4
UPDATE_TOL = {"dmd": 2e-2, "instruct": 1e-1}


def _jax_draws(rng, config, batch, shape):
    r_noise, r_seg, r_fresh = jax.random.split(rng, 3)
    z = jax.random.normal(r_noise, (batch, *shape), jnp.float32)
    r_seg2, r_t = jax.random.split(r_seg)
    seg = jax.random.randint(r_seg2, (batch,), config.min_seg, config.num_steps + 1)
    u = jax.random.uniform(r_t, (batch,))
    fresh = jax.random.normal(r_fresh, z.shape, jnp.float32)
    return ttdm.StepDraws(
        z=_t(z)[0], seg=torch.from_numpy(np.array(seg)).long(), u=_t(u)[0], fresh=_t(fresh)[0],
        critic_u=torch.zeros(0, batch), critic_eps=torch.zeros(0, batch, *shape))


@pytest.mark.parametrize("mode", ["dmd", "instruct"])
def test_quant_forwards_step_matches_jax(monkeypatch, mode):
    """One tiny PixArt step with quant_forwards on both sides (every gate at
    1), from one state: the losses, grad norms and updates within the
    bounds of tests/test_torch_port_train.py widened to 2e-2 relative for
    the losses and norms, and for the updates to a relative L2 of 2e-2
    ('dmd', measured 6e-3) or 1e-1 ('instruct', measured 5.7e-2), and to a
    fifth of the distance int8 itself moves the update from the plain step
    (30% and 58%): an int8 code on a half-integer edge may round the other
    way between the packages' fp32 inputs (each such flip moves one product
    by 1/127 of its row's scale), and 'instruct' regresses the student onto
    the teacher's CFG mix at cfg 4.5, which multiplies that error by 4.5
    before Adam normalises it; the step differs from the plain one; and the port
    quantizes exactly the forwards the JAX step wraps in q(): the student's
    4-step rollout, then the no-grad student x̂₀, the teacher's CFG probe
    and the critic's ε probe ('dmd'), or the critic's ε probe and the
    teacher's CFG target ('instruct'), each forward's Dense layers once."""
    set_gates(monkeypatch, 1, 1, 1)
    jb = jfamilies.build("pixart", tiny=True)
    tb = tfamilies.build("pixart", tiny=True, device="cpu")
    teacher = jb.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(14)
    text = rng.standard_normal((BATCH, 8, jb.embed_dim)).astype(np.float32)
    mask = np.ones((BATCH, 8), np.int32)
    cond, uncond = (text, mask), (np.zeros_like(text), np.ones_like(mask))
    rng_p = np.random.default_rng(16)
    student = jax.tree.map(
        lambda a: a * (1 + 0.05 * rng_p.standard_normal(a.shape).astype(np.float32)), teacher)
    tteacher = from_jax.state_dict_from_jax(from_jax.flatten_tree(teacher), tb.model)
    results, updates = {}, {}
    for quant in (True, False):
        config = jtdm.TDMConfig(loss_mode=mode, quant_forwards=quant)
        tconfig = ttdm.TDMConfig(loss_mode=mode, quant_forwards=quant)
        jtx = jopt.make_optimizer(LR, eps=ADAM_EPS)
        ttx = topt.make_optimizer(LR, eps=ADAM_EPS)
        jstate = jtdm.init_state(student, teacher, jtx, jtx)
        tstate = from_jax.train_state_from_jax(jstate, tb.model, device="cpu")
        before = {role: {k: v.clone() for k, v in getattr(tstate, role).items()}
                  for role in ("student", "critic")}
        jstep = jtdm.build_train_step(jb.denoise_fn, teacher, jb.schedule, config, jtx, jtx,
                                      sample_shape=jb.sample_shape)
        key = jax.random.PRNGKey(5)
        jnew, jm = jax.block_until_ready(jstep(
            jstate, key, tuple(jnp.asarray(x) for x in cond),
            tuple(jnp.asarray(x) for x in uncond), teacher))
        tstep = ttdm.build_train_step(tb.denoise_fn, tteacher, tb.schedule, tconfig, ttx, ttx,
                                      sample_shape=tb.sample_shape)
        calls, real = [], tq.int8_dot
        monkeypatch.setattr(tq, "int8_dot", lambda a, w: calls.append(a.shape[0]) or real(a, w))
        tnew, tm = tstep(tstate, _jax_draws(key, config, BATCH, jb.sample_shape),
                         _t(*cond[:1]) + (torch.from_numpy(mask),),
                         _t(*uncond[:1]) + (torch.from_numpy(uncond[1]),))
        monkeypatch.setattr(tq, "int8_dot", real)
        results[quant] = tm
        for role in ("student", "critic"):
            ref = from_jax.state_dict_from_jax(
                from_jax.flatten_tree(getattr(jnew, role)), tb.model)
            got = getattr(tnew, role)
            updates[quant, role] = (
                torch.cat([(v - before[role][k]).flatten() for k, v in ref.items()]),
                torch.cat([(got[k] - before[role][k]).flatten() for k in ref]))
        if not quant:
            assert calls == []
            continue
        n_dense = sum(isinstance(m, TL.Dense) for m in tb.model.modules())
        # rows of each rerouted forward: B for the student and critic
        # probes, 2B for the teacher's batched CFG pair
        rows = [BATCH] * 4 + {"dmd": [BATCH, 2 * BATCH, BATCH],
                              "instruct": [BATCH, 2 * BATCH]}[mode]
        assert len(calls) == n_dense * len(rows)
        assert sorted(set(calls)) == sorted(set(rows))
        for name in jtdm.StepMetrics._fields:
            j, t = float(getattr(jm, name)), float(getattr(tm, name))
            assert t == pytest.approx(j, rel=2e-2, abs=1e-6), name
    assert float(results[True].loss_student) != float(results[False].loss_student)
    for role in ("student", "critic"):
        d_ref, d_got = updates[True, role]
        effect = float((d_ref - updates[False, role][0]).norm())  # int8's own move
        assert float(d_ref.abs().max()) > 0.5 * LR, role
        assert float((d_got - d_ref).norm()) <= UPDATE_TOL[mode] * float(d_ref.norm()), role
        assert float((d_got - d_ref).norm()) <= 0.2 * effect, role
