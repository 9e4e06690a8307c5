"""The SD3 serving slice against the JAX package: the MMDiT, the solvers
and grids, the LoRA files and merge, the pipeline, its loader and the
server, at tiny sizes on the CPU.

Inputs, weights and noise are made with numpy from a seed (or by JAX, for
the committed goldens) and handed to both packages. Models and solvers run
in fp32, where the two differ only in the order of sums: ~1e-5. The
pipelines round the sampler state to bf16 at every step in both packages
(as tests/test_torch_port_pipeline.py explains), so pipeline latents are
held to one bf16 ulp of their scale with under 1% of elements differing,
and images to 2e-3, half a step of the 8-bit PNG they are served as.
"""

import base64
import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu import lora as jlora
from tdm_tpu.core import schedules as jsched, solvers as jsolvers
from tdm_tpu.models import mmdit_sd3 as jmmdit, vae as jvae
from tdm_tpu.pipelines.sd3 import SD3Pipeline as JaxSD3Pipeline
from tdm_tpu_torch.core import schedules as tsched, solvers as tsolvers
from tdm_tpu_torch.data.prompts import EmbeddingCache, pack_family_cond
from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.lora import adapter as tadapter, io as tlora_io
from tdm_tpu_torch.models import mmdit_sd3 as tmmdit
from tdm_tpu_torch.ops import attention as tattn
from tdm_tpu_torch.pipelines import from_pretrained, save_pretrained
from tdm_tpu_torch.pipelines.sd3 import SD3Pipeline, default_sd3_pipeline
from tdm_tpu_torch.serve import batcher as tbatcher, server as tserver

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_ATOL = 5e-4  # tests/test_golden_grids.py's tolerance
LAT = 8  # the tiny config's latent side: 64px images


def port_config(jcfg, **kw) -> tmmdit.MMDiTConfig:
    """The port's config with the JAX config's fields (dtype fp32)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name != "dtype"}
    return tmmdit.MMDiTConfig(**{**fields, **kw}, dtype=torch.float32)


def variant(name: str, scan: bool) -> jmmdit.MMDiTConfig:
    cfg = jmmdit.MMDiTConfig.tiny()
    if name == "sd35":  # qk RMSNorm, a dual-attention prefix, 3 layers
        cfg = dataclasses.replace(cfg, num_layers=3, qk_norm="rms", dual_attention_layers=(0,))
    return dataclasses.replace(cfg, scan_layers=scan)


def jax_model(cfg, seed=1, b=2):
    """A JAX MMDiT with every parameter moved off its init (zero-initialised
    gates would hide a wiring fault)."""
    model = jmmdit.SD3Transformer2D(cfg=cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((b, 16, LAT, LAT)),
                        jnp.zeros((b,)), jnp.zeros((b, 6, cfg.context_dim)),
                        jnp.zeros((b, cfg.pooled_dim)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    return model, params


def port_model(cfg, params, **kw):
    tm = tmmdit.SD3Transformer2D(port_config(cfg, **kw), device="cpu")
    tm.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(params), tm))
    return tm


def inputs(seed, b=2, ctx_len=6, cfg=None):
    cfg = cfg or jmmdit.MMDiTConfig.tiny()
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 16, LAT, LAT)).astype(np.float32),
            rng.uniform(0, 1000, size=b).astype(np.float32),
            rng.standard_normal((b, ctx_len, cfg.context_dim)).astype(np.float32),
            rng.standard_normal((b, cfg.pooled_dim)).astype(np.float32))


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


# --- the MMDiT ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["sd3", "sd35"])
@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_mmdit_matches_jax(name, scan):
    """The tiny MMDiT forward in both layer layouts of the JAX package (the
    scanned `blocks_dual`/`blocks` stacks plus the unrolled last block, or
    `blocks_{i}`), and the inverse carry back to the JAX tree, bit for bit."""
    cfg = variant(name, scan)
    model, params = jax_model(cfg)
    x, t, ctx, pooled = inputs(3, cfg=cfg)
    ref = np.asarray(model.apply({"params": params}, x, t, ctx, pooled))
    tm = port_model(cfg, params)
    with torch.no_grad():
        got = tm(*_t(x, t, ctx, pooled)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    flat = from_jax.flatten_tree(params)
    back = from_jax.jax_layout(tm.state_dict(), stacks=from_jax.layer_stacks(tm.cfg))
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_mmdit_presets_match_jax():
    for preset in ("sd35_medium", "sd35_large", "tiny"):
        j, t = getattr(jmmdit.MMDiTConfig, preset)(), getattr(tmmdit.MMDiTConfig, preset)()
        for f in dataclasses.fields(j):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), (preset, f.name)
    c = tmmdit.MMDiTConfig()  # SD3-Medium
    assert (c.num_layers, c.num_heads, c.head_dim, c.hidden, c.context_dim, c.pooled_dim,
            c.attn_impl, c.dtype) == (24, 24, 64, 1536, 4096, 2048, "auto", torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous prefix"):
        tmmdit.SD3Transformer2D(dataclasses.replace(
            tmmdit.MMDiTConfig.tiny(), dual_attention_layers=(1,), num_layers=3), device="cpu")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tmmdit.SD3Transformer2D(dataclasses.replace(
            tmmdit.MMDiTConfig.tiny(), attn_impl="flash3"), device="cpu")


def test_mmdit_joint_attention_takes_the_splash_route(monkeypatch):
    """attn_impl='splash' at head dim 64: every joint attention (and the
    dual branch's self-attention) goes through the splash wrapper, with the
    same output as the flash route."""
    cfg = dataclasses.replace(variant("sd35", True), head_dim=64)
    _, params = jax_model(cfg)
    calls = []
    wrapper = tattn.splash_attention_fwd
    monkeypatch.setattr(tattn, "splash_attention_fwd",
                        lambda *a: calls.append(a[0].shape) or wrapper(*a))
    x, t, ctx, pooled = inputs(4, cfg=cfg)
    with torch.no_grad():
        got = port_model(cfg, params, attn_impl="splash")(*_t(x, t, ctx, pooled))
        assert len(calls) == 3 + 1  # 3 joint blocks + one dual block's attn2
        assert calls[0] == (2, 2, 16 + 6, 64)  # 4x4 image tokens + 6 text tokens
        ref = port_model(cfg, params, attn_impl="xla")(*_t(x, t, ctx, pooled))
    assert len(calls) == 4
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


# --- grids and solvers --------------------------------------------------------


@pytest.mark.parametrize("steps,shift", [(4, 6.0), (4, 1.0), (28, 3.0), (1, 6.0)])
def test_flow_grid_matches_jax(steps, shift):
    j = jsolvers.flow_grid(steps, flow_shift=shift)
    t = tsolvers.flow_grid(steps, flow_shift=shift)
    for name in ("model_t", "alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.prediction_type == j.prediction_type == "flow" and t.num_steps == steps


@pytest.mark.parametrize("spacing", ["linspace", "leading", "trailing"])
def test_ddpm_grid_matches_jax(spacing):
    j = jsolvers.ddpm_grid(jsched.ddpm_linear(), 4, timestep_spacing=spacing, steps_offset=1)
    t = tsolvers.ddpm_grid(tsched.ddpm_linear(device="cpu"), 4, timestep_spacing=spacing,
                           steps_offset=1)
    for name in ("model_t", "alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    with pytest.raises(ValueError, match="timestep_spacing"):
        tsolvers.ddpm_grid(tsched.ddpm_linear(device="cpu"), 4, timestep_spacing="karras")


def _analytic(xp):
    """A smooth denoiser written once for either array library: the output
    depends on x, t and the conditioning, so every solver coefficient
    shows."""
    def fn(x, t, cond):
        return xp.tanh(0.7 * x + cond) * (0.5 + t[:, None, None, None] / 2000.0)
    return fn


@pytest.mark.parametrize("solver", ["dpm", "unipc", "unipc_order1", "unipc_bh1_nocorr", "lcm"])
@pytest.mark.parametrize("grid", ["flow", "ddpm"])
def test_solvers_match_jax(solver, grid):
    """Each loop against the JAX scan in fp32, with CFG on (a distinct
    unconditional branch) and off. LCM gets JAX's own per-step draws."""
    rng = np.random.default_rng(5)
    noise = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    cond = rng.standard_normal((2, 3, 4, 4)).astype(np.float32) * 0.3
    uncond = rng.standard_normal((2, 3, 4, 4)).astype(np.float32) * 0.3
    if grid == "flow":
        jg, tg = jsolvers.flow_grid(4, flow_shift=6.0), tsolvers.flow_grid(4, flow_shift=6.0)
    else:
        jg = jsolvers.ddpm_grid(jsched.ddpm_linear(), 4)
        tg = tsolvers.ddpm_grid(tsched.ddpm_linear(device="cpu"), 4)
    kw = {"unipc_order1": dict(solver_order=1),
          "unipc_bh1_nocorr": dict(solver_type="bh1", corrector=False)}.get(solver, {})
    for cfg in (None, 3.0):
        ju = None if cfg is None else jnp.asarray(uncond)
        tu = None if cfg is None else torch.from_numpy(uncond)
        if solver == "dpm":
            ref = jsolvers.sample_dpm_solver(_analytic(jnp), jg, jnp.asarray(noise),
                                             jnp.asarray(cond), uncond=ju, cfg=cfg)
            got = tsolvers.sample_dpm_solver(_analytic(torch), tg, torch.from_numpy(noise),
                                             torch.from_numpy(cond), uncond=tu, cfg=cfg)
        elif solver == "lcm":
            key = jax.random.PRNGKey(17)
            draws = [np.asarray(jax.random.normal(k, noise.shape, jnp.float32))
                     for k in jax.random.split(key, 4)]
            ref = jsolvers.sample_lcm(_analytic(jnp), jg, jnp.asarray(noise), jnp.asarray(cond),
                                      rng=key, uncond=ju, cfg=cfg)
            got = tsolvers.sample_lcm(_analytic(torch), tg, torch.from_numpy(noise),
                                      torch.from_numpy(cond), step_noise=draws,
                                      uncond=tu, cfg=cfg)
        else:
            ref = jsolvers.sample_unipc(_analytic(jnp), jg, jnp.asarray(noise),
                                        jnp.asarray(cond), uncond=ju, cfg=cfg, **kw)
            got = tsolvers.sample_unipc(_analytic(torch), tg, torch.from_numpy(noise),
                                        torch.from_numpy(cond), uncond=tu, cfg=cfg, **kw)
        ref = np.asarray(ref)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())


def test_solver_state_keeps_the_noise_dtype():
    """bf16 noise keeps a bf16 state between steps, as in the JAX scan."""
    noise = torch.randn(1, 2, 4, 4, generator=torch.Generator().manual_seed(0))
    cond = torch.zeros_like(noise)
    for sample in (tsolvers.sample_dpm_solver, tsolvers.sample_unipc, tsolvers.sample_lcm):
        out = sample(_analytic(torch), tsolvers.flow_grid(4), noise.bfloat16(), cond)
        assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    with pytest.raises(ValueError, match="solver_order"):
        tsolvers.sample_unipc(_analytic(torch), tsolvers.flow_grid(4), noise, cond, solver_order=3)
    with pytest.raises(ValueError, match="step_noise"):
        tsolvers.sample_lcm(_analytic(torch), tsolvers.flow_grid(4), noise, cond,
                            step_noise=[noise])


@pytest.fixture(scope="module")
def golden_tuple():
    """The goldens' tuple, made by JAX as tests/test_golden_grids.py:75-120
    makes it (seeds 8888, 44, 45 and 9), carried across as numpy."""
    cfg = jmmdit.MMDiTConfig.tiny()
    model = jmmdit.SD3Transformer2D(cfg=cfg)
    b = 2
    noise = jax.random.normal(jax.random.PRNGKey(8888),
                              (b, cfg.in_channels, cfg.sample_size, cfg.sample_size))
    ctx = jax.random.normal(jax.random.PRNGKey(44), (b, 6, cfg.context_dim)) * 0.1
    pooled = jax.random.normal(jax.random.PRNGKey(45), (b, cfg.pooled_dim)) * 0.1
    params = model.init(jax.random.PRNGKey(9), noise, jnp.zeros((b,)), ctx, pooled)["params"]
    tm = port_model(cfg, params)
    return tm, *_t(noise, ctx, pooled)


@pytest.mark.parametrize("solver", ["dpm", "unipc"])
def test_tiny_sd3_4nfe_matches_the_golden(golden_tuple, solver):
    """The port's MMDiT through the port's solver on the recipe's flow grid
    (flow_shift 6), against the committed golden: the functions the SD3
    pipeline runs, in fp32 (the pipeline itself rounds its noise and state
    to bf16, which the fp32 goldens were not made with)."""
    tm, noise, ctx, pooled = golden_tuple
    sample = {"dpm": tsolvers.sample_dpm_solver, "unipc": tsolvers.sample_unipc}[solver]
    with torch.no_grad():
        got = sample(tmmdit.make_denoise_fn(tm), tsolvers.flow_grid(4, flow_shift=6.0),
                     noise, (ctx, pooled))
    ref = np.load(os.path.join(GOLDEN, f"sd3_tiny_4nfe_{solver}.npz"))["latents"]
    np.testing.assert_allclose(got.numpy(), ref, atol=GOLDEN_ATOL, rtol=GOLDEN_ATOL)


# --- LoRA, pipeline, loader ---------------------------------------------------


def assert_bf16_state_close(got: torch.Tensor, ref) -> None:
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    diff = np.abs(got - ref)
    assert diff.max() <= 2**-7 * np.abs(ref).max(), diff.max()
    assert np.mean(diff > 0) < 0.01, np.mean(diff > 0)


def jax_lora(params, seed=7, rank=4):
    """A JAX LoRA on the default targets with both factors non-zero."""
    lora = jlora.init_lora(params, jax.random.PRNGKey(seed), rank=rank, alpha=2.0 * rank)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: jnp.asarray(a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)),
        lora.params)
    return jlora.LoRA(params=tree, alpha=lora.alpha)


@pytest.fixture(scope="module", params=[True, False], ids=["scanned", "unrolled"])
def sd3_pair(request, tmp_path_factory):
    """A tiny JAX SD3 pipeline (TAESD3 with one stage) written with the JAX
    package's save_pretrained, its kohya LoRA written by JAX's save_kohya,
    and the port's pipeline loaded from the directory on the CPU."""
    cfg = variant("sd3", request.param)
    model, params = jax_model(cfg, seed=2)
    vcfg = dataclasses.replace(jvae.TAESDConfig.taesd3(), width=8, num_stages=1,
                               blocks_per_stage=1, scaling_factor=1.5, shift_factor=0.1)
    dec = jvae.TAESDDecoder(cfg=vcfg)
    vparams = dec.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, LAT, LAT)))["params"]
    jpipe = JaxSD3Pipeline(model, params, vae_decoder=dec, vae_params=vparams,
                           vae_scaling=vcfg.scaling_factor, vae_shift=vcfg.shift_factor)
    path = str(tmp_path_factory.mktemp("sd3_jax"))
    jpipe.save_pretrained(path)
    lora_file = os.path.join(path, "tdm_lora.safetensors")
    jlora.save_kohya(jax_lora(params), lora_file)
    return jpipe, from_pretrained(path, device="cpu"), path, lora_file


def test_from_pretrained_loads_a_jax_sd3_dir(sd3_pair):
    jpipe, pipe, path, _ = sd3_pair
    assert isinstance(pipe, SD3Pipeline) and pipe.family == "sd3"
    assert pipe.transformer.cfg == port_config(jpipe.transformer.cfg)
    assert pipe.vae_decoder.cfg.latent_channels == 16
    assert (pipe.vae_scaling, pipe.vae_shift, pipe.flow_shift) == (1.5, 0.1, 6.0)
    with open(os.path.join(path, "pipeline.json")) as f:
        assert json.load(f)["family"] == "sd3"


@pytest.mark.parametrize("solver", ["dpm", "unipc"])
def test_sd3_pipeline_matches_jax(sd3_pair, solver):
    jpipe, pipe, _, _ = sd3_pair
    lat, _, ctx, pooled = inputs(11, b=3)
    kw = dict(num_inference_steps=4, height=LAT * 8, width=LAT * 8, solver=solver,
              flow_shift=3.0)
    ref = jpipe(prompt_embeds=(jnp.asarray(ctx), jnp.asarray(pooled)),
                latents=jnp.asarray(lat), **kw)
    got = pipe(prompt_embeds=(ctx, pooled), latents=lat, **kw)
    assert got.latents.dtype == torch.bfloat16
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))
    assert got.images.shape == (3, 16, 16, 3)  # TAESD3 with one 2x stage
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)


def test_sd3_pipeline_cfg_matches_jax(sd3_pair):
    """CFG with negative embeddings equal to the prompt's (c - u = 0 keeps
    the mix exact in either package's arithmetic; the mix with distinct
    branches is held in fp32 by test_solvers_match_jax)."""
    jpipe, pipe, _, _ = sd3_pair
    lat, _, ctx, pooled = inputs(12, b=2)
    kw = dict(num_inference_steps=2, height=64, width=64, guidance_scale=3.0,
              output_type="latent")
    ref = jpipe(prompt_embeds=(jnp.asarray(ctx), jnp.asarray(pooled)),
                negative_embeds=(jnp.asarray(ctx), jnp.asarray(pooled)),
                latents=jnp.asarray(lat), **kw)
    got = pipe(prompt_embeds=(ctx, pooled), negative_embeds=(ctx, pooled), latents=lat, **kw)
    assert got.images is None
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))


def test_kohya_lora_from_jax_merges_like_jax(sd3_pair):
    """A kohya file written by JAX's save_kohya, loaded and merged by the
    port at the recipe's 0.125, gives JAX's merged forward;
    set_adapters([...], [0.0]) gives back the base bit for bit."""
    jpipe, pipe, _, lora_file = sd3_pair
    x, t, ctx, pooled = inputs(13)
    base = {k: v.clone() for k, v in pipe.transformer.state_dict().items()}
    try:
        jpipe.load_lora_weights(lora_file, adapter_name="tdm")
        jpipe.set_adapters(["tdm"], [0.125])
        pipe.load_lora_weights(lora_file, adapter_name="tdm")
        pipe.set_adapters(["tdm"], [0.125])
        ref = np.asarray(jpipe.transformer.apply({"params": jpipe.params}, x, t, ctx, pooled))
        with torch.no_grad():
            got = pipe.transformer(*_t(x, t, ctx, pooled)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
        changed = [k for k, v in pipe.transformer.state_dict().items()
                   if not torch.equal(v, base[k])]
        assert any(".to_q." in k for k in changed) and any("blocks.1." in k for k in changed)
        merged = {k: np.asarray(v) for k, v in from_jax.flatten_tree(jpipe.params).items()}
        port = from_jax.jax_layout(pipe.transformer.state_dict(),
                                   stacks=from_jax.layer_stacks(pipe.transformer.cfg))
        for k in merged:
            np.testing.assert_allclose(port[k], merged[k], rtol=1e-6, atol=1e-6, err_msg=k)
    finally:
        pipe.set_adapters(["tdm"], [0.0])
        jpipe.set_adapters(["tdm"], [0.0])
    for k, v in pipe.transformer.state_dict().items():
        torch.testing.assert_close(v, base[k], rtol=0, atol=0)


def test_lora_file_round_trip_and_errors(sd3_pair, tmp_path):
    """The port's save_kohya ↔ load_lora round trip (a stacked tree's
    entries go out per layer and come back stacked), a peft-style dotted
    file, and the faults load_lora names."""
    _, pipe, _, lora_file = sd3_pair
    lora = tlora_io.load_lora(lora_file, model=pipe.transformer)
    out = str(tmp_path / "again.safetensors")
    tlora_io.save_kohya(lora, out, dtype=np.float32)
    again = tlora_io.load_lora(out, model=pipe.transformer)
    assert again.params.keys() == lora.params.keys() and again.alpha == lora.alpha
    for p, e in lora.params.items():
        for w in ("a", "b"):
            torch.testing.assert_close(again.params[p][w], e[w], rtol=0, atol=0)
    stacked = [p for p, e in lora.params.items() if e["a"].dim() == 3]
    assert bool(stacked) == pipe.transformer.cfg.scan_layers
    # peft keys: transformer.<module>.lora_A.weight [r, in] / lora_B [out, r]
    from tdm_tpu_torch.io import params as params_io

    raw = params_io.load_file(lora_file)
    peft = {}
    for key, arr in raw.items():
        mod, _, kind = key.removeprefix("lora_unet_").partition(".")
        if kind.startswith("lora_down"):
            peft[f"transformer.{mod}.lora_A.weight"] = arr
        elif kind.startswith("lora_up"):
            peft[f"transformer.{mod}.lora_B.weight"] = arr
        else:
            peft[f"transformer.{mod}.alpha"] = arr
    peft_file = str(tmp_path / "peft.safetensors")
    params_io.save_file(peft, peft_file)
    from_peft = tlora_io.load_lora(peft_file, model=pipe.transformer)
    assert from_peft.params.keys() == lora.params.keys()
    a_file = str(tmp_path / "gap.safetensors")
    params_io.save_file({k: v for k, v in raw.items() if "lora_up" not in k or "to_k" not in k},
                        a_file)
    with pytest.raises(ValueError, match="missing factor b"):
        tlora_io.load_lora(a_file, model=pipe.transformer)
    bad = tadapter.LoRA(params={"blocks_9/to_q": lora.params[next(iter(lora.params))]})
    with pytest.raises(KeyError, match="no matching kernel"):
        tadapter.merge(pipe.transformer.state_dict(), bad, 1.0,
                       from_jax.layer_stacks(pipe.transformer.cfg))


def test_init_lora_matches_the_jax_targets(sd3_pair):
    jpipe, pipe, _, _ = sd3_pair
    j = jlora.init_lora(jpipe.params, jax.random.PRNGKey(0), rank=3)
    t = tadapter.init_lora(pipe.transformer, rank=3, generator=torch.Generator().manual_seed(0))
    jflat = {"/".join(p): e for p, e in jlora.adapter._flatten(j.params).items()}
    assert t.params.keys() == jflat.keys() and dict(t.alpha) == dict(j.alpha)
    for p, e in t.params.items():
        assert tuple(e["a"].shape) == jflat[p]["a"].shape
        assert not e["b"].any() and e["a"].abs().max() <= 1 / np.sqrt(e["a"].shape[-2])
    before = pipe.transformer.state_dict()
    merged = tadapter.merge(before, t, 0.125, from_jax.layer_stacks(pipe.transformer.cfg))
    for k, v in merged.items():  # b = 0: the merge changes nothing
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_save_pretrained_round_trips_the_base(sd3_pair, tmp_path):
    """The port writes an sd3 directory the JAX package loads; with an
    adapter active it still writes the pristine base, as JAX's does."""
    from tdm_tpu.pipelines import loading as jloading

    jpipe, pipe, _, lora_file = sd3_pair
    pipe.load_lora_weights(lora_file, adapter_name="tdm")
    pipe.set_adapters(["tdm"], [0.125])
    try:
        save_pretrained(str(tmp_path), pipe)
    finally:
        pipe.set_adapters(["tdm"], [0.0])
    back = jloading.from_pretrained(str(tmp_path))
    assert type(back).__name__ == "SD3Pipeline"
    ref = from_jax.flatten_tree(jpipe.base_params)
    got = from_jax.flatten_tree(back.params)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_from_pretrained_keeps_attn_impl_splash(tmp_path, monkeypatch):
    """A JAX-written sd3 directory with attn_impl='splash' at head dim 64
    loads with the choice kept: every joint attention takes the splash
    route, and the forward matches the JAX model's."""
    from tdm_tpu.pipelines import loading as jloading

    cfg = dataclasses.replace(jmmdit.MMDiTConfig.tiny(), head_dim=64, attn_impl="splash")
    model, params = jax_model(dataclasses.replace(cfg, attn_impl="xla"), seed=4)
    jloading.save_pretrained(str(tmp_path), family="sd3", transformer_params=params,
                             model_config=jloading.config_dict(cfg))
    pipe = from_pretrained(str(tmp_path), device="cpu")
    assert pipe.transformer.cfg.attn_impl == "splash" and pipe.vae_decoder is None
    calls = []
    wrapper = tattn.splash_attention_fwd
    monkeypatch.setattr(tattn, "splash_attention_fwd",
                        lambda *a: calls.append(1) or wrapper(*a))
    x, t, ctx, pooled = inputs(14, cfg=cfg)
    with torch.no_grad():
        got = pipe.transformer(*_t(x, t, ctx, pooled)).numpy()
    assert len(calls) == cfg.num_layers
    ref = np.asarray(model.apply({"params": params}, x, t, ctx, pooled))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_sd3_pipeline_contract():
    pipe = default_sd3_pipeline(cfg=tmmdit.MMDiTConfig.tiny(), device="cpu")
    assert pipe.vae_decoder.cfg.latent_channels == 16 and pipe.vae_shift == 0.0
    _, _, ctx, pooled = inputs(15)
    out = pipe(prompt_embeds=(ctx, pooled), seed=3, height=64, width=64)
    again = pipe(prompt_embeds=(ctx, pooled), seed=3, height=64, width=64)
    assert out.images.shape == (2, 64, 64, 3) and out.latents.shape == (2, 16, 8, 8)
    torch.testing.assert_close(out.images, again.images, rtol=0, atol=0)
    with pytest.raises(ValueError, match="SD3 needs clip_l/clip_g/t5"):
        pipe(["a cat"])
    with pytest.raises(ValueError, match="unknown solver"):
        pipe(prompt_embeds=(ctx, pooled), solver="fewstep")
    with pytest.raises(ValueError, match="negative_prompt has 1 entries"):
        pipe(prompt_embeds=(ctx, pooled), negative_prompt=["x"])


def test_pack_family_cond_and_pooled_cache(tmp_path):
    e, m, p = np.zeros((1, 3, 4)), np.ones((1, 3)), np.ones((1, 2))
    assert pack_family_cond("sd3", e, m, p)[1] is p
    assert pack_family_cond("pixart", e, m)[1] is m
    with pytest.raises(ValueError, match="pooled"):
        pack_family_cond("sd3", e, m, None)
    assert pack_family_cond("cogvideox", e, m) is e  # the sequence alone, no mask
    path = str(tmp_path / "c.npz")
    EmbeddingCache(np.zeros((2, 3, 4), np.float16), np.ones((2, 3), np.int32), ["a", "b"],
                   uncond_embed=np.zeros((3, 4), np.float16), uncond_mask=np.ones(3, np.int32),
                   pooled=np.arange(4, dtype=np.float16).reshape(2, 2),
                   uncond_pooled=np.ones(2, np.float16)).save(path)
    c = EmbeddingCache.load(path)
    np.testing.assert_array_equal(c.pooled, np.arange(4).reshape(2, 2))
    np.testing.assert_array_equal(c.uncond_pooled, [1, 1])
    fake = type("P", (), {"family": "sd3"})()
    ctx, pooled = tbatcher.make_cond_fn(fake, path)("b")
    assert ctx.shape == (1, 3, 4) and pooled.tolist() == [[2.0, 3.0]]
    assert tbatcher.make_cond_fn(fake, path)("")[1].tolist() == [[1.0, 1.0]]
    sd3 = type("P", (), {"family": "sd3", "transformer": type("T", (), {
        "cfg": tmmdit.MMDiTConfig()})()})()
    assert tbatcher.latent_shape(sd3, {}) == (1, 16, 128, 128)


# --- serving ------------------------------------------------------------------

PROMPTS = ["a cat", "a dog", "a red panda"]


def _post(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_server_serves_sd3_with_a_lora(sd3_pair, tmp_path):
    """`--lora` / `--lora_scale` / `--flow_shift` over an SD3 pooled cache on
    the CPU: the served image is the pipeline's with the adapter merged at
    the scale, per request seed, whatever its batch-mates."""
    from PIL import Image
    import io

    _, pipe, path, lora_file = sd3_pair
    rng = np.random.default_rng(16)
    cache = str(tmp_path / "sd3_cache.npz")
    EmbeddingCache(rng.standard_normal((3, 6, 48)).astype(np.float16),
                   np.ones((3, 6), np.int32), PROMPTS,
                   pooled=rng.standard_normal((3, 24)).astype(np.float16)).save(cache)
    args = tserver.parse_args([
        "--model", path, "--embedding_cache", cache, "--device", "cpu", "--port", "0",
        "--batch_size", "2", "--max_delay_ms", "1500", "--height", "64", "--width", "64",
        "--lora", lora_file,
        "--lora_scale", "0.125", "--flow_shift", "3.0",
    ])
    srv = tserver.build_server(args).start()
    try:
        results = {}

        def go(i, prompt, seed):
            results[i] = _post(srv.port, {"prompt": prompt, "seed": seed})

        threads = [threading.Thread(target=go, args=a)
                   for a in [(0, "a cat", 1), (1, "a dog", 5)]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        solo = _post(srv.port, {"prompt": "a dog", "seed": 5})
        served = srv.batcher.pipe
        assert served.transformer.cfg.dtype == torch.float32 and served.family == "sd3"
        assert served._active == (("tdm", 0.125),)
        noise = tbatcher.request_noise(5, (1, 16, 8, 8))
        cond = srv.batcher.cond_fn("a dog")
        direct = served(prompt_embeds=cond, latents=noise, height=64, width=64,
                        flow_shift=3.0).images[0].numpy()
    finally:
        srv.close()
    assert results[1]["image"] == solo["image"] and results[0]["image"] != solo["image"]
    img = np.asarray(Image.open(io.BytesIO(base64.b64decode(solo["image"]))))
    assert img.shape == (16, 16, 3) and solo["shape"] == [16, 16, 3]
    np.testing.assert_array_equal(img, (np.clip(direct, 0, 1) * 255).astype(np.uint8))
    # the adapter moved the image: the base weights give another one
    plain = from_pretrained(path, device="cpu")(prompt_embeds=cond, latents=noise,
                                                 height=64, width=64, flow_shift=3.0)
    assert np.abs(plain.images[0].numpy() - direct).max() > 1e-3
