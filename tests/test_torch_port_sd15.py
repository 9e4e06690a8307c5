"""SD1.5 / Dreamshaper serving in the port against the JAX package: kernel
1's function at head dim 160, the scaled-linear schedule, the GEGLU
feed-forward and bias-free attention, the tiny UNet, the tiny pipeline
against the committed golden, the diffusers converter and `from_pretrained`
of a diffusers checkout, the tdm_tpu layout both ways, a kohya LoRA merge,
and the HTTP server at `--device cpu`, at tiny sizes on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both packages;
JAX parameters cross through the weight carry (`io/from_jax.py`). Models
run in fp32: the UNet and the attention agree to fp32 roundoff (the same
sums in another order), held at 1e-5 (relative L2 for the UNet, absolute
for attention, whose outputs are O(1)); the golden is held at
tests/test_golden_grids.py's own 5e-4. The pipelines round the sampler
state to bf16 at every step in both packages (tests/test_torch_port_pipeline.py
says why), so their latents are held to one bf16 ulp of their scale with
under 1% of elements differing, and their images to 2e-3, half a step of
the 8-bit PNG they are served as.
"""

import base64
import dataclasses
import io
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu import lora as jlora
from tdm_tpu.core import schedules as jsched, solvers as jsolvers
from tdm_tpu.io import convert as jconvert, manifest as jmanifest
from tdm_tpu.models import layers as jlayers, unet_sd15 as junet, vae as jvae
from tdm_tpu.ops import attention as jattn
from tdm_tpu.pipelines import loading as jloading
from tdm_tpu.pipelines.sd15 import SD15Pipeline as JaxSD15Pipeline
from tdm_tpu_torch.core import schedules as tsched, solvers as tsolvers
from tdm_tpu_torch.data.prompts import EmbeddingCache, pack_family_cond
from tdm_tpu_torch.io import convert as tconvert, from_jax, manifest as tmanifest
from tdm_tpu_torch.lora import adapter as tadapter, io as tlora_io
from tdm_tpu_torch.models import layers as tlayers, unet_sd15 as tunet, vae as tvae
from tdm_tpu_torch.ops import attention as tattn
from tdm_tpu_torch.pipelines import SD15Pipeline, from_pretrained, save_pretrained
from tdm_tpu_torch.serve import batcher as tbatcher, server as tserver

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_ATOL = 5e-4  # tests/test_golden_grids.py's tolerance
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "manifests")
F32 = {"dtype": "float32", "attn_impl": "xla"}
CALL = dict(num_inference_steps=4, height=128, width=128)
LAT, CTX = 16, 6  # latent side and context length of the tiny calls


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a, np.float32)) for a in arrays)


def assert_bf16_state_close(got: torch.Tensor, ref) -> None:
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    diff = np.abs(got - ref)
    assert diff.max() <= 2**-7 * np.abs(ref).max(), diff.max()
    assert np.mean(diff > 0) < 0.01, np.mean(diff > 0)


def port_unet(params, cfg=None) -> tunet.UNet2DCondition:
    """The port's tiny UNet holding JAX `params`, carried by from_jax."""
    model = tunet.UNet2DCondition(cfg or tunet.UNetConfig.tiny(), device="cpu")
    model.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(params), model))
    return model.eval()


def inputs(seed, b=2):
    """(latent, t, context, mask) as numpy: a ragged CLIP mask with one
    batch row whose keys are all masked when b > 2."""
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, 4, LAT, LAT)).astype(np.float32)
    t = rng.integers(0, 1000, size=b).astype(np.float32)
    ctx = rng.standard_normal((b, CTX, 32)).astype(np.float32)
    lengths = np.array([CTX, 3, 0, 5][:b])
    mask = (np.arange(CTX)[None] < lengths[:, None]).astype(np.int32)
    return lat, t, ctx, mask


# --- kernel 1's function at head dim 160, the schedule, the layers -----------------


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("d", [136, 160])
def test_attention_matches_jax_pallas_at_head_dim_160(d, masked):
    """`attention` at SD1.5's D 160 (and 136, zero-filled to 160 by the
    kernel) against the JAX package's Pallas flash kernel in interpret mode
    (D padded to 256), fp32, with a ragged key mask and an all-masked batch
    row, within 1e-5."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((3, 2, s, d)).astype(np.float32) for s in (70, 45, 45))
    mask = (np.arange(45)[None] < np.array([[45], [17], [0]])).astype(np.int32) if masked else None
    ref = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if mask is None else jnp.asarray(mask), impl="pallas",
                          block_q=64, block_k=32, interpret=True)
    got = tattn.attention(*_t(q, k, v), None if mask is None else torch.from_numpy(mask))
    assert got.shape == (3, 2, 70, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    if masked:
        assert not got[2].any()


def test_ddpm_scaled_linear_matches_jax():
    """SD1.5's scaled-linear tables, bit for bit (both built in float64 on
    the host, stored fp32), and the DPM grid the pipeline samples on."""
    j, t = jsched.ddpm_scaled_linear(), tsched.ddpm_scaled_linear(device="cpu")
    np.testing.assert_array_equal(t.alphas.numpy(), np.asarray(j.alphas))
    np.testing.assert_array_equal(t.sigmas.numpy(), np.asarray(j.sigmas))
    assert (t.num_train_timesteps, t.prediction_type) == (1000, "epsilon")
    tg, jg = tsolvers.ddpm_grid(t, 4), jsolvers.ddpm_grid(j, 4)
    for field in ("model_t", "alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(tg, field).numpy(), np.asarray(getattr(jg, field)))


def test_geglu_feed_forward_and_bias_free_attention_match_jax():
    """FeedForward(activation='geglu') (exact erf GELU on the gate half) and
    Attention(qkv_bias=False) with a 768-style context width, on JAX's
    initialised parameters; PixArt's defaults keep their biases and tanh
    GELU."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 12)).astype(np.float32)
    ff = jlayers.FeedForward(mult=4, activation="geglu")
    fp = ff.init(jax.random.PRNGKey(0), x)["params"]
    tff = tlayers.FeedForward(24, 4, activation="geglu", dtype=torch.float32)
    tff.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(fp), tff))
    with torch.no_grad():
        got = tff(*_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ff.apply({"params": fp}, x)), rtol=1e-5, atol=1e-5)
    attn = jlayers.Attention(heads=2, head_dim=12, qkv_bias=False, attn_impl="xla")
    ap = attn.init(jax.random.PRNGKey(1), x, context=ctx)["params"]
    tatt = tlayers.Attention(24, 2, 12, context_dim=12, qkv_bias=False, dtype=torch.float32)
    tatt.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(ap), tatt))
    assert tatt.to_q.bias is None and tatt.to_k.weight.shape == (24, 12)
    with torch.no_grad():
        got = tatt(*_t(x, ctx)).numpy()
    ref = np.asarray(attn.apply({"params": ap}, x, context=ctx))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    plain = tlayers.FeedForward(24, 4, dtype=torch.float32)
    assert plain.proj_in.weight.shape == (96, 24) and plain.activation == "gelu-approximate"
    with pytest.raises(ValueError, match="unknown activation"):
        tlayers.FeedForward(24, activation="swiglu", dtype=torch.float32)


# --- the UNet --------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden_tuple():
    """The golden's model, noise and conditioning, made by JAX as
    tests/test_golden_grids.py:280-301 makes them (seeds 317, 46 and 11)."""
    cfg = junet.UNetConfig.tiny()
    model = junet.UNet2DCondition(cfg=cfg)
    b = 2
    noise = jax.random.normal(jax.random.PRNGKey(317), (b, 4, LAT, LAT))
    ctx = jax.random.normal(jax.random.PRNGKey(46), (b, CTX, cfg.context_dim)) * 0.1
    mask = jnp.ones((b, CTX), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(11), noise, jnp.zeros((b,)), ctx,
                                 mask)["params"]
    return model, params, np.asarray(noise), np.asarray(ctx), np.asarray(mask)


def test_tiny_unet_matches_jax(golden_tuple):
    """The tiny UNet (widths 32/64, 2 heads, GroupNorm 8) on JAX's
    parameters, with a ragged and an all-masked context row, fp32: relative
    L2 within 1e-5."""
    model, params, *_ = golden_tuple
    lat, t, ctx, mask = inputs(3, b=3)
    ref = np.asarray(jax.jit(model.apply)({"params": params}, lat, t, ctx, mask))
    with torch.no_grad():
        got = port_unet(params)(*_t(lat, t, ctx), torch.from_numpy(mask)).numpy()
    assert got.shape == (3, 4, LAT, LAT)
    assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)


def test_tiny_sd15_4nfe_matches_the_golden(golden_tuple):
    """The SD15 pipeline's functions (its UNet denoiser and scaled-linear
    schedule through DPM-Solver++(2M), 4 steps, cfg 1) against the
    committed golden, in fp32 (the pipeline itself rounds its noise and
    state to bf16, which the fp32 golden was not made with)."""
    _, params, noise, ctx, mask = golden_tuple
    pipe = SD15Pipeline(port_unet(params), device="cpu")
    with torch.no_grad():
        got = tsolvers.sample_dpm_solver(
            tunet.make_denoise_fn(pipe.unet), tsolvers.ddpm_grid(pipe.schedule, 4),
            *_t(noise), (*_t(ctx), torch.tensor(mask)))
    ref = np.load(os.path.join(GOLDEN, "sd15_tiny_4nfe_dpm.npz"))["latents"]
    np.testing.assert_allclose(got.numpy(), ref, atol=GOLDEN_ATOL, rtol=GOLDEN_ATOL)


def test_unet_refusals():
    # remat (--gradient_checkpointing) builds: every ResBlock and
    # SpatialTransformer is checkpointed under the same module names
    remat = tunet.UNet2DCondition(dataclasses.replace(tunet.UNetConfig.tiny(), remat=True),
                                  device="cpu")
    plain = tunet.UNet2DCondition(tunet.UNetConfig.tiny(), device="cpu")
    assert list(remat.state_dict()) == list(plain.state_dict())
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tunet.UNet2DCondition(dataclasses.replace(tunet.UNetConfig.tiny(), attn_impl="x"),
                              device="cpu")
    pipe = SD15Pipeline(tunet.UNet2DCondition(tunet.UNetConfig.tiny(), device="cpu"),
                        device="cpu")
    with pytest.raises(ValueError, match="no tokenizer/text_encoder attached"):
        pipe(["a cat"])
    with pytest.raises(ValueError, match="unknown solver"):
        pipe(prompt_embeds=_t(*inputs(0)[2:]), solver="ddim")


def test_unet_convolutions_run_without_cudnn():
    """The UNet's convolutions never reach cuDNN (its bf16 engine on the
    H100 is not bitwise stable between calls; the module docstring): every
    one is a `GemmConv2d` (im2col and a batched product), no convolution
    operator runs in the forward, the cuDNN switch is left as it was, and a
    bad input still raises."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Convolutions(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Convolutions.n += "convolution" in func.__name__
            return func(*args, **(kwargs or {}))

    unet = tunet.UNet2DCondition(tunet.UNetConfig.tiny(), device="cpu")
    convs = [m for m in unet.modules() if isinstance(m, torch.nn.Conv2d)]
    assert convs and all(isinstance(m, tlayers.GemmConv2d) for m in convs)
    seen = []
    unet.conv_in.register_forward_hook(
        lambda mod, a, o: seen.append(torch.backends.cudnn.enabled))
    lat, t, ctx, mask = inputs(1)
    assert torch.backends.cudnn.enabled
    with torch.no_grad(), Convolutions():
        unet(*_t(lat, t, ctx), torch.from_numpy(mask))
        with pytest.raises(RuntimeError):
            unet(*_t(lat[:, :3], t, ctx), torch.from_numpy(mask))
    assert seen == [True] and Convolutions.n == 0 and torch.backends.cudnn.enabled


def test_full_unet_widths_and_launches():
    """The released SD1.5 UNet on the meta device: 859.5M parameters, head
    dims 40/80/160 and the 16 spatial transformers whose two attention calls
    make kernel 1's 32 launches a forward."""
    model = tunet.UNet2DCondition(device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in tmanifest.expected_manifest("unet_sd15").values())
    assert n == 859_520_964
    blocks = [m for m in model.modules() if isinstance(m, tunet.TransformerBlock)]
    assert len(blocks) == 16
    dims = sorted(b.attn1.head_dim for b in blocks)
    assert dims.count(40) == 5 and dims.count(80) == 5 and dims.count(160) == 6


# --- checkpoints -----------------------------------------------------------------


def test_unet_manifest_equals_jax_and_the_fixture():
    cfg = tunet.UNetConfig.tiny()
    assert tmanifest.expected_manifest("unet_sd15", cfg) == jmanifest.expected_manifest(
        "unet_sd15", junet.UNetConfig.tiny())
    committed = tmanifest.load_manifest(os.path.join(FIXDIR, "sd15_unet.json"))
    assert tmanifest.expected_manifest("unet_sd15") == committed


def test_unet_converter_matches_jax():
    """`unet_sd15_params` on a seeded SD1.5 state dict: JAX's tree leaf for
    leaf (1×1 proj convs become Dense kernels), a leftover key raises, and
    a missing one names the family."""
    cfg = tunet.UNetConfig.tiny()
    sd = tmanifest.synthetic_state_dict("unet_sd15", cfg, seed=4)
    kw = dict(layers_per_block=1, n_stages=2)
    got = tconvert.flatten(tconvert.unet_sd15_params(sd, **kw))
    ref = from_jax.flatten_tree(jconvert.unet_sd15_params(sd, **kw))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)
    assert got["down_0_attn_0/proj_in/kernel"].shape == (32, 32)
    with pytest.raises(ValueError, match="never consumed"):
        tconvert.unet_sd15_params({**sd, "extra.weight": np.zeros(1)}, **kw)
    sd.pop("mid_block.resnets.0.conv1.weight")
    with pytest.raises(KeyError, match="unet_sd15 converter"):
        tconvert.unet_sd15_params(sd, **kw)


def write_sd15_checkout(root, cfg, vcfg, *, seed=0) -> str:
    """A stock SD1.5 diffusers checkout: model_index.json, unet/ and vae/,
    each a config.json and one fp16 safetensors file of seeded weights
    (SD1.5's int `attention_head_dim` is its head count)."""
    root = str(root)
    files = {
        "model_index.json": {"_class_name": "StableDiffusionPipeline"},
        "unet/config.json": {
            "_class_name": "UNet2DConditionModel", "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels, "layers_per_block": cfg.layers_per_block,
            "block_out_channels": list(cfg.block_widths), "norm_num_groups": cfg.norm_groups,
            "cross_attention_dim": cfg.context_dim, "attention_head_dim": cfg.num_heads},
        "vae/config.json": {
            "_class_name": "AutoencoderKL", "latent_channels": vcfg.latent_channels,
            "block_out_channels": list(vcfg.block_widths),
            "layers_per_block": vcfg.layers_per_block, "norm_num_groups": vcfg.norm_groups,
            "scaling_factor": vcfg.scaling_factor},
    }
    for name, conf in files.items():
        os.makedirs(os.path.dirname(os.path.join(root, name)), exist_ok=True)
        with open(os.path.join(root, name), "w") as f:
            json.dump(conf, f)
    tmanifest.write_synthetic("unet_sd15", os.path.join(
        root, "unet", "diffusion_pytorch_model.safetensors"), cfg, seed=seed, scale=0.1)
    tmanifest.write_synthetic("klvae", os.path.join(
        root, "vae", "diffusion_pytorch_model.safetensors"), vcfg, seed=seed + 1, scale=0.3)
    return root


def test_from_pretrained_sd15_checkout_matches_jax(tmp_path):
    """A tiny SD1.5 checkout through both packages' from_pretrained: the
    port's UNet holds JAX's converted weights, and one 4-NFE batch gives
    JAX's latents and images."""
    root = write_sd15_checkout(tmp_path / "sd15", tunet.UNetConfig.tiny(),
                               tvae.KLVAEConfig.tiny())
    jpipe = jloading.from_pretrained(root, model_config=F32)
    pipe = from_pretrained(root, device="cpu", model_config=F32)
    assert isinstance(pipe, SD15Pipeline) and pipe.family == "sd15"
    assert pipe.unet.cfg == tunet.UNetConfig.tiny()
    assert isinstance(pipe.vae_decoder, tvae.KLDecoder) and pipe.vae_range == "pm1"
    assert pipe.vae_scaling == 0.18215
    port = from_jax.jax_layout(pipe.unet.state_dict(), stacks=())
    for k, ref in from_jax.flatten_tree(jpipe.params).items():
        np.testing.assert_array_equal(port[k], ref, err_msg=k)
    lat, _, ctx, mask = inputs(6, b=3)
    ref = jpipe(prompt_embeds=(jnp.asarray(ctx), jnp.asarray(mask)), latents=jnp.asarray(lat),
                **CALL)
    got = pipe(prompt_embeds=(ctx, mask), latents=lat, **CALL)
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))
    assert got.images.shape == (3, 32, 32, 3)  # the tiny KL decoder's one 2x stage
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)


# --- the tdm_tpu layout, LoRA and the server ---------------------------------------


def jax_lora(params, seed=7, rank=4):
    """A JAX LoRA on the default targets with both factors non-zero."""
    lora = jlora.init_lora(params, jax.random.PRNGKey(seed), rank=rank, alpha=2.0 * rank)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: jnp.asarray(a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)),
        lora.params)
    return jlora.LoRA(params=tree, alpha=lora.alpha)


@pytest.fixture(scope="module")
def sd15_pair(golden_tuple, tmp_path_factory):
    """The tiny JAX SD1.5 pipeline (the golden's UNet, a tiny KL decoder)
    written with the JAX package's save_pretrained, its kohya LoRA written
    by JAX's save_kohya, and the port's pipeline loaded from the directory
    on the CPU."""
    model, params, *_ = golden_tuple
    vcfg = jvae.KLVAEConfig.tiny()
    dec = jvae.KLDecoder(cfg=vcfg)
    vparams = dec.init(jax.random.PRNGKey(3), jnp.zeros((1, 4, LAT, LAT)))["params"]
    jpipe = JaxSD15Pipeline(model, params, vae_decoder=dec, vae_params=vparams)
    path = str(tmp_path_factory.mktemp("sd15_jax"))
    jpipe.save_pretrained(path)
    lora_file = os.path.join(path, "tdm_lora.safetensors")
    jlora.save_kohya(jax_lora(params), lora_file)
    return jpipe, from_pretrained(path, device="cpu"), path, lora_file


def test_sd15_layout_both_ways(sd15_pair, tmp_path):
    """A directory the JAX package wrote loads into the port (UNet and KL
    decoder), gives JAX's batch, and the port's save_pretrained writes one
    the JAX package loads back to the same weights."""
    jpipe, pipe, _, _ = sd15_pair
    assert pipe.unet.cfg == tunet.UNetConfig.tiny() and pipe.denoiser is pipe.unet
    assert isinstance(pipe.vae_decoder, tvae.KLDecoder)
    lat, _, ctx, mask = inputs(8, b=2)
    ref = jpipe(prompt_embeds=(jnp.asarray(ctx), jnp.asarray(mask)), latents=jnp.asarray(lat),
                **CALL)
    got = pipe(prompt_embeds=(ctx, mask), latents=lat, **CALL)
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)
    out = str(tmp_path / "port_written")
    save_pretrained(out, pipe)
    back = jloading.from_pretrained(out)
    assert back.family == "sd15" and back.unet.cfg == jpipe.unet.cfg
    for tree_a, tree_b in ((back.params, jpipe.params), (back.vae_params, jpipe.vae_params)):
        a, b = from_jax.flatten_tree(tree_a), from_jax.flatten_tree(tree_b)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_kohya_lora_from_jax_merges_like_jax(sd15_pair):
    """A kohya file written by JAX's save_kohya (its UNet module names as
    keys), loaded by the port onto the UNet and merged at 0.5, gives JAX's
    merged weights and forward; scale 0 gives back the base bit for bit."""
    jpipe, pipe, _, lora_file = sd15_pair
    lat, t, ctx, mask = inputs(9)
    base = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    try:
        jpipe.load_lora_weights(lora_file, adapter_name="tdm")
        jpipe.set_adapters(["tdm"], [0.5])
        pipe.load_lora_weights(lora_file, adapter_name="tdm")
        pipe.set_adapters(["tdm"], [0.5])
        changed = [k for k, v in pipe.unet.state_dict().items() if not torch.equal(v, base[k])]
        assert any("attn2.to_k" in k for k in changed) and any("ff.proj_in" in k for k in changed)
        merged = from_jax.flatten_tree(jpipe.params)
        port = from_jax.jax_layout(pipe.unet.state_dict(), stacks=())
        for k in merged:
            np.testing.assert_allclose(port[k], merged[k], rtol=1e-6, atol=1e-6, err_msg=k)
        ref = np.asarray(jax.jit(jpipe.unet.apply)({"params": jpipe.params}, lat, t, ctx, mask))
        with torch.no_grad():
            got = pipe.unet(*_t(lat, t, ctx), torch.from_numpy(mask)).numpy()
        assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)
    finally:
        pipe.set_adapters(["tdm"], [0.0])
        jpipe.set_adapters(["tdm"], [0.0])
    for k, v in pipe.unet.state_dict().items():
        torch.testing.assert_close(v, base[k], rtol=0, atol=0)


def test_server_answers_a_tiny_sd15_request(sd15_pair, tmp_path):
    """The HTTP server at --device cpu over the JAX-written SD1.5 dir with
    its kohya LoRA at 0.5, from a CLIP-shaped embedding cache: at 64² (an
    8² latent, 16² out of the tiny KL decoder) a PNG that is the
    pipeline's own image for the seed's noise."""
    _, pipe, path, lora_file = sd15_pair
    rng = np.random.default_rng(12)
    cache = str(tmp_path / "clip_cache.npz")
    EmbeddingCache(rng.standard_normal((2, CTX, 32)).astype(np.float16),
                   (np.arange(CTX)[None] < np.array([[CTX], [2]])).astype(np.int32),
                   ["a castle", "a lake"]).save(cache)
    args = tserver.parse_args([
        "--model", path, "--device", "cpu", "--embedding_cache", cache, "--port", "0",
        "--batch_size", "2", "--max_delay_ms", "10", "--height", "64", "--width", "64",
        "--lora", lora_file, "--lora_scale", "0.5",
    ])
    server = tserver.build_server(args).start()
    try:
        assert tbatcher.latent_shape(server.batcher.pipe, server.batcher.call_kwargs) == (
            1, 4, 8, 8)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate",
            data=json.dumps({"prompt": "a lake", "seed": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = json.loads(r.read())
        served = server.batcher.pipe
        cond = server.batcher.cond_fn("a lake")
        noise = tbatcher.request_noise(5, (1, 4, 8, 8))
        direct = served(prompt_embeds=cond, latents=noise, num_inference_steps=4,
                        height=64, width=64).images[0].numpy()
    finally:
        server.close()
    from PIL import Image

    assert reply["format"] == "png" and reply["shape"] == [16, 16, 3]
    img = np.asarray(Image.open(io.BytesIO(base64.b64decode(reply["image"]))))
    np.testing.assert_array_equal(img, (np.clip(direct, 0, 1) * 255).astype(np.uint8))
    assert served._active == (("tdm", 0.5),)
    assert tbatcher.latent_shape(pipe, {}) == (1, 4, 64, 64)
    e, m = pack_family_cond("sd15", np.zeros((1, 77, 768)), np.ones((1, 77)))
    assert e.shape == (1, 77, 768) and m.shape == (1, 77)


def test_port_lora_round_trip_on_the_unet(sd15_pair, tmp_path):
    """The port's init_lora over the UNet's attention projections (the
    smoke's rank-64 kind at rank 2), written with its save_kohya, reads back
    through load_lora onto the same weights."""
    _, pipe, _, _ = sd15_pair
    lora = tadapter.init_lora(
        pipe.unet, rank=2, generator=torch.Generator().manual_seed(0),
        target=lambda path, shape: path[-1] in ("to_q", "to_k", "to_v", "to_out"))
    blocks = [m for m in pipe.unet.modules() if isinstance(m, tunet.TransformerBlock)]
    assert len(lora.params) == len(blocks) * 2 * 4  # 2 attentions of 4 projections each
    out = str(tmp_path / "port_lora.safetensors")
    tlora_io.save_kohya(lora, out, dtype=np.float32)
    again = tlora_io.load_lora(out, model=pipe.unet)
    assert again.params.keys() == lora.params.keys()
    for p, e in lora.params.items():
        torch.testing.assert_close(again.params[p]["a"], e["a"], rtol=0, atol=0)
