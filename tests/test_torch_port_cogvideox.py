"""CogVideoX serving in the port against the JAX package: the schedule, the
layers (modulate, apply_rotary), the 3D position tables, one block and the
tiny transformer under both position schemes, the tiny 4-NFE rollout
against the committed golden, the converter and manifests, both
`from_pretrained` layouts, the slice-6 refusals, and the HTTP server's GIF
replies at `--device cpu`, at tiny sizes on the CPU.

Inputs are drawn with numpy from fixed seeds (the golden's noise by JAX, as
tests/test_golden_grids.py makes it) and handed to both packages; JAX
parameters cross through the weight carry (`io/from_jax.py`). The models run
in fp32 and agree to fp32 roundoff (the same sums in another order): a
relative L2 of 1e-5 for blocks and transformers, 1e-6 for the schedule's
tables, bit for bit for the host-side numpy tables; the golden is held at
tests/test_golden_grids.py's own 5e-4. The pipelines round their sampler
state to bf16 at every step in both packages, so latents are held to one
bf16 ulp of their scale with under 1% of elements differing, and frames to
2e-3, half a step of an 8-bit channel.
"""

import base64
import dataclasses
import io
import json
import os
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu.core import sampling as jsampling, schedules as jsched
from tdm_tpu.io import convert as jconvert, manifest as jmanifest
from tdm_tpu.models import cogvideox as jcog, layers as jlayers, vae3d as jvae3d
from tdm_tpu.pipelines import loading as jloading
from tdm_tpu.pipelines.cogvideox import (
    TDM_TRAINED_GRID as JGRID, CogVideoXPipeline as JaxCogVideoXPipeline,
)
from tdm_tpu_torch.core import sampling as tsampling, schedules as tsched
from tdm_tpu_torch.data.prompts import EmbeddingCache, pack_family_cond
from tdm_tpu_torch.io import convert as tconvert, from_jax, manifest as tmanifest
from tdm_tpu_torch.models import cogvideox as tcog, layers as tlayers, vae3d as tvae3d
from tdm_tpu_torch.pipelines import (
    CogVideoXPipeline, PipelineOutput, from_pretrained, save_pretrained,
)
from tdm_tpu_torch.pipelines.cogvideox import TDM_TRAINED_GRID
from tdm_tpu_torch.serve import batcher as tbatcher, server as tserver

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_ATOL = 5e-4  # tests/test_golden_grids.py's tolerance
F32 = {"dtype": "float32", "attn_impl": "xla"}
TXT = 8  # the tiny config's text length


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a, np.float32)) for a in arrays)


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def assert_bf16_state_close(got: torch.Tensor, ref) -> None:
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    diff = np.abs(got - ref)
    assert diff.max() <= 2**-7 * np.abs(ref).max(), diff.max()
    assert np.mean(diff > 0) < 0.01, np.mean(diff > 0)


def port_model(params, cfg) -> tcog.CogVideoXTransformer3D:
    """The port's transformer holding JAX `params`, carried by from_jax."""
    model = tcog.CogVideoXTransformer3D(cfg, device="cpu")
    model.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(params), model))
    return model.eval()


def inputs(seed, b=2, f=3, side=8):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, 16, f, side, side)).astype(np.float32)
    t = rng.integers(0, 1000, size=b).astype(np.float32)
    text = rng.standard_normal((b, TXT, 32)).astype(np.float32)
    return lat, t, text


# --- the schedule, the layers and the tables ---------------------------------


def test_cogvideox_schedule_matches_jax():
    """Scaled-linear β, the SNR shift at 3 and the zero-terminal-SNR rescale,
    in float64 on the host both sides, v-prediction; σ at t = 999 is 1."""
    j, t = jsched.cogvideox(), tsched.cogvideox(device="cpu")
    np.testing.assert_allclose(t.alphas.numpy(), np.asarray(j.alphas), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.sigmas.numpy(), np.asarray(j.sigmas), rtol=0, atol=1e-6)
    assert (t.num_train_timesteps, t.prediction_type) == (1000, "v_prediction")
    assert t.alphas[-1].item() == 0.0 and t.sigmas[-1].item() == 1.0
    assert TDM_TRAINED_GRID == JGRID == (999, 856, 665, 399)


def test_modulate_and_apply_rotary_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    shift, scale = rng.standard_normal((2, 2, 8)).astype(np.float32)
    for sh, sc in ((shift, scale), (shift[:, None], scale[:, None])):
        np.testing.assert_allclose(
            tlayers.modulate(*_t(x, sh, sc)).numpy(),
            np.asarray(jlayers.modulate(x, sh, sc)), rtol=1e-6, atol=1e-6)
    q = rng.standard_normal((2, 3, 12, 16)).astype(np.float32)
    cos, sin = jcog.rope_3d(16, 3, 2, 2)
    np.testing.assert_allclose(
        tlayers.apply_rotary(*_t(q), _t(cos, sin)).numpy(),
        np.asarray(jlayers.apply_rotary(q, (cos, sin))), rtol=1e-6, atol=1e-6)
    qb = torch.from_numpy(q).bfloat16()
    assert tlayers.apply_rotary(qb, _t(cos, sin)).dtype == torch.bfloat16


@pytest.mark.parametrize("dims", [(1920, 13, 30, 45), (32, 3, 4, 4), (96, 2, 3, 5)])
def test_position_tables_match_jax(dims):
    """The 2B's sin-cos table (at the full 49-frame 480×720 grid too) and the
    5B's RoPE tables, host numpy both sides: bit for bit."""
    dim, f, gh, gw = dims
    np.testing.assert_array_equal(tcog.sincos_3d(dim, f, gh, gw), jcog.sincos_3d(dim, f, gh, gw))
    d = min(dim, 64)
    for a, b in zip(tcog.rope_3d(d, f, gh, gw), jcog.rope_3d(d, f, gh, gw)):
        np.testing.assert_array_equal(a, b)


# --- the block and the transformer -------------------------------------------


@pytest.mark.parametrize("use_rotary", [False, True], ids=["sincos", "rope"])
def test_block_matches_jax(use_rotary):
    """One CogVideoXBlock (text first, shared affine LayerNormZero, per-head
    qk LayerNorm, RoPE on the video rows) on JAX's parameters, fp32."""
    cfg = jcog.CogVideoXConfig.tiny(use_rotary=use_rotary)
    block = jcog.CogVideoXBlock(cfg=cfg)
    rng = np.random.default_rng(2)
    f, gh, gw = 3, 2, 2
    x = rng.standard_normal((2, f * gh * gw, cfg.hidden)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, cfg.hidden)).astype(np.float32)
    temb = rng.standard_normal((2, cfg.time_embed_dim)).astype(np.float32)
    rotary = jcog.rope_3d(cfg.head_dim, f, gh, gw) if use_rotary else None
    params = block.init(jax.random.PRNGKey(2), x, ctx, temb, rotary)["params"]
    jx, jctx = block.apply({"params": params}, x, ctx, temb, rotary)
    tb = tcog.CogVideoXBlock(tcog.CogVideoXConfig.tiny(use_rotary=use_rotary), device="cpu")
    tb.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(params), tb))
    with torch.no_grad():
        tx, tctx = tb(*_t(x, ctx, temb), None if rotary is None else _t(*rotary))
    assert rel_l2(tx, jx) < 1e-5 and rel_l2(tctx, jctx) < 1e-5


@pytest.fixture(scope="module")
def golden_tuple():
    """The golden's model, noise and text, made by JAX as
    tests/test_golden_grids.py:129-153 makes them (seeds 8888, 46, 10)."""
    cfg = jcog.CogVideoXConfig.tiny()
    model = jcog.CogVideoXTransformer3D(cfg=cfg)
    noise = jax.random.normal(
        jax.random.PRNGKey(8888),
        (1, cfg.in_channels, cfg.sample_frames, cfg.sample_h, cfg.sample_w))
    text = jax.random.normal(jax.random.PRNGKey(46), (1, cfg.max_text_len, cfg.text_dim)) * 0.1
    params = model.init(jax.random.PRNGKey(10), noise, jnp.zeros((1,)), text)["params"]
    return model, params, np.asarray(noise), np.asarray(text)


@pytest.mark.parametrize("use_rotary", [False, True], ids=["sincos", "rope"])
def test_tiny_transformer_matches_jax(use_rotary):
    """The tiny transformer (2 layers, stacked 'blocks' tree) on JAX's
    parameters, fp32, under both position schemes."""
    cfg = jcog.CogVideoXConfig.tiny(use_rotary=use_rotary)
    model = jcog.CogVideoXTransformer3D(cfg=cfg)
    lat, t, text = inputs(3)
    params = model.init(jax.random.PRNGKey(4), lat, t, text)["params"]
    assert "blocks" in params  # the scan_layers layout
    ref = np.asarray(jax.jit(model.apply)({"params": params}, lat, t, text))
    with torch.no_grad():
        got = port_model(params, tcog.CogVideoXConfig.tiny(use_rotary=use_rotary))(
            *_t(lat, t, text)).numpy()
    assert got.shape == lat.shape and rel_l2(got, ref) < 1e-5


def test_tiny_cogvideox_4nfe_matches_the_golden(golden_tuple):
    """The tiny model's 4-NFE rollout on TDM_TRAINED_GRID under the
    cogvideox schedule (the pipeline's sampler and denoiser) against the
    committed golden, in fp32."""
    _, params, noise, text = golden_tuple
    model = port_model(params, tcog.CogVideoXConfig.tiny())
    with torch.no_grad():
        got = tsampling.sample_fewstep(
            tcog.make_denoise_fn(model), tsched.cogvideox(device="cpu"), *_t(noise, text),
            timestep_grid=tsched.grid_from_list(TDM_TRAINED_GRID))
    ref = np.load(os.path.join(GOLDEN, "cogvideox_tiny_4nfe.npz"))["latents"]
    np.testing.assert_allclose(got.numpy(), ref, atol=GOLDEN_ATOL, rtol=GOLDEN_ATOL)


def test_slice6_options_raise():
    """Pipeline parallelism waits for slice 6. Sequence parallelism is
    ported (tests/test_torch_port_sp.py): its misuses raise the JAX
    package's ValueErrors, word for word — sequence_parallel_apply on a
    model whose config names no axis, and the pipeline's mesh without the
    config's axis or the axis without a mesh; a data-parallel or a separate
    tensor-parallel knob on a sequence-parallel pipeline."""
    from tdm_tpu_torch.parallel import mesh as pmesh
    from tdm_tpu_torch.parallel import tp as ttp

    with pytest.raises(NotImplementedError, match="slice 6"):
        tcog.make_pp_forward(None, None)
    mono = tcog.CogVideoXTransformer3D(tcog.CogVideoXConfig.tiny(), device="cpu")
    jmono = jcog.CogVideoXTransformer3D(cfg=jcog.CogVideoXConfig.tiny())
    with pytest.raises(ValueError) as terr:
        tcog.sequence_parallel_apply(mono, pmesh.make_mesh())
    with pytest.raises(ValueError) as jerr:
        jcog.sequence_parallel_apply(jmono, None)
    assert str(terr.value) == str(jerr.value)
    spm = tcog.CogVideoXTransformer3D(
        dataclasses.replace(tcog.CogVideoXConfig.tiny(), sequence_parallel_axis="sp"),
        device="cpu")
    with pytest.raises(ValueError, match="must be set together"):
        CogVideoXPipeline(mono, sequence_parallel_mesh=pmesh.make_mesh(), device="cpu")
    with pytest.raises(ValueError, match="must be set together"):
        CogVideoXPipeline(spm, device="cpu")
    pipe = CogVideoXPipeline(spm, sequence_parallel_mesh=pmesh.make_mesh(), device="cpu")
    with pytest.raises(ValueError, match="sequence_parallel_mesh and data_parallel_mesh are "
                                         "mutually exclusive"):
        pipe.data_parallel_devices = ["cpu", "cpu"]
    with pytest.raises(ValueError, match="sequence_parallel_mesh and tensor_parallel_mesh are "
                                         "mutually exclusive"):
        pipe.tensor_parallel = ttp.TPGroup(1)
    with pytest.raises(ValueError, match="no tokenizer/text_encoder"):
        CogVideoXPipeline(mono, device="cpu")(["a cat"])


def test_full_width_2b_parameters_and_attention_shape():
    """CogVideoX-2B on the meta device: its parameter count equals the
    manifest's, 30 blocks of 30 heads × 64, and one 49-frame 480×720 call
    attends over 226 + 13·30·45 = 17,776 tokens."""
    model = tcog.CogVideoXTransformer3D(device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in tmanifest.expected_manifest("cogvideox").values())
    c = model.cfg
    assert (c.num_layers, c.num_heads, c.head_dim, c.hidden) == (30, 30, 64, 1920)
    assert c.max_text_len + 13 * (60 // 2) * (90 // 2) == 17_776
    pipe = CogVideoXPipeline(model, device="meta")
    assert pipe.latent_shape(1, 49, 480, 720) == (1, 16, 13, 60, 90)


# --- checkpoints -----------------------------------------------------------------


@pytest.mark.parametrize("family,tiny", [
    ("cogvideox", True), ("cogvideox", False), ("vae3d_decoder", True), ("vae3d_decoder", False),
])
def test_manifests_equal_jax(family, tiny):
    tcfg = jcfg = None
    if tiny and family == "cogvideox":
        tcfg, jcfg = tcog.CogVideoXConfig.tiny(), jcog.CogVideoXConfig.tiny()
    elif tiny:
        tcfg, jcfg = tvae3d.VAE3DConfig.tiny(), jvae3d.VAE3DConfig.tiny()
    assert tmanifest.expected_manifest(family, tcfg) == jmanifest.expected_manifest(family, jcfg)


def test_converter_matches_jax():
    """`cogvideox_params` on a seeded state dict: JAX's tree leaf for leaf,
    stacked and unrolled; the 2B's position buffer is ignored, a leftover
    key raises and a missing one names the family."""
    cfg = tcog.CogVideoXConfig.tiny()
    sd = tmanifest.synthetic_state_dict("cogvideox", cfg, seed=4)
    sd["patch_embed.pos_embedding"] = np.zeros((1, 5, 32), np.float32)
    for scan in (True, False):
        got = tconvert.flatten(tconvert.cogvideox_params(sd, scan_layers=scan))
        ref = from_jax.flatten_tree(jconvert.cogvideox_params(sd, scan_layers=scan))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)
    with pytest.raises(ValueError, match="never consumed"):
        tconvert.cogvideox_params({**sd, "extra.weight": np.zeros(1)})
    sd.pop("transformer_blocks.1.attn1.norm_k.weight")
    with pytest.raises(KeyError, match="cogvideox converter"):
        tconvert.cogvideox_params(sd)


VCFG = dict(block_widths=(8, 8, 16, 16), layers_per_block=1, norm_groups=4)


def write_cog_checkout(root, cfg, vcfg, *, seed=0) -> str:
    """A stock CogVideoX diffusers checkout: model_index.json, transformer/
    (its config counting pixel frames) and vae/ (an AutoencoderKLCogVideoX
    decoder in the JAX package's key layout), each a config.json and one
    fp16 safetensors file of seeded weights."""
    root = str(root)
    files = {
        "model_index.json": {"_class_name": "CogVideoXPipeline"},
        "transformer/config.json": {
            "_class_name": "CogVideoXTransformer3DModel", "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels, "patch_size": cfg.patch_size,
            "num_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "attention_head_dim": cfg.head_dim, "text_embed_dim": cfg.text_dim,
            "time_embed_dim": cfg.time_embed_dim, "max_text_seq_length": cfg.max_text_len,
            "sample_frames": (cfg.sample_frames - 1) * 4 + 1, "sample_height": cfg.sample_h,
            "sample_width": cfg.sample_w, "temporal_compression_ratio": 4,
            "use_rotary_positional_embeddings": cfg.use_rotary},
        "vae/config.json": {
            "_class_name": "AutoencoderKLCogVideoX", "latent_channels": vcfg.latent_channels,
            "block_out_channels": list(vcfg.block_widths),
            "layers_per_block": vcfg.layers_per_block, "norm_num_groups": vcfg.norm_groups,
            "scaling_factor": vcfg.scaling_factor,
            "temporal_compression_ratio": vcfg.temporal_factor},
    }
    for name, conf in files.items():
        os.makedirs(os.path.dirname(os.path.join(root, name)), exist_ok=True)
        with open(os.path.join(root, name), "w") as f:
            json.dump(conf, f)
    tmanifest.write_synthetic("cogvideox", os.path.join(
        root, "transformer", "diffusion_pytorch_model.safetensors"), cfg, seed=seed, scale=0.1)
    tmanifest.write_synthetic("vae3d_decoder", os.path.join(
        root, "vae", "diffusion_pytorch_model.safetensors"), vcfg, seed=seed + 1, scale=0.3)
    return root


CALL = dict(num_inference_steps=4, num_frames=9, height=64, width=64)


@pytest.mark.parametrize("use_rotary", [False, True], ids=["sincos", "rope"])
def test_from_pretrained_cogvideox_checkout_matches_jax(tmp_path, use_rotary):
    """A tiny CogVideoX checkout (the 3D decoder at the released topology,
    narrow) through both packages' from_pretrained: the port holds JAX's
    converted weights, and one 4-NFE batch of 9 frames gives JAX's latents
    and frames."""
    cfg = dataclasses.replace(tcog.CogVideoXConfig.tiny(), use_rotary=use_rotary)
    vcfg = dataclasses.replace(tvae3d.VAE3DConfig(), **VCFG)
    root = write_cog_checkout(tmp_path / "cog", cfg, vcfg)
    jpipe = jloading.from_pretrained(root, model_config=F32)
    pipe = from_pretrained(root, device="cpu", model_config=F32)
    assert isinstance(pipe, CogVideoXPipeline) and pipe.family == "cogvideox"
    assert pipe.transformer.cfg == cfg  # 9 pixel frames → 3 latent frames
    assert isinstance(pipe.vae_decoder, tvae3d.VAE3DDecoder) and pipe.vae_cfg == vcfg
    port = from_jax.jax_layout(pipe.transformer.state_dict(),
                               stacks=from_jax.layer_stacks(pipe.transformer.cfg))
    for k, ref in from_jax.flatten_tree(jpipe.params).items():
        np.testing.assert_array_equal(port[k], ref, err_msg=k)
    lat, _, text = inputs(6, b=2)
    ref = jpipe(prompt_embeds=jnp.asarray(text), latents=jnp.asarray(lat), **CALL)
    got = pipe(prompt_embeds=text, latents=lat, **CALL)
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))
    assert got.frames.shape == (2, 9, 64, 64, 3)  # 3 spatial ×2 stages of the 4
    np.testing.assert_allclose(got.frames.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)


@pytest.fixture(scope="module")
def cog_pair(golden_tuple, tmp_path_factory):
    """The tiny JAX CogVideoX pipeline (the golden's transformer, the tiny
    3D decoder, tiles of 6 latents overlapping by 2) written with the JAX
    package's save_pretrained, and the port's pipeline loaded from it."""
    model, params, *_ = golden_tuple
    vcfg = jvae3d.VAE3DConfig.tiny()
    dec = jvae3d.VAE3DDecoder(cfg=vcfg)
    vparams = dec.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 2, 4, 4)))["params"]
    jpipe = JaxCogVideoXPipeline(model, params, vae_decoder=dec, vae_params=vparams,
                                 vae_cfg=vcfg, vae_tile=6, vae_tile_overlap=2)
    path = str(tmp_path_factory.mktemp("cog_jax"))
    jpipe.save_pretrained(path)
    return jpipe, from_pretrained(path, device="cpu", vae_tile=6, vae_tile_overlap=2), path


def test_cogvideox_layout_both_ways(cog_pair, tmp_path):
    """A directory the JAX package wrote loads into the port, gives JAX's
    batch through a tiled decode (8×10 latents in 6-tiles overlapping by 2),
    with a streamed one within fp32 roundoff of it, and the port's save_pretrained writes
    one the JAX package loads back to the same weights."""
    jpipe, pipe, _ = cog_pair
    assert pipe.transformer.cfg == tcog.CogVideoXConfig.tiny()
    assert pipe.vae_cfg == tvae3d.VAE3DConfig.tiny()
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((2, 16, 3, 8, 10)).astype(np.float32)
    text = rng.standard_normal((2, TXT, 32)).astype(np.float32)
    call = dict(num_frames=5, height=16, width=20)
    ref = jpipe(prompt_embeds=jnp.asarray(text), latents=jnp.asarray(lat), **call)
    got = pipe(prompt_embeds=text, latents=lat, **call)
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))
    assert got.frames.shape == (2, 5, 16, 20, 3)
    np.testing.assert_allclose(got.frames.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)
    pipe.vae_temporal_chunk = 2
    try:
        streamed = pipe.decode(got.latents)
    finally:
        pipe.vae_temporal_chunk = None
    tiled = pipe.decode(got.latents)  # the streamed decode's frames: tests/test_torch_port_vae3d.py
    assert (streamed - tiled).abs().max() <= 1e-5 * tiled.abs().max()
    out = str(tmp_path / "port_written")
    save_pretrained(out, pipe)
    back = jloading.from_pretrained(out)
    assert back.family == "cogvideox" and back.transformer.cfg == jpipe.transformer.cfg
    for tree_a, tree_b in ((back.params, jpipe.params), (back.vae_params, jpipe.vae_params)):
        a, b = from_jax.flatten_tree(tree_a), from_jax.flatten_tree(tree_b)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_decode_is_per_video(cog_pair):
    """The pipeline decodes one video at a time, so a video's frames are
    the same bits whatever its batch-mate (the served determinism rule)."""
    _, pipe, _ = cog_pair
    z = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 16, 3, 8, 10))
                         .astype(np.float32))
    with torch.no_grad():
        pair = pipe.decode(z)
        alone = pipe.decode(z[1:])
        other = pipe.decode(torch.stack([z[0] * 2, z[1]]))
    assert pair.shape == (2, 3, 5, 16, 20)
    torch.testing.assert_close(pair[1:], alone, rtol=0, atol=0)
    torch.testing.assert_close(other[1:], alone, rtol=0, atol=0)


def test_pipeline_calls_like_jax(cog_pair):
    """The pipeline's call conventions against JAX: a latent output,
    num_videos_per_prompt and another step count's fewstep grid; CFG above
    1 with the zero uncond of a pipeline without an encoder (JAX's rule),
    after one step: the mix u + w·(c − u) is fused by XLA:CPU with excess
    precision where eager PyTorch rounds each op to bf16, so, as
    tests/test_torch_port_pipeline.py's CFG test holds it, up to one bf16
    ulp of the largest latent and a relative L2 of 1e-2, where the same call
    without CFG is off by several times that (the tiny model's text moves
    its output little at t = 999). `.frames` exists only on a video."""
    jpipe, pipe, _ = cog_pair
    rng = np.random.default_rng(9)
    text = rng.standard_normal((1, TXT, 32)).astype(np.float32)
    lat = rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32)
    call = dict(num_frames=5, height=16, width=16, output_type="latent",
                num_videos_per_prompt=2, num_inference_steps=3)
    ref = jpipe(prompt_embeds=jnp.asarray(text), latents=jnp.asarray(lat), **call)
    got = pipe(prompt_embeds=text, latents=lat, **call)
    assert got.images is None and got.latents.shape == (2, 16, 3, 8, 8)
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))
    one = dict(call, num_inference_steps=1)
    ref = np.asarray(jpipe(prompt_embeds=jnp.asarray(text), latents=jnp.asarray(lat),
                           guidance_scale=3.0, **one).latents.astype(jnp.float32))
    got = pipe(prompt_embeds=text, latents=lat, guidance_scale=3.0, **one).latents
    diff = got.float().numpy() - ref
    assert np.abs(diff).max() <= 2**-7 * np.abs(ref).max()
    assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(ref)
    no_cfg = pipe(prompt_embeds=text, latents=lat, **one).latents.float().numpy()
    assert np.linalg.norm(no_cfg - ref) > 3e-2 * np.linalg.norm(ref)
    with pytest.raises(AttributeError, match="frames"):
        PipelineOutput(images=None, latents=got).frames
    with pytest.raises(AttributeError, match="frames"):
        PipelineOutput(images=torch.zeros(1, 4, 4, 3)).frames


# --- the server ------------------------------------------------------------------


def _gif_blocks(gif: bytes) -> dict:
    """The structure of a GIF89a byte string, read without an imaging
    package: size, loop count, each frame's delay."""
    assert gif[:6] == b"GIF89a" and gif[-1:] == b"\x3b"
    w, h, packed = int.from_bytes(gif[6:8], "little"), int.from_bytes(gif[8:10], "little"), gif[10]
    pos = 13 + (3 * 2 ** ((packed & 7) + 1) if packed & 0x80 else 0)
    loop, delays, frames = None, [], 0
    while gif[pos] != 0x3B:
        if gif[pos] == 0x21:
            label = gif[pos + 1]
            pos += 2
            blocks = []
            while gif[pos]:
                blocks.append(gif[pos + 1:pos + 1 + gif[pos]])
                pos += 1 + gif[pos]
            pos += 1
            if label == 0xFF and blocks[0] == b"NETSCAPE2.0":
                loop = int.from_bytes(blocks[1][1:3], "little")
            elif label == 0xF9:
                delays.append(int.from_bytes(blocks[0][1:3], "little"))
        else:
            assert gif[pos] == 0x2C
            pos += 11  # the descriptor (no local table) and the LZW code size
            while gif[pos]:
                pos += 1 + gif[pos]
            pos += 1
            frames += 1
    return {"size": (w, h), "loop": loop, "delays": delays, "frames": frames}


def test_server_serves_tiny_cogvideox_videos(cog_pair, tmp_path):
    """The HTTP server at --device cpu over the JAX-written tiny CogVideoX
    dir, --num_frames 9 at 16×16 from a T5-shaped cache: GIF replies of 9
    frames that Pillow reads back within the fixed palette's half step of
    the pipeline's own frames for the seed's noise, with the NETSCAPE loop
    block and 12 cs (125 ms as Pillow writes it) delays; the same seed gives
    the same bytes alone and in a batch of 2."""
    from PIL import Image

    _, pipe, path = cog_pair
    rng = np.random.default_rng(12)
    cache = str(tmp_path / "t5_cache.npz")
    EmbeddingCache(rng.standard_normal((2, TXT, 32)).astype(np.float16),
                   np.ones((2, TXT), np.int32), ["a castle", "a lake"]).save(cache)
    args = tserver.parse_args([
        "--model", path, "--device", "cpu", "--embedding_cache", cache, "--port", "0",
        "--batch_size", "2", "--max_delay_ms", "500", "--num_frames", "9",
        "--height", "16", "--width", "16",
    ])
    server = tserver.build_server(args).start()

    def post(prompt, seed):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate",
            data=json.dumps({"prompt": prompt, "seed": seed}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        assert tbatcher.latent_shape(server.batcher.pipe, server.batcher.call_kwargs) == (
            1, 16, 5, 8, 8)
        with ThreadPoolExecutor(2) as ex:
            pair = list(ex.map(lambda a: post(*a), [("a lake", 5), ("a castle", 6)]))
        alone = post("a lake", 5)
        batches = server.batcher.stats.batches
        served = server.batcher.pipe
        direct = served(prompt_embeds=server.batcher.cond_fn("a lake"),
                        latents=tbatcher.request_noise(5, (1, 16, 5, 8, 8)),
                        num_frames=9, height=16, width=16).frames[0].numpy()
    finally:
        server.close()
    assert batches == 2
    reply = pair[0]
    assert reply["format"] == "gif" and reply["shape"] == [9, 16, 16, 3]
    gif = base64.b64decode(reply["video"])
    assert alone["video"] == reply["video"] and pair[1]["video"] != reply["video"]
    blocks = _gif_blocks(gif)
    assert blocks == {"size": (16, 16), "loop": 0, "delays": [12] * 9, "frames": 9}
    im = Image.open(io.BytesIO(gif))
    assert im.n_frames == 9 and im.info["loop"] == 0
    half = 255.0 / (np.array(tserver.GIF_LEVELS) - 1) / 2 + 0.5
    for i in range(9):
        im.seek(i)
        assert im.info["duration"] == 120
        rgb = np.asarray(im.convert("RGB"), np.float64)
        assert (np.abs(rgb - direct[i] * 255.0) <= half).all(), i
    e = np.zeros((1, 226, 4096), np.float32)
    assert pack_family_cond("cogvideox", e, np.ones((1, 226))) is e


def test_gif_encoder_round_trips_through_pil():
    """`encode_gif` on frames with flat areas and noise (table resets at
    4095 codes included): Pillow decodes every frame to the palette colours
    of `gif_indices`, with the loop block and the 12 cs delays."""
    from PIL import Image

    rng = np.random.default_rng(0)
    frames = rng.random((3, 90, 120, 3)).astype(np.float32)
    frames[1, :45] = 0.25
    gif = tserver.encode_gif(frames)
    idx, pal = tserver.gif_indices(frames), tserver.gif_palette()
    assert len(np.unique(pal[:252], axis=0)) == 252 and (pal[252:] == 0).all()
    im = Image.open(io.BytesIO(gif))
    assert im.n_frames == 3 and im.size == (120, 90) and im.info["loop"] == 0
    for i in range(3):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), pal[idx[i]])
    assert gif == tserver.encode_gif(frames)
    with pytest.raises(ValueError, match="F, H, W, 3"):
        tserver.encode_gif(frames[0])


def test_num_frames_is_for_the_video_model(tmp_path):
    """--num_frames is refused for an image family before any request;
    pack_family_cond keeps the other families' tuples."""
    from tdm_tpu_torch.models import pixart as tpixart
    from tdm_tpu_torch.pipelines import PixArtPipeline

    path = str(tmp_path / "pixart")
    save_pretrained(path, PixArtPipeline(
        tpixart.PixArtTransformer2D(tpixart.PixArtConfig.tiny(), device="cpu"), device="cpu"))
    args = tserver.parse_args(["--model", path, "--device", "cpu", "--num_frames", "17"])
    assert args.num_frames == 17
    with pytest.raises(ValueError, match="--num_frames applies to the video model"):
        tserver.build_server(args)
    e, m = np.zeros((1, 3, 4)), np.ones((1, 3))
    assert pack_family_cond("pixart", e, m)[1] is m
