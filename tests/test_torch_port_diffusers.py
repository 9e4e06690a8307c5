"""Stock diffusers checkouts in the port against the JAX package: the key
manifests, the strict converters and the folder rule of the state-dict
reader, the KL VAE decoder and its tiled decode, `from_pretrained` on a
checkout and on a cached hub repo id, the server, and the training CLI's
teacher directory, at tiny sizes on the CPU.

Checkouts are written from the port's manifests with weights drawn from
numpy seeds (the JAX package's own synthetic numbers), and both packages
read the same files. The converters are held bit for bit. The KL decoder
runs in fp32 in both: the same convs, GroupNorms and softmax with sums in
another order, so its output is held to 1e-4 of its largest magnitude. The
pipelines round the sampler state to bf16 at every step in both packages
(tests/test_torch_port_pipeline.py says why), so fp32 pipelines hold their
latents to one bf16 ulp of their scale with under 1% of elements differing,
and their images to 2e-3, half a step of the 8-bit PNG they are served as.
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

from tdm_tpu.io import convert as jconvert, hub as jhub, manifest as jmanifest
from tdm_tpu.models import mmdit_sd3 as jmmdit, pixart as jpixart, vae as jvae
from tdm_tpu.pipelines import base as jbase, loading as jloading
from tdm_tpu_torch.data.prompts import EmbeddingCache
from tdm_tpu_torch.io import convert as tconvert, from_jax, hub as thub, manifest as tmanifest
from tdm_tpu_torch.io import params as params_io
from tdm_tpu_torch.models import mmdit_sd3 as tmmdit, pixart as tpixart, vae as tvae
from tdm_tpu_torch.pipelines import PixArtPipeline, from_pretrained, save_pretrained
from tdm_tpu_torch.pipelines import base as tbase
from tdm_tpu_torch.pipelines.sd3 import SD3Pipeline
from tdm_tpu_torch.serve import server as tserver

torch.set_num_threads(2)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "manifests")
F32 = {"dtype": "float32", "attn_impl": "xla"}
PIX_CALL = dict(num_inference_steps=4, height=128, width=128)
SD3_CALL = dict(num_inference_steps=4, height=64, width=64)
# the VAE's synthetic weights: large enough that the decoded images spread
# over [0, 1] (at the transformers' 0.02 every pixel would sit near 0.5)
VAE_SCALE = 0.3


# --- configs of both packages -------------------------------------------------


def _sd35_tiny(pkg):
    return dataclasses.replace(pkg.MMDiTConfig.tiny(), num_layers=3, qk_norm="rms",
                               dual_attention_layers=(0,))


def _kl_sd3_tiny(pkg):
    return dataclasses.replace(pkg.KLVAEConfig.sd3(), block_widths=(8, 16), norm_groups=4)


def _taesd_tiny(pkg):
    return pkg.TAESDConfig(width=8, num_stages=1, blocks_per_stage=1)


# name → (manifest family, config factory taking the models module of a package)
CONFIGS = {
    "pixart-tiny": ("pixart", lambda m: m["pixart"].PixArtConfig.tiny()),
    "pixart": ("pixart", lambda m: m["pixart"].PixArtConfig()),
    "sd3-tiny": ("sd3", lambda m: m["mmdit"].MMDiTConfig.tiny()),
    "sd3": ("sd3", lambda m: m["mmdit"].MMDiTConfig()),
    "sd35-tiny": ("sd3", lambda m: _sd35_tiny(m["mmdit"])),
    "sd35-medium": ("sd3", lambda m: m["mmdit"].MMDiTConfig.sd35_medium()),
    "klvae-tiny": ("klvae", lambda m: m["vae"].KLVAEConfig.tiny()),
    "klvae": ("klvae", lambda m: m["vae"].KLVAEConfig()),
    "klvae-sd3": ("klvae", lambda m: m["vae"].KLVAEConfig.sd3()),
    "klvae-sd3-tiny": ("klvae", lambda m: _kl_sd3_tiny(m["vae"])),
    "taesd-tiny": ("taesd", lambda m: _taesd_tiny(m["vae"])),
    "taesd": ("taesd", lambda m: m["vae"].TAESDConfig()),
    "taesd3": ("taesd3", lambda m: m["vae"].TAESDConfig.taesd3()),
}
JAX_MODELS = {"pixart": jpixart, "mmdit": jmmdit, "vae": jvae}
PORT_MODELS = {"pixart": tpixart, "mmdit": tmmdit, "vae": tvae}


def configs(name):
    family, make = CONFIGS[name]
    return family, make(JAX_MODELS), make(PORT_MODELS)


# --- checkouts ----------------------------------------------------------------


def _json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def transformer_config(family, cfg) -> dict:
    """The diffusers transformer config.json of a port config."""
    out = {"sample_size": cfg.sample_size, "patch_size": cfg.patch_size,
           "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
           "num_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
           "attention_head_dim": cfg.head_dim}
    if family == "pixart":
        return {"_class_name": "PixArtTransformer2DModel", **out,
                "caption_channels": cfg.caption_dim}
    return {"_class_name": "SD3Transformer2DModel", **out,
            "joint_attention_dim": cfg.context_dim,
            "pooled_projection_dim": cfg.pooled_dim,
            "pos_embed_max_size": cfg.pos_embed_max_size,
            "qk_norm": "rms_norm" if cfg.qk_norm == "rms" else None,
            "dual_attention_layers": list(cfg.dual_attention_layers)}


def vae_config(vcfg) -> tuple[str, dict]:
    """(manifest family, diffusers vae/config.json) of a port VAE config."""
    if isinstance(vcfg, tvae.KLVAEConfig):
        return "klvae", {
            "_class_name": "AutoencoderKL", "latent_channels": vcfg.latent_channels,
            "block_out_channels": list(vcfg.block_widths),
            "layers_per_block": vcfg.layers_per_block,
            "norm_num_groups": vcfg.norm_groups, "scaling_factor": vcfg.scaling_factor,
            "shift_factor": vcfg.shift_factor if vcfg.shift_factor else None}
    return "taesd", {
        "_class_name": "AutoencoderTiny", "latent_channels": vcfg.latent_channels,
        "scaling_factor": vcfg.scaling_factor, "shift_factor": vcfg.shift_factor,
        "decoder_block_out_channels": [vcfg.width] * (vcfg.num_stages + 1),
        "num_decoder_blocks": [vcfg.blocks_per_stage] * vcfg.num_stages + [1]}


def write_checkout(root, family, cfg, vcfg=None, *, seed=0) -> str:
    """A diffusers checkout: model_index.json, transformer/ and an optional
    vae/, each a config.json and one fp16 safetensors file of seeded
    weights, as the hub ships them."""
    root = str(root)
    pipeline = {"pixart": "PixArtAlphaPipeline", "sd3": "StableDiffusion3Pipeline"}[family]
    _json(os.path.join(root, "model_index.json"), {"_class_name": pipeline})
    _json(os.path.join(root, "transformer", "config.json"), transformer_config(family, cfg))
    tmanifest.write_synthetic(
        family, os.path.join(root, "transformer", "diffusion_pytorch_model.safetensors"),
        cfg, seed=seed)
    if vcfg is not None:
        vfamily, conf = vae_config(vcfg)
        _json(os.path.join(root, "vae", "config.json"), conf)
        tmanifest.write_synthetic(
            vfamily, os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"),
            vcfg, seed=seed + 1, scale=VAE_SCALE)
    return root


def assert_bf16_state_close(got: torch.Tensor, ref) -> None:
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    diff = np.abs(got - ref)
    assert diff.max() <= 2**-7 * np.abs(ref).max(), diff.max()
    assert np.mean(diff > 0) < 0.01, np.mean(diff > 0)


def pix_inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, 4, 16, 16)).astype(np.float32)
    text = rng.standard_normal((b, 8, 32)).astype(np.float32)
    mask = (np.arange(8)[None] < np.array([8, 3, 1, 6][:b])[:, None]).astype(np.int32)
    return lat, text, mask


def pix_pair(root, model_config, seed=3):
    """The same call through the JAX pipeline and the port's, both loaded
    from `root`: (JAX output, port output)."""
    lat, text, mask = pix_inputs(seed)
    jpipe = jloading.from_pretrained(root, model_config=model_config)
    tpipe = from_pretrained(root, device="cpu", model_config=model_config)
    ref = jpipe(prompt_embeds=(jnp.asarray(text), jnp.asarray(mask)),
                latents=jnp.asarray(lat), **PIX_CALL)
    got = tpipe(prompt_embeds=(text, mask), latents=lat, **PIX_CALL)
    return tpipe, ref, got


# --- manifests ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_manifest_equals_jax(name):
    family, jcfg, tcfg = configs(name)
    assert tmanifest.expected_manifest(family, tcfg) == jmanifest.expected_manifest(family, jcfg)


@pytest.mark.parametrize("family", ["pixart", "sd3", "klvae", "taesd", "taesd3"])
def test_default_manifest_equals_jax(family):
    assert tmanifest.expected_manifest(family) == jmanifest.expected_manifest(family)


@pytest.mark.parametrize("fixture,family", [
    ("pixart_xl2_512", "pixart"), ("sd15_klvae", "klvae"), ("sd3_medium", "sd3"),
    ("taesd", "taesd"), ("taesd3", "taesd3"),
])
def test_manifest_equals_committed_fixture(fixture, family):
    committed = tmanifest.load_manifest(os.path.join(FIXDIR, f"{fixture}.json"))
    assert tmanifest.expected_manifest(family) == committed


def test_unported_manifests_raise():
    """A family with no converter raises; every family of the JAX package
    has its manifest in the port (unet_sd15: tests/test_torch_port_sd15.py;
    cogvideox and vae3d_decoder: tests/test_torch_port_cogvideox.py)."""
    assert set(tmanifest.MANIFEST_FAMILIES) == set(jmanifest.MANIFEST_FAMILIES)
    for family in ("cogvideox", "vae3d_decoder"):
        assert tmanifest.expected_manifest(family) == jmanifest.expected_manifest(family)
    with pytest.raises(ValueError, match="unknown manifest family"):
        tmanifest.expected_manifest("flux")


def test_check_manifest_reports_as_jax():
    """A renamed key, a wrong shape, an extra key and an ignored buffer,
    with and without a nesting prefix: the same report in both packages."""
    _, jcfg, tcfg = configs("pixart-tiny")
    good = tmanifest.expected_manifest("pixart", tcfg)
    bad = dict(good)
    key = "transformer_blocks.0.attn1.to_q.weight"
    bad[key.replace("to_q", "to_Q")] = bad.pop(key)
    bad["proj_out.bias"] = (7,)
    bad["bogus.weight"] = (1, 2)
    bad["caption_projection.y_embedding"] = (120, 32)
    for actual, prefix in ((bad, None), ({f"model.{k}": v for k, v in bad.items()}, "model.")):
        got = tmanifest.check_manifest("pixart", actual, tcfg, strip_prefix=prefix)
        assert got == jmanifest.check_manifest("pixart", actual, jcfg, strip_prefix=prefix)
        assert len(got) == 4
    assert tmanifest.check_manifest("pixart", good, tcfg) == []


def test_synthetic_weights_and_headers_match_jax(tmp_path):
    """The seeded synthetic state dict has the JAX package's numbers;
    write_synthetic writes them one leaf at a time at fp16, and the header
    reader, load_manifest and save_manifest agree with the JAX package's."""
    _, jcfg, tcfg = configs("sd35-tiny")
    sd = tmanifest.synthetic_state_dict("sd3", tcfg, seed=4)
    ref = jmanifest.synthetic_state_dict("sd3", jcfg, seed=4)
    assert sd.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(sd[k], ref[k])
    path = str(tmp_path / "sd3.safetensors")
    n = tmanifest.write_synthetic("sd3", path, tcfg, seed=4)
    assert n == sum(a.size for a in ref.values())
    back = params_io.load_file(path)
    for k in ref:
        assert back[k].dtype == np.float16
        np.testing.assert_array_equal(back[k], ref[k].astype(np.float16))
    man = tmanifest.read_safetensors_manifest(path)
    assert man == jmanifest.read_safetensors_manifest(path) == tmanifest.expected_manifest(
        "sd3", tcfg)
    assert tmanifest.load_manifest(str(tmp_path)) == man
    tmanifest.save_manifest(man, str(tmp_path / "t.json"))
    jmanifest.save_manifest(man, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert tmanifest.load_manifest(str(tmp_path / "t.json")) == man


# --- converters ---------------------------------------------------------------


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in tconvert.flatten(tree).items()}


CONVERTERS = {
    "pixart": (tconvert.pixart_params, jconvert.pixart_params),
    "sd3": (tconvert.sd3_params, jconvert.sd3_params),
    "klvae": (tconvert.klvae_params, jconvert.klvae_params),
    "taesd": (tconvert.taesd_params, jconvert.taesd_params),
    "taesd3": (tconvert.taesd_params, jconvert.taesd_params),
}


def _converter_kwargs(family, cfg, scan):
    if family in ("pixart", "sd3"):
        return {"scan_layers": scan}
    if family == "klvae":
        return {"layers_per_block": cfg.layers_per_block, "n_stages": len(cfg.block_widths)}
    return {"num_stages": cfg.num_stages, "blocks_per_stage": cfg.blocks_per_stage}


@pytest.mark.parametrize("name,scan", [
    ("pixart-tiny", False), ("pixart-tiny", True), ("sd3-tiny", False), ("sd3-tiny", True),
    ("sd35-tiny", False), ("sd35-tiny", True), ("klvae-tiny", None),
    ("klvae-sd3-tiny", None), ("taesd-tiny", None), ("taesd3", None),
])
def test_converter_matches_jax_bit_exact(name, scan):
    """The same synthetic state dict through both converters: the same
    tree, leaf for leaf, in value and dtype (the port's leaves are views)."""
    family, jcfg, tcfg = configs(name)
    sd = tmanifest.synthetic_state_dict(family, tcfg, seed=6)
    tconv, jconv = CONVERTERS[family]
    got = _flat_np(tconv(sd, **_converter_kwargs(family, tcfg, scan)))
    ref = _flat_np(jconv(sd, **_converter_kwargs(family, jcfg, scan)))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name", ["pixart-tiny", "sd3-tiny", "klvae-tiny", "taesd-tiny"])
def test_strict_accounting_matches_jax(name):
    """One extra key is a ValueError and one missing key a KeyError, each
    naming the family, with the JAX package's message."""
    family, jcfg, tcfg = configs(name)
    sd = tmanifest.synthetic_state_dict(family, tcfg)
    tconv, jconv = CONVERTERS[family]
    extra = {**sd, "bogus.weight": np.zeros((2, 2), np.float32)}
    missing = dict(sd)
    del missing[next(k for k in sd if k.endswith(".weight"))]
    for bad, exc in ((extra, ValueError), (missing, KeyError)):
        with pytest.raises(exc, match=f"{family} converter") as got:
            tconv(bad, **_converter_kwargs(family, tcfg, False))
        with pytest.raises(exc) as ref:
            jconv(bad, **_converter_kwargs(family, jcfg, False))
        assert str(got.value) == str(ref.value)
    # strict=False skips only the leftover check
    tconv(extra, strict=False, **_converter_kwargs(family, tcfg, False))


def test_folder_rule_matches_jax(tmp_path):
    """load_torch_state_dict reads a file, or every *.safetensors of a
    folder in sorted order (a later file's keys win; an fp16 and an fp32
    file of one checkout both load and the fp32 file, sorted last, wins),
    or the shards that a model.safetensors.index.json names. Diffusers'
    own index name is not looked for, so the listing loads its shards."""
    rng = np.random.default_rng(8)
    a32 = {"w": rng.standard_normal((3, 2)).astype(np.float32), "only32": np.ones(2, np.float32)}
    a16 = {"w": rng.standard_normal((3, 2)).astype(np.float16), "only16": np.ones(3, np.float16)}
    cases = {}
    d = tmp_path / "both"
    d.mkdir()
    params_io.save_file(a32, str(d / "diffusion_pytorch_model.safetensors"))
    params_io.save_file(a16, str(d / "diffusion_pytorch_model.fp16.safetensors"))
    cases["both"] = d
    d = tmp_path / "diffusers_index"
    d.mkdir()
    params_io.save_file({"a": np.zeros(1, np.float32)},
                        str(d / "diffusion_pytorch_model-00001-of-00002.safetensors"))
    params_io.save_file({"b": np.ones(1, np.float32)},
                        str(d / "diffusion_pytorch_model-00002-of-00002.safetensors"))
    (d / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {"a": "diffusion_pytorch_model-00001-of-00002.safetensors"}}))
    cases["diffusers_index"] = d
    d = tmp_path / "model_index"
    d.mkdir()
    params_io.save_file({"a": np.zeros(1, np.float32)}, str(d / "s1.safetensors"))
    params_io.save_file({"b": np.ones(1, np.float32)}, str(d / "s2.safetensors"))
    params_io.save_file({"c": np.ones(1, np.float32)}, str(d / "stray.safetensors"))
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {"a": "s1.safetensors", "b": "s2.safetensors"}}))
    cases["model_index"] = d
    cases["file"] = cases["both"] / "diffusion_pytorch_model.fp16.safetensors"
    want_keys = {"both": {"w", "only32", "only16"}, "diffusers_index": {"a", "b"},
                 "model_index": {"a", "b"}, "file": {"w", "only16"}}
    for name, path in cases.items():
        got = tconvert.load_torch_state_dict(str(path))
        ref = jconvert.load_torch_state_dict(str(path))
        assert set(got) == set(ref) == want_keys[name], name
        for k in ref:
            assert got[k].dtype == ref[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(tconvert.load_torch_state_dict(str(cases["both"]))["w"],
                                  a32["w"])


# --- the KL decoder -------------------------------------------------------------


def kl_pair(name, seed=10):
    """The JAX KL decoder with its params and the port's with the same
    weights, both from one synthetic state dict."""
    _, jcfg, tcfg = configs(name)
    sd = tmanifest.synthetic_state_dict("klvae", tcfg, seed=seed, scale=VAE_SCALE)
    kw = dict(layers_per_block=tcfg.layers_per_block, n_stages=len(tcfg.block_widths))
    jparams = jconvert.to_jax(jconvert.klvae_params(sd, **kw)["decoder"])
    dec = tvae.KLDecoder(tcfg, device="cpu")
    dec.load_state_dict(from_jax.state_dict_from_jax(
        tconvert.flatten(tconvert.klvae_params(sd, **kw)["decoder"]), dec))
    return jvae.KLDecoder(cfg=jcfg), jparams, dec


@pytest.mark.parametrize("name", ["klvae-tiny", "klvae-sd3-tiny"])
def test_kl_decoder_matches_jax(name):
    """fp32 on both sides, a non-square latent (a swapped H/W or a
    transposed kernel shows): max |port − JAX| ≤ 1e-4 × max |JAX|. Every
    width change takes the 1×1 shortcut, and the 2× upsampling is nearest."""
    jdec, jparams, dec = kl_pair(name)
    z = np.random.default_rng(11).standard_normal(
        (2, dec.cfg.latent_channels, 6, 5)).astype(np.float32)
    ref = np.asarray(jdec.apply({"params": jparams}, jnp.asarray(z)))
    with torch.no_grad():
        got = dec(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (2, 3, 12, 10)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.abs(ref).max() > 0.1  # the weights' scale reaches the output
    assert {type(m.shortcut) for n, m in dec.named_modules() if n.startswith("up_")
            and hasattr(m, "shortcut")} == {torch.nn.Conv2d, type(None)}


def test_kl_configs_and_unscale_match_jax():
    for preset in ("tiny", "sd3"):
        j = getattr(jvae.KLVAEConfig, preset)()
        t = getattr(tvae.KLVAEConfig, preset)()
        for f in dataclasses.fields(j):
            if f.name != "dtype":
                assert tuple(np.atleast_1d(getattr(t, f.name))) == tuple(
                    np.atleast_1d(getattr(j, f.name))), (preset, f.name)
    assert tvae.KLVAEConfig().dtype == torch.float32  # fp32 by default, as in JAX
    z = np.random.default_rng(12).standard_normal((2, 16, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tvae.unscale_latents(torch.from_numpy(z), 1.5305, 0.0609).numpy(),
        np.asarray(jvae.unscale_latents(jnp.asarray(z), 1.5305, 0.0609)), rtol=0, atol=1e-7)


def test_tiled_decode_matches_jax():
    """Overlapping tiles cross-faded in image space, with the last row and
    column of tiles moved back to the edge: the KL decoder's tiles through
    both packages' tiled_decode agree within 1e-5 of the largest output; a
    latent no larger than one tile is decoded whole."""
    jdec, jparams, dec = kl_pair("klvae-tiny", seed=13)
    z = np.random.default_rng(14).standard_normal((1, 4, 13, 10)).astype(np.float32)
    kw = dict(tile=6, overlap=2, spatial_factor=2)
    ref = np.asarray(jvae.tiled_decode(
        lambda t: jdec.apply({"params": jparams}, t), jnp.asarray(z), **kw))
    with torch.no_grad():
        got = tvae.tiled_decode(dec, torch.from_numpy(z), **kw).numpy()
    assert got.shape == ref.shape == (1, 3, 26, 20)
    assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    small = torch.from_numpy(z[:, :, :6, :5])
    sentinel = object()
    assert tvae.tiled_decode(lambda t: sentinel if t is small else None, small, **kw) is sentinel
    np.testing.assert_allclose(
        tvae._ramp(10, 4, torch.float32, "cpu").numpy(),
        np.asarray(jvae._ramp(10, 4, jnp.float32)), rtol=0, atol=0)


def test_to_images_matches_jax():
    x = np.random.default_rng(15).uniform(-1.5, 1.5, (2, 3, 4, 5)).astype(np.float32)
    for value_range in ("unit", "pm1"):
        np.testing.assert_array_equal(
            tbase.to_images(torch.from_numpy(x), value_range=value_range).numpy(),
            np.asarray(jbase.to_images(jnp.asarray(x), value_range=value_range)))
    with pytest.raises(ValueError, match="value_range"):
        tbase.to_images(torch.from_numpy(x), value_range="bogus")


# --- from_pretrained on a checkout ------------------------------------------------


def test_from_pretrained_pixart_kl_checkout_matches_jax(tmp_path):
    """PixArt with a tiny AutoencoderKL ('pm1' range, scaling 0.18215):
    the port's images are JAX's."""
    _, _, tcfg = configs("pixart-tiny")
    root = write_checkout(tmp_path / "ckpt", "pixart", tcfg, tvae.KLVAEConfig.tiny())
    tpipe, ref, got = pix_pair(root, F32)
    assert isinstance(tpipe, PixArtPipeline) and isinstance(tpipe.vae_decoder, tvae.KLDecoder)
    assert (tpipe.vae_range, tpipe.vae_scaling) == ("pm1", 0.18215)
    assert tpipe.transformer.cfg.dtype == torch.float32
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))
    assert got.images.shape == (2, 32, 32, 3)
    ref_img = np.asarray(ref.images)
    assert ref_img.std() > 0.05  # the images spread over [0, 1]
    np.testing.assert_allclose(got.images.numpy(), ref_img, rtol=0, atol=2e-3)


def test_from_pretrained_pixart_taesd_checkout_matches_jax(tmp_path):
    _, _, tcfg = configs("pixart-tiny")
    vcfg = tvae.TAESDConfig(width=8, num_stages=1, blocks_per_stage=1)
    root = write_checkout(tmp_path / "ckpt", "pixart", tcfg, vcfg)
    tpipe, ref, got = pix_pair(root, F32)
    assert isinstance(tpipe.vae_decoder, tvae.TAESDDecoder) and tpipe.vae_range == "unit"
    assert tpipe.vae_decoder.cfg == vcfg
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)


def test_from_pretrained_sd3_kl_checkout_matches_jax(tmp_path):
    """SD3 with a tiny 16-channel AutoencoderKL: vae_shift comes from the
    VAE's shift_factor."""
    _, _, tcfg = configs("sd3-tiny")
    vcfg = _kl_sd3_tiny(tvae)
    root = write_checkout(tmp_path / "ckpt", "sd3", tcfg, vcfg)
    rng = np.random.default_rng(16)
    lat = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, tcfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, tcfg.pooled_dim)).astype(np.float32)
    jpipe = jloading.from_pretrained(root, model_config=F32)
    tpipe = from_pretrained(root, device="cpu", model_config=F32)
    assert isinstance(tpipe, SD3Pipeline) and isinstance(tpipe.vae_decoder, tvae.KLDecoder)
    assert (tpipe.vae_scaling, tpipe.vae_shift, tpipe.vae_range) == (1.5305, 0.0609, "pm1")
    assert (jpipe.vae_scaling, jpipe.vae_shift) == (1.5305, 0.0609)
    ref = jpipe(prompt_embeds=(jnp.asarray(ctx), jnp.asarray(pooled)),
                latents=jnp.asarray(lat), **SD3_CALL)
    got = tpipe(prompt_embeds=(ctx, pooled), latents=lat, **SD3_CALL)
    ref_lat = np.asarray(ref.latents.astype(jnp.float32))
    np.testing.assert_allclose(got.latents.float().numpy(), ref_lat, rtol=0, atol=1e-4)
    assert got.images.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)


def test_from_pretrained_bf16_checkout_matches_jax(tmp_path):
    """The checkout at the configs' own dtypes (bf16 transformer, fp32 KL
    decoder) in both packages. Here the forwards themselves differ: XLA
    fuses bf16 ops and rounds once per fusion, eager PyTorch rounds after
    each op, so ε differs by up to a few bf16 ulps of its scale in ~8% of
    elements, and the x₀ projection at t = 899 (σ/α ≈ 16) carries one ulp of
    ε into about one ulp of the latents' scale. Latents within two bf16
    ulps of their scale (measured: 2.0 at scale 239, 1.5 at 251, 1.0 at
    207 over three seeds) and 5e-3 in relative L2 (measured ≤ 1.6e-3);
    images within 5e-3."""
    _, _, tcfg = configs("pixart-tiny")
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    root = write_checkout(tmp_path / "ckpt", "pixart", tcfg, tvae.KLVAEConfig.tiny())
    tpipe, ref, got = pix_pair(root, {"dtype": "bfloat16", "attn_impl": "xla"})
    assert tpipe.transformer.cfg.dtype == torch.bfloat16
    assert tpipe.vae_decoder.cfg.dtype == torch.float32
    ref_lat = np.asarray(ref.latents.astype(jnp.float32))
    got_lat = got.latents.float().numpy()
    diff = np.abs(got_lat - ref_lat)
    assert diff.max() <= 2**-6 * np.abs(ref_lat).max(), diff.max()
    assert np.linalg.norm(got_lat - ref_lat) <= 5e-3 * np.linalg.norm(ref_lat)
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=5e-3)


def _hub_cache(tmp_path, repo_id, write):
    """A hub cache holding `repo_id` at one commit with refs/main, the
    checkout written by `write(snapshot_dir)`."""
    cache = tmp_path / "hub"
    repo = cache / f"models--{repo_id.replace('/', '--')}"
    commit = "c" * 40
    write(repo / "snapshots" / commit)
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text(commit)
    return cache, repo / "snapshots" / commit


def test_from_pretrained_repo_id_resolves_through_the_hub_cache(tmp_path, monkeypatch):
    _, _, tcfg = configs("pixart-tiny")
    cache, snap = _hub_cache(tmp_path, "tdm/pixart-tiny", lambda d: write_checkout(
        d, "pixart", tcfg, tvae.KLVAEConfig.tiny()))
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    tpipe, ref, got = pix_pair("tdm/pixart-tiny", F32)
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)
    direct = from_pretrained(str(snap), device="cpu", model_config=F32)
    for k, v in direct.transformer.state_dict().items():
        torch.testing.assert_close(tpipe.transformer.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="not in the hub cache"):
        from_pretrained("tdm/absent", device="cpu")
    with pytest.raises(FileNotFoundError, match="neither an existing path"):
        from_pretrained("not a repo id", device="cpu")


def test_cached_snapshot_matches_jax(tmp_path):
    """A full commit hash, a ref, the default 'main', a missing ref, and a
    cache without refs (the newest snapshot): the same directory, or None,
    in both packages."""
    cache = tmp_path / "hub"
    repo = cache / "models--org--name"
    old, new = "a" * 40, "b" * 40
    for c in (old, new):
        (repo / "snapshots" / c).mkdir(parents=True)
    os.utime(repo / "snapshots" / old, (1, 1))
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text(old)
    (repo / "refs" / "dev").write_text(new + "\n")
    bare = cache / "models--org--bare"
    for c in (old, new):
        (bare / "snapshots" / c).mkdir(parents=True)
    os.utime(bare / "snapshots" / old, (1, 1))
    cases = [("org/name", None), ("org/name", "dev"), ("org/name", new), ("org/name", "c" * 40),
             ("org/name", "absent"), ("org/bare", None), ("org/bare", "main"), ("org/none", None)]
    want = [old, new, new, None, None, new, None, None]
    for (repo_id, rev), w in zip(cases, want):
        got = thub.cached_snapshot(repo_id, revision=rev, cache_dir=str(cache))
        ref = jhub.cached_snapshot(repo_id, revision=rev, cache_dir=str(cache))
        assert got == ref, (repo_id, rev)
        assert (got and os.path.basename(got)) == w, (repo_id, rev)


@pytest.mark.parametrize("cls,err,where", [
    # SD1.5 is ported (tests/test_torch_port_sd15.py): its classes read the
    # unet/ folder, which this PixArt checkout lacks
    ("StableDiffusionPipeline", FileNotFoundError, "unet"),
    ("LatentConsistencyModelPipeline", FileNotFoundError, "unet"),
    # CogVideoX is ported (tests/test_torch_port_cogvideox.py): its strict
    # converters find no CogVideoX keys in this PixArt checkout
    ("CogVideoXPipeline", KeyError, "cogvideox converter"),
    ("AutoencoderKLCogVideoX", KeyError, "vae3d_decoder converter"),
    ("FluxPipeline", ValueError, "unsupported diffusers pipeline class"),
])
def test_from_pretrained_refuses_unported_checkouts(tmp_path, cls, err, where):
    _, _, tcfg = configs("pixart-tiny")
    root = write_checkout(tmp_path / "ckpt", "pixart", tcfg)
    if cls.startswith("Autoencoder"):
        _json(os.path.join(root, "vae", "config.json"), {"_class_name": cls})
    else:
        _json(os.path.join(root, "model_index.json"), {"_class_name": cls})
    with pytest.raises(err, match=where):
        from_pretrained(root, device="cpu")


def test_save_pretrained_refuses_a_kl_decoder(tmp_path):
    """The tdm_tpu layout stores a pixart/sd3 VAE as TAESD only, so a
    pipeline that decodes with a KLDecoder is refused before anything is
    written."""
    pipe = PixArtPipeline(
        tpixart.PixArtTransformer2D(tpixart.PixArtConfig.tiny(), device="cpu"),
        vae_decoder=tvae.KLDecoder(tvae.KLVAEConfig.tiny(), device="cpu"),
        vae_range="pm1", device="cpu")
    with pytest.raises(ValueError, match="TAESD only"):
        save_pretrained(str(tmp_path / "out"), pipe)
    assert not (tmp_path / "out").exists()


# --- the server ----------------------------------------------------------------


@pytest.mark.parametrize("source", ["checkout", "repo_id"])
def test_server_serves_a_diffusers_checkout(tmp_path, monkeypatch, source):
    """--model takes a checkout directory or a cached repo id; a request
    gets the PNG of the pipeline's image for its seed."""
    from PIL import Image

    _, _, tcfg = configs("pixart-tiny")
    if source == "checkout":
        model = write_checkout(tmp_path / "ckpt", "pixart", tcfg, tvae.KLVAEConfig.tiny())
    else:
        cache, _ = _hub_cache(tmp_path, "tdm/pixart-tiny", lambda d: write_checkout(
            d, "pixart", tcfg, tvae.KLVAEConfig.tiny()))
        monkeypatch.setenv("HF_HUB_CACHE", str(cache))
        model = "tdm/pixart-tiny"
    rng = np.random.default_rng(17)
    cache_file = str(tmp_path / "cache.npz")
    EmbeddingCache(rng.standard_normal((2, 8, 32)).astype(np.float16),
                   np.ones((2, 8), np.int32), ["a cat", "a dog"],
                   uncond_embed=np.zeros((8, 32), np.float16),
                   uncond_mask=np.zeros(8, np.int32)).save(cache_file)
    args = tserver.parse_args([
        "--model", model, "--embedding_cache", cache_file, "--device", "cpu",
        "--port", "0", "--batch_size", "1", "--height", "128", "--width", "128"])
    srv = tserver.build_server(args).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt": "a dog", "seed": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = json.loads(r.read())
    finally:
        srv.close()
    assert reply["format"] == "png" and reply["shape"] == [32, 32, 3]
    img = np.asarray(Image.open(io.BytesIO(base64.b64decode(reply["image"]))))
    pipe = srv.batcher.pipe
    assert isinstance(pipe.vae_decoder, tvae.KLDecoder)
    want = pipe(prompt_embeds=srv.batcher.cond_fn("a dog"), seed=5, **PIX_CALL).images[0]
    assert np.abs(img.astype(np.float32) - np.round(want.numpy() * 255)).max() <= 1


# --- the training CLI's teacher directory ------------------------------------------


def _cli(tmp_path, *flags):
    from tdm_tpu_torch.cli import train_tdm

    train_tdm.main(["--device", "cpu", "--output_dir", str(tmp_path / "run"),
                    "--export_lora_rank", "0", *flags])


def test_cli_teacher_from_a_transformer_dir_matches_jax(tmp_path, monkeypatch):
    """--pretrained_model_name_or_path <checkout>/transformer: the teacher
    is the JAX CLI's load of the same directory, value for value (the JAX
    tree keeps the file's fp16, the port its fp32 parameters), and one TDM
    step from that teacher gives the JAX step's metrics within the bounds
    of tests/test_torch_port_train.py."""
    from tdm_tpu.train import families as jfamilies, optim as jopt, tdm as jtdm
    from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm
    from tests.test_torch_port_train import _jax_draws

    _, _, tcfg = configs("pixart-tiny")
    root = write_checkout(tmp_path / "ckpt", "pixart", tcfg)
    tdir = os.path.join(root, "transformer")
    captured = {}
    build = tfamilies.build

    def capturing_build(*a, **kw):
        bundle = build(*a, **kw)
        conv = bundle.convert

        def convert(sd):
            captured["teacher"] = {k: v.clone() for k, v in conv(sd).items()}
            return captured["teacher"]
        return dataclasses.replace(bundle, convert=convert)

    monkeypatch.setattr(tfamilies, "build", capturing_build)
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.delenv("TDM_EMBEDDING_CACHE", raising=False)
    monkeypatch.delenv("TDM_TAESD_DIR", raising=False)
    _cli(tmp_path, "--max_train_steps", "1", "--pretrained_model_name_or_path", tdir)
    lines = (tmp_path / "run_cfg4.5_steps900" / "logs" / "metrics.jsonl").read_text()
    assert all(np.isfinite(v) for v in json.loads(lines.splitlines()[0]).values())

    # the JAX CLI's load (tdm_tpu/cli/train_tdm.py): the directory's state
    # dict through the bundle's converter
    jb = jfamilies.build("pixart", tiny=True)
    jteacher = jconvert.to_jax(jb.convert(jconvert.load_torch_state_dict(tdir)))
    tb = build("pixart", tiny=True, device="cpu")
    want = from_jax.state_dict_from_jax(from_jax.flatten_tree(jteacher), tb.model)
    teacher = captured["teacher"]
    assert teacher.keys() == want.keys()
    for k, v in want.items():  # the port's fp32 master copy of the fp16 file
        assert teacher[k].dtype == torch.float32 and v.dtype == torch.float16
        torch.testing.assert_close(teacher[k], v.float(), rtol=0, atol=0)

    # one step from that teacher (student = teacher, as the CLI starts),
    # the JAX step given the same fp32 values (its CLI would train the fp16
    # tree itself: critic updates rounded to fp16, which the port's fp32
    # masters do not do)
    jteacher = jax.tree.map(lambda a: a.astype(jnp.float32), jteacher)
    rng = np.random.default_rng(18)
    cond = (rng.standard_normal((2, 8, 32)).astype(np.float32), np.ones((2, 8), np.int32))
    uncond = (np.zeros((2, 8, 32), np.float32), np.ones((2, 8), np.int32))
    config, tconfig = jtdm.TDMConfig(), ttdm.TDMConfig()
    jtx, ttx = jopt.make_optimizer(1e-4, eps=1e-4), topt.make_optimizer(1e-4, eps=1e-4)
    jstate = jtdm.init_state(jteacher, jteacher, jtx, jtx)
    jstep = jtdm.build_train_step(jb.denoise_fn, jteacher, jb.schedule, config, jtx, jtx,
                                  sample_shape=jb.sample_shape)
    key = jax.random.PRNGKey(5)
    _, jm = jax.block_until_ready(jstep(jstate, key, tuple(jnp.asarray(x) for x in cond),
                                        tuple(jnp.asarray(x) for x in uncond), jteacher))
    tstate = ttdm.init_state(teacher, teacher, ttx, ttx)
    tstep = ttdm.build_train_step(tb.denoise_fn, teacher, tb.schedule, tconfig, ttx, ttx,
                                  sample_shape=tb.sample_shape)
    _, tm = tstep(tstate, _jax_draws(key, config, 2, jb.sample_shape),
                  tuple(torch.from_numpy(x) for x in cond),
                  tuple(torch.from_numpy(x) for x in uncond))
    for name in jtdm.StepMetrics._fields:
        j, t = float(getattr(jm, name)), float(getattr(tm, name))
        assert t == pytest.approx(j, rel=1e-4, abs=1e-7), name


def test_cli_refuses_a_checkout_root_as_jax(tmp_path, monkeypatch):
    """A checkout's root holds no .safetensors: the converter's missing-key
    error, as the JAX CLI's load gives it."""
    from tdm_tpu.train import families as jfamilies

    _, _, tcfg = configs("pixart-tiny")
    root = write_checkout(tmp_path / "ckpt", "pixart", tcfg)
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    with pytest.raises(KeyError, match="pixart converter: checkpoint is missing key") as got:
        _cli(tmp_path, "--max_train_steps", "1", "--pretrained_model_name_or_path", root)
    with pytest.raises(KeyError) as ref:
        jfamilies.build("pixart", tiny=True).convert(jconvert.load_torch_state_dict(root))
    assert str(got.value) == str(ref.value)
    assert not (tmp_path / "run_cfg4.5_steps900" / "logs").exists()
