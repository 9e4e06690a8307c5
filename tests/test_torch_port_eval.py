"""The offline verbs: the CLIP vision tower and its converters, the CLIP
score (`eval/clip_score.py`), `cli/generate.py`, `cli/evaluate.py`, the
server at `--quant int8`, and the image VAE encoders, against the JAX
package on the same numpy inputs at tiny sizes on the CPU.

Tolerances: fp32 modules to 1e-5 of the largest |reference| (the same sums
in another order); the bicubic resize to 5e-5 of the largest normalised
value (the same fp32 weights, the two products contracted in another
order, each normalised value ×3.7 an input's error; measured up to 1.8e-5);
pipelines as
tests/test_torch_port_pipeline.py holds them (the sampler state rounds to
bf16 in both packages), so PNG pixels to one 8-bit step; CLIP scores of the
JAX package's default bf16 towers to 0.5 of 100 (both round each product
to bf16, at different points, and the score is a bf16 cosine ×100). Where
a comparison needs the same initial noise, both packages draw it from one
numpy function of the shape. Servers bind port 0 and write only under
tmp_path.
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

from tdm_tpu.cli import evaluate as jevaluate, generate as jgenerate
from tdm_tpu.eval import clip_score as jclip_score
from tdm_tpu.io import convert as jconvert
from tdm_tpu.models import clip as jclip, pixart as jpixart, vae as jvae
from tdm_tpu.pipelines import base as jbase, save_pretrained as jsave_pretrained
from tdm_tpu_torch.cli import evaluate as tevaluate, generate as tgenerate
from tdm_tpu_torch.data.prompts import EmbeddingCache
from tdm_tpu_torch.data.tokenizer import HashTokenizer
from tdm_tpu_torch.eval import clip_score as tclip_score
from tdm_tpu_torch.io import convert as tconvert, from_jax, manifest as tmanifest
from tdm_tpu_torch.models import clip as tclip, vae as tvae
from tdm_tpu_torch.ops import quant as tq
from tdm_tpu_torch.pipelines import base as tbase, from_pretrained
from tdm_tpu_torch.pipelines import pixart as tpixart_pipe
from tdm_tpu_torch.serve import server as tserver

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)

PROMPTS = ["a cat on a mat", "a dog in fog"]
SCORE_TOL = 0.5


def assert_f32_close(got, ref, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), params)


# --- the CLIP vision tower ------------------------------------------------------


@pytest.mark.parametrize("case", ["projected", "no_projection", "gelu"])
def test_clip_vision_encoder_matches_jax(case):
    """The tiny tower in fp32 from one JAX init: the last state (no final
    LayerNorm), the pooled (post_layernorm of token 0) and projected
    vector, and every block's output."""
    kw = {"no_projection": dict(projection_dim=None), "gelu": dict(activation="gelu")}.get(
        case, {})
    jcfg = dataclasses.replace(jclip.CLIPVisionConfig.tiny(), **kw)
    tcfg = dataclasses.replace(tclip.CLIPVisionConfig.tiny(), **kw)
    jm = jclip.CLIPVisionEncoder(cfg=jcfg)
    px = np.random.default_rng(2).standard_normal((3, 3, 16, 16)).astype(np.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(px))["params"], 1)
    ref = jm.apply({"params": params}, jnp.asarray(px))
    tm = from_jax.load_from_jax(from_jax.flatten_tree(params),
                                tclip.CLIPVisionEncoder(tcfg, device="cpu"))
    with torch.no_grad():
        got = tm(torch.from_numpy(px))
    assert_f32_close(got.last_hidden_state, ref.last_hidden_state)
    assert_f32_close(got.pooled, ref.pooled)
    assert got.pooled.shape == (3, 24 if case != "no_projection" else 32)
    for g, r in zip(got.hidden_states, ref.hidden_states, strict=True):
        assert_f32_close(g, r)


def test_clip_vision_encoder_bf16_matches_jax():
    """The default compute dtype (bf16) to a relative L2 of 1e-2."""
    jm = jclip.CLIPVisionEncoder(cfg=dataclasses.replace(jclip.CLIPVisionConfig.tiny(),
                                                         dtype=jnp.bfloat16))
    px = np.random.default_rng(3).standard_normal((2, 3, 16, 16)).astype(np.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(px))["params"], 2)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(px)).pooled, np.float32)
    tm = from_jax.load_from_jax(from_jax.flatten_tree(params), tclip.CLIPVisionEncoder(
        dataclasses.replace(tclip.CLIPVisionConfig.tiny(), dtype=torch.bfloat16), device="cpu"))
    with torch.no_grad():
        got = tm(torch.from_numpy(px)).pooled.float().numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2


# --- a tiny HF CLIPModel folder -------------------------------------------------


def hf_clip_model(seed=0):
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=96, hidden_size=32, num_attention_heads=4,
                         num_hidden_layers=2, intermediate_size=128,
                         max_position_embeddings=16, hidden_act="quick_gelu",
                         eos_token_id=95),
        vision_config=dict(image_size=16, patch_size=4, hidden_size=32, num_attention_heads=4,
                           num_hidden_layers=2, intermediate_size=128,
                           hidden_act="quick_gelu"),
        projection_dim=24,
    )
    torch.manual_seed(seed)
    return transformers.CLIPModel(cfg).eval()


def _state_dict(model) -> dict:
    return {k: np.ascontiguousarray(v.detach().numpy()) for k, v in model.state_dict().items()}


def write_clip_folder(path, *, tokenizer: str = "hf", seed: int = 0) -> str:
    """config.json, model.safetensors and a tokenizer: HF files (a minimal
    CLIP BPE vocab over the test prompts, slow-tokenizer files) or the
    port's hash bundle (`tdm_tokenizer.json`)."""
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    model = hf_clip_model(seed)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(model.config.to_dict(), f)
    save_file(_state_dict(model), os.path.join(path, "model.safetensors"))
    if tokenizer == "hash":
        with open(os.path.join(path, tclip_score.HASH_TOKENIZER_FILE), "w") as f:
            json.dump({"kind": "hash", "vocab_size": 96, "eos_id": 95}, f)
        return str(path)
    words = sorted({w for p in PROMPTS for w in p.split()})
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for w in words:
        vocab.setdefault(w + "</w>", len(vocab))
        for ch in w:
            vocab.setdefault(ch, len(vocab))
            vocab.setdefault(ch + "</w>", len(vocab))
    files = {
        "vocab.json": json.dumps(vocab),
        "merges.txt": "#version: 0.2\n",
        "tokenizer_config.json": json.dumps({"tokenizer_class": "CLIPTokenizer"}),
        "special_tokens_map.json": json.dumps({
            "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
            "pad_token": "<|endoftext|>", "unk_token": "<|endoftext|>"}),
    }
    for name, text in files.items():
        with open(os.path.join(path, name), "w") as f:
            f.write(text)
    return str(path)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    return write_clip_folder(str(tmp_path_factory.mktemp("clip")))


def test_clip_model_params_match_jax():
    """A whole CLIPModel state dict through both packages' strict
    converters: the same text and vision trees leaf for leaf, the same
    logit scale; the same errors for an unknown key, a missing key and a
    leftover key."""
    sd = _state_dict(hf_clip_model())
    jt, jv, jscale = jconvert.clip_model_params(dict(sd))
    tt, tv, tscale = tconvert.clip_model_params(dict(sd))
    assert tscale == pytest.approx(jscale, rel=1e-6)
    for got, ref in ((tt, jt), (tv, jv)):
        got, ref = tconvert.flatten(got), tconvert.flatten(ref)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    assert "visual_projection/kernel" in tconvert.flatten(tv)
    for mutate, err in [
        (lambda d: d.update(extra=np.zeros(1)), ValueError),
        (lambda d: d.pop("vision_model.post_layernorm.weight"), KeyError),
        (lambda d: d.update({"vision_model.stray.weight": np.zeros(1)}), ValueError),
    ]:
        bad = dict(sd)
        mutate(bad)
        with pytest.raises(err) as jerr:
            jconvert.clip_model_params(dict(bad))
        with pytest.raises(err) as terr:
            tconvert.clip_model_params(dict(bad))
        assert str(terr.value) == str(jerr.value)
    vision_only = {k: v for k, v in sd.items() if k.startswith("vision_model.")}
    got = tconvert.flatten(tconvert.clip_vision_params(vision_only))
    assert "visual_projection/kernel" not in got
    assert got.keys() == tconvert.flatten(jconvert.clip_vision_params(vision_only)).keys()


def test_hf_vision_tower_matches_transformers():
    """The port's tower on a converted HF state dict gives transformers'
    own CLIPModel image features (fp32)."""
    model = hf_clip_model(3)
    _, tv, _ = tconvert.clip_model_params(_state_dict(model))
    tm = from_jax.load_from_jax(tconvert.flatten(tv), tclip.CLIPVisionEncoder(
        dataclasses.replace(tclip.CLIPVisionConfig.tiny(), projection_dim=24), device="cpu"))
    px = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 16, 16))
                          .astype(np.float32))
    with torch.no_grad():
        ref = model.get_image_features(pixel_values=px)
        ref = getattr(ref, "image_embeds", ref)
        if not isinstance(ref, torch.Tensor):
            ref = ref.pooler_output
        got = tm(px).pooled
    assert_f32_close(got, ref.numpy(), 1e-4)


# --- preprocessing and the score ------------------------------------------------


@pytest.mark.parametrize("hw", [(512, 512), (1024, 1024), (480, 720), (224, 224), (64, 300)])
def test_preprocess_images_matches_jax(hw):
    """jax.image.resize's antialiased Keys bicubic (a = −0.5), clipped, then
    the CLIP normalisation: 512², 1024² and a video's 480×720 middle frame
    to 224² (and an image already at 224², and one that grows on one axis
    and shrinks on the other)."""
    h, w = hw
    imgs = np.random.default_rng(h + w).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    imgs[0, : h // 2] = 1.0  # a hard edge, where a = −0.5 against −0.75 shows
    ref = np.asarray(jclip_score.preprocess_images(jnp.asarray(imgs)))
    got = tclip_score.preprocess_images(torch.from_numpy(imgs))
    assert got.shape == (2, 3, 224, 224)
    assert_f32_close(got, ref, 5e-5)
    assert np.abs(got.numpy() - ref).max() < 1e-4  # both normalised from [0, 1]


def test_clip_score_and_scorer_match_jax():
    """clip_score on the same embeddings, and CLIPScorer.score (the towers
    at fp32 from one HF state dict) on the same images and token ids."""
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal((4, 24)).astype(np.float32) for _ in range(2))
    b[0] = -a[0]  # a negative cosine clips to 0
    np.testing.assert_allclose(
        tclip_score.clip_score(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jclip_score.clip_score(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-4)
    sd = _state_dict(hf_clip_model(1))
    jt, jv, _ = jconvert.clip_model_params(dict(sd))
    tt, tv, _ = tconvert.clip_model_params(dict(sd))
    cfg = json.loads(json.dumps(hf_clip_model(1).config.to_dict()))
    jtc, jvc = (dataclasses.replace(c, dtype=jnp.float32)
                for c in jclip_score._configs_from_hf(cfg))
    ttc, tvc = (dataclasses.replace(c, dtype=torch.float32)
                for c in tclip_score._configs_from_hf(cfg))
    for tc, jc in ((ttc, jtc), (tvc, jvc)):  # every field but the dtype as JAX maps it
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    jscorer = jclip_score.CLIPScorer(jtc, jvc, jconvert.to_jax(jt), jconvert.to_jax(jv))
    tscorer = tclip_score.CLIPScorer(ttc, tvc, tt, tv, device="cpu")
    imgs = rng.uniform(0, 1, (3, 40, 40, 3)).astype(np.float32)
    ids = rng.integers(1, 95, (3, 16))
    ids[:, 9] = 95
    ref = jscorer.score(jnp.asarray(imgs), input_ids=jnp.asarray(ids))
    got = tscorer.score(torch.from_numpy(imgs), input_ids=torch.from_numpy(ids))
    assert got.shape == (3,) and ((got >= 0) & (got <= 100)).all()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="no tokenizer attached"):
        tscorer.score(imgs, ["a cat"] * 3)


@pytest.mark.parametrize("kind", ["hf", "hash", "none"])
def test_scorer_from_pretrained_tokenizers(tmp_path, kind):
    """A folder's HF tokenizer files load through HFTokenizer (ids equal to
    JAX's CLIPTokenizerFast); a tdm_tokenizer.json loads the hash
    tokenizer; a folder with neither has no tokenizer, as JAX's."""
    path = write_clip_folder(str(tmp_path / "clip"), tokenizer="hash" if kind == "hash" else "hf")
    if kind == "none":
        for name in os.listdir(path):
            if name not in ("config.json", "model.safetensors"):
                os.remove(os.path.join(path, name))
    scorer = tclip_score.CLIPScorer.from_pretrained(path, device="cpu")
    if kind == "none":
        assert scorer.tokenizer is None
        return
    if kind == "hash":
        assert isinstance(scorer.tokenizer, HashTokenizer)
        ids = scorer.tokenize(PROMPTS)
        np.testing.assert_array_equal(ids.numpy(), HashTokenizer(96, 95)(PROMPTS, 16)[0])
        return
    jscorer = jclip_score.CLIPScorer.from_pretrained(path)
    np.testing.assert_array_equal(scorer.tokenize(PROMPTS).numpy(),
                                  np.asarray(jscorer.tokenize(PROMPTS)))
    imgs = np.random.default_rng(6).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(scorer.score(torch.from_numpy(imgs), PROMPTS),
                               np.asarray(jscorer.score(jnp.asarray(imgs), PROMPTS),
                                          np.float32), rtol=0, atol=SCORE_TOL)


# --- generate and evaluate -----------------------------------------------------


def np_noise(shape) -> np.ndarray:
    return np.random.default_rng(17).standard_normal(shape).astype(np.float32)


@pytest.fixture
def same_noise(monkeypatch):
    """Both packages' pipelines draw their initial noise from `np_noise`."""

    def jax_noise(latents, rng, shape):
        return jnp.asarray(np_noise(shape) if latents is None else latents, jnp.bfloat16)

    def port_noise(latents, generator, shape, device):
        src = np_noise(shape) if latents is None else np.asarray(latents, np.float32)
        return torch.from_numpy(src).to(device=device, dtype=torch.bfloat16)

    monkeypatch.setattr(jbase.DiffusionPipelineBase, "initial_noise", staticmethod(jax_noise))
    monkeypatch.setattr(tpixart_pipe, "initial_noise", port_noise)


@pytest.fixture(scope="module")
def pixart_dir(tmp_path_factory):
    """A tiny PixArt pipeline with a one-stage TAESD, written by the JAX
    package's save_pretrained (as tests/test_cli_generate.py writes it)."""
    d = str(tmp_path_factory.mktemp("pipe") / "pixart")
    cfg = jpixart.PixArtConfig.tiny()
    model = jpixart.PixArtTransformer2D(cfg=cfg)
    lat = jnp.zeros((1, 4, 16, 16))
    params = model.init(jax.random.PRNGKey(0), lat, jnp.zeros((1,)),
                        jnp.zeros((1, 8, cfg.caption_dim)), jnp.ones((1, 8), jnp.int32))["params"]
    vcfg = jvae.TAESDConfig(width=8, num_stages=1, blocks_per_stage=1)
    vparams = jvae.TAESDDecoder(cfg=vcfg).init(jax.random.PRNGKey(1), lat)["params"]
    jsave_pretrained(
        d, family="pixart", transformer_params=params,
        model_config={"sample_size": cfg.sample_size, "num_layers": cfg.num_layers,
                      "num_heads": cfg.num_heads, "head_dim": cfg.head_dim,
                      "caption_dim": cfg.caption_dim, "dtype": "float32", "attn_impl": "xla"},
        vae_params=vparams, vae_config={"width": 8, "num_stages": 1, "blocks_per_stage": 1},
    )
    return d


@pytest.fixture(scope="module")
def cache_path(tmp_path_factory):
    rng = np.random.default_rng(7)
    cache = EmbeddingCache(
        embeds=rng.normal(size=(2, 8, 32)).astype(np.float16), masks=np.ones((2, 8), np.int64),
        prompts=list(PROMPTS), uncond_embed=np.zeros((8, 32), np.float16),
        uncond_mask=np.ones(8, np.int64))
    p = str(tmp_path_factory.mktemp("cache") / "embeds.npz")
    cache.save(p)
    return p


def _png(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


GEN = ["--num_inference_steps", "2", "--seed", "42", "--height", "128", "--width", "128"]


def test_generate_png_matches_jax_cli(pixart_dir, cache_path, tmp_path, same_noise):
    """One PNG from each package's CLI on the same pipeline dir, cache and
    noise: the same 32×32 image to one 8-bit step."""
    args = ["--model", pixart_dir, "--prompt", PROMPTS[0], "--embedding_cache", cache_path,
            *GEN, "--output"]
    jgenerate.main([*args, str(tmp_path / "j.png")])
    tgenerate.main([*args, str(tmp_path / "t.png"), "--device", "cpu"])
    ref, got = _png(tmp_path / "j.png"), _png(tmp_path / "t.png")
    assert got.shape == (32, 32, 3)
    assert np.abs(got - ref).max() <= 1


@pytest.mark.parametrize("case", ["directory", "per_prompt", "latent", "cfg_negative"])
def test_generate_outputs(pixart_dir, cache_path, tmp_path, case):
    """A directory of PNGs for two prompts, 2 images per prompt (4 files),
    the fp32 latents as .npy, and CFG with a negative prompt from the
    cache."""
    out = str(tmp_path / "out")
    extra = {"directory": [], "per_prompt": ["--num_images_per_prompt", "2"],
             "latent": ["--output_type", "latent"],
             "cfg_negative": ["--guidance_scale", "3.0", "--negative_prompt", PROMPTS[1],
                              PROMPTS[0]]}[case]
    tgenerate.main(["--model", pixart_dir, "--prompt", *PROMPTS, "--embedding_cache",
                    cache_path, *GEN, "--output", out, "--device", "cpu", *extra])
    if case == "latent":
        lat = np.load(out + ".npy")
        assert lat.shape == (2, 4, 16, 16) and lat.dtype == np.float32
        return
    n = 4 if case == "per_prompt" else 2
    assert sorted(os.listdir(out)) == [f"{i:03d}.png" for i in range(n)]
    imgs = [_png(os.path.join(out, f)) for f in sorted(os.listdir(out))]
    assert all(im.shape == (32, 32, 3) for im in imgs)
    if case == "per_prompt":  # the repeats of one prompt draw their own noise rows
        assert not np.array_equal(imgs[0], imgs[1])


def test_generate_lora_scale_and_quant(pixart_dir, cache_path, tmp_path, monkeypatch):
    """--lora with --lora_scale gives the latents of the pipeline with that
    adapter set by hand; --quant int8 (gates lowered to the tiny widths)
    moves them and stays within 0.15."""
    from tdm_tpu_torch.lora import adapter as tadapter, io as tlora_io

    pipe = from_pretrained(pixart_dir, device="cpu")
    lora = tadapter.init_lora(pipe.transformer, 4, generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    lora = tadapter.from_factors({k: v + 0.1 * torch.randn(v.shape, generator=gen)
                                  for k, v in tadapter.factors(lora).items()}, lora.alpha)
    path = str(tmp_path / "lora.safetensors")
    tlora_io.save_kohya(lora, path)
    outs = {}
    for name, extra in {"plain": [], "lora": ["--lora", path, "--lora_scale", "0.5"],
                        "int8": ["--quant", "int8"]}.items():
        if name == "int8":
            for attr in ("MIN_TOKENS", "MIN_DIM", "WIDE_DIM"):
                monkeypatch.setattr(tq, attr, 1)
        tgenerate.main(["--model", pixart_dir, "--prompt", PROMPTS[0], "--embedding_cache",
                        cache_path, *GEN, "--output_type", "latent", "--device", "cpu",
                        "--output", str(tmp_path / name), *extra])
        outs[name] = np.load(str(tmp_path / name) + ".npy")
    pipe.load_lora_weights(path, adapter_name="tdm")
    pipe.set_adapters(["tdm"], [0.5])
    cache = EmbeddingCache.load(cache_path)
    want = pipe(prompt_embeds=(cache.embeds[:1].astype(np.float32), cache.masks[:1]),
                num_inference_steps=2, seed=42, height=128, width=128,
                output_type="latent").latents.float().numpy()
    np.testing.assert_array_equal(outs["lora"], want)
    assert not np.array_equal(outs["lora"], outs["plain"])
    assert not np.array_equal(outs["int8"], outs["plain"])
    rel = np.linalg.norm(outs["int8"] - outs["plain"]) / np.linalg.norm(outs["plain"])
    assert rel < 0.15


@pytest.mark.parametrize("case", ["missing_prompt", "no_cache"])
def test_generate_errors_match_jax_cli(pixart_dir, cache_path, tmp_path, case):
    args = ["--model", pixart_dir, "--prompt", "not cached", *GEN,
            "--output", str(tmp_path / "x.png")]
    if case == "missing_prompt":
        args += ["--embedding_cache", cache_path]
    with pytest.raises(SystemExit) as jerr:
        jgenerate.main(args)
    with pytest.raises(SystemExit) as terr:
        tgenerate.main([*args, "--device", "cpu"])
    assert str(terr.value) == str(jerr.value)
    # --tp is ported: the conditioning's checks come before the world forms
    # (no follower process starts), with the same message
    with pytest.raises(SystemExit) as tperr:
        tgenerate.main([*args, "--device", "cpu", "--tp", "2"])
    assert str(tperr.value) == str(jerr.value)


def _read_gif(path):
    from PIL import Image

    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append((np.asarray(im.convert("RGB")), im.info.get("duration")))
    return frames


def test_generate_cogvideox_gif(tmp_path):
    """A tiny CogVideoX pipeline (JAX-written) to a GIF: 5 frames of 16×16
    at fps 4 (250 ms a frame), each frame the cube-palette rendering of the
    pipeline's frame."""
    from tdm_tpu.models import cogvideox as jcog, vae3d as jvae3d
    from tdm_tpu.pipelines.cogvideox import CogVideoXPipeline as JCog

    cfg = jcog.CogVideoXConfig.tiny()
    model = jcog.CogVideoXTransformer3D(cfg=cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.in_channels, 2, 2, 2)),
                        jnp.zeros((1,)), jnp.zeros((1, cfg.max_text_len, cfg.text_dim)))["params"]
    vcfg = jvae3d.VAE3DConfig.tiny()
    dec = jvae3d.VAE3DDecoder(cfg=vcfg)
    vparams = dec.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 2, 4, 4)))["params"]
    d = str(tmp_path / "cog")
    JCog(model, params, vae_decoder=dec, vae_params=vparams, vae_cfg=vcfg).save_pretrained(d)
    rng = np.random.default_rng(9)
    cache = EmbeddingCache(embeds=rng.normal(size=(1, cfg.max_text_len, cfg.text_dim))
                           .astype(np.float16), masks=np.ones((1, cfg.max_text_len), np.int64),
                           prompts=["a wave"])
    cache.save(str(tmp_path / "c.npz"))
    out = str(tmp_path / "wave.gif")
    call = ["--num_frames", "5", "--height", "16", "--width", "16", "--seed", "1"]
    tgenerate.main(["--model", d, "--prompt", "a wave", "--embedding_cache",
                    str(tmp_path / "c.npz"), *call, "--fps", "4", "--output", out,
                    "--device", "cpu"])
    frames = _read_gif(out)
    assert len(frames) == 5 and all(f.shape == (16, 16, 3) for f, _ in frames)
    assert all(ms == 250 for _, ms in frames)
    pipe = from_pretrained(d, device="cpu")
    video = pipe(prompt_embeds=cache.embeds.astype(np.float32), seed=1, num_frames=5,
                 height=16, width=16).frames[0].numpy()
    palette = tserver.gif_palette()[tserver.gif_indices(video)]
    np.testing.assert_array_equal(np.stack([f for f, _ in frames]), palette)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_evaluate_matches_jax_cli(pixart_dir, cache_path, clip_dir, tmp_path, same_noise,
                                  monkeypatch, capsys, quant):
    """Both CLIs with --compare_teacher on one pipeline dir, cache, CLIP
    folder (HF tokenizer files) and noise: the same JSON keys, rounding and
    lengths, scores in [0, 100] and within 0.5 of JAX's, the scored PNGs
    written. Under --quant int8 (gates lowered in both packages to the
    tiny widths) the same holds."""
    from tdm_tpu.ops import quant as jq

    if quant:
        for mod in (jq, tq):
            for attr in ("MIN_TOKENS", "MIN_DIM", "WIDE_DIM"):
                monkeypatch.setattr(mod, attr, 1)
    args = ["--model", pixart_dir, "--clip_model", clip_dir, "--prompt", *PROMPTS,
            "--embedding_cache", cache_path, "--num_inference_steps", "2", "--seed", "42",
            "--height", "128", "--width", "128", "--compare_teacher", "--teacher_steps", "4",
            "--teacher_guidance", "3.0", *(["--quant", quant] if quant else [])]
    jevaluate.main([*args, "--output", str(tmp_path / "j.json")])
    capsys.readouterr()
    tevaluate.main([*args, "--output", str(tmp_path / "t.json"), "--save_images",
                    str(tmp_path / "png"), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = json.loads(open(tmp_path / "t.json").read())
    ref = json.loads(open(tmp_path / "j.json").read())
    assert printed == got
    assert got.keys() == ref.keys() == {"prompts", "student", "teacher", "student_minus_teacher"}
    for role in ("student", "teacher"):
        assert got[role].keys() == ref[role].keys()
        assert (got[role]["steps"], got[role]["guidance_scale"]) == (
            ref[role]["steps"], ref[role]["guidance_scale"])
        assert len(got[role]["clip_scores"]) == len(PROMPTS)
        for s, r in zip(got[role]["clip_scores"], ref[role]["clip_scores"]):
            assert 0.0 <= s <= 100.0 and abs(s - r) <= SCORE_TOL
        assert got[role]["clip_score_mean"] == round(got[role]["clip_score_mean"], 4)
    assert sorted(os.listdir(tmp_path / "png")) == [
        f"{tag}_{i:03d}.png" for tag in ("student", "teacher") for i in range(2)]


def test_evaluate_with_a_hash_tokenizer_and_its_errors(pixart_dir, cache_path, tmp_path,
                                                        capsys):
    """A CLIP folder with the port's hash bundle evaluates; one with no
    tokenizer exits as the JAX CLI does; no prompts exits."""
    hash_dir = write_clip_folder(str(tmp_path / "hash"), tokenizer="hash")
    base = ["--model", pixart_dir, "--embedding_cache", cache_path, "--num_inference_steps",
            "1", "--height", "64", "--width", "64", "--device", "cpu"]
    tevaluate.main([*base, "--clip_model", hash_dir, "--prompt", PROMPTS[0]])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"prompts", "student"} and len(out["student"]["clip_scores"]) == 1
    os.remove(os.path.join(hash_dir, tclip_score.HASH_TOKENIZER_FILE))
    with pytest.raises(SystemExit, match="has no tokenizer files"):
        tevaluate.main([*base, "--clip_model", hash_dir, "--prompt", PROMPTS[0]])
    with pytest.raises(SystemExit, match="pass --prompt or --prompts_file"):
        tevaluate.main([*base, "--clip_model", hash_dir])


def test_server_takes_quant_int8(pixart_dir, cache_path, monkeypatch):
    """`--quant int8` sets pipe.quant; a request is answered (gates lowered
    to the tiny widths) with another image than the plain server's."""
    for attr in ("MIN_TOKENS", "MIN_DIM", "WIDE_DIM"):
        monkeypatch.setattr(tq, attr, 1)
    pngs = {}
    for quant in (None, "int8"):
        argv = ["--model", pixart_dir, "--embedding_cache", cache_path, "--device", "cpu",
                "--port", "0", "--height", "64", "--width", "64", "--batch_size", "1"]
        server = tserver.build_server(tserver.parse_args(
            argv + (["--quant", quant] if quant else []))).start()
        try:
            assert server.batcher.pipe.quant == quant
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/generate",
                data=json.dumps({"prompt": PROMPTS[0], "seed": 3}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                pngs[quant] = base64.b64decode(json.loads(r.read())["image"])
        finally:
            server.close()
    assert pngs[None] != pngs["int8"]
    from PIL import Image

    assert Image.open(io.BytesIO(pngs["int8"])).size == (16, 16)


# --- the image VAE encoders ----------------------------------------------------


@pytest.mark.parametrize("kind", ["taesd", "klvae", "klvae_sd3"])
def test_vae_encoders_match_jax(kind):
    """The encoder halves of one synthetic diffusers state dict through
    both converters into TAESDEncoder / KLEncoder, fp32, a non-square image:
    z (TAESD) or (mean, logvar) after quant_conv (KL) within 1e-5 of the
    largest |JAX output|."""
    if kind == "taesd":
        jcfg = jvae.TAESDConfig(width=8, num_stages=2, blocks_per_stage=1)
        tcfg = tvae.TAESDConfig(width=8, num_stages=2, blocks_per_stage=1)
        sd = tmanifest.synthetic_state_dict("taesd", tcfg, seed=6, scale=0.3)
        kw = dict(num_stages=2, blocks_per_stage=1)
        jtree, ttree = (conv(sd, **kw)["encoder"] for conv in (jconvert.taesd_params,
                                                              tconvert.taesd_params))
        jm, tm = jvae.TAESDEncoder(cfg=jcfg), tvae.TAESDEncoder(tcfg, device="cpu")
    else:
        jcfg, tcfg = jvae.KLVAEConfig.tiny(), tvae.KLVAEConfig.tiny()
        if kind == "klvae_sd3":
            jcfg = dataclasses.replace(jcfg, latent_channels=16)
            tcfg = dataclasses.replace(tcfg, latent_channels=16)
        sd = tmanifest.synthetic_state_dict("klvae", tcfg, seed=6, scale=0.3)
        kw = dict(layers_per_block=tcfg.layers_per_block, n_stages=len(tcfg.block_widths))
        jtree, ttree = (conv(sd, **kw)["encoder"] for conv in (jconvert.klvae_params,
                                                              tconvert.klvae_params))
        jm, tm = jvae.KLEncoder(cfg=jcfg), tvae.KLEncoder(tcfg, device="cpu")
    from_jax.load_from_jax(tconvert.flatten(ttree), tm)
    img = np.random.default_rng(12).uniform(-1, 1, (2, 3, 24, 40)).astype(np.float32)
    ref = jm.apply({"params": jconvert.to_jax(jtree)}, jnp.asarray(img))
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    if kind == "taesd":
        assert got.shape == (2, 4, 6, 10)
        assert_f32_close(got, ref)
        return
    for g, r in zip(got, ref, strict=True):
        assert g.shape == (2, tcfg.latent_channels, 12, 20)
        assert_f32_close(g, r)
