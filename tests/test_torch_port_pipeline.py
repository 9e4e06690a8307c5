"""The serving slice as a whole: the port's PixArt pipeline, loader, batcher
and HTTP server against the JAX package.

A tiny JAX pipeline (PixArt tiny + a one-stage TAESD) is written with the
JAX package's `save_pretrained`, loaded by the port's `from_pretrained` on
the CPU, and given the same `latents=` and `prompt_embeds=`. The models run
in fp32, but both pipelines round the sampler state to bf16 at every step
(base.py:398-411, schedules.py:255). Forwards that agree to ~1e-6 still
land a rare state on the other side of a bf16 rounding boundary, and the
next steps carry that one-ulp step along. So the latents are held to one
bf16 ulp of the largest latent with under 1% of elements differing at all,
and the images to 2e-3, half a step of the 8-bit PNG they are served as.
Servers bind port 0 and write only under tmp_path.
"""

import base64
import io
import json
import shutil
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu.models import pixart as jpixart, vae as jvae
from tdm_tpu.pipelines import loading as jloading
from tdm_tpu.pipelines.pixart import PixArtPipeline as JaxPipeline
from tdm_tpu_torch.data.prompts import EmbeddingCache
from tdm_tpu_torch.models import pixart as tpixart
from tdm_tpu_torch.ops import attention as tattn
from tdm_tpu_torch.pipelines import PixArtPipeline, from_pretrained, save_pretrained
from tdm_tpu_torch.serve import batcher as tbatcher, server as tserver

torch.set_num_threads(2)

CALL = dict(num_inference_steps=4, height=128, width=128)


def assert_bf16_state_close(got: torch.Tensor, ref) -> None:
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    diff = np.abs(got - ref)
    assert diff.max() <= 2**-7 * np.abs(ref).max(), diff.max()
    assert np.mean(diff > 0) < 0.01, np.mean(diff > 0)


@pytest.fixture(scope="module")
def jax_pipe():
    cfg = jpixart.PixArtConfig.tiny()
    model = jpixart.PixArtTransformer2D(cfg=cfg)
    params = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 8, 32)), jnp.ones((1, 8), jnp.int32),
    )["params"]
    vcfg = jvae.TAESDConfig(width=8, num_stages=1, blocks_per_stage=1)
    dec = jvae.TAESDDecoder(cfg=vcfg)
    vparams = dec.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, 16, 16)))["params"]
    return JaxPipeline(model, params, vae_decoder=dec, vae_params=vparams)


@pytest.fixture(scope="module")
def jax_dir(jax_pipe, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_pipe"))
    jax_pipe.save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def port_pipe(jax_dir):
    return from_pretrained(jax_dir, device="cpu")


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, 4, 16, 16)).astype(np.float32)
    text = rng.standard_normal((b, 8, 32)).astype(np.float32)
    lengths = rng.integers(0, 9, size=b)
    mask = (np.arange(8)[None] < lengths[:, None]).astype(np.int32)
    return lat, text, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_matches_jax(jax_pipe, port_pipe, seed):
    lat, text, mask = _inputs(3, seed)
    ref = jax_pipe(prompt_embeds=(jnp.asarray(text), jnp.asarray(mask)),
                   latents=jnp.asarray(lat), **CALL)
    got = port_pipe(prompt_embeds=(text, mask), latents=lat, **CALL)
    ref_lat = np.asarray(ref.latents.astype(jnp.float32))
    assert got.latents.dtype == torch.bfloat16
    assert_bf16_state_close(got.latents, ref_lat)
    assert got.images.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)


def test_pipeline_cfg_path_matches_jax(jax_pipe, port_pipe):
    """CFG on, with the negative embeddings equal to the prompt's: both
    branches run, and c - u = 0 keeps the mix exact in either package's
    arithmetic (the mix itself is held in fp32 by the sampler test)."""
    lat, text, mask = _inputs(2, 3)
    kw = dict(CALL, guidance_scale=4.5)
    ref = jax_pipe(prompt_embeds=(jnp.asarray(text), jnp.asarray(mask)),
                   negative_embeds=(jnp.asarray(text), jnp.asarray(mask)),
                   latents=jnp.asarray(lat), **kw)
    got = port_pipe(prompt_embeds=(text, mask), negative_embeds=(text, mask), latents=lat, **kw)
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))
    plain = port_pipe(prompt_embeds=(text, mask), latents=lat, **CALL)
    torch.testing.assert_close(got.latents, plain.latents, rtol=0, atol=0)


def test_pipeline_cfg_with_distinct_negative_matches_jax(jax_pipe, port_pipe):
    """CFG on with negative embeddings unlike the prompt's, so c - u != 0
    and the guidance wiring (which branch is the negative, the scale) is
    held against the JAX package, after one step.

    The two branches' ε agree (bf16, up to rounding ties) and the mix
    u + w·(c - u) alone is bit-identical, but inside the jitted sampler
    XLA:CPU fuses the bf16 mix into the x₀ projection and keeps excess
    precision, where eager PyTorch rounds each op to bf16. So about a fifth
    of the elements differ by up to one bf16 ulp of ε, which the projection
    carries into x₀ as up to one bf16 ulp of the largest latent (relative L2
    a few 1e-3). A swapped branch or another scale is off by O(1)."""
    lat, text, mask = _inputs(2, 6)
    _, neg, neg_mask = _inputs(2, 7)
    kw = dict(CALL, num_inference_steps=1, guidance_scale=4.5, output_type="latent")
    ref = jax_pipe(prompt_embeds=(jnp.asarray(text), jnp.asarray(mask)),
                   negative_embeds=(jnp.asarray(neg), jnp.asarray(neg_mask)),
                   latents=jnp.asarray(lat), **kw)
    got = port_pipe(prompt_embeds=(text, mask), negative_embeds=(neg, neg_mask),
                    latents=lat, **kw)
    ref_lat = np.asarray(ref.latents.astype(jnp.float32))
    diff = got.latents.float().numpy() - ref_lat
    assert np.abs(diff).max() <= 2**-7 * np.abs(ref_lat).max()
    assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(ref_lat)
    swapped = port_pipe(prompt_embeds=(neg, neg_mask), negative_embeds=(text, mask),
                        latents=lat, **kw)
    off = swapped.latents.float().numpy() - ref_lat
    assert np.linalg.norm(off) > 0.1 * np.linalg.norm(ref_lat)


def test_pipeline_call_contract(port_pipe):
    lat, text, mask = _inputs(2, 4)
    seeded = port_pipe(prompt_embeds=(text, mask), seed=7, output_type="latent", **CALL)
    assert seeded.images is None and seeded.latents.shape == (2, 4, 16, 16)
    again = port_pipe(prompt_embeds=(text, mask), seed=7, output_type="latent", **CALL)
    torch.testing.assert_close(seeded.latents, again.latents, rtol=0, atol=0)
    rep = port_pipe(prompt_embeds=(text, mask), latents=np.repeat(lat, 2, axis=0)[[0, 0, 2, 2]],
                    num_images_per_prompt=2, output_type="latent", **CALL)
    assert rep.latents.shape == (4, 4, 16, 16)
    # rows 0 and 1 are prompt 0 twice, with the same noise row
    torch.testing.assert_close(rep.latents[0], rep.latents[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="latents shape"):
        port_pipe(prompt_embeds=(text, mask), latents=lat[:, :, :8], **CALL)
    with pytest.raises(ValueError, match="negative_prompt has 1 entries"):
        port_pipe(prompt_embeds=(text, mask), negative_prompt=["x"], **CALL)
    with pytest.raises(NotImplementedError, match="slice 7"):
        port_pipe(["a cat"], **CALL)
    with pytest.raises(ValueError, match="unknown solver"):
        port_pipe(prompt_embeds=(text, mask), solver="euler", **CALL)


@pytest.mark.parametrize("solver", ["dpm", "unipc"])
def test_pipeline_solvers_match_jax(jax_pipe, port_pipe, solver):
    """solver='dpm' / 'unipc' on the DDPM grid (JAX pixart.py:161-177)."""
    lat, text, mask = _inputs(2, 8)
    ref = jax_pipe(prompt_embeds=(jnp.asarray(text), jnp.asarray(mask)),
                   latents=jnp.asarray(lat), solver=solver, **CALL)
    got = port_pipe(prompt_embeds=(text, mask), latents=lat, solver=solver, **CALL)
    assert_bf16_state_close(got.latents, ref.latents.astype(jnp.float32))
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)


def test_from_pretrained_loads_jax_layout_and_round_trips(jax_pipe, port_pipe, jax_dir, tmp_path):
    """A directory the JAX package wrote loads into the port; one the port
    writes (stacked or unrolled layers) loads back into the JAX package
    with the same parameters."""
    assert port_pipe.device.type == "cpu"
    with open(f"{jax_dir}/pipeline.json") as f:
        assert json.load(f)["model"]["attn_impl"] == "xla"  # PixArt tiny's
    assert not hasattr(port_pipe.transformer.cfg, "attn_impl")
    out = str(tmp_path / "port_pipe")
    save_pretrained(out, port_pipe)
    back = jloading.from_pretrained(out)
    ref = jax.tree.map(np.asarray, jax_pipe.params)
    got = jax.tree.map(np.asarray, back.params)
    assert jax.tree.structure(ref) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / "port_pipe" / "pipeline.json") as f:
        meta = json.load(f)
    # no attn_impl: the JAX package reads its default, 'auto'
    assert meta["model"]["dtype"] == "float32" and "attn_impl" not in meta["model"]
    reloaded = from_pretrained(out, device="cpu")
    for k, v in port_pipe.transformer.state_dict().items():
        torch.testing.assert_close(reloaded.transformer.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla", "splash", "bogus"])
def test_from_pretrained_reads_every_jax_attn_impl(jax_dir, tmp_path, impl):
    """Every attention choice the JAX package saves is read: PixArt's
    attention computes one function whatever the name (its masked cross
    attention and head dim 72 take the flash route even under 'splash'), so
    the choice is dropped. An unknown name is an error."""
    shutil.copytree(jax_dir, tmp_path / "pipe")
    meta_file = tmp_path / "pipe" / "pipeline.json"
    meta = json.loads(meta_file.read_text())
    meta["model"]["attn_impl"] = impl
    meta_file.write_text(json.dumps(meta))
    if impl == "bogus":
        with pytest.raises(ValueError, match="unknown attn_impl"):
            from_pretrained(str(tmp_path / "pipe"), device="cpu")
    else:
        pipe = from_pretrained(str(tmp_path / "pipe"), device="cpu")
        assert not hasattr(pipe.transformer.cfg, "attn_impl")


def test_from_pretrained_refuses_unported_families(tmp_path):
    """cogvideox waits for its slice (sd3 and sd15 are ported:
    tests/test_torch_port_sd3.py, tests/test_torch_port_sd15.py)."""
    for family, where in (("cogvideox", "slice 5"),):
        (tmp_path / "pipeline.json").write_text(json.dumps({"family": family}))
        with pytest.raises(NotImplementedError, match=where):
            from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        from_pretrained(str(tmp_path / "missing"), device="cpu")


# --- serving over HTTP ------------------------------------------------------

PROMPTS = ["a cat", "a dog", "a red panda"]


@pytest.fixture(scope="module")
def cache_file(tmp_path_factory):
    rng = np.random.default_rng(11)
    embeds = rng.standard_normal((3, 8, 32)).astype(np.float16)
    masks = (np.arange(8)[None] < np.array([[8], [3], [5]])).astype(np.int32)
    path = str(tmp_path_factory.mktemp("cache") / "cache.npz")
    EmbeddingCache(embeds, masks, PROMPTS,
                   uncond_embed=np.zeros((8, 32), np.float16),
                   uncond_mask=np.zeros(8, np.int32)).save(path)
    return path


@pytest.fixture(scope="module")
def server(jax_dir, cache_file):
    args = tserver.parse_args([
        "--model", jax_dir, "--embedding_cache", cache_file, "--device", "cpu",
        "--port", "0", "--batch_size", "4", "--max_delay_ms", "1500",
        "--height", "128", "--width", "128", "--warmup",
    ])
    srv = tserver.build_server(args).start()
    yield srv
    srv.close()


def _post(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _png_pixels(b64: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    img.load()
    return np.asarray(img)


def test_server_is_deterministic_across_batch_compositions(server, port_pipe):
    solo = _post(server.port, {"prompt": "a dog", "seed": 7})
    results = {}

    def go(i, prompt, seed):
        results[i] = _post(server.port, {"prompt": prompt, "seed": seed})

    threads = [threading.Thread(target=go, args=a)
               for a in [(0, "a cat", 1), (1, "a dog", 7), (2, "a red panda", 3)]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert results[1]["image"] == solo["image"]  # same bytes in another batch
    assert results[0]["image"] != solo["image"]
    for r in list(results.values()) + [solo]:
        assert r["format"] == "png" and r["shape"] == [32, 32, 3]
        assert _png_pixels(r["image"]).shape == (32, 32, 3)
    # the server's image is the pipeline's, for the seed's noise
    noise = tbatcher.request_noise(7, (1, 4, 16, 16))
    cond = server.batcher.cond_fn("a dog")
    direct = port_pipe(prompt_embeds=cond, latents=noise, **CALL).images[0].numpy()
    np.testing.assert_array_equal(
        _png_pixels(solo["image"]), (np.clip(direct, 0, 1) * 255).astype(np.uint8)
    )
    stats = server.batcher.stats
    assert stats.rows_padded >= 3 and stats.batches_by_shape.keys() == {4}


def test_server_status_endpoints_and_errors(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["stats"]["batches"] >= 1
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=30) as r:
        text = r.read().decode()
    assert "tdm_serve_requests_total" in text and 'shape="4"' in text
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, {"prompt": "not cached"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, {"seed": 1})
    assert e.value.code == 400


@pytest.mark.parametrize("flag,value,where", [
    ("--tp", "2", "slice 6"), ("--dp", "2", "slice 6"),
    ("--quant", "int8", "slice 4"), ("--lora", "x.safetensors", None),
])
def test_server_refuses_unported_options(flag, value, where):
    """The options still unported raise naming their slice; --lora is
    ported (served in tests/test_torch_port_sd3.py), so it passes the
    check and the missing model (neither a directory nor a hub repo id) is
    what fails."""
    args = tserver.parse_args(["--model", "unused", "--device", "cpu", flag, value])
    if where is None:
        with pytest.raises(FileNotFoundError, match="neither an existing path"):
            tserver.build_server(args)
        return
    with pytest.raises(NotImplementedError, match=where):
        tserver.build_server(args)


def test_kernel_not_launched_on_cpu(monkeypatch):
    """Every attention call of the model goes through the kernel's wrapper,
    which on the CPU takes the plain version and counts nothing."""
    pipe = PixArtPipeline(
        tpixart.PixArtTransformer2D(tpixart.PixArtConfig.tiny(), device="cpu"), device="cpu"
    )
    wrapper, calls = tattn.flash_attention_fwd, []

    def counted(*args):
        calls.append(args[0].device.type)
        return wrapper(*args)

    monkeypatch.setattr(tattn, "flash_attention_fwd", counted)
    before = wrapper.launches
    lat, text, mask = _inputs(1, 5)
    pipe(prompt_embeds=(text, mask), latents=lat, output_type="latent", **CALL)
    assert calls == ["cpu"] * (2 * 2 * 4)  # 2 layers x (self, cross) x 4 steps
    assert wrapper.launches == before
