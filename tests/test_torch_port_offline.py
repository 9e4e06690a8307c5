"""The port's last single-card modules against the JAX package on the CPU:
param files (`io/params.save_params` / `load_params`), the reverse PixArt
converter, `cli/convert_checkpoint.py`, `pipelines.loading.config_dict`,
`pipelines.pixart.default_pixart_pipeline`, `models/vae3d.VAE3DEncoder`,
HF-dataset prompts, `io/hub.push_to_hub` with the trainer's
`--push_to_hub`, and the server's `--compilation_cache`.

Inputs come from numpy seeds; checkpoints are the seeded synthetic ones of
`io/manifest` at tiny widths. Nothing reaches the network: the hub client
and `datasets.load_dataset` are stubs, except one local dataset folder read
by the real `datasets` package in a subprocess with the hub set offline and
its cache under tmp_path.
"""

import argparse
import json
import os
import struct
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu.cli import convert_checkpoint as jcli
from tdm_tpu.io import convert as jconvert, params as jparams
from tdm_tpu.models import pixart as jpixart, vae as jvae, vae3d as jvae3d
from tdm_tpu.pipelines import loading as jloading, pixart as jpipe
from tdm_tpu_torch.cli import convert_checkpoint as tcli
from tdm_tpu_torch.io import convert as tconvert, from_jax, hub as thub, manifest as tmanifest
from tdm_tpu_torch.io import params as tparams
from tdm_tpu_torch.models import pixart as tpixart, vae as tvae, vae3d as tvae3d
from tdm_tpu_torch.pipelines import loading as tloading, pixart as tpipe

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def raw_entries(path: str) -> dict:
    """name → (dtype code, shape, raw bytes) of a safetensors file: what a
    byte-for-byte comparison of two writers' files should hold equal (the
    header's spacing and the data's order may differ between writers)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    return {k: (v["dtype"], tuple(v["shape"]), data[v["data_offsets"][0]:v["data_offsets"][1]])
            for k, v in header.items() if k != "__metadata__"}


def _tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"blocks": {"attn": {"kernel": rng.standard_normal((2, 4, 3)).astype(np.float32),
                                "bias": rng.standard_normal((2, 3)).astype(np.float32)}},
            "proj_out": {"kernel": (rng.standard_normal((3, 5)) * 1e3).astype(np.float32)},
            "table": rng.standard_normal(7).astype(np.float64),
            "step": np.arange(4, dtype=np.int32)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, key)
        else:
            yield key, np.asarray(v)


# --- the server's flags -------------------------------------------------------


def test_server_parses_the_jax_servers_full_flag_set(monkeypatch):
    """Every option of the JAX server's parser, each with a value it
    takes, parses with the port's parser (`--compilation_cache` is accepted
    and ignored), and each lands on the same attribute."""
    from tdm_tpu.serve import server as jserver
    from tdm_tpu_torch.serve import server as tserver

    grabbed = {}
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        grabbed["parser"] = self
        return parse(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    jserver.parse_args(["--model", "m"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    argv, dests = [], []
    for action in grabbed["parser"]._actions:
        if not action.option_strings or action.dest == "help":
            continue
        opt = action.option_strings[0]
        dests.append(action.dest)
        if action.nargs == 0:
            argv.append(opt)
        elif action.choices:
            argv += [opt, next(str(c) for c in action.choices if c is not None)]
        elif action.type in (int, float):
            argv += [opt, "2"]
        else:
            argv += [opt, "x"]
    assert "--compilation_cache" in argv
    args = tserver.parse_args(argv)
    assert args.compilation_cache == "x"
    assert set(dests) <= set(vars(args))


# --- param files ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, "float16", "bfloat16"])
def test_param_files_both_ways_with_jax(tmp_path, dtype):
    """A nested tree written by either package reads back equal in the
    other, and the two writers' entries are equal byte for byte (bfloat16
    rounded to nearest even on both sides)."""
    import ml_dtypes

    tree = _tree()
    jdtype = None if dtype is None else {"float16": np.float16,
                                         "bfloat16": ml_dtypes.bfloat16}[dtype]
    port_file, jax_file = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    tparams.save_params(tree, port_file, dtype=dtype)
    jparams.save_params(tree, jax_file, dtype=jdtype)
    assert raw_entries(port_file) == raw_entries(jax_file)
    if dtype == "bfloat16":
        assert raw_entries(port_file)["proj_out/kernel"][0] == "BF16"
    back_in_jax = dict(_leaves(jparams.load_params(port_file, to_jnp=False)))
    back_in_port = dict(_leaves(tparams.load_params(jax_file)))
    assert set(back_in_jax) == set(back_in_port) == {k for k, _ in _leaves(tree)}
    for k, v in back_in_port.items():
        np.testing.assert_array_equal(v, np.asarray(back_in_jax[k], v.dtype), err_msg=k)
        if dtype is None:
            np.testing.assert_array_equal(v, dict(_leaves(tree))[k], err_msg=k)


def test_save_params_takes_tensors_and_load_params_gives_them(tmp_path):
    path = str(tmp_path / "t.safetensors")
    tree = {"a": {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)},
            "b": torch.ones(2)}
    tparams.save_params(tree, path, dtype=torch.float16)
    back = tparams.load_params(path, to_torch=True, device="cpu")
    assert back["a"]["w"].dtype == torch.float16 and back["a"]["w"].device.type == "cpu"
    torch.testing.assert_close(back["a"]["w"].float(), tree["a"]["w"].float(), rtol=0, atol=0)
    assert raw_entries(path)["b"][0] == "F16"


def test_bfloat16_rounding_matches_ml_dtypes():
    import ml_dtypes

    rng = np.random.default_rng(5)
    x = (rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000)).astype(np.float32)
    ties = np.array([0x3F808000, 0x3F818000, 0x7F7FFFFF], np.uint32).view(np.float32)
    x = np.concatenate([x, ties, np.array([np.inf, -np.inf, np.nan, 0.0, -0.0], np.float32)])
    np.testing.assert_array_equal(tparams.bfloat16_bits(x),
                                  x.astype(ml_dtypes.bfloat16).view(np.uint16))


# --- the reverse converter --------------------------------------------------------


def _tiny_pixart_sd(seed: int = 0) -> dict:
    return tmanifest.synthetic_state_dict("pixart", tpixart.PixArtConfig.tiny(), seed=seed)


@pytest.mark.parametrize("scan", [True, False])
def test_pixart_to_torch_round_trip_matches_jax(scan):
    """pixart_params → pixart_to_torch gives the checkpoint back exactly,
    key for key, and the same state dict as the JAX package's."""
    sd = _tiny_pixart_sd()
    tree = tconvert.pixart_params(sd, scan_layers=scan)
    back = tconvert.pixart_to_torch(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].flags["C_CONTIGUOUS"], k
    ref = jconvert.pixart_to_torch(jconvert.pixart_params(sd, scan_layers=scan))
    assert set(ref) == set(back)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    assert tconvert.TO_TORCH.keys() == jconvert.TO_TORCH.keys()


def test_unstack_layers_matches_jax():
    tree = tconvert.pixart_params(_tiny_pixart_sd(1))
    got = tconvert.unstack_layers(tree)
    ref = jconvert.unstack_layers(jconvert.pixart_params(_tiny_pixart_sd(1)))
    assert "blocks" not in got and set(got) == set(ref)
    got_flat, ref_flat = dict(_leaves(got)), dict(_leaves(ref))
    assert set(got_flat) == set(ref_flat)
    for k, v in ref_flat.items():
        np.testing.assert_array_equal(got_flat[k], v, err_msg=k)
    assert tconvert.unstack_layers({"a": np.zeros(2)}).keys() == {"a"}


# --- cli/convert_checkpoint -------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    path = str(root / "diffusion_pytorch_model.safetensors")
    tmanifest.write_synthetic("pixart", path, tpixart.PixArtConfig.tiny(), seed=3)
    return root, path


@pytest.fixture(scope="module")
def tiny_bf16_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_bf16")
    tparams.save_params(_tiny_pixart_sd(4), str(root / "diffusion_pytorch_model.safetensors"),
                        dtype="bfloat16")
    return root


def _both(capsys, argv_port, argv_jax):
    out = []
    for main, argv in ((tcli.main, argv_port), (jcli.main, argv_jax)):
        code = 0
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
        out.append((code, capsys.readouterr().out))
    return out


def test_convert_checkpoint_check_manifest_matches_jax(tiny_checkpoint, tmp_path, capsys):
    """--check-manifest: a tiny checkpoint against the released model's
    inventory fails with the JAX CLI's report and exit code; a manifest of
    that inventory passes with its line."""
    _, path = tiny_checkpoint
    port, jax_ = _both(capsys, ["--family", "pixart", "--check-manifest", path],
                       ["--family", "pixart", "--check-manifest", path])
    assert port == jax_ and port[0] == 1 and "problem(s)" in port[1]
    manifest_json = str(tmp_path / "pixart.json")
    tmanifest.save_manifest(tmanifest.expected_manifest("pixart"), manifest_json)
    for family in ("pixart", "vae3d"):
        argv = ["--family", family, "--check-manifest", manifest_json]
        port, jax_ = _both(capsys, argv, argv)
        assert port == jax_, family
    assert port[0] == 1  # the pixart inventory is not the 3D VAE's
    assert _both(capsys, ["--family", "pixart", "--check-manifest", manifest_json],
                 ["--family", "pixart", "--check-manifest", manifest_json])[0] == (
        0, f"{manifest_json}: OK — {len(tmanifest.expected_manifest('pixart'))} keys match "
           "the pixart inventory\n")


@pytest.mark.parametrize("extra", [[], ["--no_scan"], ["--dtype", "float32"],
                                   ["--dtype", "bfloat16"], "bf16_source"],
                         ids=["scan", "no_scan", "float32", "bfloat16", "bf16_source"])
def test_convert_checkpoint_src_dst_and_reverse_match_jax(tiny_checkpoint, tiny_bf16_checkpoint,
                                                          tmp_path, capsys, extra):
    """--src/--dst writes the JAX CLI's file (entries byte for byte), each
    package's output loads with the other's `load_params`; --reverse gives
    the JAX CLI's state dict, and from an undowncast file the checkpoint's
    own tensors. A BF16 checkpoint converts to BF16 without --dtype, as
    the JAX CLI keeps a bfloat16 source's dtype."""
    root, _ = tiny_checkpoint
    if extra == "bf16_source":
        root, extra = tiny_bf16_checkpoint, []
    port_out, jax_out = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    argv = ["--family", "pixart", "--src", str(root)]
    port, jax_ = _both(capsys, argv + ["--dst", port_out, *extra],
                       argv + ["--dst", jax_out, *extra])
    assert port[0] == jax_[0] == 0
    assert port[1].replace(port_out, "D") == jax_[1].replace(jax_out, "D")
    assert raw_entries(port_out) == raw_entries(jax_out)
    if root == tiny_bf16_checkpoint:
        assert {v[0] for v in raw_entries(port_out).values()} == {"BF16"}
    loaded_in_jax = dict(_leaves(jparams.load_params(port_out, to_jnp=False)))
    loaded_in_port = dict(_leaves(tparams.load_params(jax_out)))
    assert set(loaded_in_jax) == set(loaded_in_port)
    for k, v in loaded_in_port.items():
        np.testing.assert_array_equal(v, np.asarray(loaded_in_jax[k]).astype(v.dtype), err_msg=k)

    port_rev, jax_rev = str(tmp_path / "port_rev.safetensors"), str(tmp_path / "jax_rev.safetensors")
    rev = ["--family", "pixart", "--reverse"]
    port, jax_ = _both(capsys, rev + ["--src", port_out, "--dst", port_rev],
                       rev + ["--src", jax_out, "--dst", jax_rev])
    assert port[0] == jax_[0] == 0
    assert raw_entries(port_rev) == raw_entries(jax_rev)
    if "bfloat16" not in extra:  # no rounding on the way: the checkpoint's tensors
        sd = tconvert.load_torch_state_dict(str(root))
        back = tparams.load_file(port_rev)
        assert set(back) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k].astype(v.dtype), v, err_msg=k)


def test_convert_checkpoint_refusals(tiny_checkpoint, tmp_path):
    _, path = tiny_checkpoint
    for argv, match in ((["--family", "pixart"], "--src and --dst"),
                        (["--family", "taesd3", "--src", path, "--dst", "x"], "check-manifest-only"),
                        (["--family", "sd3", "--reverse", "--src", path, "--dst", "x"],
                         "--reverse supports")):
        with pytest.raises(SystemExit):
            tcli.main(argv)
    assert tcli.FAMILIES == jcli.FAMILIES and tcli._CHECK_FAMILIES == jcli._CHECK_FAMILIES


def test_convert_checkpoint_runs_as_a_module(tiny_checkpoint, tmp_path):
    """`python -m tdm_tpu_torch.cli.convert_checkpoint`, as a user runs it;
    --src/--dst is host work and imports no torch (the package imports it
    on first use)."""
    root, _ = tiny_checkpoint
    out = str(tmp_path / "m.safetensors")
    code = ("import runpy, sys; sys.argv[0] = 'convert_checkpoint'; "
            "runpy.run_module('tdm_tpu_torch.cli.convert_checkpoint', run_name='__main__', "
            "alter_sys=True); assert 'torch' not in sys.modules, 'torch imported'")
    proc = subprocess.run([sys.executable, "-c", code, "--family", "pixart", "--src", str(root),
                           "--dst", out], capture_output=True, text=True, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(f"wrote {out}:")


# --- config_dict and default_pixart_pipeline ------------------------------------


CONFIGS = {
    "pixart": ("models.pixart", "PixArtConfig", ("tiny",)),
    "sd3": ("models.mmdit_sd3", "MMDiTConfig", ("tiny",)),
    "unet_sd15": ("models.unet_sd15", "UNetConfig", ("tiny",)),
    "cogvideox": ("models.cogvideox", "CogVideoXConfig", ("tiny", "cogvideox_5b")),
    "taesd": ("models.vae", "TAESDConfig", ("taesd3",)),
    "klvae": ("models.vae", "KLVAEConfig", ("tiny", "sd3")),
    "vae3d": ("models.vae3d", "VAE3DConfig", ("tiny",)),
    "t5": ("models.t5", "T5Config", ("tiny",)),
    "clip_text": ("models.clip", "CLIPTextConfig", ("tiny",)),
    "clip_vision": ("models.clip", "CLIPVisionConfig", ("tiny",)),
}
# fields of the JAX configs that the port's configs do not have: their
# attention takes one route for every name (pipelines/loading._config)
NOT_IN_PORT = {"pixart": {"attn_impl"}, "t5": {"attn_impl"}, "clip_text": {"attn_impl"}}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_dict_matches_jax(name):
    import importlib

    module, cls, variants = CONFIGS[name]
    jcls = getattr(importlib.import_module(f"tdm_tpu.{module}"), cls)
    tcls = getattr(importlib.import_module(f"tdm_tpu_torch.{module}"), cls)
    for variant in (None, *variants):
        make = (lambda c: c()) if variant is None else (lambda c: getattr(c, variant)())
        ref, got = jloading.config_dict(make(jcls)), tloading.config_dict(make(tcls))
        skipped = NOT_IN_PORT.get(name, set())
        assert got == {k: v for k, v in ref.items() if k not in skipped}, variant
        assert json.loads(json.dumps(got)) == got


def test_default_pixart_pipeline_matches_jax():
    """The tiny DiT and a one-stage TAESD from JAX init trees: the port's
    pipeline built from the two trees against the JAX one, from the same
    latents and embeddings (the bounds of test_torch_port_pipeline: one
    bf16 ulp of the latent state, the images to 2e-3)."""
    cfg, vcfg = jpixart.PixArtConfig.tiny(), jvae.TAESDConfig(width=8, num_stages=1,
                                                             blocks_per_stage=1)
    params = jpixart.PixArtTransformer2D(cfg=cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 8, 32)), jnp.ones((1, 8), jnp.int32))["params"]
    vparams = jvae.TAESDDecoder(cfg=vcfg).init(jax.random.PRNGKey(2),
                                                jnp.zeros((1, 4, 16, 16)))["params"]
    jp = jpipe.default_pixart_pipeline(params, vparams, cfg=cfg, vae_cfg=vcfg)
    tp = tpipe.default_pixart_pipeline(
        params, vparams, cfg=tpixart.PixArtConfig.tiny(),
        vae_cfg=tvae.TAESDConfig(width=8, num_stages=1, blocks_per_stage=1), device="cpu")
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    text = rng.standard_normal((2, 8, 32)).astype(np.float32)
    mask = (np.arange(8)[None] < np.array([[8], [3]])).astype(np.int32)
    call = dict(num_inference_steps=4, height=128, width=128)
    ref = jp(prompt_embeds=(jnp.asarray(text), jnp.asarray(mask)), latents=jnp.asarray(lat),
             **call)
    got = tp(prompt_embeds=(text, mask), latents=lat, **call)
    ref_lat = np.asarray(ref.latents.astype(jnp.float32))
    diff = np.abs(got.latents.float().numpy() - ref_lat)
    assert diff.max() <= 2**-7 * np.abs(ref_lat).max() and np.mean(diff > 0) < 0.01
    np.testing.assert_allclose(got.images.numpy(), np.asarray(ref.images), rtol=0, atol=2e-3)
    assert tp.vae_scaling == jp.vae_scaling and tp.device.type == "cpu"


# --- the 3D VAE's encoder ---------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    cfg = jvae3d.VAE3DConfig.tiny()
    jenc = jvae3d.VAE3DEncoder(cfg=cfg)
    params = jenc.init(jax.random.PRNGKey(4), jnp.zeros((1, 3, 5, 8, 8)))["params"]
    tenc = tvae3d.VAE3DEncoder(tvae3d.VAE3DConfig.tiny(), device="cpu")
    from_jax.load_from_jax(from_jax.flatten_tree(params), tenc)
    return jenc, params, tenc


@pytest.mark.parametrize("frames,batch", [(5, 1), (9, 2)])
def test_vae3d_encoder_matches_jax(encoders, frames, batch):
    """The tiny encoder from the JAX init (the strided causal conv: 5 → 3
    and 9 → 5 latent frames, 16² → 8²): mean and logvar to 1e-5 of their
    scale (fp32 through ~10 convolutions)."""
    jenc, params, tenc = encoders
    video = np.random.default_rng(frames).uniform(-1, 1, (batch, 3, frames, 16, 16))
    video = video.astype(np.float32)
    jmean, jlogvar = jenc.apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        mean, logvar = tenc(torch.from_numpy(video))
    f_lat = 1 + (frames - 1) // 2
    assert mean.shape == logvar.shape == (batch, tenc.cfg.latent_channels, f_lat, 8, 8)
    for got, ref in ((mean, jmean), (logvar, jlogvar)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_vae3d_encoder_is_causal(encoders):
    """Frame 0's latent sees frame 0 only: a change to later frames leaves
    it as it was, bit for bit."""
    _, _, tenc = encoders
    video = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 3, 5, 16, 16))
                             .astype(np.float32))
    other = video.clone()
    other[:, :, 1:] = -other[:, :, 1:]
    with torch.no_grad():
        a, b = tenc(video)[0], tenc(other)[0]
    torch.testing.assert_close(a[:, :, 0], b[:, :, 0], rtol=0, atol=0)
    assert not torch.equal(a[:, :, 1:], b[:, :, 1:])


# --- prompts from an HF dataset --------------------------------------------------


def _stub_datasets(monkeypatch, calls, columns=("prompt",)):
    class _DS:
        column_names = list(columns)

        def __getitem__(self, k):
            return [f"{k} a", f"{k} b", f"{k} c"]

    fake = types.ModuleType("datasets")

    def load_dataset(name, config=None, split=None):
        calls.append((name, config, split))
        return _DS()

    fake.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", fake)


def test_load_prompts_from_a_hub_dataset_matches_jax(monkeypatch):
    """A hub name reaches `datasets.load_dataset(name, config,
    split='train')` with JAX's arguments; the caption column and
    max_samples as there; a missing column raises as there."""
    from tdm_tpu.data import prompts as jprompts
    from tdm_tpu_torch.data import prompts as tprompts

    calls = []
    _stub_datasets(monkeypatch, calls, columns=("prompt", "text"))
    kw = dict(caption_column="text", max_samples=2, dataset_config_name="cfgA")
    assert tprompts.load_prompts("org/ds", **kw) == jprompts.load_prompts("org/ds", **kw)
    assert calls[0] == calls[1] == ("org/ds", "cfgA", "train")
    with pytest.raises(ValueError, match="caption column 'caption'") as e:
        tprompts.load_prompts("org/ds", caption_column="caption")
    with pytest.raises(ValueError) as je:
        jprompts.load_prompts("org/ds", caption_column="caption")
    assert str(e.value) == str(je.value)


def test_load_prompts_without_datasets_raises_its_import_error(monkeypatch):
    from tdm_tpu_torch.data import prompts as tprompts

    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError):
        tprompts.load_prompts("org/ds")


def test_load_prompts_from_a_local_dataset_folder(tmp_path):
    """A local folder (a train.jsonl file) read by the real `datasets` in
    a subprocess with the hub offline and its caches under tmp_path: both
    packages give the same prompts."""
    folder = tmp_path / "ds"
    folder.mkdir()
    rows = [{"text": f"prompt number {i}", "score": i} for i in range(7)]
    (folder / "train.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    code = (
        "import json, sys\n"
        "from tdm_tpu.data import prompts as j\n"
        "from tdm_tpu_torch.data import prompts as t\n"
        "kw = dict(caption_column='text', max_samples=5)\n"
        "print(json.dumps([t.load_prompts(sys.argv[1], **kw), j.load_prompts(sys.argv[1], **kw)]))\n"
    )
    cache = tmp_path / "cache"
    env = dict(os.environ, PYTHONPATH=REPO, HF_HUB_OFFLINE="1", HF_DATASETS_OFFLINE="1",
               HF_HUB_DISABLE_TELEMETRY="1", HF_HOME=str(tmp_path / "hf"),
               HF_DATASETS_CACHE=str(cache), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code, str(folder)], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    port, ref = json.loads(proc.stdout.strip().splitlines()[-1])
    assert port == ref == [f"prompt number {i}" for i in range(5)]
    assert cache.is_dir() and any(cache.iterdir())


# --- push_to_hub ------------------------------------------------------------------


def _stub_hub(monkeypatch, calls):
    class FakeApi:
        def __init__(self, token=None):
            calls["token"] = token

        def create_repo(self, repo_id, exist_ok=False, private=True):
            calls["create"] = (repo_id, exist_ok, private)
            return types.SimpleNamespace(repo_id=repo_id)

        def upload_folder(self, repo_id, folder_path, commit_message):
            calls["upload"] = (repo_id, folder_path, commit_message)

    fake = types.ModuleType("huggingface_hub")
    fake.HfApi = FakeApi
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)


def test_push_to_hub_matches_jax(monkeypatch, tmp_path):
    """The token rule, then create_repo(exist_ok) + upload_folder against
    a stub HfApi, with the JAX function's calls and return value."""
    from tdm_tpu.io import hub as jhub

    monkeypatch.delenv("HF_TOKEN", raising=False)
    with pytest.raises(RuntimeError, match="token"):
        thub.push_to_hub(str(tmp_path), "org/repo")
    port, ref = {}, {}
    _stub_hub(monkeypatch, port)
    url = thub.push_to_hub(str(tmp_path), "org/repo", token="t0", private=False,
                           commit_message="m")
    _stub_hub(monkeypatch, ref)
    assert url == jhub.push_to_hub(str(tmp_path), "org/repo", token="t0", private=False,
                                   commit_message="m")
    assert port == ref == {"token": "t0", "create": ("org/repo", True, False),
                           "upload": ("org/repo", str(tmp_path), "m")}
    monkeypatch.setenv("HF_TOKEN", "from-env")
    _stub_hub(monkeypatch, port)
    thub.push_to_hub(str(tmp_path), "org/repo")
    assert port["token"] == "from-env"


def test_push_to_hub_without_the_package_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub is not installed"):
        thub.push_to_hub(str(tmp_path), "org/repo", token="t")


def test_trainer_pushes_its_output_dir_at_the_end(monkeypatch, tmp_path):
    """`--push_to_hub --hub_token`: one tiny step, then the exported output
    directory uploaded to the repo named after it (no --hub_model_id), as
    the JAX CLI does."""
    from tdm_tpu_torch.cli import train_tdm

    calls = {}
    _stub_hub(monkeypatch, calls)
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.delenv("TDM_EMBEDDING_CACHE", raising=False)
    monkeypatch.delenv("TDM_TAESD_DIR", raising=False)
    train_tdm.main(["--device", "cpu", "--output_dir", str(tmp_path / "run"), "--seed", "0",
                    "--export_lora_rank", "0", "--train_batch_size", "2",
                    "--max_train_steps", "1", "--push_to_hub", "--hub_token", "tok"])
    out = str(tmp_path / "run_cfg4.5_steps900")
    assert os.path.exists(os.path.join(out, "student.safetensors"))
    assert calls == {"token": "tok", "create": ("run_cfg4.5_steps900", True, True),
                     "upload": ("run_cfg4.5_steps900", out, "tdm_tpu checkpoint (step 1)")}
