"""Data-parallel serving of the port (`pipelines/base.py`
`data_parallel_devices`, `serve/server.py --dp`) on the CPU, where N
replicas of the model run on the CPU, one thread each:

* each family's tiny pipeline with two CPU replicas gives the undivided
  batch's latents and images bit for bit (a row's products do not depend
  on its batch-mates on the CPU);
* the server with `--dp 2 --device cpu` answers a batch of 4 as the
  `--dp 1` server does, bit for bit, its rows split 2 + 2;
* the JAX server's rules: --batch_size and --batch_buckets must be
  multiples of --dp, with its messages; a batch the replicas do not divide
  raises ValueError;
* the kernels' launch counts stay exact when replicas launch from several
  threads."""

import sys
import threading

import numpy as np
import pytest
import torch

from tdm_tpu_torch.data.prompts import EmbeddingCache
from tdm_tpu_torch.models import cogvideox as tcog, mmdit_sd3, pixart, unet_sd15, vae as tvae
from tdm_tpu_torch.ops import attention as tattn
from tdm_tpu_torch.pipelines import (CogVideoXPipeline, PixArtPipeline, SD15Pipeline,
                                     save_pretrained)
from tdm_tpu_torch.pipelines.sd3 import SD3Pipeline
from tdm_tpu_torch.serve import server as tserver

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _pipe(family):
    """A tiny pipeline with seeded weights, and one call's inputs for 4
    rows (latents out)."""
    torch.manual_seed(0)
    rng = np.random.default_rng(3)
    b = 4
    if family == "pixart":
        pipe = PixArtPipeline(
            pixart.PixArtTransformer2D(pixart.PixArtConfig.tiny(), device=CPU),
            vae_decoder=tvae.TAESDDecoder(tvae.TAESDConfig(width=8, num_stages=1,
                                                           blocks_per_stage=1), device=CPU),
            device="cpu")
        cond = (rng.standard_normal((b, 8, 32)), (np.arange(8)[None] < [[8], [3], [5], [1]]))
        call = dict(latents=rng.standard_normal((b, 4, 16, 16)), height=128, width=128,
                    guidance_scale=2.0, negative_embeds=(np.zeros((b, 8, 32)), np.ones((b, 8))))
    elif family == "sd3":
        cfg = mmdit_sd3.MMDiTConfig.tiny()
        pipe = SD3Pipeline(mmdit_sd3.SD3Transformer2D(cfg, device=CPU), device="cpu")
        cond = (rng.standard_normal((b, 8, cfg.context_dim)),
                rng.standard_normal((b, cfg.pooled_dim)))
        call = dict(latents=rng.standard_normal((b, 16, 8, 8)), height=64, width=64,
                    output_type="latent")
    elif family == "sd15":
        cfg = unet_sd15.UNetConfig.tiny()
        pipe = SD15Pipeline(unet_sd15.UNet2DCondition(cfg, device=CPU), device="cpu")
        cond = (rng.standard_normal((b, 8, cfg.context_dim)), np.ones((b, 8)))
        call = dict(latents=rng.standard_normal((b, 4, 8, 8)), height=64, width=64,
                    output_type="latent")
    else:
        cfg = tcog.CogVideoXConfig.tiny()
        pipe = CogVideoXPipeline(tcog.CogVideoXTransformer3D(cfg, device=CPU), device="cpu")
        cond = rng.standard_normal((b, cfg.max_text_len, cfg.text_dim))
        call = dict(latents=rng.standard_normal((b, 16, 3, 8, 8)), num_frames=9, height=64,
                    width=64, output_type="latent")

    def f32(x):
        if isinstance(x, tuple):
            return tuple(f32(t) for t in x)
        x = np.asarray(x)
        return torch.from_numpy(x.astype(np.int32 if x.dtype == bool else np.float32))

    return pipe, dict(prompt_embeds=f32(cond), **{
        k: f32(v) if k in ("latents", "negative_embeds") else v for k, v in call.items()})


@pytest.mark.parametrize("family", ["pixart", "sd3", "sd15", "cogvideox"])
def test_two_replicas_give_the_undivided_batch_bit_for_bit(family):
    pipe, call = _pipe(family)
    whole = pipe(**call)
    pipe.data_parallel_devices = [CPU, CPU]
    assert pipe.data_parallel_devices == [CPU, CPU]
    assert pipe._replicas[0] is pipe and pipe._replicas[1].denoiser is not pipe.denoiser
    split = pipe(**call)
    assert torch.equal(split.latents, whole.latents)
    if whole.images is not None:
        assert torch.equal(split.images, whole.images)
    three = {k: (tuple(t[:3] for t in v) if isinstance(v, tuple) else v[:3])
             if k in ("prompt_embeds", "latents", "negative_embeds") else v
             for k, v in call.items()}
    with pytest.raises(ValueError, match="batch 3 does not divide the 2 data-parallel"):
        pipe(**three)
    pipe.data_parallel_devices = None
    assert pipe.data_parallel_devices is None
    assert torch.equal(pipe(**call).latents, whole.latents)


PROMPTS = ["a cat", "a dog", "a fox", "an owl"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny PixArt pipeline written in the tdm_tpu layout and an
    embedding cache of PROMPTS."""
    root = tmp_path_factory.mktemp("dp")
    pipe, _ = _pipe("pixart")
    save_pretrained(str(root / "pipe"), pipe)
    rng = np.random.default_rng(11)
    EmbeddingCache(rng.standard_normal((4, 8, 32)).astype(np.float16),
                   (np.arange(8)[None] < np.array([[8], [3], [5], [2]])).astype(np.int32),
                   PROMPTS).save(str(root / "cache.npz"))
    return str(root / "pipe"), str(root / "cache.npz")


def _serve(served, *flags):
    model, cache = served
    args = tserver.parse_args(["--model", model, "--embedding_cache", cache, "--device", "cpu",
                               "--port", "0", "--batch_size", "4", "--max_delay_ms", "3000",
                               "--height", "128", "--width", "128", *flags])
    server = tserver.build_server(args).start()
    try:
        futures = [server.batcher.submit(p, seed=7 + i) for i, p in enumerate(PROMPTS)]
        results = [f.result(timeout=300) for f in futures]
        stats = server.batcher.stats
        assert stats.batches == 1 and stats.batches_by_shape == {4: 1}
        return server.batcher.pipe.data_parallel_devices, results
    finally:
        server.close()


def test_dp_server_answers_as_one_replica(served):
    devices, two = _serve(served, "--dp", "2")
    assert devices == [CPU, CPU]
    devices, one = _serve(served, "--dp", "1")
    assert devices is None
    for a, b in zip(two, one):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags,message", [
    (["--dp", "2", "--batch_size", "3"],
     "--batch_size 3 must be a multiple of --dp 2 (the batch shards over the mesh)"),
    (["--dp", "2", "--batch_buckets", "1,4"],
     "--batch_buckets 1,4 must all be multiples of --dp 2 (each bucket batch shards "
     "over the mesh)"),
    (["--dp", "2", "--tp", "1"], "--tp and --dp are mutually exclusive"),
])
def test_dp_server_rules(flags, message):
    """The JAX server's SystemExits, raised before any model loads (the
    model path does not exist)."""
    args = tserver.parse_args(["--model", "unused", "--device", "cpu", *flags])
    with pytest.raises(SystemExit, match=message.replace("(", r"\(").replace(")", r"\)")):
        tserver.build_server(args)


def test_dp_above_the_visible_gpus_raises(monkeypatch):
    """On CUDA, --dp N takes cuda:0..N-1 and all must exist: no smaller
    mesh, no fall back to the CPU (the card is faked: one visible)."""
    from tdm_tpu_torch import device as tdevice

    monkeypatch.setattr(tdevice, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = tserver.parse_args(["--model", "unused", "--dp", "2"])
    with pytest.raises(ValueError, match="--dp 2 needs 2 CUDA devices; 1 visible"):
        tserver.build_server(args)


def test_launch_counts_are_exact_from_many_threads():
    """count_launch under 16 threads (more than this box's cores) with a
    switch interval of 1 µs: no increment is lost."""
    w = tattn.flash_attention_fwd
    before = w.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tattn.count_launch(w) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert w.launches - before == 16 * 2000
    w.launches = before
