"""The port's ground rules and its host-side pieces: no JAX imports, the
CUDA-by-default device rule, the safetensors reader/writer, the PNG encoder
and the batcher's queueing, all on the CPU without models; and the flash
kernel against its plain version on the card.

This file imports no JAX, so on the machine with the card (which has no
JAX) its card test runs with
`python -m pytest --noconftest tests/test_torch_port_rules.py -m cuda`."""

import ast
import math
import pathlib
import threading
import time
import types

import numpy as np
import pytest
import torch

from tdm_tpu_torch import resolve_device
from tdm_tpu_torch.core import schedules as tsched
from tdm_tpu_torch.io import params as params_io
from tdm_tpu_torch.models import pixart as tpixart, vae as tvae
from tdm_tpu_torch.ops import attention as tattn
from tdm_tpu_torch.pipelines import from_pretrained
from tdm_tpu_torch.pipelines.base import PipelineOutput
from tdm_tpu_torch.serve import batcher as tbatcher, server as tserver

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tdm_tpu"}
GPU_ONLY = {"triton", "pycuda", "cupy"}


def _port_files():
    files = sorted((REPO / "tdm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    return files


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node, node.module.split(".")[0]


def test_port_imports_no_jax_nor_the_jax_package():
    """An AST scan (not sys.modules: this machine's interpreter imports jax
    at start-up) of every port module and chip_smoke.py."""
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node, root in _imported_roots(tree):
            if root in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}:{node.lineno} imports {root}")
    assert not bad, bad


def test_port_imports_nothing_gpu_only_at_module_level():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:  # module-level statements only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for _, root in _imported_roots(node):
                    if root in GPU_ONLY:
                        bad.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert not bad, bad


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsched.ddpm_linear()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpixart.PixArtTransformer2D(tpixart.PixArtConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvae.TAESDDecoder()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserver.build_server(tserver.parse_args(["--model", str(tmp_path)]))
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrapper_has_no_path_for_other_devices():
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no flash kernel for device meta"):
        tattn.flash_attention_fwd(q, q, q, None)
    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="no flash kernel for device meta"):
        tattn.splash_attention_fwd(q, q, q)


def test_splash_wrapper_checks_what_its_kernel_takes():
    """The checks the wrapper makes before a launch on the card (here on
    CPU tensors, which the wrapper itself hands to the plain version)."""
    q = torch.zeros(1, 2, 5, 64)
    tattn._check_splash(q, q, q)
    for bad, err, match in (
        ((torch.zeros(1, 2, 5, 72),) * 3, ValueError, "head dims"),
        ((q, q.bfloat16(), q.bfloat16()), TypeError, "one dtype"),
        ((q.double(),) * 3, TypeError, "float32 or bfloat16"),
        ((q, torch.zeros(1, 3, 5, 64), torch.zeros(1, 3, 5, 64)), ValueError, "shape mismatch"),
        ((torch.zeros(1, 2, 64, 5).transpose(2, 3), q, q), ValueError, "contiguous"),
        ((torch.zeros(1, 2, 5, 65)[..., 1:], q, q), ValueError, "contiguous"),
    ):
        with pytest.raises(err, match=match):
            tattn._check_splash(*bad)


# --- safetensors ------------------------------------------------------------


def test_safetensors_writer_and_reader_match_the_package(tmp_path):
    st_numpy = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(0)
    tensors = {
        "blocks/attn1/to_q/kernel": rng.standard_normal((2, 8, 8)).astype(np.float32),
        "pos_embed/proj/bias": rng.standard_normal(8).astype(np.float16),
        "step": np.arange(5, dtype=np.int64),
        "mask": np.array([1, 0, 1], np.int32),
    }
    ours = tmp_path / "ours.safetensors"
    params_io.save_file(tensors, str(ours))
    theirs_read = st_numpy.load_file(str(ours))
    theirs = tmp_path / "theirs.safetensors"
    st_numpy.save_file(tensors, str(theirs))
    ours_read = params_io.load_file(str(theirs))
    for name, arr in tensors.items():
        for got in (theirs_read[name], ours_read[name]):
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got, arr)


def test_safetensors_reads_bf16_exactly(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    x = torch.randn(3, 5).to(torch.bfloat16)
    path = str(tmp_path / "bf16.safetensors")
    st_torch.save_file({"w": x}, path)
    got = params_io.load_file(path)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())


# --- PNG --------------------------------------------------------------------


def test_png_encoder_round_trips_through_pil():
    from PIL import Image
    import io

    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, size=(7, 5, 3), dtype=np.uint8)
    png = tserver.encode_png(rgb)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    img = Image.open(io.BytesIO(png))
    img.load()
    assert img.mode == "RGB" and img.size == (5, 7)
    np.testing.assert_array_equal(np.asarray(img), rgb)
    with pytest.raises(ValueError):
        tserver.encode_png(rgb.astype(np.float32))


def test_encode_image_quantizes_like_the_jax_server():
    arr = np.array([[[0.0, 0.5, 1.2]]], np.float32)
    out = tserver._encode_image(arr)
    assert out["format"] == "png" and out["shape"] == [1, 1, 3]
    lat = tserver._encode_image(np.zeros((4, 2, 2), np.float32))
    assert lat["format"] == "npy" and lat["shape"] == [4, 2, 2]


# --- batcher ----------------------------------------------------------------


class _FakePipe:
    """Stands in for PixArtPipeline: echoes the noise, optionally blocking
    until released, and records each call's batch size."""

    family = "pixart"

    def __init__(self):
        self.device = torch.device("cpu")
        self.transformer = types.SimpleNamespace(
            cfg=types.SimpleNamespace(in_channels=4, dtype=torch.float32)
        )
        self.release = threading.Event()
        self.release.set()
        self.batches = []

    def __call__(self, *, prompt_embeds, negative_embeds, latents, **kw):
        assert self.release.wait(timeout=60)
        self.batches.append(latents.shape[0])
        return PipelineOutput(images=None, latents=latents.clone())


def _cond(prompt):
    return (np.zeros((1, 2, 3), np.float32), np.ones((1, 2), np.int32))


def test_request_noise_is_per_seed_and_bf16_rounded():
    a = tbatcher.request_noise(8888, (1, 4, 8, 8))
    b = tbatcher.request_noise(8888, (1, 4, 8, 8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, a.bfloat16().float(), rtol=0, atol=0)
    assert not torch.equal(a, tbatcher.request_noise(317, (1, 4, 8, 8)))


def test_batcher_pads_to_buckets_and_returns_each_row():
    pipe = _FakePipe()
    b = tbatcher.MicroBatcher(pipe, batch_size=4, batch_buckets=(1, 4), max_delay_ms=1.0,
                              cond_fn=_cond, call_kwargs={"height": 64, "width": 64})
    try:
        out = b.submit("x", seed=3).result(timeout=60)
        np.testing.assert_array_equal(out, tbatcher.request_noise(3, (1, 4, 8, 8))[0].numpy())
        assert pipe.batches == [1] and b.stats.rows_padded == 0
    finally:
        b.close()
    with pytest.raises(ValueError, match="batch_buckets"):
        tbatcher.MicroBatcher(_FakePipe(), batch_size=2, batch_buckets=(4,), cond_fn=_cond)


def test_batcher_rejects_when_the_queue_is_full():
    pipe = _FakePipe()
    pipe.release.clear()
    b = tbatcher.MicroBatcher(pipe, batch_size=1, max_queue=1, max_delay_ms=1.0, cond_fn=_cond)
    try:
        first = b.submit("x", seed=1)  # taken by the worker, which blocks
        for _ in range(600):  # wait until the worker has taken it
            if b._q.empty():
                break
            time.sleep(0.05)
        second = b.submit("x", seed=2)  # fills the queue
        with pytest.raises(tbatcher.Overloaded):
            b.submit("x", seed=3)
        assert b.stats.rejected == 1
        pipe.release.set()
        first.result(timeout=60)
        second.result(timeout=60)
        assert b.stats.requests == 2 and b.stats.batches == 2
    finally:
        pipe.release.set()
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("x")


def test_batcher_needs_an_embedding_cache():
    with pytest.raises(ValueError, match="embedding_cache"):
        tbatcher.MicroBatcher(_FakePipe())


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version at PixArt's shapes (bf16),
    a ragged bf16 shape (Sq and Sk not multiples of the query and key tiles, an
    all-masked batch row) and an odd fp32 shape; runs on a machine with the
    card. bf16, per batch
    row: relative L2 under 1e-2 and max error under 4 bf16 ulps of the
    row's largest |plain| (both versions round the output and p to bf16);
    a row with every key masked is exactly 0. fp32: 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, h, sq, sk, d, dtype, lengths) in (
        (2, 16, 1024, 1024, 72, torch.bfloat16, None),
        (2, 16, 1024, 120, 72, torch.bfloat16, [90, 0]),
        (4, 16, 1024, 120, 72, torch.bfloat16, [120, 77, 13, 0]),
        (3, 2, 333, 200, 72, torch.bfloat16, [200, 129, 0]),
        (2, 3, 1000, 77, 64, torch.float32, [77, 40]),
    ):
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
                   for s in (sq, sk, sk))
        bias = None
        if lengths is not None:
            mask = torch.arange(sk, device="cuda")[None] < torch.tensor(
                lengths, device="cuda")[:, None]
            bias = tattn.key_bias(mask)
        before = tattn.flash_attention_fwd.launches
        out = tattn.flash_attention_fwd(q, k, v, bias)
        assert tattn.flash_attention_fwd.launches == before + 1
        ref = tattn.plain_attention(q, k, v, bias)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
            continue
        for o, r in zip(out.float(), ref.float()):
            top = r.abs().max().item()
            if top == 0:
                assert not o.any()
                continue
            ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
            assert (o - r).norm() <= 1e-2 * r.norm()
            assert (o - r).abs().max().item() <= 4 * ulp


@pytest.mark.cuda
def test_splash_kernel_matches_plain_on_card():
    """The splash kernel against its plain version on the card: SD3's joint
    attention shape [4,24,4429,4429,64] in bf16 (per batch row, relative L2
    under 1e-2 and max error under 4 bf16 ulps of the row's largest
    |plain|), ragged shapes at D = 64 and 128 (fp32 2e-5, bf16 per row), and
    rows whose real logits are all below -32, where the TPU path's pad
    rescale fails (2e-5 against plain in fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, h, sq, sk, d, dtype) in (
        (4, 24, 4429, 4429, 64, torch.bfloat16),
        (2, 3, 1000, 777, 64, torch.float32),
        (2, 3, 1000, 777, 128, torch.float32),
        (2, 3, 1000, 777, 64, torch.bfloat16),
        (2, 4, 333, 77, 128, torch.bfloat16),
    ):
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
                   for s in (sq, sk, sk))
        q = (q.float() / math.sqrt(d)).to(dtype)
        before = tattn.splash_attention_fwd.launches
        out = tattn.splash_attention_fwd(q, k, v)
        assert tattn.splash_attention_fwd.launches == before + 1
        ref = tattn.plain_splash_attention(q, k, v)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
            continue
        for o, r in zip(out.float(), ref.float()):
            ulp = 2.0 ** (math.floor(math.log2(r.abs().max().item())) - 7)
            assert (o - r).norm() <= 1e-2 * r.norm()
            assert (o - r).abs().max().item() <= 4 * ulp
    u = torch.randn(64, generator=gen, device="cuda")
    u = u / u.norm()
    k = u + 0.05 * torch.randn(1, 2, 77, 64, generator=gen, device="cuda")
    q = (-50.0 * u).expand(1, 2, 50, 64).contiguous()
    v = torch.randn(1, 2, 77, 64, generator=gen, device="cuda")
    assert (q @ k.transpose(2, 3)).max() < -32
    torch.testing.assert_close(tattn.splash_attention_fwd(q, k, v),
                               tattn.plain_splash_attention(q, k, v), rtol=2e-5, atol=2e-5)
