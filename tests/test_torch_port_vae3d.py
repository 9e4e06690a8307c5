"""The CogVideoX causal 3D VAE decoder in the port against the JAX package,
at tiny sizes on the CPU: CausalConv3d, ResBlock3D and the decoder in fp32,
temporal causality, the streamed decode against the monolithic one, the
tiled decode (and its tile origins at 60×90 latents), and the decoder's
converter.

Inputs are drawn with numpy from fixed seeds; JAX parameters cross through
the weight carry (`io/from_jax.py`, whose 3D conv kernels [kt, kh, kw, in,
out] become torch's [out, in, kt, kh, kw]). The port's causal conv is a sum
of per-tap conv2d calls and JAX's one 3D conv, the same products summed in
another order, so outputs are held to 1e-5 of the largest |JAX| value. The
streamed decode runs the same convolutions on the same frames as the
monolithic one, but a chunk's conv2d calls hold fewer frames, for which the
convolution library may pick another algorithm (another order of the same
fp32 sums), so it is held to 1e-5 of the largest |monolithic| value, the
JAX package's own test_streaming_decode_exact tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu.io import convert as jconvert
from tdm_tpu.models import vae3d as jvae3d
from tdm_tpu_torch.io import convert as tconvert, from_jax, manifest as tmanifest
from tdm_tpu_torch.models import vae3d as tvae3d

torch.set_num_threads(2)

TOL = 1e-5  # of the largest |JAX| output: fp32 sums in another order


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def carry(module, params):
    module.load_state_dict(from_jax.state_dict_from_jax(from_jax.flatten_tree(params), module))
    return module.eval()


def assert_close_to_jax(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max(), np.abs(got - ref).max()


def channels_last(x):
    """The port's [B, F, C, H, W] activations as JAX's [B, F, H, W, C]."""
    return np.transpose(np.asarray(x), (0, 1, 3, 4, 2))


@pytest.mark.parametrize("kernel", [(3, 3, 3), (1, 3, 3), (2, 2, 2)])
def test_causal_conv3d_matches_jax(kernel):
    """The front pad of k_t − 1 copies of frame 0 and the ((k−1)//2, k//2)
    spatial pad, at the decoder's kernels and an even one."""
    rng = np.random.default_rng(sum(kernel))
    x = rng.standard_normal((2, 5, 6, 7, 4)).astype(np.float32)  # B, F, H, W, C (JAX)
    conv = jvae3d.CausalConv3d(3, kernel=kernel)
    params = conv.init(jax.random.PRNGKey(0), x)["params"]
    ref = conv.apply({"params": params}, x)
    port = carry(tvae3d.CausalConv3d(4, 3, kernel, dtype=torch.float32), params)
    with torch.no_grad():
        got = port(_t(np.transpose(x, (0, 1, 4, 2, 3))))
    assert_close_to_jax(channels_last(got), ref)


def test_resblock_matches_jax():
    """GroupNorm per frame, SiLU, two causal convs and the 1×1×1 shortcut
    of a width change."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 5, 6, 8)).astype(np.float32)
    block = jvae3d.ResBlock3D(16, 4, jnp.float32)
    params = block.init(jax.random.PRNGKey(1), x)["params"]
    ref = block.apply({"params": params}, x)
    port = carry(tvae3d.ResBlock3D(8, 16, 4, dtype=torch.float32), params)
    with torch.no_grad():
        got = port(_t(np.transpose(x, (0, 1, 4, 2, 3))))
    assert_close_to_jax(channels_last(got), ref)


@pytest.fixture(scope="module")
def decoders():
    """The tiny JAX decoder, its parameters, and the port's holding them."""
    cfg = jvae3d.VAE3DConfig.tiny()
    dec = jvae3d.VAE3DDecoder(cfg=cfg)
    params = dec.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 3, 4, 4)))["params"]
    port = carry(tvae3d.VAE3DDecoder(tvae3d.VAE3DConfig.tiny(), device="cpu"), params)
    return dec, params, port


def latents(seed, f=5, h=6, w=7, b=2):
    return np.random.default_rng(seed).standard_normal((b, 16, f, h, w)).astype(np.float32)


def test_tiny_decoder_matches_jax(decoders):
    """5 latent frames → (5−1)·2+1 = 9 frames at 2× (the tiny config's
    factors), [B, 3, F, H, W] as the JAX decoder gives it."""
    dec, params, port = decoders
    z = latents(4)
    ref = jax.jit(dec.apply)({"params": params}, z)
    with torch.no_grad():
        got = port(_t(z))
    assert got.shape == (2, 3, 9, 12, 14)
    assert_close_to_jax(got, ref)


def test_temporal_causality(decoders):
    """Changing latent frame k leaves every output frame before its first,
    (k−1)·tf + 1, unchanged bit for bit, and changes the last one."""
    _, _, port = decoders
    z = latents(5)
    z2 = z.copy()
    z2[:, :, 3] += 1.0
    with torch.no_grad():
        a, b = port(_t(z)), port(_t(z2))
    first = (3 - 1) * 2 + 1
    torch.testing.assert_close(a[:, :, :first], b[:, :, :first], rtol=0, atol=0)
    assert not torch.allclose(a[:, :, -1], b[:, :, -1])


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_streaming_decode_equals_monolithic(decoders, chunk):
    """Temporal chunks with each causal conv's last frames carried: the
    monolithic decode (chunk 1 carries frame 0 alone; 3 leaves a short last
    chunk of 2 of the 5 frames); a chunk that dropped or repeated a carried
    frame would be off by O(1)."""
    _, _, port = decoders
    z = _t(latents(6))
    with torch.no_grad():
        full = port(z)
        streamed = tvae3d.decode_streaming(port, z, chunk=chunk)
    assert streamed.shape == full.shape
    assert (streamed - full).abs().max() <= TOL * full.abs().max()
    with pytest.raises(ValueError, match="chunk"):
        tvae3d.decode_streaming(port, z, chunk=0)


def test_decode_tiled_matches_jax(decoders):
    """Tiles of 4 latents overlapping by 1 over 7×9 latents (origins 0, 3
    and a clamped 3 / 0, 3, 5): the ramped blend over the full time axis,
    against JAX's decode_tiled of its own decoder."""
    dec, params, port = decoders
    z = latents(7, f=3, h=7, w=9)
    ref = jvae3d.decode_tiled(lambda t: dec.apply({"params": params}, t), jnp.asarray(z),
                              tile=4, overlap=1, spatial_factor=2)
    with torch.no_grad():
        got = tvae3d.decode_tiled(port, _t(z), tile=4, overlap=1, spatial_factor=2)
    assert got.shape == (2, 3, 5, 14, 18)
    assert_close_to_jax(got, ref)


def test_decode_tiled_origins_at_480x720():
    """At 60×90 latents with tile 32 and overlap 4 there are 8 tiles, y₀ ∈
    {0, 28} and x₀ ∈ {0, 28, 56, 58}, and a decode that is the same
    constant on every tile blends back to that constant (the ramps divided
    by their summed weights)."""
    yy, xx = torch.meshgrid(torch.arange(60.0), torch.arange(90.0), indexing="ij")
    z = torch.stack([yy, xx])[None, :, None]  # [1, 2, 1, 60, 90]: each latent's (y, x)
    origins = []

    def record(zt):
        origins.append((int(zt[0, 0, 0, 0, 0]), int(zt[0, 1, 0, 0, 0])))
        return torch.full((1, 3, 1, zt.shape[3] * 8, zt.shape[4] * 8), 0.25)

    out = tvae3d.decode_tiled(record, z, tile=32, overlap=4, spatial_factor=8)
    assert origins == [(0, 0), (0, 28), (0, 56), (0, 58), (28, 0), (28, 28), (28, 56), (28, 58)]
    assert out.shape == (1, 3, 1, 480, 720)
    torch.testing.assert_close(out, torch.full_like(out, 0.25), rtol=0, atol=1e-6)


def test_vae3d_decoder_converter_matches_jax():
    """`vae3d_decoder_params` on a seeded state dict with the manifest's
    keys (and an encoder's, which it leaves alone): JAX's tree leaf for
    leaf; the upsampler Conv2d becomes a (1, 3, 3) kernel; a leftover key
    raises and a missing one names the family."""
    cfg = tvae3d.VAE3DConfig.tiny()
    sd = tmanifest.synthetic_state_dict("vae3d_decoder", cfg, seed=9)
    sd["encoder.conv_in.conv.weight"] = np.zeros((8, 3, 3, 3, 3), np.float32)
    kw = dict(layers_per_block=1, n_stages=2)
    got = tconvert.flatten(tconvert.vae3d_decoder_params(sd, **kw))
    ref = from_jax.flatten_tree(jconvert.vae3d_decoder_params(sd, **kw))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)
    assert got["up_0_upsampler/conv/kernel"].shape == (1, 3, 3, 16, 16)
    dec = tvae3d.VAE3DDecoder(cfg, device="cpu")
    dec.load_state_dict(from_jax.state_dict_from_jax(got, dec))
    with pytest.raises(ValueError, match="never consumed"):
        tconvert.vae3d_decoder_params({**sd, "decoder.extra.weight": np.zeros(1)}, **kw)
    sd.pop("decoder.mid_block.resnets.0.conv1.conv.weight")
    with pytest.raises(KeyError, match="vae3d_decoder converter"):
        tconvert.vae3d_decoder_params(sd, **kw)


def test_decoder_round_trips_the_jax_layout(decoders):
    """The port's state_dict back in the JAX layout (5-D kernels
    transposed back) equals the JAX parameters."""
    _, params, port = decoders
    back = from_jax.jax_layout(port.state_dict())
    ref = from_jax.flatten_tree(params)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_full_width_decoder_matches_the_manifest():
    """The released decoder's topology on the meta device: its parameters
    are the vae3d_decoder manifest's, layer for layer."""
    dec = tvae3d.VAE3DDecoder(device="meta")
    n = sum(p.numel() for p in dec.parameters())
    assert n == sum(int(np.prod(s)) for s in
                    tmanifest.expected_manifest("vae3d_decoder").values())
