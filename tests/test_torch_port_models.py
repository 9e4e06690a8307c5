"""The port's PixArt layers, PixArt forward, TAESD decoder and weight carry
against the JAX package.

Parameters are made by the JAX package's own `init` (seeded), perturbed
with numpy noise so zero-initialised biases matter, and carried into the
port by `io.from_jax`; inputs come from numpy seeds. All fp32 on the CPU:
the two packages differ only in the order of sums (and XLA's vs PyTorch's
exp/sin), so outputs of magnitude ~1-10 agree to ~1e-5; tolerances are
1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu.io.params import _flatten
from tdm_tpu.models import layers as JL, pixart as jpixart, vae as jvae
from tdm_tpu_torch.io import from_jax
from tdm_tpu_torch.models import layers as TL, pixart as tpixart, vae as tvae

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params,
    )


def _pixart_inputs(b=3, seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, 4, 16, 16)).astype(np.float32)
    t = np.array([899, 500, 10][:b])
    text = rng.standard_normal((b, 8, 32)).astype(np.float32)
    mask = np.array([[1] * 8, [1] * 3 + [0] * 5, [0] * 8][:b], np.int32)
    return lat, t, text, mask


@pytest.fixture(scope="module", params=[True, False], ids=["scanned", "unrolled"])
def pixart_pair(request):
    cfg = dataclasses.replace(jpixart.PixArtConfig.tiny(), scan_layers=request.param)
    jm = jpixart.PixArtTransformer2D(cfg=cfg)
    params = jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 8, 32)), jnp.ones((1, 8), jnp.int32),
    )["params"]
    params = _perturbed(params, 1)
    tm = tpixart.PixArtTransformer2D(tpixart.PixArtConfig.tiny(), device="cpu")
    tm.load_state_dict(from_jax.state_dict_from_jax(_flatten(params), tm))
    return jm, params, tm


def test_pixart_forward_matches(pixart_pair):
    """Both parameter layouts (stacked `blocks/...` and `blocks_{i}/...`)
    carry into the same port model and give the JAX forward."""
    jm, params, tm = pixart_pair
    lat, t, text, mask = _pixart_inputs()
    ref = np.asarray(jm.apply({"params": params}, *(jnp.asarray(a) for a in (lat, t, text, mask))))
    with torch.no_grad():
        got = tm(_t(lat), _t(t), _t(text), _t(mask)).numpy()
    assert got.shape == ref.shape == (3, 8, 16, 16)
    np.testing.assert_allclose(got, ref, **TOL)


def test_pixart_epsilon_and_denoise_fn(pixart_pair):
    jm, params, tm = pixart_pair
    lat, t, text, mask = _pixart_inputs(b=2, seed=4)
    ref = np.asarray(jpixart.make_denoise_fn(jm, params)(
        jnp.asarray(lat), jnp.asarray(t), (jnp.asarray(text), jnp.asarray(mask))))
    with torch.no_grad():
        got = tpixart.make_denoise_fn(tm)(_t(lat), _t(t), (_t(text), _t(mask))).numpy()
    assert got.shape == (2, 4, 16, 16)  # the first 4 of 8 channels
    np.testing.assert_allclose(got, ref, **TOL)


def test_pixart_block_matches():
    cfg = jpixart.PixArtConfig.tiny()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    text = rng.standard_normal((2, 8, 32)).astype(np.float32)
    mask = np.array([[1] * 5 + [0] * 3, [0] * 8], np.int32)
    t6 = rng.standard_normal((2, 6, 32)).astype(np.float32)
    jb = jpixart.PixArtBlock(cfg=cfg)
    params = _perturbed(jb.init(jax.random.PRNGKey(1), *(jnp.asarray(a) for a in (x, text, mask, t6)))["params"], 2)
    tb = tpixart.PixArtBlock(tpixart.PixArtConfig.tiny(), device="cpu")
    tb.load_state_dict(from_jax.state_dict_from_jax(_flatten(params), tb))
    ref = np.asarray(jb.apply({"params": params}, *(jnp.asarray(a) for a in (x, text, mask, t6))))
    with torch.no_grad():
        got = tb(*(_t(a) for a in (x, text, mask, t6))).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("dim", [256, 31])
def test_sinusoidal_timestep_embedding_matches(dim):
    t = np.array([0, 1, 224, 449, 674, 899], np.int32)
    ref = np.asarray(JL.sinusoidal_timestep_embedding(jnp.asarray(t), dim))
    got = TL.sinusoidal_timestep_embedding(_t(t), dim).numpy()
    # fp32 args up to 899 rad: one ulp of the frequency moves sin/cos ~1e-4
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_pos_embed_and_unpatchify_match():
    np.testing.assert_array_equal(
        TL.get_2d_sincos_pos_embed(32, 8, 8, base_size=8),
        JL.get_2d_sincos_pos_embed(32, 8, 8, base_size=8),
    )
    rng = np.random.default_rng(6)
    tokens = rng.standard_normal((2, 16, 2 * 2 * 8)).astype(np.float32)
    np.testing.assert_array_equal(
        TL.unpatchify(_t(tokens), 4, 4, 2, 8).numpy(),
        np.asarray(JL.unpatchify(jnp.asarray(tokens), 4, 4, 2, 8)),
    )


def test_layer_norm_matches_in_fp32_and_keeps_dtype():
    rng = np.random.default_rng(7)
    x = (3 + 2 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    np.testing.assert_allclose(
        TL.layer_norm(_t(x)).numpy(), np.asarray(JL.layer_norm(jnp.asarray(x))), rtol=1e-5, atol=1e-5
    )
    assert TL.layer_norm(_t(x).bfloat16()).dtype == torch.bfloat16


def test_pixart_refuses_unported_options():
    cfg = dataclasses.replace(tpixart.PixArtConfig.tiny(), moe_experts=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpixart.PixArtTransformer2D(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpixart.make_pp_forward(None, None)
    # both of the JAX package's remat policies are ported; another one is
    # refused as the JAX package refuses it
    cfg = dataclasses.replace(tpixart.PixArtConfig.tiny(), remat=True, remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        tpixart.PixArtTransformer2D(cfg, device="cpu")


@pytest.mark.parametrize("stages,blocks,width", [(1, 1, 8), (3, 3, 16)])
def test_taesd_decoder_matches(stages, blocks, width):
    jcfg = jvae.TAESDConfig(width=width, num_stages=stages, blocks_per_stage=blocks)
    jd = jvae.TAESDDecoder(cfg=jcfg)
    rng = np.random.default_rng(8)
    z = (3 * rng.standard_normal((2, 4, 8, 8))).astype(np.float32)  # exercises the tanh clamp
    params = _perturbed(jd.init(jax.random.PRNGKey(3), jnp.asarray(z))["params"], 9)
    td = tvae.TAESDDecoder(
        tvae.TAESDConfig(width=width, num_stages=stages, blocks_per_stage=blocks), device="cpu"
    )
    td.load_state_dict(from_jax.state_dict_from_jax(_flatten(params), td))
    ref = np.asarray(jd.apply({"params": params}, jnp.asarray(z)))
    with torch.no_grad():
        got = td(_t(z)).numpy()
    assert got.shape == (2, 3, 8 * 2**stages, 8 * 2**stages)
    np.testing.assert_allclose(got, ref, **TOL)


def test_nearest_upsample_matches_jax_resize():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)  # NHWC
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 12, 3), "nearest"))
    got = torch.nn.functional.interpolate(
        _t(x).permute(0, 3, 1, 2), scale_factor=2, mode="nearest"
    ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_weight_carry_is_strict(pixart_pair):
    _, params, tm = pixart_pair
    flat = _flatten(params)
    missing = {k: v for k, v in flat.items() if "final_scale_shift_table" not in k}
    with pytest.raises(KeyError, match="missing keys.*final_scale_shift_table"):
        from_jax.state_dict_from_jax(missing, tm)
    extra = dict(flat, **{"lora/alpha": np.ones(1, np.float32)})
    with pytest.raises(KeyError, match=r"unexpected keys \['lora.alpha'\]"):
        from_jax.state_dict_from_jax(extra, tm)
    bad = dict(flat, proj_out=None)
    bad.pop("proj_out")
    bad["proj_out/bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="proj_out.bias"):
        from_jax.state_dict_from_jax(bad, tm)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_jax_layout_inverts_the_carry(pixart_pair, scan_layers):
    _, params, tm = pixart_pair
    flat = from_jax.jax_layout(tm.state_dict(), scan_layers=scan_layers)
    if scan_layers:
        assert flat["blocks/attn1/to_q/kernel"].shape == (2, 32, 32)
        ref = _flatten(params) if "blocks/attn1/to_q/kernel" in _flatten(params) else None
        if ref is not None:
            assert set(flat) == set(ref)
            for k in ref:
                np.testing.assert_array_equal(flat[k], np.asarray(ref[k]))
    else:
        assert "blocks_1/ff/proj_in/kernel" in flat
    back = from_jax.state_dict_from_jax(flat, tm)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
