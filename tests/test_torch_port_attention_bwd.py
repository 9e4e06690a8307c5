"""The port's training attention (the forward with its logsumexp, dQ and
dK/dV) against the JAX package's flash kernels, and the kernels against
their plain versions on the card.

On the CPU the wrappers take the plain versions, so the JAX comparisons
hold the port's plain arithmetic against `attention(impl="pallas",
interpret=True)` (the Pallas kernels in interpret mode) and its `jax.grad`:
fp32 on both sides, the same sums in another order (blockwise online
softmax on the JAX side), to 2e-4 as the JAX package's own backward test
holds its kernels against XLA. JAX is imported inside those tests, so this
file also runs on the card's machine (no JAX) with
`python -m pytest --noconftest tests/test_torch_port_attention_bwd.py -m cuda`.
"""

import math

import numpy as np
import pytest
import torch

from tdm_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

# the multiblock ragged shape of tests/test_attention.py (padding on every
# axis at 128-blocks), plus a batch row whose keys are all masked
B, H, SQ, SK, D = 3, 2, 300, 260, 40
LENGTHS = (200, 64, 0)


def _inputs(seed=7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, s, D)).astype(dtype) for s in (SQ, SK, SK))
    g = rng.standard_normal((B, H, SQ, D)).astype(dtype)
    mask = (np.arange(SK)[None] < np.array(LENGTHS)[:, None]).astype(np.int32)
    return q, k, v, g, mask


def _port_grads(q, k, v, g, mask, impl="auto"):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tattn.attention(*leaves, torch.from_numpy(mask), impl=impl)
    return (out.detach(), *torch.autograd.grad(out, leaves, torch.from_numpy(g)))


def test_plain_lse_forward_matches_pallas_interpret():
    import jax.numpy as jnp

    from tdm_tpu.ops.attention import _flash_fwd_res

    q, k, v, _, mask = _inputs()
    scale = 1.0 / math.sqrt(D)
    bias = np.where(mask.astype(bool), 0.0, -1e30).astype(np.float32)
    jout, res = _flash_fwd_res(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), scale,
        128, 128, True, with_lse=True,
    )
    jlse = np.asarray(res[-1])[..., 0]
    qs = (torch.from_numpy(q) * scale).to(torch.float32)
    out, lse = tattn.flash_attention_fwd_lse(
        qs, torch.from_numpy(k), torch.from_numpy(v), tattn.key_bias(torch.from_numpy(mask))
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-4, rtol=2e-4)
    live = np.asarray(LENGTHS) > 0
    np.testing.assert_allclose(lse.numpy()[live], jlse[live], atol=2e-4, rtol=2e-5)
    # the all-masked row: the +1e30 sentinel on both sides, output exactly 0
    assert (lse.numpy()[~live] == 1e30).all() and (jlse[~live] == 1e30).all()
    assert not out[~torch.from_numpy(live)].any()


def test_plain_backward_matches_pallas_interpret_grads():
    import jax
    import jax.numpy as jnp

    from tdm_tpu.ops.attention import attention as jattention

    q, k, v, g, mask = _inputs()

    def f(q_, k_, v_):
        out = jattention(q_, k_, v_, jnp.asarray(mask), impl="pallas", interpret=True,
                         block_q=128, block_k=128)
        return jnp.sum(out * jnp.asarray(g))

    jgrads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    got = _port_grads(q, k, v, g, mask)[1:]
    for name, a, b_ in zip("qkv", got, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=2e-4, rtol=2e-4,
                                   err_msg=f"d{name}")
    # the all-masked batch row gets exactly zero gradient, on both sides
    for a, b_ in zip(got, jgrads):
        assert not a[2].any() and not np.asarray(b_)[2].any()
    # masked keys get exactly zero dK and dV
    for a in got[1:]:
        assert not a[0, :, 200:].any() and not a[1, :, 64:].any()


def test_plain_backward_matches_autograd_of_plain_attention_fp64():
    """fp64 end to end: FlashAttention's backward (the plain versions of the
    dQ and dK/dV kernels, Δ from the output) against autograd through
    plain_attention's einsum-softmax-einsum, to 1e-10 (fp64 roundoff)."""
    q, k, v, g, mask = _inputs(seed=3, dtype=np.float64)
    got = _port_grads(q, k, v, g, mask, impl="auto")
    ref = _port_grads(q, k, v, g, mask, impl="plain")
    for name, a, b_ in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b_, rtol=1e-10, atol=1e-10, msg=name)


def test_scale_enters_dq_once():
    """A non-default scale: the gradient of q through FlashAttention equals
    autograd of the plain version at that scale (a scale applied twice, or
    to a residual that is already scaled, is off by the scale's factor)."""
    q, k, v, g, mask = _inputs(seed=5, dtype=np.float64)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    grads = {}
    for impl in ("auto", "plain"):
        out = tattn.attention(*leaves, torch.from_numpy(mask), scale=0.37, impl=impl)
        grads[impl] = torch.autograd.grad(out, leaves[0], torch.from_numpy(g))[0]
    torch.testing.assert_close(grads["auto"], grads["plain"], rtol=1e-10, atol=1e-10)


def test_no_grad_forward_takes_the_no_lse_route(monkeypatch):
    """Under torch.no_grad() attention() calls the forward without the lse;
    under autograd, the forward with the lse and then both backward
    wrappers. On the CPU no kernel launches."""
    calls = []
    for name in ("flash_attention_fwd", "flash_attention_fwd_lse",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        wrapper = getattr(tattn, name)

        def counted(*args, _w=wrapper, _n=name):
            calls.append(_n)
            return _w(*args)

        monkeypatch.setattr(tattn, name, counted)
    before = tattn.launch_counts()
    q, k, v, g, mask = _inputs()
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        tattn.attention(qt, kt, vt, torch.from_numpy(mask))
    assert calls == ["flash_attention_fwd"]
    calls.clear()
    out = tattn.attention(qt, kt, vt, torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    assert calls == ["flash_attention_fwd_lse", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"]
    assert tattn.launch_counts() == before


def test_backward_wrappers_have_no_path_for_other_devices():
    x = torch.zeros(1, 1, 4, 8, device="meta")
    row = torch.zeros(1, 1, 4, device="meta")
    with pytest.raises(ValueError, match="no flash kernel for device meta"):
        tattn.flash_attention_fwd_lse(x, x, x, None)
    with pytest.raises(ValueError, match="no flash kernel for device meta"):
        tattn.flash_attention_bwd_dq(x, x, x, None, x, row, row, 1.0)
    with pytest.raises(ValueError, match="no flash kernel for device meta"):
        tattn.flash_attention_bwd_dkv(x, x, x, None, x, row, row)


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card():
    """The dQ and dK/dV kernels and the lse forward against their plain
    versions on the same inputs (lse and Δ from the plain forward; dQ and
    dK/dV once more from the forward kernel's own lse), at PixArt's self and
    cross shapes (bf16), a ragged bf16 shape and an odd fp32 shape; runs on
    a machine with the card. bf16, per batch row: relative L2 under 1e-2 and
    max error under 4 bf16 ulps of the row's largest |plain| (both round P
    and dS to bf16 and the result to bf16); fp32: max error under 1e-4 of
    the largest |plain|. A batch row with every key masked is exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, h, sq, sk, d, dtype, lengths) in (
        (2, 16, 1024, 1024, 72, torch.bfloat16, None),
        (2, 16, 1024, 120, 72, torch.bfloat16, [90, 0]),
        (3, 2, 333, 200, 72, torch.bfloat16, [200, 129, 0]),
        (2, 3, 1000, 77, 64, torch.float32, [77, 0]),
    ):
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
                   for s in (sq, sk, sk))
        dout = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
        bias = None
        if lengths is not None:
            mask = torch.arange(sk, device="cuda")[None] < torch.tensor(
                lengths, device="cuda")[:, None]
            bias = tattn.key_bias(mask)
        out, lse = tattn.plain_attention_lse(q, k, v, bias)
        delta = tattn.attention_delta(dout, out)
        before = tattn.launch_counts()
        got = {
            "out": tattn.flash_attention_fwd_lse(q, k, v, bias)[0],
            "dq": tattn.flash_attention_bwd_dq(q, k, v, bias, dout, lse, delta, 0.3),
            **dict(zip(("dk", "dv"), tattn.flash_attention_bwd_dkv(
                q, k, v, bias, dout, lse, delta))),
        }
        after = tattn.launch_counts()
        assert {n: after[n] - before[n] for n in after} == {
            "flash_attention_fwd": 0, "flash_attention_fwd_lse": 1,
            "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
            "splash_attention_fwd": 0}
        # dQ and dK/dV driven by the forward kernel's own lse, as in training
        own_lse = tattn.flash_attention_fwd_lse(q, k, v, bias)[1]
        got["dq_own_lse"] = tattn.flash_attention_bwd_dq(
            q, k, v, bias, dout, own_lse, delta, 0.3)
        got["dk_own_lse"], got["dv_own_lse"] = tattn.flash_attention_bwd_dkv(
            q, k, v, bias, dout, own_lse, delta)
        ref = {
            "out": out,
            "dq": tattn.plain_attention_bwd_dq(q, k, v, bias, dout, lse, delta, 0.3),
            **dict(zip(("dk", "dv"), tattn.plain_attention_bwd_dkv(
                q, k, v, bias, dout, lse, delta))),
        }
        ref.update({f"{n}_own_lse": ref[n] for n in ("dq", "dk", "dv")})
        for name in got:
            o, r = got[name].float(), ref[name].float()
            assert torch.isfinite(o).all(), name
            if dtype == torch.float32:
                assert (o - r).abs().max() <= 1e-4 * r.abs().max(), name
                continue
            for oi, ri in zip(o, r):
                top = ri.abs().max().item()
                if top == 0:
                    assert not oi.any(), name
                    continue
                ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
                assert (oi - ri).norm() <= 1e-2 * ri.norm(), name
                assert (oi - ri).abs().max().item() <= 4 * ulp, name
