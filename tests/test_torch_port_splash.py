"""The port's splash route against the JAX package's splash path.

`attention(impl="splash")` on the CPU runs `plain_splash_attention`, the
kernel's plain version (fp32 logits, softmax, p rounded to v's dtype, fp32
product), and is held here against JAX's `attention(impl="splash",
interpret=True)` at the JAX package's own ragged splash shapes
(tests/test_attention.py:199-227), within 2e-5 in fp32: the same function,
sums in another order. The kernel itself (`csrc/splash_fwd.cu`) is held
against the plain version on the card by tests/test_torch_port_rules.py and
chip_smoke.py.

Inputs are drawn with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdm_tpu.ops.attention import attention as jattention
from tdm_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for s in (sq, sk, sk))


@pytest.mark.parametrize("shape", [
    (1, 2, 96, 80, 64),  # sk 80: 48 pad keys in the JAX path's 128 block
    (1, 2, 112, 72, 64),  # sk 72: 44% pad keys
    (2, 3, 130, 77, 128),  # D = 128, a ragged tail of 13 keys
])
def test_splash_matches_jax_splash(shape):
    b, h, sq, sk, d = shape
    q, k, v = _qkv(sum(shape), b, h, sq, sk, d)
    ref = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                impl="splash", interpret=True))
    got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)), impl="splash")
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_splash_exact_where_every_real_logit_is_very_negative():
    """Rows whose real logits all lie below -50. The port masks the ragged
    key tail exactly and agrees with JAX's plain `impl="xla"` to 2e-5. The
    JAX package's splash path does not: it pads the keys with zeros (logit
    0) and divides their mass out again, out / (1 - n_pad·e^{-lse})
    (tdm_tpu/ops/attention.py:225-229), and where the pad mass dwarfs the
    real mass that correction cancels away (ADVICE.md:3) — its output
    collapses towards 0, far from the reference."""
    rng = np.random.default_rng(21)
    d, sk = 64, 72
    u = rng.standard_normal(d).astype(np.float32)
    u /= np.linalg.norm(u)
    k = (u + 0.05 * rng.standard_normal((1, 2, sk, d))).astype(np.float32)
    q = np.broadcast_to(-70.0 * np.sqrt(d) * u, (1, 2, 40, d)).astype(np.float32).copy()
    v = rng.standard_normal((1, 2, sk, d)).astype(np.float32)
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
    assert logits.max() < -50
    ref = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="xla"))
    got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)), impl="splash").numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    jax_splash = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       impl="splash", interpret=True))
    assert np.abs(jax_splash - ref).max() > 0.1 * np.abs(ref).max()


@pytest.fixture
def routes(monkeypatch):
    """Record which wrapper each attention call reaches."""
    seen = []
    for name in ("splash_attention_fwd", "flash_attention_fwd"):
        wrapper = getattr(tattn, name)

        def rec(*args, _w=wrapper, _n=name):
            seen.append(_n)
            return _w(*args)

        monkeypatch.setattr(tattn, name, rec)
    monkeypatch.setattr(tattn.FlashAttention, "apply",
                        lambda *a, _f=tattn.FlashAttention.apply: seen.append("FlashAttention")
                        or _f(*a))
    return seen


@pytest.mark.parametrize("case,route", [
    ("unmasked_d64", "splash_attention_fwd"),
    ("unmasked_d128", "splash_attention_fwd"),
    ("masked", "flash_attention_fwd"),
    ("d72", "flash_attention_fwd"),
    ("grad", "FlashAttention"),
])
def test_splash_route_follows_the_jax_rules(routes, case, route):
    """splash takes the splash kernel only for an unmasked call at head dim
    64 or 128 that autograd does not record; otherwise the flash route, as
    the JAX package falls back to its flash kernel (attention.py:98-105) and
    its splash VJP recomputes through the flash kernels (:237-254). The
    result is the same function either way."""
    d = {"d72": 72, "unmasked_d128": 128}.get(case, 64)
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 2, 2, 20, 13, d))
    mask = None
    if case == "masked":
        mask = torch.tensor([[1] * 13, [1] * 5 + [0] * 8], dtype=torch.int32)
    if case == "grad":
        q.requires_grad_(True)
    out = tattn.attention(q, k, v, mask, impl="splash")
    assert routes == [route]
    ref = tattn.attention(q.detach(), k, v, mask, impl="plain")
    torch.testing.assert_close(out.detach(), ref, rtol=2e-5, atol=2e-5)
    if case == "grad":
        out.sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()
    with torch.no_grad():  # without autograd the same call takes the kernel
        routes.clear()
        tattn.attention(q, k, v, mask, impl="splash")
        assert routes == [route if case != "grad" else "splash_attention_fwd"]
