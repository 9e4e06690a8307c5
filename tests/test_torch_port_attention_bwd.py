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

import ctypes
import math
import threading

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


@pytest.mark.parametrize("b,h,sq,sk,d,lengths", [
    (B, H, SQ, SK, D, LENGTHS),  # multiblock, ragged, an all-masked batch row
    (2, 3, 130, 70, 72, (70, 33)),  # PixArt's head dim
])
def test_plain_dq_and_delta_match_bwd_core_interpret(b, h, sq, sk, d, lengths):
    """The dQ kernel's plain version returns (dQ, Δ): dQ against the JAX
    package's `_bwd_core` in interpret mode (the Pallas dQ kernel), Δ
    against its `:718-724` sum, and the dK/dV plain version fed that Δ
    against `_bwd_core`'s dK and dV. Both sides take the JAX forward's
    residuals (pre-scaled q, output, lse); fp32, to 2e-4."""
    import jax.numpy as jnp

    from tdm_tpu.ops.attention import _bwd_core, _flash_fwd_res

    rng = np.random.default_rng(17)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for s in (sq, sk, sk))
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    mask = (np.arange(sk)[None] < np.array(lengths)[:, None]).astype(np.int32)
    bias = np.where(mask.astype(bool), 0.0, -1e30).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    _, (qs, _, _, _, out, lse) = _flash_fwd_res(
        *(jnp.asarray(x) for x in (q, k, v, bias)), scale, 128, 128, True, with_lse=True)
    jdq, jdk, jdv = _bwd_core(qs, jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), out, lse,
                              jnp.asarray(g), scale, 128, 128, True)
    # Δ as `_bwd_core` forms it, before its lane broadcast
    jdelta = jnp.sum(jnp.asarray(g).astype(jnp.float32) * out.astype(jnp.float32), axis=-1)

    t = {name: torch.from_numpy(np.array(x)) for name, x in
         (("qs", qs), ("k", k), ("v", v), ("g", g), ("out", out), ("lse", np.asarray(lse)[..., 0]))}
    tbias = torch.from_numpy(bias)
    dq, delta = tattn.plain_attention_bwd_dq(
        t["qs"], t["k"], t["v"], tbias, t["g"], t["out"], t["lse"], scale)
    dk, dv = tattn.plain_attention_bwd_dkv(t["qs"], t["k"], t["v"], tbias, t["g"], t["lse"], delta)
    assert delta.shape == (b, h, sq) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), atol=2e-4, rtol=2e-4)
    for name, got, ref in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4,
                                   err_msg=name)
    for i, n_live in enumerate(lengths):  # masked keys and all-masked rows: exactly 0
        assert not dk[i, :, n_live:].any() and not dv[i, :, n_live:].any()
        if n_live == 0:
            assert not dq[i].any()


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("d", [136, 160])
def test_backward_matches_jax_grads_at_head_dim_160(d, masked):
    """The port's training attention at SD1.5's D 160 (and 136, which the
    kernels zero-fill to 160) under autograd, and the plain versions of the
    dQ and dK/dV kernels on the JAX forward's residuals, against `jax.grad`
    of the JAX package's attention through its Pallas kernels in interpret
    mode (D padded to 256) and through XLA: fp32, within 1e-5, with a
    ragged key mask and an all-masked batch row."""
    import jax
    import jax.numpy as jnp

    from tdm_tpu.ops.attention import _bwd_core, _flash_fwd_res
    from tdm_tpu.ops.attention import attention as jattention

    rng = np.random.default_rng(d + masked)
    b, h, sq, sk = 3, 2, 70, 45
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for s in (sq, sk, sk))
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    lengths = (45, 17, 0) if masked else (sk,) * b
    mask = (np.arange(sk)[None] < np.array(lengths)[:, None]).astype(np.int32)
    jmask = jnp.asarray(mask) if masked else None

    def loss(impl):
        def f(q_, k_, v_):
            kw = {"interpret": True, "block_q": 64, "block_k": 32} if impl == "pallas" else {}
            out = jattention(q_, k_, v_, jmask, impl=impl, **kw)
            return jnp.sum(out * jnp.asarray(g))
        return f

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tattn.attention(*leaves, torch.from_numpy(mask) if masked else None)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for impl in ("pallas", "xla"):
        ref = jax.grad(loss(impl), argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
        for name, a, r in zip("qkv", got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0, atol=1e-5,
                                       err_msg=f"d{name} against {impl}")

    # the plain versions of kernels 2 and 3 against `_bwd_core` (interpret)
    # on the JAX forward's residuals
    scale = 1.0 / math.sqrt(d)
    bias = np.where(mask.astype(bool), 0.0, -1e30).astype(np.float32)
    _, (qs, _, _, _, jout, jlse) = _flash_fwd_res(
        *(jnp.asarray(x) for x in (q, k, v, bias)), scale, 64, 32, True, with_lse=True)
    jdq, jdk, jdv = _bwd_core(qs, jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), jout,
                              jlse, jnp.asarray(g), scale, 64, 32, True)
    t = [torch.from_numpy(np.array(x)) for x in (qs, k, v, bias, g, jout)]
    lse = torch.from_numpy(np.array(jlse)[..., 0])
    dq, delta = tattn.flash_attention_bwd_dq(*t, lse, scale)  # the CPU takes the plain version
    dk, dv = tattn.flash_attention_bwd_dkv(*t[:5], lse, delta)
    for name, a, r in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0, atol=1e-5, err_msg=name)
    if masked:
        assert not dq[2].any() and not dk[2].any() and not dv[2].any()
        assert not dk[1, :, 17:].any() and not dv[1, :, 17:].any()


def test_backward_wrappers_take_head_dim_160_and_refuse_168(monkeypatch):
    """On a CUDA tensor the backward wrappers hand the kernels D 160 as it
    is and D 136 at 136 (TMA zero-fills it to the 160 panels), and refuse
    D 168 before any launch, naming the gap still to port."""
    monkeypatch.setattr(tattn, "_on_card", lambda wrapper, q: True)
    calls = []
    monkeypatch.setattr(tattn, "_launch", lambda name, device, *args: calls.append((name, args)))
    counts = tattn.launch_counts()
    for d in (136, 160):
        q = torch.zeros(2, 2, 33, d, dtype=torch.bfloat16)
        lse = torch.zeros(2, 2, 33)
        tattn.flash_attention_bwd_dq(q, q, q, None, q, q, lse, 1.0)
        tattn.flash_attention_bwd_dkv(q, q, q, None, q, lse, lse)
        assert [c[0] for c in calls] == ["tdm_flash_bwd_dq", "tdm_flash_bwd_dkv"]
        assert calls[0][1][13] == d and calls[1][1][13] == d
        calls.clear()
    q = torch.zeros(2, 2, 33, 168, dtype=torch.bfloat16)
    lse = torch.zeros(2, 2, 33)
    with pytest.raises(ValueError, match=r"range \[1, 160\].*still to port"):
        tattn.flash_attention_bwd_dq(q, q, q, None, q, q, lse, 1.0)
    with pytest.raises(ValueError, match=r"range \[1, 160\].*still to port"):
        tattn.flash_attention_bwd_dkv(q, q, q, None, q, lse, lse)
    assert not calls
    for w in tattn.WRAPPERS:
        w.launches = counts[w.__name__]


HEAD_DIMS = (8, 16, 36, 64, 72, 100, 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_backward_hands_the_kernels_out_and_one_fused_delta(monkeypatch, d, dtype):
    """What `FlashAttention.backward` hands the backward kernels, with every
    launch recorded instead of made (the recorded forward writes a known O
    into its output buffer): the dQ kernel reads the forward's output O and
    writes a fresh [B,H,Sq] fp32 Δ buffer, the dK/dV kernel reads that same
    buffer, and Δ's plain version `attention_delta` is never called. bf16
    operands reach both kernels zero-padded to a head dim that is a
    multiple of 8 at 16-byte aligned addresses, and the gradients come back
    at the caller's head dim; fp32 passes D as it is."""
    b, h, sq, sk = 3, 2, 45, 77
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32)).to(dtype)
               for s in (sq, sk, sk))
    g = torch.from_numpy(rng.standard_normal((b, h, sq, d)).astype(np.float32)).to(dtype)
    o_written = torch.from_numpy(rng.standard_normal((b, h, sq, d)).astype(np.float32)).to(dtype)
    mask = torch.arange(sk)[None] < torch.tensor([77, 30, 0])[:, None]
    dp = tattn.tma_head_dim(d) if dtype == torch.bfloat16 else d
    item = o_written.element_size()
    calls = {}

    def launch(name, device, *args):
        calls[name] = args
        if name == "tdm_flash_fwd":  # the forward kernel writes O
            src = tattn.pad_head_dim(o_written, dp).contiguous()
            ctypes.memmove(args[4], src.data_ptr(), src.numel() * item)
        elif name == "tdm_flash_bwd_dq":  # what the dQ kernel reads as O
            raw = bytearray(ctypes.string_at(args[5], b * h * sq * dp * item))
            calls["o_read"] = torch.frombuffer(raw, dtype=torch.uint8).view(dtype).view(
                b, h, sq, dp).clone()

    def no_plain_delta(*args):
        raise AssertionError("attention_delta called on the kernel route")

    handed = {}
    dkv_wrapper = tattn.flash_attention_bwd_dkv

    def dkv_recorded(*args):
        handed["delta"] = args[6]
        return dkv_wrapper(*args)

    dkv_recorded.launches = 0  # the wrapper counts through its module name

    counts = tattn.launch_counts()
    monkeypatch.setattr(tattn, "_on_card", lambda wrapper, q: True)
    monkeypatch.setattr(tattn, "_launch", launch)
    monkeypatch.setattr(tattn, "attention_delta", no_plain_delta)
    monkeypatch.setattr(tattn, "flash_attention_bwd_dkv", dkv_recorded)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tattn.attention(*leaves, mask)
    grads = torch.autograd.grad(out, leaves, g)
    for w in tattn.WRAPPERS:  # recorded launches do not count
        w.launches = counts[w.__name__]

    dq_args, dkv_args = calls["tdm_flash_bwd_dq"], calls["tdm_flash_bwd_dkv"]
    code = tattn._DTYPE_CODE[dtype]
    assert dq_args[9:14] == (b, h, sq, sk, dp) and dq_args[15] == code
    assert dkv_args[9:15] == (b, h, sq, sk, dp, code)
    assert torch.equal(calls["o_read"][..., :d], o_written)
    assert not calls["o_read"][..., d:].any()
    delta = handed["delta"]
    assert delta.shape == (b, h, sq) and delta.dtype == torch.float32 and delta.is_contiguous()
    assert dq_args[7] == delta.data_ptr() == dkv_args[6]
    assert delta.data_ptr() not in (dq_args[6], dq_args[5], dq_args[8])  # not lse, O or dQ
    if dtype == torch.bfloat16:
        assert all(p % 16 == 0 for p in (*dq_args[:3], *dq_args[4:6], dq_args[8]))
        assert all(p % 16 == 0 for p in (*dkv_args[:3], dkv_args[4], *dkv_args[7:9]))
    for grad, leaf in zip(grads, leaves):
        assert grad.shape == leaf.shape and grad.dtype == dtype and grad.is_contiguous()


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
        tattn.flash_attention_bwd_dq(x, x, x, None, x, x, row, 1.0)
    with pytest.raises(ValueError, match="no flash kernel for device meta"):
        tattn.flash_attention_bwd_dkv(x, x, x, None, x, row, row)


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card():
    """The dQ kernel (with its fused Δ), the dK/dV kernel and the lse
    forward against their plain versions on the same inputs (lse and O from
    the plain forward, the dK/dV kernel fed the plain Δ; dQ and dK/dV once
    more from the forward kernel's own output and lse, as in training), at
    PixArt's self and cross shapes (bf16), a ragged bf16 shape, an odd fp32
    shape, more than 65535 (batch, head) pairs (bf16 and fp32) and SD1.5's
    head dims 136 and 160 (bf16 and fp32); runs on a machine with the card. bf16, per batch row: relative L2 under 1e-2 and
    max error under 4 bf16 ulps of the row's largest |plain| (both round P
    and dS to bf16 and the result to bf16); fp32: max error under 1e-4 of
    the largest |plain|; Δ within 1e-5 of the largest |Δ| (fp32 sums of the
    same products in another order). A batch row with every key masked is
    exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, h, sq, sk, d, dtype, lengths) in (
        (2, 16, 1024, 1024, 72, torch.bfloat16, None),
        (2, 16, 1024, 120, 72, torch.bfloat16, [90, 0]),
        (3, 2, 333, 200, 72, torch.bfloat16, [200, 129, 0]),
        (2, 3, 1000, 77, 64, torch.float32, [77, 0]),
        (2, 32769, 5, 7, 16, torch.bfloat16, [7, 3]),
        (2, 32769, 5, 7, 16, torch.float32, [7, 3]),
        # SD1.5's head dim 160 (three panels; the dK/dV kernel's dV and dK
        # passes, one and two warpgroups) and 136 (zero-filled to 160)
        (4, 8, 256, 256, 160, torch.bfloat16, None),
        (4, 8, 256, 77, 160, torch.bfloat16, [77, 40, 13, 0]),
        (3, 2, 333, 200, 136, torch.bfloat16, [200, 129, 0]),
        (3, 2, 333, 200, 160, torch.float32, [200, 129, 0]),
        (2, 3, 100, 77, 136, torch.float32, [77, 0]),
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
        ref = {"out": out}
        ref["dq"], ref_delta = tattn.plain_attention_bwd_dq(q, k, v, bias, dout, out, lse, 0.3)
        ref["dk"], ref["dv"] = tattn.plain_attention_bwd_dkv(q, k, v, bias, dout, lse, ref_delta)
        before = tattn.launch_counts()
        got = {}
        got["dq"], delta = tattn.flash_attention_bwd_dq(q, k, v, bias, dout, out, lse, 0.3)
        got["dk"], got["dv"] = tattn.flash_attention_bwd_dkv(q, k, v, bias, dout, lse, ref_delta)
        pairs = b * h <= 65535  # the forward kernel's cap
        if pairs:
            # dQ and dK/dV driven by the forward kernel's own output and lse
            got["out"], own_lse = tattn.flash_attention_fwd_lse(q, k, v, bias)
            got["dq_own"], own_delta = tattn.flash_attention_bwd_dq(
                q, k, v, bias, dout, got["out"], own_lse, 0.3)
            got["dk_own"], got["dv_own"] = tattn.flash_attention_bwd_dkv(
                q, k, v, bias, dout, own_lse, own_delta)
            ref.update({f"{n}_own": ref[n] for n in ("dq", "dk", "dv")})
        after = tattn.launch_counts()
        assert {n: after[n] - before[n] for n in after} == {
            "flash_attention_fwd": 0, "flash_attention_fwd_lse": int(pairs),
            "flash_attention_bwd_dq": 1 + pairs, "flash_attention_bwd_dkv": 1 + pairs,
            "splash_attention_fwd": 0}
        assert delta.shape == (b, h, sq) and delta.dtype == torch.float32
        assert (delta - ref_delta).abs().max() <= 1e-5 * ref_delta.abs().max()
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


@pytest.mark.cuda
def test_kernels_launch_from_a_thread_that_never_selected_a_device():
    """Autograd runs the backward on a worker thread that has no CUDA
    context of its own until something binds one. Every bf16 kernel (the
    forward with and without its lse, dQ, dK/dV, splash) launched from a
    fresh thread, whose first CUDA call is the kernel's, gives the same bits
    as the same launch from the main thread (no kernel uses atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, sq, sk, d = 3, 2, 333, 200, 72
    q, k, v, g = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
                  for s in (sq, sk, sk, sq))
    q64, k64, v64 = (torch.randn(2, 3, 257, 64, generator=gen, device="cuda").bfloat16()
                     for _ in range(3))
    mask = torch.arange(sk, device="cuda")[None] < torch.tensor(
        [200, 129, 0], device="cuda")[:, None]
    bias = tattn.key_bias(mask)

    def run():
        out, lse = tattn.flash_attention_fwd_lse(q, k, v, bias)
        dq, delta = tattn.flash_attention_bwd_dq(q, k, v, bias, g, out, lse, 0.3)
        dk, dv = tattn.flash_attention_bwd_dkv(q, k, v, bias, g, lse, delta)
        return (out, lse, tattn.flash_attention_fwd(q, k, v, bias), dq, delta, dk, dv,
                tattn.splash_attention_fwd(q64, k64, v64))

    counts = tattn.launch_counts()
    on_main = run()
    torch.cuda.synchronize()
    result = {}

    def worker():
        try:
            result["got"] = run()
            torch.cuda.synchronize()
        except Exception as e:  # reported by the assertion below
            result["error"] = e

    thread = threading.Thread(target=worker)
    thread.start()
    thread.join(timeout=120)
    for w in tattn.WRAPPERS:  # a check, not a path
        w.launches = counts[w.__name__]
    assert not thread.is_alive() and "error" not in result, result.get("error")
    for a, b_ in zip(on_main, result["got"]):
        assert torch.equal(a, b_)


def bwd_kernel_bits() -> dict:
    """{case: sha256 of the output bytes} of the dQ kernel (dQ and Δ) and the
    dK/dV kernel at head dims 64, 80 and 128 with a ragged key mask, once
    with few (batch, head) pairs (one dK/dV warpgroup) and once with many
    (two), on bf16 inputs drawn with numpy from a fixed seed."""
    import hashlib

    def digest(t):
        view = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        return hashlib.sha256(t.cpu().view(view).numpy().tobytes()).hexdigest()

    out = {}
    for d in (64, 80, 128):
        for b, h in ((2, 3), (2, 40)):
            rng = np.random.default_rng(d + h)
            q, k, v, g = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
                np.float32)).to("cuda", torch.bfloat16) for s in (200, 150, 150, 200))
            mask = torch.arange(150, device="cuda")[None] < torch.tensor([150, 77],
                                                                         device="cuda")[:, None]
            bias = tattn.key_bias(mask)
            o, lse = tattn.plain_attention_lse(q, k, v, bias)
            dq, delta = tattn.flash_attention_bwd_dq(q, k, v, bias, g, o, lse, 0.3)
            dk, dv = tattn.flash_attention_bwd_dkv(q, k, v, bias, g, lse, delta)
            for name, t in (("dq", dq), ("delta", delta), ("dk", dk), ("dv", dv)):
                out[f"{name}_d{d}_h{h}"] = digest(t)
    return out


# bwd_kernel_bits() as the kernels of the parent commit gave it on an NVIDIA
# H100 80GB HBM3, before the backward kernels took a third head-dim panel
# for DP = 160: the instantiations at 64, 80 and 128 keep their arithmetic
# and must keep their bits
BWD_KERNEL_BITS = {
    "dq_d64_h3": "1eb2aae7696b04446493212ee9ca27f1e726757f84615240cc125d4dc853d784",
    "delta_d64_h3": "deea47f89d853e4294b89d9df7cde6b259e16415c18effbf41d577835dcd653c",
    "dk_d64_h3": "e8c647eb02dc59093de380040b48d91e89751f36746eb644dd6af9865296973a",
    "dv_d64_h3": "392801173690a354c16c102fa6b4a572506dd757cdf3d2d9d045ce3fbae07b74",
    "dq_d64_h40": "ba69b1bf06369ecdbc002991eec00f5b787aba477ed9e16bf29540e1a79e62aa",
    "delta_d64_h40": "b377e4da4107b7ea427e491e889db3cd6c7caeabba9c4703814aed2fb2b7b1d4",
    "dk_d64_h40": "61d07ed17250edb6fdf501c55551a7af4c88fc6bbcc9b9029ac779acfb11b2a0",
    "dv_d64_h40": "19ac8fab70d0e053f2a86e105b82597f5c91a03adfe27c6587f9ef7d8861739e",
    "dq_d80_h3": "115444031ab68fb58d4e6b48c7f006b202987a1cf51bfe44ee79d7676794697d",
    "delta_d80_h3": "899ceb8a8ddf35d3704ac588f7c3b697a4e972e8a2caf53698f83983a66837b1",
    "dk_d80_h3": "bc60e573a7df8285aef53bceead377475186bf8b2a6159a1cbe57d0e262f166e",
    "dv_d80_h3": "d1894428c9a9e26bf9bff792ba4180f570557e0024504938a07d7250fe662257",
    "dq_d80_h40": "c28c71c89c1ab0bdc37d810bb3c0cfc31a5404d23b0c517a0c151dcff0861eca",
    "delta_d80_h40": "0c3ee26312014ef5ab068c0c870d161a0d74d1988122fa9290d080ddaceb8e6a",
    "dk_d80_h40": "592bf2f52d8876da3b9f651f84ee3bb37f07b08deb1d89a9c06ceefee9c72d77",
    "dv_d80_h40": "6189aae3c3456f93f431b2d77e49226f1fc7d17bd714c0a0acd07fb4153fab1d",
    "dq_d128_h3": "bd345a37b0ca45cf1b48d420fcfe2c626f1a5883b71a0b3abe3a7966b4ec1e64",
    "delta_d128_h3": "50f72141be7f4995a6e0c02764c9efe9dee9311b10baa342d6f3bfe8d8696aa9",
    "dk_d128_h3": "482ab43cccb7a6e9620c672c83d5e92e277a8526e061a168413a8e3276689063",
    "dv_d128_h3": "d9a4fea2344555b95bf28ace57d014960b5f8165d2d0adeb0b7653435065dd9b",
    "dq_d128_h40": "0c0e3f16d75d952ceca27b6fd26ebdddb3255061cd6a48518875524fcc79033f",
    "delta_d128_h40": "f9a915ca83c78daf891276c7424ac9658a6dce83800a865624913c7545e4ba17",
    "dk_d128_h40": "9b0c6c5ad0cb7ad9c43a532355ca7a5bf0f6ceb7f6ff2bc69417970237c3e9e9",
    "dv_d128_h40": "4ebae0159dd5a2e1a1b9a12842280416701f0464d850213cc89feef77b72e274",
}


@pytest.mark.cuda
def test_backward_bits_unchanged_at_64_80_128_on_card():
    """The third head-dim panel and the dV/dK passes of DP 160 are
    compile-time branches: dQ, Δ, dK and dV at DP 64, 80 and 128 (one and
    two dK/dV warpgroups) give the parent commit's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    assert bwd_kernel_bits() == BWD_KERNEL_BITS
