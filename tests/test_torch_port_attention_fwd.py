"""The attention forwards' wrappers around the Hopper kernels (kernel 1,
`csrc/flash_fwd.cu`, and kernel 4, `csrc/splash_fwd.cu`, both on the
wgmma/TMA mainloop of `csrc/attn_fwd_sm90.cuh`), and the kernels against
their plain versions on the card.

TMA moves rows of a multiple of 16 bytes, so the bf16 flash wrapper
zero-pads the head dim to a multiple of 8 before the launch and slices the
output back. On the CPU the wrappers take the plain versions, so the tests
here hold the padding itself against the unpadded plain function (it must
be exact: zero columns add nothing to the logits and give zero output
columns), and check what the wrapper hands the kernel. This file imports no
JAX, so on the card's machine its card tests run with
`python -m pytest --noconftest tests/test_torch_port_attention_fwd.py -m cuda`.
"""

import math

import numpy as np
import pytest
import torch

from tdm_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

HEAD_DIMS = (8, 16, 36, 40, 64, 72, 100, 128, 136, 160)
LENGTHS = (77, 30, 0)  # ragged, and a batch row whose keys are all masked


def _inputs(d, dtype, b=3, h=2, sq=45, sk=77, lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
               for s in (sq, sk, sk))
    q = q / math.sqrt(d)
    mask = torch.arange(sk)[None] < torch.tensor(lengths)[:, None]
    return q.to(dtype), k.to(dtype), v.to(dtype), tattn.key_bias(mask)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_head_dim_padding_is_exact(d, dtype):
    """plain_attention_lse on the padded operands, sliced back, is the
    function of the unpadded ones: to fp64 roundoff in fp64; in bf16 the
    output within one bf16 rounding (the fp32 sums may run in another
    order) and the lse to fp32 roundoff; all-masked rows 0 and +1e30."""
    q, k, v, bias = _inputs(d, dtype)
    dp = tattn.tma_head_dim(d)
    assert dp % 8 == 0 and d <= dp < d + 8
    padded = [tattn.pad_head_dim(t, dp) for t in (q, k, v)]
    for t, p in zip((q, k, v), padded):
        assert p.shape[-1] == dp and p.is_contiguous() and p.data_ptr() % 16 == 0
        assert torch.equal(p[..., :d], t) and not p[..., d:].any()
    out, lse = tattn.plain_attention_lse(*padded, bias)
    ref_out, ref_lse = tattn.plain_attention_lse(q, k, v, bias)
    assert not out[..., d:].any()
    out = out[..., :d]
    if dtype == torch.float64:
        torch.testing.assert_close(out, ref_out, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-12, atol=1e-12)
    else:
        # fp32 sums over zero-padded columns: at most one bf16 rounding apart
        diff = (out.float() - ref_out.float()).abs()
        assert diff.max() <= 2.0 ** -8 * ref_out.float().abs().max()
        torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=1e-6)
    assert not out[2].any() and bool((lse[2] == 1e30).all())


def test_pad_head_dim_keeps_an_aligned_tensor_and_copies_a_misaligned_one():
    t = torch.randn(2, 3, 5, 64)
    assert tattn.pad_head_dim(t, 64) is t
    view = torch.randn(2 * 3 * 5 * 64 + 1)[1:].view(2, 3, 5, 64)  # 4-byte offset
    assert view.data_ptr() % 16 != 0
    copy = tattn.pad_head_dim(view, 64)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_wrapper_hands_the_kernel_padded_operands(monkeypatch, d, with_lse):
    """What the bf16 wrapper passes to `tdm_flash_fwd`: a head dim that is a
    multiple of 8, 16-byte aligned pointers, and an output it slices back
    to [B, H, Sq, D]; fp32 passes D as it is (its scalar kernel takes any
    D). The launch is recorded instead of made."""
    calls = []
    counts = tattn.launch_counts()
    monkeypatch.setattr(tattn, "_on_card", lambda wrapper, q: True)
    monkeypatch.setattr(tattn, "_launch", lambda name, device, *args: calls.append(args))
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias = _inputs(d, dtype)
        fn = tattn.flash_attention_fwd_lse if with_lse else tattn.flash_attention_fwd
        got = fn(q, k, v, bias)
        out, lse = got if with_lse else (got, None)
        assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
        assert (lse is not None) == with_lse
        args = calls.pop()
        b, h, sq, sk, dk, code = args[6:]
        assert (b, h, sq, sk, code) == (3, 2, 45, 77, tattn._DTYPE_CODE[dtype])
        assert dk == (tattn.tma_head_dim(d) if dtype == torch.bfloat16 else d)
        if dtype == torch.bfloat16:
            assert all(p % 16 == 0 for p in (args[0], args[1], args[2], args[4]))
        assert (args[5] is not None) == with_lse
    for w in tattn.WRAPPERS:  # recorded launches do not count
        w.launches = counts[w.__name__]


def test_head_dim_limits_name_the_known_gaps(monkeypatch):
    """Kernel 1 and the backward kernels take head dims up to 160 (SD1.5's
    1280-wide blocks at 8 heads); above, the wrappers raise before any
    launch, naming the gap still to port in ROADMAP.md §2."""
    monkeypatch.setattr(tattn, "_on_card", lambda wrapper, q: True)
    monkeypatch.setattr(tattn, "_launch", lambda name, device, *args: None)
    counts = tattn.launch_counts()
    assert tattn.tma_head_dim(160) == 160 and tattn.tma_head_dim(131) == 136
    for d in (0, 161, 168):
        with pytest.raises(ValueError, match="still to port"):
            tattn.tma_head_dim(d)
    q, k, v, bias = _inputs(168, torch.bfloat16)
    lse = torch.zeros(q.shape[:3])
    for fwd in (tattn.flash_attention_fwd, tattn.flash_attention_fwd_lse):
        with pytest.raises(ValueError, match=r"range \[1, 160\].*still to port"):
            fwd(q, k, v, bias)
    with pytest.raises(ValueError, match=r"range \[1, 160\].*still to port"):
        tattn.flash_attention_bwd_dq(q, k, v, bias, q, q, lse, 1.0)
    with pytest.raises(ValueError, match=r"range \[1, 160\].*still to port"):
        tattn.flash_attention_bwd_dkv(q, k, v, bias, q, lse, lse)
    q, k, v, bias = _inputs(136, torch.bfloat16)
    lse = torch.zeros(q.shape[:3])
    tattn.flash_attention_fwd(q, k, v, bias)
    dq, delta = tattn.flash_attention_bwd_dq(q, k, v, bias, q, q, lse, 1.0)
    dk, dv = tattn.flash_attention_bwd_dkv(q, k, v, bias, q, lse, delta)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    for w in tattn.WRAPPERS:
        w.launches = counts[w.__name__]


def test_forward_wrappers_check_the_pair_count():
    """The bf16 forwards put (batch, head) pairs on the grid's y axis: more
    than 65535 raise before any launch, for kernel 1 and kernel 4."""
    tattn._check_pairs(1, 65535, "flash")
    with pytest.raises(ValueError, match="at most 65535 \\(batch, head\\) pairs, got 65536"):
        tattn._check_pairs(2, 32768, "flash")
    q = torch.zeros(1, 65536, 1, 64)
    with pytest.raises(ValueError, match="splash kernel takes at most 65535"):
        tattn._check_splash(q, q, q)


# --- on the card -------------------------------------------------------------


def _per_row_bf16(out, ref):
    """bf16, per batch row: relative L2 under 1e-2 and max error under 4
    bf16 ulps of the row's largest |plain|; an all-masked row exactly 0."""
    for o, r in zip(out.float(), ref.float()):
        top = r.abs().max().item()
        if top == 0:
            assert not o.any()
            continue
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        assert (o - r).norm() <= 1e-2 * r.norm()
        assert (o - r).abs().max().item() <= 4 * ulp


def _lse_close(lse, ref):
    """The kernel's lse: +1e30 exactly on all-masked rows, else within 1e-4
    (fp32 logsumexp of the same logits, exp2 and another order of sums)."""
    masked = ref >= 1e29
    assert torch.equal(lse[masked], ref[masked])
    if (~masked).any():
        assert (lse[~masked] - ref[~masked]).abs().max() <= 1e-4


@pytest.mark.cuda
def test_forward_kernels_match_plain_at_ragged_shapes_on_card():
    """Kernel 1 with and without its lse, and kernel 4, against their plain
    versions on ragged shapes: Sq and Sk not multiples of the kernels'
    tiles, PixArt's cross shape with key lengths [120, 77, 13, 0], every
    head dim of the sweep (zero-padded to a multiple of 8 by the wrapper),
    and splash rows whose logits all lie at or below -32. bf16 per batch
    row (relative L2 1e-2, 4 ulps), fp32 2e-5, the lse 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(b, h, sq, sk, d, dtype, lengths):
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda") for s in (sq, sk, sk))
        q = (q / math.sqrt(d)).to(dtype)
        bias = None
        if lengths is not None:
            mask = torch.arange(sk, device="cuda")[None] < torch.tensor(
                lengths, device="cuda")[:, None]
            bias = tattn.key_bias(mask)
        return q, k.to(dtype), v.to(dtype), bias

    cases = [(3, 2, 333, 200, 72, [200, 129, 0]), (4, 16, 1024, 120, 72, [120, 77, 13, 0]),
             (2, 3, 257, 129, 64, None)]
    cases += [(2, 2, 130, 70, d, [70, 33]) for d in HEAD_DIMS]
    for b, h, sq, sk, d, lengths in cases:
        q, k, v, bias = draw(b, h, sq, sk, d, torch.bfloat16, lengths)
        before = tattn.launch_counts()
        out = tattn.flash_attention_fwd(q, k, v, bias)
        out_lse, lse = tattn.flash_attention_fwd_lse(q, k, v, bias)
        after = tattn.launch_counts()
        assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
        assert after["flash_attention_fwd_lse"] == before["flash_attention_fwd_lse"] + 1
        ref, ref_lse = tattn.plain_attention_lse(q, k, v, bias)
        assert out.shape == ref.shape and out.is_contiguous()
        _per_row_bf16(out, ref)
        _per_row_bf16(out_lse, ref)
        _lse_close(lse, ref_lse)
    for b, h, sq, sk, d in ((2, 3, 1000, 777, 64), (2, 3, 1000, 777, 128), (1, 2, 5, 3, 64)):
        q, k, v, _ = draw(b, h, sq, sk, d, torch.bfloat16, None)
        _per_row_bf16(tattn.splash_attention_fwd(q, k, v), tattn.plain_splash_attention(q, k, v))
    u = torch.randn(64, generator=gen, device="cuda")
    u = u / u.norm()
    k = u + 0.05 * torch.randn(2, 2, 300, 64, generator=gen, device="cuda")
    q = (-50.0 * u).expand(2, 2, 70, 64).contiguous()
    v = torch.randn(2, 2, 300, 64, generator=gen, device="cuda")
    assert (q @ k.transpose(2, 3)).max() <= -32
    torch.testing.assert_close(tattn.splash_attention_fwd(q, k, v),
                               tattn.plain_splash_attention(q, k, v), rtol=2e-5, atol=2e-5)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    _per_row_bf16(tattn.splash_attention_fwd(qb, kb, vb), tattn.plain_splash_attention(qb, kb, vb))


@pytest.mark.cuda
def test_kernel_lse_drives_the_backward_kernels_to_the_plain_gradients_on_card():
    """dQ and dK/dV fed the forward kernel's own lse (and the dQ kernel's Δ)
    against the plain backward fed the plain lse (both Δ from the plain
    output), in bf16 at a ragged shape
    with an all-masked batch row, by the per-row bf16 rule; then the whole
    FlashAttention route on the card: one launch of each training kernel,
    finite gradients, exactly 0 on the all-masked row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, sq, sk, d = 3, 2, 333, 200, 72
    scale = 1.0 / math.sqrt(d)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
               for s in (sq, sk, sk))
    g = torch.randn(b, h, sq, d, generator=gen, device="cuda").bfloat16()
    mask = (torch.arange(sk, device="cuda")[None]
            < torch.tensor([200, 129, 0], device="cuda")[:, None])
    bias = tattn.key_bias(mask)
    qs = (q.float() * scale).bfloat16()
    _, lse = tattn.flash_attention_fwd_lse(qs, k, v, bias)
    ref_out, ref_lse = tattn.plain_attention_lse(qs, k, v, bias)
    dq, delta = tattn.flash_attention_bwd_dq(qs, k, v, bias, g, ref_out, lse, scale)
    ref_dq, ref_delta = tattn.plain_attention_bwd_dq(qs, k, v, bias, g, ref_out, ref_lse, scale)
    got = (dq, *tattn.flash_attention_bwd_dkv(qs, k, v, bias, g, lse, delta))
    ref = (ref_dq, *tattn.plain_attention_bwd_dkv(qs, k, v, bias, g, ref_lse, ref_delta))
    for o, r in zip(got, ref):
        assert torch.isfinite(o).all()
        _per_row_bf16(o, r)

    before = tattn.launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tattn.attention(*leaves, mask)
    grads = (out, *torch.autograd.grad(out, leaves, g))
    after = tattn.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_attention_fwd": 0, "flash_attention_fwd_lse": 1,
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
        "splash_attention_fwd": 0}
    for t in grads:
        assert torch.isfinite(t).all() and not t[2].any()


@pytest.mark.cuda
def test_flash_kernel_matches_plain_at_sd15_head_dims_on_card():
    """Kernel 1 at SD1.5's head dims 40 (the 64-column panel, zero-filled
    past column 40), 160 (three panels of 64, 64 and 32 columns) and 136
    (the same, zero-filled past 136): ragged Sq and Sk, a ragged key mask
    and an all-masked batch row, against the plain version. bf16 by the
    per-row rule, fp32 within 1e-5 (the same sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for d in (40, 136, 160):
        for b, h, sq, sk, lengths in ((3, 2, 333, 200, (200, 129, 0)), (2, 8, 256, 77, None)):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, bias = (t.cuda() for t in _inputs(
                    d, dtype, b=b, h=h, sq=sq, sk=sk, lengths=lengths or (sk,) * b, seed=d))
                bias = None if lengths is None else bias
                out = tattn.flash_attention_fwd(q, k, v, bias)
                ref = tattn.plain_attention(q, k, v, bias)
                assert out.shape == ref.shape and torch.isfinite(out).all()
                if dtype == torch.bfloat16:
                    _per_row_bf16(out, ref)
                else:
                    assert (out - ref).abs().max() <= 1e-5, (d, b, dtype)


def kernel_bits() -> dict:
    """{case: sha256 of the output bytes} of kernel 1 (without and with the
    lse) at head dims 64, 80 and 128 with a ragged key mask, and of kernel 4
    at 64 and 128, on bf16 inputs drawn with numpy from a fixed seed."""
    import hashlib

    out = {}
    for d in (64, 80, 128):
        q, k, v, bias = (t.cuda() for t in _inputs(d, torch.bfloat16, b=2, h=3, sq=200, sk=150,
                                                   lengths=(150, 77), seed=d))
        o = tattn.flash_attention_fwd(q, k, v, bias)
        o_lse, lse = tattn.flash_attention_fwd_lse(q, k, v, bias)
        for name, t in ((f"flash_d{d}", o), (f"flash_lse_d{d}", o_lse),
                        (f"flash_lse_d{d}_lse", lse)):
            out[name] = hashlib.sha256(t.cpu().view(torch.int16 if t.dtype == torch.bfloat16
                                                    else torch.int32).numpy().tobytes()).hexdigest()
    for d in (64, 128):
        q, k, v, _ = (t.cuda() for t in _inputs(d, torch.bfloat16, b=2, h=3, sq=200, sk=150,
                                                lengths=(150, 150), seed=d))
        o = tattn.splash_attention_fwd(q, k, v)
        out[f"splash_d{d}"] = hashlib.sha256(o.cpu().view(torch.int16).numpy().tobytes()).hexdigest()
    return out


# kernel_bits() as the kernels of the parent commit gave it on an NVIDIA H100
# 80GB HBM3, before their mainloop took a third head-dim panel and a 64-key
# tile for DP = 160: the instantiations at 64, 80 and 128 keep their code
# and must keep their bits
KERNEL_BITS = {
    "flash_d64": "892998e922feb4f70312a490ec86211bebe8c304937332d6f02cd42a98065098",
    "flash_lse_d64": "892998e922feb4f70312a490ec86211bebe8c304937332d6f02cd42a98065098",
    "flash_lse_d64_lse": "31b7325099193c6cecf14896e574d9e4c13788b2fb301f97a8ece73e3887e892",
    "flash_d80": "17ff4c7495f3f12dcf7cf0a2e5a7759deebf4bba73b70c6e419a8b4ad777b9b1",
    "flash_lse_d80": "17ff4c7495f3f12dcf7cf0a2e5a7759deebf4bba73b70c6e419a8b4ad777b9b1",
    "flash_lse_d80_lse": "ab38a4d736b0148d58364142fed4f45aed8c2f18554ee9df450c8c77f56ff5d0",
    "flash_d128": "52116e02544e2d80ea3e2975e9609bf170327882bd35bf3014ce01f929b7f0f1",
    "flash_lse_d128": "52116e02544e2d80ea3e2975e9609bf170327882bd35bf3014ce01f929b7f0f1",
    "flash_lse_d128_lse": "e91cd7760d0d4391d34046659ced3cd41324a6b112ef91d2b3150362e2accf5b",
    "splash_d64": "ac4bf1aac1377ad13682586a13241cb75549bc35fb94dd14b796244992c8e919",
    "splash_d128": "b6192ea1bf6b58af8746653daafd8626a603affb1cbf2eb71270438c2b795838",
}


@pytest.mark.cuda
def test_flash_and_splash_bits_unchanged_at_64_80_128_on_card():
    """The third head-dim panel and DP 160's 64-key tiles are compile-time
    branches: kernel 1 at DP 64, 80 and 128 (with and without its lse) and
    kernel 4 give the parent commit's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    assert kernel_bits() == KERNEL_BITS
