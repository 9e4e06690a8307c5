"""CogVideoX training on the card: the training kernels at CogVideoX-2B's
joint attention length against their plain versions, and one tiny
cogvideox TDM step on the card against the same step on the CPU. Both need
a CUDA device and skip without one. This file imports no JAX, so it runs on
the card's machine with `python -m pytest --noconftest
tests/test_torch_port_cogvideox_train_card.py -m cuda`; the cogvideox
step's parity with the JAX package is held on the CPU by
tests/test_torch_port_cogvideox_train.py."""

import math

import pytest
import torch

from tdm_tpu_torch.ops import attention as tattn
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm

torch.set_num_threads(2)

# CogVideoX-2B at 49 frames, 480×720: 226 T5 tokens + 13·30·45 video tokens
COG_S = 226 + 13 * 30 * 45


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _rows_close(got, ref, name):
    """bf16, per batch row: relative L2 under 1e-2 and max error under 4
    bf16 ulps of the row's largest |plain| (both round P and dS to bf16 and
    the result to bf16)."""
    for o, r in zip(got.float(), ref.float()):
        assert torch.isfinite(o).all(), name
        top = r.abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        assert (o - r).norm() <= 1e-2 * r.norm(), name
        assert (o - r).abs().max().item() <= 4 * ulp, name


@pytest.mark.cuda
def test_training_kernels_at_cogvideox_length_match_plain_on_card():
    """[1, 2, 17776, 17776, 64] bf16 with no key mask, CogVideoX-2B's joint
    attention length at 2 of its 30 heads: 17,776 = 138·128 + 112, so every
    kernel walks a ragged tail of query and key tiles. The forward without
    and with its lse, dQ with its fused Δ and dK/dV, each against its plain
    version on the same inputs, and the backward driven by the forward
    kernel's own output and lse as in training. Tolerances as
    tests/test_torch_port_sd3_train_card.py: per batch row, relative L2
    under 1e-2 and at most 4 bf16 ulps of the row's largest |plain|; lse to
    1e-4, Δ to 1e-5 of the largest |Δ| (fp32 sums in another order)."""
    _need_card()
    assert COG_S == 17776 and COG_S % 128 == 112
    gen = torch.Generator(device="cuda").manual_seed(17)
    b, h, s, d = 1, 2, COG_S, 64
    q, k, v, dout = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
                     for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    qs = (q.float() * scale).bfloat16()
    out, lse = tattn.plain_attention_lse(qs, k, v, None)
    dq, delta = tattn.plain_attention_bwd_dq(qs, k, v, None, dout, out, lse, scale)
    dk, dv = tattn.plain_attention_bwd_dkv(qs, k, v, None, dout, lse, delta)
    before = tattn.launch_counts()
    got_out = tattn.flash_attention_fwd(qs, k, v, None)
    got_out_lse, got_lse = tattn.flash_attention_fwd_lse(qs, k, v, None)
    got_dq, got_delta = tattn.flash_attention_bwd_dq(qs, k, v, None, dout, got_out_lse,
                                                     got_lse, scale)
    got_dk, got_dv = tattn.flash_attention_bwd_dkv(qs, k, v, None, dout, got_lse, got_delta)
    torch.cuda.synchronize()
    after = tattn.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_attention_fwd": 1, "flash_attention_fwd_lse": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1, "splash_attention_fwd": 0}
    assert (got_lse - lse).abs().max().item() <= 1e-4
    own_delta = tattn.attention_delta(dout, got_out_lse)  # Δ of the kernel's own output
    assert (got_delta - own_delta).abs().max() <= 1e-5 * own_delta.abs().max()
    for name, got, ref in (("out", got_out, out), ("out lse", got_out_lse, out),
                           ("dq", got_dq, dq), ("dk", got_dk, dk), ("dv", got_dv, dv)):
        _rows_close(got, ref, name)
        # the ragged tail's rows are held on their own as well
        _rows_close(got[:, :, 138 * 128:], ref[:, :, 138 * 128:], f"{name} tail")


@pytest.mark.cuda
def test_tiny_cogvideox_step_on_card_matches_cpu():
    """One tiny cogvideox TDM step (fp32, dmd, MSE, v-prediction at zero
    terminal SNR, video latents [3, 16, 3, 8, 8], T5 rows zeroed past their
    masks) on the card (the kernels: 14 forwards without lse, 4 with, 4 dQ
    and 4 dK/dV) against the CPU (the plain versions) from one state with
    the same draws on the 1000-step grid (its first index the terminal
    one): losses and grad norms to 1e-4 relative, each role's update to
    5e-3 relative L2 and each weight to 25% of lr, as the sd3 card step."""
    _need_card()
    lr = 1e-4
    runs, cpu_params = {}, None
    for dev in ("cpu", "cuda"):
        bundle = tfamilies.build("cogvideox", tiny=True, seed=0, device=dev)
        if cpu_params is None:
            cpu_params = bundle.init_params()
        teacher = {k: v.to(dev) for k, v in cpu_params.items()}
        gen = torch.Generator().manual_seed(6)
        config = ttdm.TDMConfig(total_steps=1000, use_huber=False)
        draws = ttdm.StepDraws(*(x.to(dev) for x in ttdm.make_draws(
            config, 3, bundle.sample_shape, gen, "cpu")))
        text = torch.randn(3, bundle.seq_len, bundle.embed_dim, generator=gen).to(dev)
        mask = (torch.arange(bundle.seq_len)[None] < torch.tensor([[8], [3], [1]])).int().to(dev)
        cond = bundle.cond_of(text, mask)
        uncond = bundle.cond_of(torch.zeros_like(text), torch.ones_like(mask))
        tx = topt.make_optimizer(lr, eps=1e-4)
        state = ttdm.init_state(teacher, teacher, tx, tx)
        start = {r: {k: v.clone().cpu() for k, v in getattr(state, r).items()}
                 for r in ("student", "critic")}
        step = ttdm.build_train_step(bundle.denoise_fn, teacher, bundle.schedule, config,
                                     tx, tx, sample_shape=bundle.sample_shape)
        before = tattn.launch_counts()
        state, metrics = step(state, draws, cond, uncond)
        after = tattn.launch_counts()
        runs[dev] = (state, metrics, start, {n: after[n] - before[n] for n in after})
    (cs, cm, start, _), (gs, gm, _, launched) = runs["cpu"], runs["cuda"]
    assert launched == {"flash_attention_fwd": 14, "flash_attention_fwd_lse": 4,
                        "flash_attention_bwd_dq": 4, "flash_attention_bwd_dkv": 4,
                        "splash_attention_fwd": 0}
    for name in ttdm.StepMetrics._fields:
        c, g = float(getattr(cm, name)), float(getattr(gm, name))
        assert math.isfinite(g) and abs(c - g) <= 1e-4 * abs(c) + 1e-7, name
    for role in ("student", "critic"):
        d_c = torch.cat([(getattr(cs, role)[k] - start[role][k]).flatten() for k in start[role]])
        d_g = torch.cat([(getattr(gs, role)[k].cpu() - start[role][k]).flatten()
                         for k in start[role]])
        assert float(d_c.abs().max()) > 0.5 * lr, role
        assert float((d_g - d_c).norm()) <= 5e-3 * float(d_c.norm()), role
        assert float((d_g - d_c).abs().max()) <= 0.25 * lr, role
