"""SD3 training on the card: the training kernels at SD3-Medium's training
shapes against their plain versions, and one tiny sd3 TDM step on the card
against the same step on the CPU. Both need a CUDA device and skip without
one. This file imports no JAX, so it runs on the card's machine with
`python -m pytest --noconftest tests/test_torch_port_sd3_train_card.py -m cuda`;
the sd3 step's parity with the JAX package is held on the CPU by
tests/test_torch_port_sd3_train.py."""

import math

import pytest
import torch

from tdm_tpu_torch.ops import attention as tattn
from tdm_tpu_torch.train import families as tfamilies, optim as topt, tdm as ttdm

torch.set_num_threads(2)


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
@pytest.mark.parametrize("b", [4, 8])
def test_training_kernels_at_sd3_shapes_match_plain_on_card(b):
    """SD3-Medium's joint attention at the CLI's default 512² (1024 image +
    154 T5 tokens, 24 heads of 64, no key mask, bf16), at the grad
    forwards' batch 4 and the CFG probe's 8: the forward without and with
    its lse, dQ with its fused Δ and dK/dV, each against its plain version
    on the same inputs, and the backward driven by the forward kernel's own
    output and lse as in training. Tolerances as the card test of
    tests/test_torch_port_attention_bwd.py; lse to 1e-4, the dQ kernel's Δ
    to 1e-5 of the largest |Δ| of the forward kernel's output it read (fp32
    of the same terms in another order)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(b)
    h, s, d = 24, 1024 + 154, 64
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


@pytest.mark.cuda
def test_tiny_sd3_step_on_card_matches_cpu():
    """One tiny sd3 TDM step (fp32, dmd, MSE, flow schedule, pooled cond) on
    the card (the kernels: 14 forwards without lse, 4 with, 4 dQ and 4
    dK/dV) against the CPU (the plain versions) from one state with the
    same draws: losses and grad norms to 1e-4 relative, each role's update
    to 5e-3 relative L2 and each weight to 25% of lr (fp32 roundoff in
    another order; a weight whose gradient is a near-cancelling sum moves
    by lr·δg/ε with Adam ε 1e-4), as chip_smoke.py's plain tiny step."""
    _need_card()
    lr = 1e-4
    runs, cpu_params = {}, None
    for dev in ("cpu", "cuda"):
        bundle = tfamilies.build("sd3", tiny=True, seed=0, device=dev)
        if cpu_params is None:
            cpu_params = bundle.init_params()
        teacher = {k: v.to(dev) for k, v in cpu_params.items()}
        gen = torch.Generator().manual_seed(6)
        config = ttdm.TDMConfig(use_huber=False)
        draws = ttdm.StepDraws(*(x.to(dev) for x in ttdm.make_draws(
            config, 3, bundle.sample_shape, gen, "cpu")))
        text = torch.randn(3, bundle.seq_len, bundle.embed_dim, generator=gen).to(dev)
        pooled = torch.randn(3, bundle.model.cfg.pooled_dim, generator=gen).to(dev)
        mask = torch.ones(3, bundle.seq_len, dtype=torch.int32, device=dev)
        cond = bundle.cond_of(text, mask, pooled)
        uncond = bundle.cond_of(torch.zeros_like(text), mask, torch.zeros_like(pooled))
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
