"""The text encoders on the card: the tiny T5 and CLIP text encoders on a
CUDA device against the same modules on the CPU. Needs a CUDA device and
skips without one. This file imports no JAX, so it runs on the card's
machine with `python -m pytest --noconftest tests/test_torch_port_text_card.py
-m cuda`; the encoders' parity with the JAX package is held on the CPU by
tests/test_torch_port_text.py."""

import dataclasses

import pytest
import torch

from tdm_tpu_torch.device import set_fp32_precision
from tdm_tpu_torch.models import clip as tclip, t5 as tt5

torch.set_num_threads(2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _seeded(module, seed):
    """Every parameter drawn from the seed at 1/sqrt(its last axis), norms
    near 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            x = torch.randn(p.shape, generator=gen)
            if name.endswith("scale"):
                x = 1.0 + 0.1 * x
            elif p.dim() == 2:
                x = x / p.shape[-1] ** 0.5
            else:
                x = 0.1 * x
            p.copy_(x)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["t5", "clip", "clip_g"])
def test_tiny_encoders_on_card_match_cpu(kind):
    """fp32 with TF32 off (as the server and build_cache set it): the card's
    outputs within 1e-5 of the largest |CPU output| (the same sums in
    another order): T5 with a padded mask, CLIP-L's last state and pooled
    vector, and CLIP-G's (exact GELU, a projection) penultimate state and
    projected pooled vector."""
    _need_card()
    set_fp32_precision()
    gen = torch.Generator().manual_seed(1)
    if kind == "t5":
        cfg = tt5.T5Config.tiny()
        cpu = _seeded(tt5.T5Encoder(cfg, device="cpu"), 0)
        card = tt5.T5Encoder(cfg, device="cuda")
        ids = torch.randint(1, cfg.vocab_size, (3, 24), generator=gen)
        mask = (torch.arange(24)[None] < torch.tensor([[24], [7], [1]])).int()
        ids = ids * mask
    else:
        cfg = tclip.CLIPTextConfig.tiny()
        if kind == "clip_g":
            cfg = dataclasses.replace(cfg, activation="gelu", projection_dim=24)
        cpu = _seeded(tclip.CLIPTextEncoder(cfg, device="cpu"), 0)
        card = tclip.CLIPTextEncoder(cfg, device="cuda")
        ids = torch.randint(1, cfg.vocab_size - 1, (3, cfg.max_positions), generator=gen)
        ids[torch.arange(3), torch.tensor([4, 15, 0])] = cfg.eos_token_id
    card.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        if kind == "t5":
            pairs = [(card(ids.cuda(), mask.cuda()), cpu(ids, mask))]
        else:
            g, r = card(ids.cuda()), cpu(ids)
            pairs = [(g.last_hidden_state, r.last_hidden_state),
                     (g.hidden_states[-2], r.hidden_states[-2]), (g.pooled, r.pooled)]
    for got, ref in pairs:
        assert got.device.type == "cuda" and torch.isfinite(got).all()
        err = (got.cpu() - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err
