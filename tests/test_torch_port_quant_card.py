"""int8 on the card: `ops/quant.int8_dot` through `torch._int_mm` against
its plain version on the CPU, and the tiny PixArt 4-step rollout at int8 on
a CUDA device against the same rollout on the CPU. Needs a CUDA device and
skips without one. This file imports no JAX, so it runs on the card's
machine with `python -m pytest --noconftest tests/test_torch_port_quant_card.py
-m cuda`; the port's parity with the JAX package is held on the CPU by
tests/test_torch_port_quant.py."""

import pytest
import torch

from tdm_tpu_torch.core import sampling, schedules
from tdm_tpu_torch.device import set_fp32_precision
from tdm_tpu_torch.models import pixart
from tdm_tpu_torch.ops import quant

torch.set_num_threads(2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    mant = 23 if dtype == torch.float32 else 7
    e = torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.pow(2.0, e - mant)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4096, 1152, 4608), (300, 100, 36), (5, 64, 64)])
def test_int8_dot_on_card_matches_cpu(m, k, n, dtype):
    """The same codes (quantized on each device), the int32 product exact on
    both, and the outputs within one ulp of the output dtype: at a PixArt
    MLP shape, at widths that are no multiple of 8 (zero-padded for
    `_int_mm`) and at 5 rows (padded to the 17 `_int_mm` needs). Each card
    call counts one launch."""
    _need_card()
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(dtype)
    w = torch.randn(n, k, generator=gen).to(dtype)
    x[0] *= 1e3
    ref = quant.int8_dot(x, w).float()
    before = quant.int8_dot.launches
    got = quant.int8_dot(x.cuda(), w.cuda())
    assert quant.int8_dot.launches == before + 1
    assert got.dtype == dtype
    xq, _ = quant.quantize_rows(x.cuda())
    assert torch.equal(xq.cpu(), quant.quantize_rows(x)[0])
    assert bool(((got.float().cpu() - ref).abs() <= _ulp(ref, dtype)).all())


@pytest.mark.cuda
def test_tiny_int8_rollout_on_card_matches_cpu(monkeypatch):
    """The tiny PixArt model in fp32 (TF32 off), every gate at 1, 4 steps
    under the int8 scope: the card's latents within a relative L2 of 1e-3
    of the CPU's (the attention kernel against plain attention moves an
    int8 code across a rounding edge now and then); the int8 products all
    launched `_int_mm`."""
    _need_card()
    set_fp32_precision()
    for name in ("MIN_TOKENS", "MIN_DIM", "WIDE_DIM"):
        monkeypatch.setattr(quant, name, 1)
    gen = torch.Generator().manual_seed(0)
    cpu = pixart.PixArtTransformer2D(pixart.PixArtConfig.tiny(), device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / max(p.shape[-1], 1) ** 0.5)
    card = pixart.PixArtTransformer2D(pixart.PixArtConfig.tiny(), device="cuda")
    card.load_state_dict(cpu.state_dict())
    noise = torch.randn(2, 4, 16, 16, generator=gen)
    text = torch.randn(2, 8, 32, generator=gen)
    mask = torch.ones(2, 8, dtype=torch.int32)
    outs = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        with torch.no_grad(), quant.quant_scope("int8"):
            outs[dev] = sampling.sample_fewstep(
                pixart.make_denoise_fn(model), schedules.ddpm_linear(device=dev),
                noise.to(dev), (text.to(dev), mask.to(dev)),
                timestep_grid=schedules.fewstep_grid(900, 4)).float().cpu()
    rel = (outs["cuda"] - outs["cpu"]).norm() / outs["cpu"].norm()
    assert float(rel) < 1e-3, float(rel)
    assert quant.int8_dot.launches > 0
