"""TAESD decoder (AutoencoderTiny) in PyTorch.

Port of `TAESDConfig` and `TAESDDecoder` from `tdm_tpu/models/vae.py`: the
tiny decoder the PixArt pipeline decodes with (`madebyollin/taesd`), and
TAESD3 (16 latent channels, shift 0) for SD3; the KL VAE is not ported yet.
Public layout NCHW: z [B, C_lat, h, w] → image [B, 3, 8h, 8w] in [0, 1]. Module
names follow the JAX tree (conv_in, stage_{s}_block_{b}/conv_{0,1,2},
stage_{s}_conv, block_out, conv_out).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tdm_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class TAESDConfig:
    latent_channels: int = 4
    image_channels: int = 3
    width: int = 64
    num_stages: int = 3  # 8× spatial factor
    blocks_per_stage: int = 3
    scaling_factor: float = 1.0
    shift_factor: float = 0.0  # the SD3 recipe sets 0.0 for TAESD3
    dtype: torch.dtype = torch.float32

    @staticmethod
    def taesd3() -> "TAESDConfig":
        return TAESDConfig(latent_channels=16)


class _TinyBlock(nn.Module):
    """conv-relu-conv-relu-conv plus the identity skip, then ReLU (TAESD
    Block; in the decoder every block keeps the width, so no skip conv)."""

    def __init__(self, width: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv_0 = nn.Conv2d(width, width, 3, padding=1, **kw)
        self.conv_1 = nn.Conv2d(width, width, 3, padding=1, **kw)
        self.conv_2 = nn.Conv2d(width, width, 3, padding=1, **kw)

    def forward(self, x):
        h = self.conv_2(F.relu(self.conv_1(F.relu(self.conv_0(x)))))
        return F.relu(h + x)


class TAESDDecoder(nn.Module):
    def __init__(
        self,
        cfg: Optional[TAESDConfig] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        c = self.cfg = cfg if cfg is not None else TAESDConfig()
        dev = resolve_device(device)
        kw = dict(dtype=c.dtype, device=dev)
        self.conv_in = nn.Conv2d(c.latent_channels, c.width, 3, padding=1, **kw)
        for s in range(c.num_stages):
            for b in range(c.blocks_per_stage):
                self.add_module(f"stage_{s}_block_{b}", _TinyBlock(c.width, **kw))
            self.add_module(
                f"stage_{s}_conv", nn.Conv2d(c.width, c.width, 3, padding=1, bias=False, **kw)
            )
        self.block_out = _TinyBlock(c.width, **kw)
        self.conv_out = nn.Conv2d(c.width, c.image_channels, 3, padding=1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = z.to(c.dtype)
        x = torch.tanh(x / 3.0) * 3.0  # TAESD Clamp
        x = F.relu(self.conv_in(x))
        for s in range(c.num_stages):
            for b in range(c.blocks_per_stage):
                x = getattr(self, f"stage_{s}_block_{b}")(x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"stage_{s}_conv")(x)
        return self.conv_out(self.block_out(x))
