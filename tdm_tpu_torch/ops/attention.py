"""Scaled dot-product attention over [B, H, S, D] tensors.

Port of the forward path of `tdm_tpu/ops/attention.py`: the same layout
(q [B,H,Sq,D], k/v [B,H,Sk,D]) and masking contract (key_mask [B,Sk],
nonzero = real key; a row whose keys are all masked outputs 0). Two
versions of one function:

  * `flash_attention_fwd` — the wrapper of the hand-written CUDA kernel
    `csrc/flash_fwd.cu` (the port of the Pallas `_flash_fwd_kernel`). On a
    CUDA tensor it launches the kernel or raises; only a tensor on the CPU
    takes the plain version.
  * `plain_attention` — fp32 einsum-softmax-einsum with the same masking,
    the reference the kernel is held against.

`impl="auto"` goes through the kernel's wrapper on every shape: the JAX
package's v5e-measured switch to XLA at S=1024 is not carried over.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from tdm_tpu_torch.ops import _build

_NEG_INF = -1e30  # the key bias of a masked key, as in the TPU kernel
IMPLS = ("auto", "plain")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention of q over k/v with an optional [B, Sk] key mask.

    The query is pre-scaled and rounded back to its dtype before either
    version runs, as the TPU kernel's caller does (`attention.py:424`).
    impl: 'auto' (the kernel's wrapper) | 'plain'."""
    if impl == "splash":
        raise NotImplementedError(
            "impl='splash' (SD3/CogVideoX inference) is not ported yet: "
            "ROADMAP.md queue 2, kernel 4"
        )
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} (one of {IMPLS})")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q_scaled = (q.float() * scale).to(q.dtype)
    bias = None if key_mask is None else key_bias(key_mask)
    if impl == "plain":
        return plain_attention(q_scaled, k, v, bias)
    return flash_attention_fwd(q_scaled, k, v, bias)


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """[B, Sk] mask → fp32 bias: 0 where the key is real, -1e30 where it
    is padding."""
    return torch.where(
        key_mask.bool(),
        torch.zeros((), dtype=torch.float32, device=key_mask.device),
        torch.full((), _NEG_INF, dtype=torch.float32, device=key_mask.device),
    ).contiguous()


def plain_attention(
    q_scaled: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 logits of the
    pre-scaled query, key bias, softmax, probabilities rounded to v's dtype,
    fp32 product with v; batch rows whose keys are all masked give 0."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q_scaled.float(), k.float())
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float())
    if bias is not None:
        valid = (bias > -1e29).any(dim=-1)
        out = torch.where(valid[:, None, None, None], out, 0.0)
    return out.to(q_scaled.dtype)


def _check(q, k, v, bias) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if not 1 <= d <= 128:
        raise ValueError(f"head dim {d} outside the kernel's range [1, 128]")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and the key bias must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash kernel needs contiguous q, k, v and bias")
    if bias is not None and (
        bias.dtype != torch.float32 or tuple(bias.shape) != (b, k.shape[2])
    ):
        raise ValueError(
            f"key bias must be float32 [B, Sk] = {(b, k.shape[2])}, got "
            f"{bias.dtype} {tuple(bias.shape)}"
        )


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (once)."""
    lib = _build.load("flash_fwd")
    fn = lib.tdm_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(
    q_scaled: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """The flash-attention forward kernel's wrapper. A CPU tensor takes
    `plain_attention`; a CUDA tensor launches `csrc/flash_fwd.cu` on the
    current stream (counted in `flash_attention_fwd.launches`) or raises."""
    if q_scaled.device.type == "cpu":
        return plain_attention(q_scaled, k, v, bias)
    if q_scaled.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q_scaled.device}")
    _check(q_scaled, k, v, bias)
    b, h, sq, d = q_scaled.shape
    out = torch.empty_like(q_scaled)
    lib = _library()
    vec = d % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q_scaled, k, v, out)
    )
    with torch.cuda.device(q_scaled.device):
        err = lib.tdm_flash_fwd(
            q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, sq, k.shape[2], d, _DTYPE_CODE[q_scaled.dtype], int(vec),
            torch.cuda.current_stream(q_scaled.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash_fwd kernel launch failed: "
            + lib.tdm_cuda_error_string(err).decode()
        )
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
