"""Scaled dot-product attention over [B, H, S, D] tensors, forward and
backward.

Port of `tdm_tpu/ops/attention.py`'s flash path: the same layout (q
[B,H,Sq,D], k/v [B,H,Sk,D]) and masking contract (key_mask [B,Sk], nonzero =
real key; a row whose keys are all masked outputs 0 and gets no gradient).
Each hand-written CUDA kernel has a wrapper and a plain PyTorch version of
the same function beside it; the wrapper takes the plain version only for a
tensor on the CPU, and on a CUDA tensor launches its kernel (counted in
`<wrapper>.launches`) or raises:

  * `flash_attention_fwd` — `csrc/flash_fwd.cu` without the logsumexp (the
    Pallas `_flash_fwd_kernel` with with_lse=False); plain: `plain_attention`.
    In bf16 it runs the wgmma/TMA mainloop of `csrc/attn_fwd_sm90.cuh`,
    which reads rows of a multiple of 16 bytes: the wrapper zero-pads the
    head dim to a multiple of 8 (`pad_head_dim`, exact) and slices the
    output back. It takes head dims up to `FWD_MAX_HEAD_DIM` (160, SD1.5's
    1280-wide blocks at 8 heads).
  * `flash_attention_fwd_lse` — the same kernel with its [B,H,Sq] fp32 lse
    output (+1e30 on all-masked rows); plain: `plain_attention_lse`.
  * `flash_attention_bwd_dq` — `csrc/flash_bwd_dq.cu` (`_flash_bwd_dq_kernel`,
    with Δ = rowsum(dO∘O) fused in: it takes the forward's output and
    returns (dQ, Δ)); plain: `plain_attention_bwd_dq`.
  * `flash_attention_bwd_dkv` — `csrc/flash_bwd_dkv.cu`
    (`_flash_bwd_dkv_kernel`), which reads the Δ of the dQ kernel; plain:
    `plain_attention_bwd_dkv`.
  In bf16 both run on wgmma and TMA, as the forward does, and their
  wrappers zero-pad the head dim the same way. They take head dims up to
  `BWD_MAX_HEAD_DIM` (160, SD1.5 training's 1280-wide blocks; at padded
  head dim 160 the dK/dV wrapper's kernel runs a dV pass and a dK pass).

`FlashAttention`, a `torch.autograd.Function`, joins them as the JAX
package's custom VJP joins its kernels (`attention.py:408-435, 678-687`):
it pre-scales q itself and saves that q as the residual, so the backward's
logits match the forward's bit for bit and `scale` enters dQ exactly once,
inside the kernel. Δ = rowsum(dO∘O), which the JAX package leaves to XLA,
is computed by the dQ kernel and handed to the dK/dV kernel
(`attention_delta` is its plain version). `attention()` takes that route only when
autograd records the call; a call under `torch.no_grad()` or
`torch.inference_mode()` takes the forward without the lse.

  * `splash_attention_fwd` — `csrc/splash_fwd.cu`, unmasked attention for
    head dims 64 and 128, no lse (the counterpart of the JAX package's
    splash kernel, `attention.py:152-263`), the same mainloop without bias
    or lse; plain: `plain_splash_attention`.

`impl="auto"` goes through the kernels' wrappers on every shape: the JAX
package's v5e-measured switch to XLA at S=1024 is not carried over.
`impl="splash"` takes the splash kernel when the call has no key mask, its
head dim is 64 or 128 and autograd does not record it; any other call takes
the `auto` route, as the JAX package falls back to its flash kernel
(`attention.py:98-105`; its splash VJP recomputes through the flash kernels,
`:237-254`). The choice is made on the shapes, before any launch. The ragged
tails are masked exactly inside the kernel: the TPU path's pad-key rescale
(`:225-229`), which fails when a row's real logits all lie well below 0, is
not carried over.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from tdm_tpu_torch.ops import _build

_NEG_INF = -1e30  # the key bias of a masked key, as in the TPU kernel
_LSE_MASKED = 1e30  # the lse of a row with no unmasked key: exp(s - lse) = 0
IMPLS = ("auto", "plain", "splash")
SPLASH_HEAD_DIMS = (64, 128)
# the largest head dim each kernel takes; above it the wrappers raise (the
# JAX kernels pad any head dim to a multiple of 128; no model of either
# package has one above 160: ROADMAP.md §2, still to port)
FWD_MAX_HEAD_DIM = 160
BWD_MAX_HEAD_DIM = 160
_HEAD_DIM_GAP = "head dims above 160 are still to port: ROADMAP.md §2"

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
    impl: 'auto' (the kernels' wrappers; `FlashAttention` when autograd
    records the call) | 'plain' (differentiated by autograd) | 'splash'
    (the splash kernel where it applies, else 'auto')."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} (one of {IMPLS})")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    records_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    )
    if impl == "splash":
        if key_mask is None and q.shape[-1] in SPLASH_HEAD_DIMS and not records_grad:
            q_scaled = (q.to(_acc(q)) * scale).to(q.dtype)
            return splash_attention_fwd(q_scaled, k.contiguous(), v.contiguous())
        impl = "auto"
    bias = None if key_mask is None else key_bias(key_mask)
    if impl == "auto" and records_grad:
        return FlashAttention.apply(q, k, v, bias, scale)
    q_scaled = (q.to(_acc(q)) * scale).to(q.dtype)
    if impl == "plain":
        return plain_attention(q_scaled, k, v, bias)
    return flash_attention_fwd(q_scaled, k, v, bias)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the backward kernels: forward(q, k, v, bias,
    scale) → out; bias is the fp32 [B, Sk] key bias or None. The bias gets
    no gradient (the JAX package returns zeros for it)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        q_scaled = (q.to(_acc(q)) * scale).to(q.dtype)
        out, lse = flash_attention_fwd_lse(q_scaled, k, v, bias)
        ctx.save_for_backward(q_scaled, k, v, bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q_scaled, k, v, bias, out, lse = ctx.saved_tensors
        dout = dout.to(q_scaled.dtype).contiguous()
        dq, delta = flash_attention_bwd_dq(q_scaled, k, v, bias, dout, out, lse, ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q_scaled, k, v, bias, dout, lse, delta)
        return dq, dk, dv, None, None


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """[B, Sk] mask → fp32 bias: 0 where the key is real, -1e30 where it
    is padding."""
    return torch.where(
        key_mask.bool(),
        torch.zeros((), dtype=torch.float32, device=key_mask.device),
        torch.full((), _NEG_INF, dtype=torch.float32, device=key_mask.device),
    ).contiguous()


# ---------------------------------------------------------------------------
# plain versions: the kernels' functions in fp32 PyTorch
# ---------------------------------------------------------------------------


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation dtype: fp32, or fp64 for fp64
    inputs (the tests' exact reference)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _logits(q_scaled, k, bias):
    f = _acc(q_scaled)
    logits = torch.einsum("bhqd,bhkd->bhqk", q_scaled.to(f), k.to(f))
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    return logits


def _valid_rows(bias, b, device):
    """[B] bool: the batch row has at least one unmasked key."""
    if bias is None:
        return torch.ones(b, dtype=torch.bool, device=device)
    return (bias > -1e29).any(dim=-1)


def plain_attention(
    q_scaled: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: fp32 logits of the
    pre-scaled query, key bias, softmax, probabilities rounded to v's dtype,
    fp32 product with v; batch rows whose keys are all masked give 0."""
    return plain_attention_lse(q_scaled, k, v, bias)[0]


def plain_attention_lse(
    q_scaled: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """`plain_attention` and the fp32 [B, H, Sq] logsumexp of its logits,
    +1e30 on the rows of a batch row whose keys are all masked."""
    f = _acc(q_scaled)
    logits = _logits(q_scaled, k, bias)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(f), v.to(f))
    valid = _valid_rows(bias, q_scaled.shape[0], q_scaled.device)[:, None, None]
    out = torch.where(valid[..., None], out, 0.0)
    lse = torch.where(valid, torch.logsumexp(logits, dim=-1), _LSE_MASKED)
    return out.to(q_scaled.dtype), lse.contiguous()


def plain_splash_attention(
    q_scaled: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """The splash kernel's function in plain PyTorch: `plain_attention`
    with no key bias (every key is real, whatever Sk is)."""
    return plain_attention(q_scaled, k, v, None)


def attention_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ∘ O) in fp32 from the output the forward wrote, [B,H,Sq]
    (`_bwd_core` `attention.py:718-724`)."""
    return (dout.to(_acc(out)) * out.to(_acc(out))).sum(dim=-1).contiguous()


def _probs_and_ds(q_scaled, k, v, bias, dout, lse, delta):
    """P = exp(S − lse) and dS = P∘(dO·Vᵀ − Δ), both fp32 [B,H,Sq,Sk]."""
    f = _acc(q_scaled)
    p = torch.exp(_logits(q_scaled, k, bias) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.to(f), v.to(f))
    return p, p * (dp - delta[..., None])


def plain_attention_bwd_dq(
    q_scaled, k, v, bias, dout, out, lse, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dQ kernel's function: Δ = `attention_delta(dout, out)` and
    scale·dS·K with dS rounded to q's dtype, fp32 product, dQ in q's dtype.
    Returns (dq, delta)."""
    f = _acc(q_scaled)
    delta = attention_delta(dout, out)
    _, ds = _probs_and_ds(q_scaled, k, v, bias, dout, lse, delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(q_scaled.dtype).to(f), k.to(f))
    return (dq * scale).to(q_scaled.dtype), delta


def plain_attention_bwd_dkv(
    q_scaled, k, v, bias, dout, lse, delta
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's function: dV = Pᵀ·dO (P rounded to dO's dtype) and
    dK = dSᵀ·Q_scaled (dS rounded to q's dtype), fp32 products."""
    f = _acc(q_scaled)
    p, ds = _probs_and_ds(q_scaled, k, v, bias, dout, lse, delta)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).to(f), dout.to(f))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q_scaled.dtype).to(f), q_scaled.to(f))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, bias, *rows, max_d: int = BWD_MAX_HEAD_DIM) -> None:
    """Shapes, dtypes, devices and contiguity the kernels take. `rows` are
    the backward's extra [B,H,Sq,D] (dO, O) and [B,H,Sq] fp32 (lse, Δ)
    operands; `max_d` is the kernel's largest head dim."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if not 1 <= d <= max_d:
        raise ValueError(
            f"head dim {d} outside the kernel's range [1, {max_d}] ({_HEAD_DIM_GAP})")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    for r in rows:
        want = (q.shape, q.dtype) if r.dim() == 4 else ((b, h, sq), torch.float32)
        if (r.shape, r.dtype) != want:
            raise ValueError(
                f"backward operand {r.dtype} {tuple(r.shape)}, expected "
                f"{want[1]} {tuple(want[0])}"
            )
    tensors = (q, k, v, *rows) if bias is None else (q, k, v, bias, *rows)
    if any(t.device != q.device for t in tensors):
        raise ValueError("the flash kernels' operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the flash kernels need contiguous operands")
    if bias is not None and (
        bias.dtype != torch.float32 or tuple(bias.shape) != (b, k.shape[2])
    ):
        raise ValueError(
            f"key bias must be float32 [B, Sk] = {(b, k.shape[2])}, got "
            f"{bias.dtype} {tuple(bias.shape)}"
        )


def _check_splash(q, k, v) -> None:
    """What the splash kernel takes: q [B,H,Sq,D], k/v [B,H,Sk,D] with D in
    SPLASH_HEAD_DIMS, one dtype (fp32 or bf16), one device, contiguous and
    16-byte aligned (TMA reads its tiles), at most 65535 (batch, head) pairs."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if d not in SPLASH_HEAD_DIMS:
        raise ValueError(f"the splash kernel takes head dims {SPLASH_HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"splash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("the splash kernel's operands must be on one device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("the splash kernel needs contiguous, 16-byte aligned operands")
    _check_pairs(b, h, "splash")


def _on_card(wrapper: str, q: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA
    tensor; raises for any other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device} ({wrapper})")
    return True


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # C entry point -> (its library, argument types)
    "tdm_flash_fwd": ("flash_fwd", [_P] * 6 + [_I] * 6 + [_P]),
    "tdm_flash_bwd_dq": (
        "flash_bwd_dq", [_P] * 9 + [_I] * 5 + [ctypes.c_float, _I, _P]),
    "tdm_flash_bwd_dkv": ("flash_bwd_dkv", [_P] * 9 + [_I] * 6 + [_P]),
    "tdm_splash_fwd": ("splash_fwd", [_P] * 4 + [_I] * 5 + [_P]),
}


@functools.cache
def _entry(fn_name: str):
    """The C entry point, its library built and its signature declared
    (once)."""
    lib_name, argtypes = _SIGNATURES[fn_name]
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.tdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib


def _launch(fn_name: str, device: torch.device, *args) -> None:
    fn, lib = _entry(fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{fn_name} kernel launch failed: "
            + lib.tdm_cuda_error_string(err).decode()
        )


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def tma_head_dim(d: int) -> int:
    """The head dim the bf16 flash kernels read: d rounded up to a multiple
    of 8, since TMA moves rows of a multiple of 16 bytes. Above
    FWD_MAX_HEAD_DIM no kernel takes it."""
    if not 1 <= d <= FWD_MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {d} outside the flash kernels' range [1, {FWD_MAX_HEAD_DIM}] "
            f"({_HEAD_DIM_GAP})")
    return -(-d // 8) * 8


def pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """t itself when its last dim is d and its base is 16-byte aligned (what
    TMA takes); else a fresh copy zero-padded to d. Zero columns add nothing
    to the logits and give zero output columns, so the padding is exact."""
    if t.shape[-1] == d and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(*t.shape[:-1], d)
    out[..., : t.shape[-1]] = t
    return out


def _kernel_operands(*tensors) -> tuple[int, tuple[torch.Tensor, ...]]:
    """The head dim the flash kernels read and the operands at it: bf16
    zero-padded to `tma_head_dim` (`pad_head_dim`), fp32 as they are (the
    scalar kernels take any head dim)."""
    d = tensors[0].shape[-1]
    if tensors[0].dtype != torch.bfloat16:
        return d, tensors
    dp = tma_head_dim(d)
    return dp, tuple(pad_head_dim(t, dp) for t in tensors)


def _check_pairs(b: int, h: int, kernel: str) -> None:
    """The bf16 forward kernels put the (batch, head) pairs on the grid's y
    axis, which holds at most 65535."""
    if b * h > 65535:
        raise ValueError(
            f"the {kernel} kernel takes at most 65535 (batch, head) pairs, got {b * h}")


def _fwd(q_scaled, k, v, bias, with_lse: bool):
    _check(q_scaled, k, v, bias, max_d=FWD_MAX_HEAD_DIM)
    b, h, sq, d = q_scaled.shape
    if q_scaled.dtype == torch.bfloat16:
        _check_pairs(b, h, "flash")
    dk, (q_scaled, k, v) = _kernel_operands(q_scaled, k, v)
    out = torch.empty((b, h, sq, dk), dtype=q_scaled.dtype, device=q_scaled.device)
    lse = (
        torch.empty((b, h, sq), dtype=torch.float32, device=q_scaled.device)
        if with_lse else None
    )
    _launch(
        "tdm_flash_fwd", q_scaled.device,
        q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
        out.data_ptr(), _ptr(lse), b, h, sq, k.shape[2], dk,
        _DTYPE_CODE[q_scaled.dtype],
    )
    if dk != d:
        out = out[..., :d].contiguous()
    return out, lse


def flash_attention_fwd(
    q_scaled: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """The flash forward without the lse (the inference variant). A CPU
    tensor takes `plain_attention`; a CUDA tensor launches
    `csrc/flash_fwd.cu` on the current stream or raises."""
    if not _on_card("flash_attention_fwd", q_scaled):
        return plain_attention(q_scaled, k, v, bias)
    out, _ = _fwd(q_scaled, k, v, bias, with_lse=False)
    count_launch(flash_attention_fwd)
    return out


def flash_attention_fwd_lse(
    q_scaled: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """The flash forward with its [B,H,Sq] fp32 lse (the training forward).
    A CPU tensor takes `plain_attention_lse`; a CUDA tensor launches
    `csrc/flash_fwd.cu` with the lse flag or raises."""
    if not _on_card("flash_attention_fwd_lse", q_scaled):
        return plain_attention_lse(q_scaled, k, v, bias)
    out, lse = _fwd(q_scaled, k, v, bias, with_lse=True)
    count_launch(flash_attention_fwd_lse)
    return out, lse


def flash_attention_bwd_dq(
    q_scaled, k, v, bias, dout, out, lse, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dQ, Δ): the gradient with respect to the unscaled q, and the fp32
    [B,H,Sq] Δ = rowsum(dO∘O) from the forward's output `out`, which the
    dK/dV kernel reads. A CPU tensor takes `plain_attention_bwd_dq`; a CUDA
    tensor launches `csrc/flash_bwd_dq.cu` or raises."""
    if not _on_card("flash_attention_bwd_dq", q_scaled):
        return plain_attention_bwd_dq(q_scaled, k, v, bias, dout, out, lse, scale)
    _check(q_scaled, k, v, bias, dout, out, lse)
    b, h, sq, d = q_scaled.shape
    dp, (q_scaled, k, v, dout, out) = _kernel_operands(q_scaled, k, v, dout, out)
    dq = torch.empty((b, h, sq, dp), dtype=q_scaled.dtype, device=q_scaled.device)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q_scaled.device)
    _launch(
        "tdm_flash_bwd_dq", q_scaled.device,
        q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
        dout.data_ptr(), out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, h, sq, k.shape[2], dp, float(scale), _DTYPE_CODE[q_scaled.dtype],
    )
    count_launch(flash_attention_bwd_dq)
    if dp != d:
        dq = dq[..., :d].contiguous()
    return dq, delta


def flash_attention_bwd_dkv(
    q_scaled, k, v, bias, dout, lse, delta
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), from the Δ that `flash_attention_bwd_dq` returned. A CPU
    tensor takes `plain_attention_bwd_dkv`; a CUDA tensor launches
    `csrc/flash_bwd_dkv.cu` or raises."""
    if not _on_card("flash_attention_bwd_dkv", q_scaled):
        return plain_attention_bwd_dkv(q_scaled, k, v, bias, dout, lse, delta)
    _check(q_scaled, k, v, bias, dout, lse, delta)
    b, h, sq, d = q_scaled.shape
    sk = k.shape[2]
    dp, (q_scaled, k, v, dout) = _kernel_operands(q_scaled, k, v, dout)
    dk, dv = (torch.empty((b, h, sk, dp), dtype=k.dtype, device=k.device) for _ in range(2))
    _launch(
        "tdm_flash_bwd_dkv", q_scaled.device,
        q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, sq, sk, dp, _DTYPE_CODE[q_scaled.dtype],
    )
    count_launch(flash_attention_bwd_dkv)
    if dp != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


def splash_attention_fwd(
    q_scaled: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Unmasked attention of the pre-scaled query for head dims 64 and 128.
    A CPU tensor takes `plain_splash_attention`; a CUDA tensor launches
    `csrc/splash_fwd.cu` on the current stream or raises."""
    if not _on_card("splash_attention_fwd", q_scaled):
        return plain_splash_attention(q_scaled, k, v)
    _check_splash(q_scaled, k, v)
    b, h, sq, d = q_scaled.shape
    out = torch.empty_like(q_scaled)
    _launch(
        "tdm_splash_fwd", q_scaled.device,
        q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, sq, k.shape[2], d, _DTYPE_CODE[q_scaled.dtype],
    )
    count_launch(splash_attention_fwd)
    return out


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """One more launch of `wrapper`'s kernel. Under a lock: replicas of a
    data-parallel pipeline launch from a thread each."""
    with _COUNT_LOCK:
        wrapper.launches += 1


WRAPPERS = (
    flash_attention_fwd, flash_attention_fwd_lse,
    flash_attention_bwd_dq, flash_attention_bwd_dkv, splash_attention_fwd,
)
for _w in WRAPPERS:
    _w.launches = 0


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}
