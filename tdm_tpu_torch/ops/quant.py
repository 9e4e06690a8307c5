"""Dynamic int8 products for the denoiser's large linear layers.

Port of `tdm_tpu/ops/quant.py`. Both operands are quantized from their live
values at every call (no calibration pass): the activations per row (token)
and the weight per output channel, each by absmax / 127 clamped at 1e-12,
rounded half to even to int8; the product accumulates in int32 and is
rescaled in fp32, then cast to the input's dtype. The layer's bias is added
after that cast, in the layer's dtype, as the JAX interceptor adds it.

`int8_dot(x, weight)` takes the weight as the port's `Dense` holds it,
[N, K] (`F.linear`'s layout); the JAX function's kernel is [K, N], so its
per-column scale is a per-row scale here. On a CUDA tensor the product is
`torch._int_mm` (cuBLASLt's int8 GEMM), counted in `int8_dot.launches`;
the JAX function is an XLA dot, not a Pallas kernel, so no kernel of the
port's own stands in for it. A CPU tensor takes the plain version,
`plain_int8_mm` (an int32 `torch.mm` of the codes, exact), and counts
nothing; any other device raises. Nothing falls back to a bf16 product.

`quant_scope(mode)` switches the route on for the calling thread only:
`models/layers.Dense` asks `active()` and `gate()` at every call, so a
scope around a sampler on one thread leaves an encoder running on another
thread on its own route (the server encodes on its handler threads while
its worker samples). The gates are module constants that tests lower to
reach tiny models, as the JAX tests do.

Under tensor parallelism (`parallel/tp.py`) the JAX package traces global
shapes, so its absmax reductions over a cut K become all-reduce-max
collectives (`tdm_tpu/pipelines/base.py:197-202`). The port does the same:
the gates read the whole layer's K and N, and a row-parallel layer (K cut
over 'tp') takes the per-row absmax of x and the per-output-channel absmax
of w over its K slice, then the max over the ranks, before it makes the
codes; its int32 accumulators are summed over the ranks (exact) before
the rescale. So the scales, the codes and the result are the
one-process ones.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from tdm_tpu_torch.ops import attention

# the JAX interceptor's gates: quantize only token-level, wide products
MIN_TOKENS = 256  # rows of x (B·S); per-sample embedders stay exact
MIN_DIM = 512  # min(K, N); narrow projections stay exact
WIDE_DIM = 512  # max(K, N) must clear this too

_state = threading.local()


def gate(tokens: int, k: int, n: int) -> bool:
    """Whether a linear layer of K inputs and N outputs over `tokens` rows
    takes the int8 route (`tdm_tpu/ops/quant.py:79-85`)."""
    return tokens >= MIN_TOKENS and min(k, n) >= MIN_DIM and max(k, n) >= WIDE_DIM


def active() -> bool:
    """Whether an int8 scope is open on this thread."""
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def quantize_int8():
    """While open on this thread, every `Dense` call that passes `gate`
    runs through `int8_dot`."""
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


def quant_scope(mode):
    """None or 'none': a scope that changes nothing; 'int8':
    `quantize_int8()`; anything else raises ValueError."""
    if mode is None or mode == "none":
        return contextlib.nullcontext()
    if mode == "int8":
        return quantize_int8()
    raise ValueError(f"unknown quant mode {mode!r} (expected 'int8')")


def quantize_rows(t: torch.Tensor, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 codes of t [..., K] and their fp32 scales
    [..., 1]: absmax / 127 clamped at 1e-12, round half to even. With `tp`
    (a `parallel.tp.TPGroup`; K cut over its ranks) the absmax is the max
    over the ranks' slices."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1, keepdim=True)
    if tp is not None:
        from tdm_tpu_torch.parallel import tp as tp_lib

        amax = tp_lib.all_reduce_max(amax, tp)
    # divided by a tensor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which moves a code across a rounding edge now and then
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
    return torch.round(tf / scale).to(torch.int8), scale


def plain_int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 codes times [N, K] int8 codes transposed → [M, N] int32,
    as an int32 product (exact: |sum| ≤ 127²·K)."""
    return torch.mm(xq.to(torch.int32), wq.to(torch.int32).t())


def _int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """`torch._int_mm` on the card: M above 16 (the gates keep it at 256 or
    more), K and N zero-padded to multiples of 8 (exact: a zero code adds
    nothing), the weight handed over as the column-major view of its
    [N, K] rows."""
    m, k = xq.shape
    n = wq.shape[0]
    pad_k, pad_n = -k % 8, -n % 8
    if pad_k:
        xq, wq = F.pad(xq, (0, pad_k)), F.pad(wq, (0, pad_k))
    if pad_n:
        wq = F.pad(wq, (0, 0, 0, pad_n))
    if m <= 16:
        xq = F.pad(xq, (0, 0, 0, 17 - m))
    acc = torch._int_mm(xq, wq.t())
    attention.count_launch(int8_dot)
    return acc[:m, :n]


def int8_dot(x: torch.Tensor, weight: torch.Tensor, tp=None) -> torch.Tensor:
    """x [..., K] @ weight[N, K]ᵀ with dynamic symmetric int8 quantization
    of both operands; the result in x's dtype (fp32 for an integer x). With
    `tp`, K is cut over its ranks (a row-parallel layer): the scales come
    from the whole K and the int32 accumulators are summed over the ranks."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8 product for device {x.device}")
    xq, sx = quantize_rows(x, tp)
    wq, sw = quantize_rows(weight, tp)
    lead, k = x.shape[:-1], x.shape[-1]
    xq2 = xq.reshape(-1, k)
    acc = _int_mm(xq2, wq) if x.device.type == "cuda" else plain_int8_mm(xq2, wq)
    if tp is not None:
        from tdm_tpu_torch.parallel import tp as tp_lib

        acc = tp_lib.all_reduce_sum(acc, tp)
    out = acc.reshape(*lead, -1).float() * sx * sw.reshape(-1)
    return out.to(x.dtype if x.dtype.is_floating_point else torch.float32)


int8_dot.launches = 0


def dense(x: torch.Tensor, weight: torch.Tensor, bias, dtype: torch.dtype, *,
          shape=None, tp=None) -> torch.Tensor:
    """A linear layer's output on the int8 route when a scope is open and
    the gate passes (tokens = the product of x's leading dims; N and K the
    whole layer's `shape`, default the weight's), else None: x and the
    weight cast to the layer's dtype, `int8_dot` (over K cut on `tp`'s
    ranks when given), then the bias added in that dtype."""
    if not active():
        return None
    n, k = weight.shape if shape is None else shape
    tokens = math.prod(x.shape[:-1]) if x.dim() > 1 else 1
    if not gate(tokens, k, n):
        return None
    x, weight = x.to(dtype), weight.to(dtype)
    # a layer whose K is whole calls int8_dot(x, w), as callers that wrap it expect
    y = int8_dot(x, weight) if tp is None else int8_dot(x, weight, tp)
    return y if bias is None else y + bias.to(dtype)
