"""Micro-batching request scheduler over the pipeline, on one device.

Port of `tdm_tpu/serve/batcher.py`. Concurrent requests coalesce into
calls of a fixed batch size (`batch_size`, or the smallest of
`batch_buckets` that fits); a partial batch is padded by repeating its last
row, and padded outputs are dropped. Each request's initial noise comes from
its own seed, so a (prompt, seed) gives the same image whatever its
batch-mates. A request's conditioning is its family's (`data/prompts.
pack_family_cond`): a tuple of batch-1 tensors, or CogVideoX's embedding
sequence alone. The noise is drawn with `torch.Generator().manual_seed(seed)`
on the CPU — different numbers from the JAX server's `PRNGKey(seed)` for the
same seed, by construction.

Threads: `submit` runs on the caller's thread (the prompt's encode, or its
cache lookup, and the upload); one worker thread calls the pipeline; one resolver thread copies results
back to the host, so a readback overlaps the next batch's work. The pending
queue is bounded (`max_queue`); overflow raises `Overloaded` (HTTP 429).

Set `pipe.quant` before wrapping (the server's `--quant int8`): the worker
thread's pipeline call opens the int8 scope around the sampler alone, and
the scope is that thread's, so the encodes on the callers' threads keep
their own route whatever batch is running.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from tdm_tpu_torch.pipelines.base import denoiser_of


def latent_shape(pipe, call_kwargs: dict) -> tuple[int, ...]:
    """Per-request (leading-1) latent shape at the server's resolution (the
    family's default: 512² PixArt and SD1.5, 1024² SD3; CogVideoX's
    `num_frames` frames, 49 by default, at 480×720)."""
    fam = getattr(pipe, "family", "")
    if fam == "cogvideox":
        return pipe.latent_shape(1, call_kwargs.get("num_frames", 49),
                                 call_kwargs.get("height", 480), call_kwargs.get("width", 720))
    if fam not in ("pixart", "sd3", "sd15"):
        raise ValueError(f"unknown serving family {fam!r}")
    ch = denoiser_of(pipe).cfg.in_channels
    side = 1024 if fam == "sd3" else 512
    h = call_kwargs.get("height", side)
    w = call_kwargs.get("width", side)
    return (1, ch, h // 8, w // 8)


def request_noise(seed: int, shape: tuple) -> torch.Tensor:
    """The request's initial noise: standard normal from a CPU generator
    seeded with `seed`, rounded to bf16 as the pipeline would."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(shape, generator=gen).to(torch.bfloat16).float()


def _to_device(tree, device, float_dtype=None):
    """Conditioning (a tuple, or one array) → tensors on `device`; floats
    cast to `float_dtype` when given (bf16 for a bf16 model: the model's
    first use rounds them the same way, and the upload is half the bytes)."""
    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        if float_dtype is not None and x.is_floating_point():
            x = x.to(float_dtype)
        return x.to(device)

    return tuple(put(x) for x in tree) if isinstance(tree, (tuple, list)) else put(tree)


def _tree_nbytes(tree) -> int:
    leaves = tree if isinstance(tree, (tuple, list)) else (tree,)
    return sum(x.numel() * x.element_size() for x in leaves)


def _cat_rows(conds: list):
    """Batch-1 conditionings → one batch, concatenated on the batch axis."""
    if isinstance(conds[0], (tuple, list)):
        return tuple(torch.cat(xs, dim=0) for xs in zip(*conds))
    return torch.cat(conds, dim=0)


def has_encoders(pipe) -> bool:
    """Whether the pipeline has text encoder(s) attached, as the JAX
    package's make_cond_fn asks: then every prompt goes to encode_prompt,
    which raises where a tokenizer is missing."""
    return bool(getattr(pipe, "text_encoder", None) is not None
                or getattr(pipe, "text_encoders", None))


def make_cond_fn(pipe, embedding_cache: Optional[str] = None) -> Callable[[str], Any]:
    """prompt → batch-1 conditioning in the family's format. Prefers the
    attached encoders (`pipe.encode_prompt([prompt])`, run on the calling
    thread under inference mode on the pipeline's device: batch 1, so a
    prompt's conditioning does not depend on other requests); falls back to
    an offline embedding cache (the `.npz` of either package's
    cli/build_cache: T5 for PixArt and CogVideoX, CLIP-L for SD1.5; SD3
    needs its pooled vectors), where the empty prompt falls back to the
    cache's uncond_* rows (the CFG branch). Raises if neither is there."""
    if has_encoders(pipe):
        return lambda prompt: pipe.encode_prompt([prompt])
    if embedding_cache is None:
        raise ValueError(
            "the pipeline has no text encoders — pass embedding_cache= (an "
            ".npz built with cli/build_cache)"
        )
    from tdm_tpu_torch.data.prompts import EmbeddingCache, pack_family_cond

    cache = EmbeddingCache.load(embedding_cache)
    fam = getattr(pipe, "family", "")

    def f32(rows):
        return None if rows is None else rows.astype(np.float32)

    def lookup(prompt: str):
        try:
            i = cache.prompts.index(prompt)
        except ValueError:
            if prompt == "" and cache.uncond_embed is not None:
                e = cache.uncond_embed[None].astype(np.float32)
                m = (
                    cache.uncond_mask[None].astype(np.int32)
                    if cache.uncond_mask is not None
                    else np.ones(e.shape[:2], np.int32)
                )
                p = None if cache.uncond_pooled is None else cache.uncond_pooled[None]
                return pack_family_cond(fam, e, m, f32(p))
            raise KeyError(
                f"prompt {prompt!r} not in the embedding cache — rebuild "
                "with cli/build_cache"
            ) from None
        return pack_family_cond(
            fam,
            cache.embeds[i : i + 1].astype(np.float32),
            cache.masks[i : i + 1].astype(np.int32),
            None if cache.pooled is None else f32(cache.pooled[i : i + 1]),
        )

    return lookup


@dataclass
class _Pending:
    cond: Any  # batch-1 conditioning on the device
    noise: torch.Tensor  # [1, ...] initial latent from the request's seed
    uncond: Any = None  # per-request negative conditioning (CFG > 1 only)
    future: Future = field(default_factory=Future)


class Overloaded(RuntimeError):
    """submit() on a full pending queue; the HTTP layer answers 429."""


@dataclass
class ServeStats:
    requests: int = 0
    batches: int = 0
    rows_padded: int = 0
    failures: int = 0
    rejected: int = 0
    # dispatch → readback complete (includes time queued behind readbacks)
    last_batch_latency_s: float = 0.0
    # completion-to-completion interval of the last two batches
    last_batch_period_s: float = 0.0
    batches_by_shape: dict = field(default_factory=dict)
    upload_bytes: int = 0
    readback_bytes: int = 0
    readback_s: float = 0.0

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        # the resolver thread may insert a shape key while this copies
        for _ in range(8):
            try:
                shapes = list(self.batches_by_shape.items())
                break
            except RuntimeError:
                continue
        else:  # pragma: no cover - 8 consecutive mutations mid-copy
            shapes = []
        d["batches_by_shape"] = {str(k): v for k, v in sorted(shapes)}
        d["mean_fill"] = (
            round(self.requests / max(1, self.batches), 3) if self.batches else 0.0
        )
        return d


class MicroBatcher:
    """Collect generation requests into fixed-size pipeline calls.
    `submit` returns a Future resolving to the request's [H, W, 3] image,
    or [F, H, W, 3] video (its latent row when the pipeline has no
    decoder)."""

    def __init__(
        self,
        pipe,
        *,
        batch_size: int = 4,
        max_delay_ms: float = 50.0,
        call_kwargs: Optional[dict] = None,
        cond_fn: Optional[Callable[[str], Any]] = None,
        embedding_cache: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        max_queue: int = 64,
        batch_buckets: Optional[Sequence[int]] = None,
        readback_dtype: Optional[str] = None,
    ):
        """`batch_buckets`: ascending batch sizes a partial batch rounds up
        to (default: only `batch_size`). `readback_dtype`: cast results to
        this dtype on the device before the copy to the host (lossy by one
        rounding)."""
        self.pipe = pipe
        self.device = pipe.device
        self.batch_size = int(batch_size)
        if batch_buckets is None:
            self.batch_buckets = (self.batch_size,)
        else:
            bb = sorted({int(b) for b in batch_buckets} | {self.batch_size})
            if bb[0] < 1 or bb[-1] != self.batch_size:
                raise ValueError(
                    f"batch_buckets {batch_buckets} must be in [1, "
                    f"batch_size={self.batch_size}]"
                )
            self.batch_buckets = tuple(bb)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.call_kwargs = dict(call_kwargs or {})
        self.call_kwargs.pop("seed", None)  # per request, via latents=
        self.cond_fn = cond_fn or make_cond_fn(pipe, embedding_cache)
        self._noise_shape = latent_shape(pipe, self.call_kwargs)
        bf16 = denoiser_of(pipe).cfg.dtype == torch.bfloat16
        self._cond_dtype = torch.bfloat16 if bf16 else None
        self._uncond = None
        gs = self.call_kwargs.get("guidance_scale", 1.0)
        if gs is not None and gs > 1.0:
            self._uncond = _to_device(
                self.cond_fn(negative_prompt or ""), self.device, self._cond_dtype
            )
        self._readback_dtype = (
            getattr(torch, readback_dtype) if readback_dtype is not None else None
        )
        self.stats = ServeStats()
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(max_queue)))
        self._resolve_q: queue.Queue = queue.Queue(maxsize=4)
        self._last_done: Optional[float] = None  # resolver thread only
        self._closed = threading.Event()
        self._resolver = threading.Thread(
            target=self._resolve_loop, name="tdm-serve-resolver", daemon=True
        )
        self._resolver.start()
        self._worker = threading.Thread(
            target=self._run_loop, name="tdm-serve-batcher", daemon=True
        )
        self._worker.start()

    # ---- client side ----

    def submit(
        self,
        prompt: Optional[str] = None,
        *,
        cond: Any = None,
        negative_prompt: Optional[str] = None,
        seed: int = 0,
    ) -> Future:
        """Enqueue one request. `cond` (batch-1 (embeds, mask)) bypasses the
        cache lookup; `negative_prompt` overrides the server-wide negative
        conditioning when the server runs with guidance_scale > 1."""
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        if self._q.full():
            self.stats.rejected += 1
            raise Overloaded(f"pending queue full ({self._q.maxsize} requests) — retry")
        if cond is None:
            if prompt is None:
                raise ValueError("need prompt or cond")
            cond = self.cond_fn(prompt)
        cond = _to_device(cond, self.device, self._cond_dtype)
        self.stats.upload_bytes += _tree_nbytes(cond)
        uncond = None
        if negative_prompt is not None and self._uncond is not None:
            uncond = _to_device(
                self.cond_fn(negative_prompt), self.device, self._cond_dtype
            )
            self.stats.upload_bytes += _tree_nbytes(uncond)
        noise = request_noise(seed, self._noise_shape).to(self.device)
        pend = _Pending(cond=cond, noise=noise, uncond=uncond)
        try:
            self._q.put_nowait(pend)
        except queue.Full:
            self.stats.rejected += 1
            raise Overloaded(
                f"pending queue full ({self._q.maxsize} requests) — retry"
            ) from None
        # close() may have finished its drain between the check above and
        # the put: fail what is left rather than orphan it (the None wake
        # sentinel goes back for a worker blocked in _collect)
        if self._closed.is_set():
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    try:
                        self._q.put_nowait(None)
                    except queue.Full:
                        pass
                    break
                if not item.future.done():
                    item.future.set_exception(RuntimeError("batcher closed"))
        return pend.future

    def warm(self, prompt: str = "", *, cond: Any = None, timeout: float = 3600.0) -> None:
        """Run one full batch of every bucket size before traffic (largest
        first), so the first request meets built kernels and warm caches.
        The rows are enqueued back to back under a widened collect window,
        so the worker cannot split them."""
        if cond is None:
            cond = self.cond_fn(prompt)
        cond = _to_device(cond, self.device, self._cond_dtype)
        noise = request_noise(0, self._noise_shape).to(self.device)
        old_delay = self.max_delay_s
        self.max_delay_s = max(old_delay, 2.0)
        try:
            for bucket in sorted(self.batch_buckets, reverse=True):
                rows = [_Pending(cond=cond, noise=noise) for _ in range(bucket)]
                for r in rows:
                    self._q.put(r)
                for r in rows:
                    r.future.result(timeout=timeout)
        finally:
            self.max_delay_s = old_delay

    def close(self, *, timeout: float = 30.0) -> None:
        self._closed.set()
        try:
            self._q.put_nowait(None)  # wake the worker
        except queue.Full:
            pass  # the queue has items: the worker is awake and sees _closed
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            # a batch is still running: its results must not be cut off by
            # the resolver's sentinel (both threads are daemons)
            return
        try:
            self._resolve_q.put(None, timeout=timeout)
        except queue.Full:
            return  # resolver wedged mid-readback; abandon (daemon thread)
        self._resolver.join(timeout=timeout)

    # ---- worker side ----

    def _collect(self) -> list[_Pending]:
        """One batch: block for the first request, then fill until
        batch_size or the collect window closes."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_delay_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _run_loop(self) -> None:
        while not self._closed.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # surface to every caller, keep serving
                self.stats.failures += len(batch)
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
        while True:  # fail anything still queued after close()
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(RuntimeError("batcher closed"))

    def _run_batch(self, batch: list[_Pending]) -> None:
        n = len(batch)
        bucket = next(b for b in self.batch_buckets if b >= n)
        pad = bucket - n
        rows = batch + [batch[-1]] * pad  # padded rows repeat the last one
        cond = _cat_rows([p.cond for p in rows])
        noise = torch.cat([p.noise for p in rows], dim=0)
        uncond = None
        if self._uncond is not None:
            uncond = _cat_rows(
                [p.uncond if p.uncond is not None else self._uncond for p in rows])
        t0 = time.monotonic()
        out = self.pipe(
            prompt_embeds=cond, negative_embeds=uncond, latents=noise, **self.call_kwargs
        )
        result = out.images if out.images is not None else out.latents
        if self._readback_dtype is not None:
            result = result.to(self._readback_dtype)
        # the copy to the host happens on the resolver thread, overlapping
        # the next batch (the queue bound caps results in flight)
        self._resolve_q.put((batch, result, t0, pad))

    def _resolve_loop(self) -> None:
        while True:
            item = self._resolve_q.get()
            if item is None:
                return
            batch, result_dev, t0, pad = item
            try:
                t_rb = time.monotonic()
                host = result_dev.cpu()  # waits for the batch's device work
                result = host.float().numpy()
                self.stats.readback_s += time.monotonic() - t_rb
                self.stats.readback_bytes += host.numel() * host.element_size()
                now = time.monotonic()
                self.stats.last_batch_latency_s = now - t0
                if self._last_done is not None:
                    self.stats.last_batch_period_s = now - self._last_done
                self._last_done = now
                self.stats.requests += len(batch)
                self.stats.batches += 1
                self.stats.rows_padded += pad
                shape = len(batch) + pad
                self.stats.batches_by_shape[shape] = (
                    self.stats.batches_by_shape.get(shape, 0) + 1
                )
                for i, p in enumerate(batch):
                    p.future.set_result(result[i])
            except Exception as e:  # asynchronous device errors surface here
                self.stats.failures += len(batch)
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
