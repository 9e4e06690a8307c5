#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed 0]

Phases, one line each, and any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel under tdm_tpu_torch/csrc compiled with nvcc for
     sm_90a, one nvcc per source, all started together;
  3. kernels: each kernel held against its plain PyTorch version on the
     card at the main path's shapes (and a sweep of head dims), with its
     time, the plain version's, one PyTorch library call's and the bound;
  4. reference: the tiny pipeline on the card (kernel) against the same
     pipeline on the CPU (plain attention);
  5. serve: a full-width PixArt-α-512 pipeline (28 layers, seeded random
     weights) written with the port's writer, served over HTTP by
     TDMServer: 6 concurrent requests (two batches of 4, one padded), PNG
     checks, per-seed determinism and the kernel launch count per batch;
     then one full-width forward with the kernel against plain attention.
Then a JSON line of per-kernel numbers, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import base64
import json
import math
import os
import subprocess
import sys
import time
import zlib

# H100 SXM dense peaks (NVIDIA data sheet), for the bound of each kernel
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

# PixArt-α-512 attention shapes at serving batch 4
PIX_B, PIX_H, PIX_S, PIX_D, PIX_TXT = 4, 16, 1024, 72, 120
# bf16, per batch row (all masked: exactly 0): relative L2 error under
# BF16_REL_L2 and max |kernel - plain| under BF16_ULPS bf16 ulps of the row's
# largest |plain|. Both versions round the output to bf16 (half an ulp) and
# round p to bf16 at different points (unnormalised in the kernel,
# normalised in the plain version), a relative L2 of a few 1e-3 at most; a
# wrong rescale or a dropped key shows as more.
BF16_REL_L2, BF16_ULPS = 1e-2, 4
# fp32, elementwise |kernel - plain| <= atol + rtol·|plain|: the same sums
# in another order.
F32_TOL = (2e-5, 2e-5)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch) -> dict:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | sm_{cap[0]}{cap[1]} | "
          f"count {torch.cuda.device_count()}", flush=True)
    check(cap == (9, 0), f"kernels target sm_90a, card is sm_{cap[0]}{cap[1]}")
    # the plain references run in full fp32 (section 6 of the kernel guide)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"smi": smi, "kind": kind}


def phase_build() -> None:
    from tdm_tpu_torch.ops import _build

    names = _build.kernel_names()
    t0 = time.monotonic()
    _build.build(names)
    secs = time.monotonic() - t0
    regs = []
    for n in names:
        log = _build.build_log.get(n, {}).get("ptxas", "")
        regs += [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"[build] {names} in {secs:.1f}s (nvcc sm_90a)", flush=True)
    for ln in regs:
        print(f"[build]   ptxas: {ln}", flush=True)


def _attn_inputs(torch, gen, b, h, sq, sk, d, dtype, lengths):
    from tdm_tpu_torch.ops import attention as A

    dev = "cuda"
    q = torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, h, sk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, h, sk, d, generator=gen, device=dev).to(dtype)
    mask = None
    if lengths is not None:
        mask = (torch.arange(sk, device=dev)[None, :]
                < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
    qs = (q.float() / d ** 0.5).to(dtype)
    bias = None if mask is None else A.key_bias(mask)
    return q, k, v, mask, qs, bias


def attention_work(b, h, sq, sk, d, item_bytes, live_keys):
    """(bytes, operations) the function needs at this run's mask: q read and
    the output written once, k and v read once for each unmasked key, the
    key bias read once; 4·d operations (two multiply-adds) per (query,
    unmasked key) pair. `live_keys` is the unmasked keys summed over the
    batch."""
    nbytes = item_bytes * h * d * (2 * b * sq + 2 * live_keys) + 4 * b * sk
    return nbytes, 4 * h * sq * d * live_keys


def bound_ms(nbytes, ops, dtype_name="bfloat16"):
    """Least time on the card: the larger of bytes over the memory rate and
    operations over the dtype's peak. Returns (ms, bound_by)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype_name] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def compare(torch, out, ref) -> tuple:
    """(max_abs_err, rel_l2, failure or None) of the kernel's output
    against the plain version's, by the tolerance of out's dtype."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    rel = (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()
    if out.dtype == torch.float32:
        excess = (diff - F32_TOL[0] - F32_TOL[1] * ref.float().abs()).max().item()
        if excess > 0:
            return err, rel, (f"max_abs_err {err:.3e} outside atol {F32_TOL[0]} "
                              f"+ rtol {F32_TOL[1]}·|plain|")
        return err, rel, None
    for i in range(out.shape[0]):
        o, r = out[i].float(), ref[i].float()
        top = r.abs().max().item()
        if top == 0:
            if bool((o != 0).any()):
                return err, rel, f"row {i}: all keys masked but output not 0"
            continue
        row_rel = ((o - r).norm() / r.norm()).item()
        row_err = (o - r).abs().max().item()
        if row_rel > BF16_REL_L2 or row_err > BF16_ULPS * bf16_ulp(top):
            return err, rel, (
                f"row {i}: rel L2 {row_rel:.3e} (limit {BF16_REL_L2}), max_abs_err "
                f"{row_err:.3e} (limit {BF16_ULPS} ulps of {top:.3g} = "
                f"{BF16_ULPS * bf16_ulp(top):.3e})")
    return err, rel, None


def phase_kernels(torch, seed: int) -> dict:
    """Hold the flash kernel against its plain version; time both, SDPA and
    the bound at the two PixArt shapes."""
    import torch.nn.functional as F

    from tdm_tpu_torch.ops import attention as A

    lib = A._library()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, b, h, sq, sk, d, dtype, lengths, timed
        ("self", PIX_B, PIX_H, PIX_S, PIX_S, PIX_D, bf16, None, True),
        ("cross", PIX_B, PIX_H, PIX_S, PIX_TXT, PIX_D, bf16,
         [120, 77, 13, 0], True),
        ("odd", 2, 3, 1000, 77, 64, f32, [77, 40], False),
    ]
    for d in (8, 16, 36, 64, 100, 128):
        for dtype in (bf16, f32):
            cases.append((f"sweep_d{d}_{str(dtype).split('.')[-1]}", 2, 2, 130,
                          70, d, dtype, [70, 33], False))
    shapes = []
    max_err = 0.0
    for name, b, h, sq, sk, d, dtype, lengths, timed in cases:
        q, k, v, mask, qs, bias = _attn_inputs(
            torch, gen, b, h, sq, sk, d, dtype, lengths)
        before = A.flash_attention_fwd.launches
        out = A.flash_attention_fwd(qs, k, v, bias)
        A.flash_attention_fwd.launches = before  # comparison launches do not count
        ref = A.plain_attention(qs, k, v, bias)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err, rel, bad = compare(torch, out, ref)
        tol = (f"per row rel L2 <= {BF16_REL_L2}, max_abs_err <= {BF16_ULPS} "
               f"bf16 ulps of max|plain|" if dtype == bf16 else
               f"atol {F32_TOL[0]:g} + rtol {F32_TOL[1]:g}·|plain|")
        print(f"[kernels] flash_fwd {name} [{b},{h},{sq},{sk},{d}] "
              f"{str(dtype).split('.')[-1]} max_abs_err {err:.3e} rel_l2 "
              f"{rel:.3e} ({tol})", flush=True)
        check(bad is None, f"{name}: {bad}")
        max_err = max(max_err, err)
        if not timed:
            continue
        stream = torch.cuda.current_stream().cuda_stream
        args = (qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                b, h, sq, sk, d, 1, int(d % 8 == 0), stream)
        ms = time_ms(torch, lambda: lib.tdm_flash_fwd(*args))
        plain_ms = time_ms(torch, lambda: A.plain_attention(qs, k, v, bias), 20)
        sdpa_mask = None if mask is None else mask.bool()[:, None, None, :]
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask), 50)
        live = sk * b if lengths is None else sum(lengths)
        nbytes, ops = attention_work(b, h, sq, sk, d, 2, live)
        bound, by = bound_ms(nbytes, ops)
        rec = {"shape": name, "dims": [b, h, sq, sk, d], "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "rel_l2": rel, "bytes": nbytes, "ops": ops}
        shapes.append(rec)
        print(f"[kernels] flash_fwd {name} ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} sdpa_ms {lib_ms:.4f} bound_ms {bound:.5f} "
              f"({by})", flush=True)
    return {"max_abs_err": max_err, "shapes": shapes}


def check_png(png: bytes, width: int, height: int) -> None:
    """A valid 8-bit RGB PNG of the given size: signature, chunk CRCs,
    IHDR, and an IDAT stream that inflates to one filter byte plus 3·width
    bytes per row."""
    check(png[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    pos, chunks = 8, {}
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        crc = int.from_bytes(png[pos + 8 + n:pos + 12 + n], "big")
        check(zlib.crc32(tag + data) & 0xFFFFFFFF == crc, f"PNG {tag} CRC")
        chunks[tag] = chunks.get(tag, b"") + data
        pos += 12 + n
    ihdr = chunks[b"IHDR"]
    w, h = int.from_bytes(ihdr[0:4], "big"), int.from_bytes(ihdr[4:8], "big")
    check((w, h, ihdr[8], ihdr[9]) == (width, height, 8, 2),
          f"PNG header {w}x{h} depth {ihdr[8]} color {ihdr[9]}")
    check(len(zlib.decompress(chunks[b"IDAT"])) == h * (1 + 3 * w), "PNG data size")
    check(b"IEND" in chunks, "PNG IEND")


def phase_reference(torch, seed: int) -> None:
    """The whole tiny pipeline (fp32, attention through the kernel) on the
    card against the same pipeline on the CPU (plain attention): the
    sampler state is bf16 in both, so the latents agree to one bf16 ulp of
    their scale and the images to half a PNG step."""
    import numpy as np

    from tdm_tpu_torch.models import pixart, vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import PixArtPipeline

    torch.manual_seed(seed)
    cpu = PixArtPipeline(
        pixart.PixArtTransformer2D(pixart.PixArtConfig.tiny(), device="cpu"),
        vae_decoder=vae.TAESDDecoder(vae.TAESDConfig(width=16), device="cpu"),
        device="cpu",
    )
    gpu = PixArtPipeline(
        pixart.PixArtTransformer2D(pixart.PixArtConfig.tiny(), device="cuda"),
        vae_decoder=vae.TAESDDecoder(vae.TAESDConfig(width=16), device="cuda"),
        device="cuda",
    )
    gpu.transformer.load_state_dict(cpu.transformer.state_dict())
    gpu.vae_decoder.load_state_dict(cpu.vae_decoder.state_dict())
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
    text = rng.standard_normal((3, 120, 32)).astype(np.float32)
    mask = (np.arange(120)[None] < np.array([[120], [7], [0]])).astype(np.int32)
    kw = dict(prompt_embeds=(text, mask), latents=lat, height=128, width=128)
    ref = cpu(**kw)
    before = A.flash_attention_fwd.launches
    got = gpu(**kw)
    torch.cuda.synchronize()
    launched = A.flash_attention_fwd.launches - before
    A.flash_attention_fwd.launches = before  # a check, not the main path
    dl = (got.latents.float().cpu() - ref.latents.float()).abs()
    scale = ref.latents.float().abs().max().item()
    di = (got.images.cpu() - ref.images).abs().max().item()
    print(f"[reference] tiny pipeline cuda (kernel, {launched} launches) vs "
          f"cpu (plain): latents max_abs_err {dl.max().item():.3e} of scale "
          f"{scale:.3g}, {(dl > 0).float().mean().item():.4f} of elements "
          f"differ; images max_abs_err {di:.3e}", flush=True)
    check(launched == 2 * 2 * 4, f"tiny pipeline launched the kernel {launched}x")
    check(dl.max().item() <= 2**-7 * scale, "tiny pipeline latents disagree")
    check((dl > 0).float().mean().item() < 0.01, "tiny pipeline latents disagree")
    check(di <= 2e-3, "tiny pipeline images disagree")


def phase_serve(torch, seed: int, workdir: str) -> dict:
    """Full-width PixArt-α-512 served over HTTP through the port."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    import urllib.request

    from tdm_tpu_torch.data.prompts import EmbeddingCache
    from tdm_tpu_torch.models import pixart, vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import PixArtPipeline, save_pretrained
    from tdm_tpu_torch.serve import server as S

    # a full-width pipeline (28 layers, hidden 1152, 16x72 heads, caption
    # 4096, TAESD width 64, bf16) with weights from the seed, written in the
    # tdm_tpu layout with the port's own writer
    t0 = time.monotonic()
    torch.manual_seed(seed)
    cfg = pixart.PixArtConfig()
    check((cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.head_dim, cfg.caption_dim)
          == (28, 1152, 16, 72, 4096), "PixArt-α-512 widths")
    pipe = PixArtPipeline(
        pixart.PixArtTransformer2D(cfg, device="cuda"),
        vae_decoder=vae.TAESDDecoder(vae.TAESDConfig(dtype=torch.bfloat16), device="cuda"),
        device="cuda",
    )
    n_params = sum(p.numel() for p in pipe.transformer.parameters())
    model_dir = os.path.join(workdir, "pixart_alpha_512")
    save_pretrained(model_dir, pipe)
    del pipe
    torch.cuda.empty_cache()
    # an embedding cache of 8 prompts with ragged T5 masks (120 tokens)
    rng = np.random.default_rng(seed)
    prompts = [f"prompt {i}" for i in range(8)]
    lengths = np.array([120, 77, 33, 9, 120, 1, 56, 100])
    cache = os.path.join(workdir, "cache.npz")
    EmbeddingCache(
        rng.standard_normal((8, 120, 4096)).astype(np.float16),
        (np.arange(120)[None] < lengths[:, None]).astype(np.int32), prompts,
        uncond_embed=np.zeros((120, 4096), np.float16),
        uncond_mask=np.zeros(120, np.int32),
    ).save(cache)
    print(f"[serve] wrote PixArt-α-512 ({n_params / 1e6:.1f}M params) and an "
          f"8-prompt cache in {time.monotonic() - t0:.1f}s", flush=True)

    t0 = time.monotonic()
    args = S.parse_args([
        "--model", model_dir, "--embedding_cache", cache, "--port", "0",
        "--batch_size", "4", "--max_delay_ms", "1000", "--warmup",
    ])
    server = S.build_server(args).start()
    stats = server.batcher.stats
    print(f"[serve] loaded and warmed in {time.monotonic() - t0:.1f}s "
          f"(warm-up batch {stats.last_batch_latency_s:.3f}s)", flush=True)

    def post(prompt, seed):
        body = json.dumps({"prompt": prompt, "seed": seed}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        t = time.monotonic()
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, time.monotonic() - t

    try:
        # the main path: counts to 0, 6 concurrent requests (one full batch
        # and one padded), then one request alone for determinism
        A.flash_attention_fwd.launches = 0
        b0, pad0 = stats.batches, stats.rows_padded
        t0 = time.monotonic()
        with ThreadPoolExecutor(6) as ex:
            replies = list(ex.map(lambda i: post(prompts[i], 100 + i), range(6)))
        wall6 = time.monotonic() - t0
        batches6 = stats.batches - b0
        solo, solo_s = post(prompts[0], 100)
        launches = A.flash_attention_fwd.launches
        batches = stats.batches - b0
        solo_batch_s = stats.last_batch_latency_s
    finally:
        server.close()
    pipe = server.batcher.pipe
    cond = tuple(np.concatenate([x] * 4) for x in server.batcher.cond_fn(prompts[1]))
    prof = profile_batch(torch, pipe, cond, torch.randn(4, 4, 64, 64))
    full_forward_check(torch, pipe.transformer, seed)
    for reply, _ in replies + [(solo, solo_s)]:
        check(reply.get("format") == "png" and reply.get("shape") == [512, 512, 3],
              f"reply {str(reply)[:200]}")
        check_png(base64.b64decode(reply["image"]), 512, 512)
    check(batches6 == 2 and stats.rows_padded - pad0 == 2 + 3,
          f"6 requests ran as {batches6} batches")
    check(solo["image"] == replies[0][0]["image"],
          "same (prompt, seed) gave different bytes in another batch")
    check(len({r["image"] for r, _ in replies}) == 6, "distinct seeds gave equal images")
    per_batch = 28 * 2 * 4
    check(launches == per_batch * batches,
          f"flash_fwd launched {launches}x over {batches} batches, "
          f"expected {per_batch} per batch")
    lat = [s for _, s in replies]
    print(f"[serve] 6 concurrent requests in {wall6:.3f}s as {batches6} "
          f"batches ({6 / wall6:.2f} images/s), request latency "
          f"{min(lat):.3f}-{max(lat):.3f}s; lone request {solo_s:.3f}s, its "
          f"batch {solo_batch_s:.3f}s; same (prompt, seed) -> same PNG bytes; "
          f"flash_fwd launches {launches} = {per_batch} x {batches} batches",
          flush=True)
    return {"launches": launches, "batches": batches, "wall6_s": wall6,
            "images_per_s": 6 / wall6, "batch_s": solo_batch_s, "profile": prof}


def profile_batch(torch, pipe, cond, noise) -> dict:
    """Device time of one full batch (4 NFE + decode) by kernel, from
    torch.profiler's CUDA activity: busy time, the flash kernel's share and
    the device's idle share of the batch's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        pipe(prompt_embeds=cond, latents=noise).images.cpu()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("[profile] no device time in the trace: not measured", flush=True)
        return {}
    flash_ms = sum(e.device_time_total for e in kernels if "flash_fwd" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    print(f"[profile] one batch of 4: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"flash_fwd {flash_ms:.1f} ms ({flash_ms / busy_ms:.3f} of busy), "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    for e in top:
        print(f"[profile]   {e.device_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "flash_ms": flash_ms}


def full_forward_check(torch, transformer, seed: int) -> None:
    """One full-width forward of the served model with the kernel against
    the same forward with the plain attention, both on the card: bf16
    activations through 28 layers, so the check is relative (L2 error
    under 2%)."""
    import functools

    import numpy as np

    from tdm_tpu_torch.models import layers
    from tdm_tpu_torch.ops import attention as A

    rng = np.random.default_rng(seed + 1)
    lat = torch.from_numpy(rng.standard_normal((4, 4, 64, 64)).astype(np.float32)).cuda()
    text = torch.from_numpy(rng.standard_normal((4, 120, 4096)).astype(np.float32)).cuda()
    mask = (torch.arange(120)[None] < torch.tensor([[120], [40], [3], [0]])).int().cuda()
    t = torch.tensor([899, 674, 449, 224], device="cuda")
    before = A.flash_attention_fwd.launches
    kernel_attention = layers.fused_attention
    with torch.inference_mode():
        out = transformer(lat, t, text, mask).float()
        # the same forward with every Attention's call made plain, here only
        layers.fused_attention = functools.partial(kernel_attention, impl="plain")
        try:
            ref = transformer(lat, t, text, mask).float()
        finally:
            layers.fused_attention = kernel_attention
    A.flash_attention_fwd.launches = before
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"[check] full-width forward, kernel vs plain attention: rel L2 "
          f"{rel:.3e}, finite {bool(torch.isfinite(out).all())}", flush=True)
    check(bool(torch.isfinite(out).all()) and rel < 2e-2,
          f"full-width forward disagrees: rel L2 {rel}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    workdir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        dev = phase_device(torch)
        phase_build()
        kern = phase_kernels(torch, args.seed)
        phase_reference(torch, args.seed)
        serve = phase_serve(torch, args.seed, workdir)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    self_, cross = kern["shapes"]
    nbytes, ops = self_["bytes"] + cross["bytes"], self_["ops"] + cross["ops"]
    pair_bound, pair_by = bound_ms(nbytes, ops)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tdm_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "tdm_tpu/ops/attention.py:291",
        "launches": serve["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": self_["ms"] + cross["ms"],
        "plain_ms": self_["plain_ms"] + cross["plain_ms"],
        "bound_ms": pair_bound,
        "bound_by": pair_by,
        "library_ms": self_["library_ms"] + cross["library_ms"],
        "per": "one PixArt block at batch 4: one self-attention call "
               "[4,16,1024,1024,72] + one cross-attention call "
               "[4,16,1024,120,72] (bf16); library = SDPA",
        "shapes": [{k: r[k] for k in ("shape", "dims", "ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by",
                                      "max_abs_err", "rel_l2")}
                   for r in kern["shapes"]],
    }], "serve": serve}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
