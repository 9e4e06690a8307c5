#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed 0]

Phases, one line each, and any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel under tdm_tpu_torch/csrc compiled with nvcc for
     sm_90a, one nvcc per source, all started together; each kernel's
     registers, spills and shared memory (ptxas) and its HGMMA (wgmma) and
     HMMA (mma.sync) instructions (cuobjdump -sass), with a check that the
     bf16 kernels of all four libraries (the forwards of kernels 1 and 4,
     dQ and dK/dV) run on wgmma and hold no mma.sync, and that the backward
     ones spill nothing;
  3. kernels: each kernel held against its plain PyTorch version on the
     card at the main path's shapes (and a sweep of head dims), with its
     time and one PyTorch library call's in turns (6 rounds of 50
     launches; median, min and max), the plain version's and the bound;
  4. reference: the tiny pipeline on the card (kernel) against the same
     pipeline on the CPU (plain attention);
  5. serve: a full-width PixArt-α-512 pipeline (28 layers, seeded random
     weights) written with the port's writer, served over HTTP by
     TDMServer: 6 concurrent requests (two batches of 4, one padded), PNG
     checks, per-seed determinism and the kernel launch count per batch;
     then one full-width forward with the kernel against plain attention;
  6. train: full-width PixArt-α-512 TDM distillation through the training
     CLI's main() (seeded weights and embedding cache, batch 4, bf16, dmd,
     3 steps): seconds per step, peak memory, the idle share of a step,
     and each training kernel's launches per step (checked);
  7. sd3: a full-width SD3-Medium pipeline (24 layers, 24x64 heads, 1024²,
     bf16, seeded weights, attn_impl='splash') with a seeded rank-64 kohya
     LoRA on the default targets, written in the tdm_tpu layout and served
     over HTTP with --lora_scale 0.125: 8 concurrent requests (two batches
     of 4), exactly 96 splash-kernel launches and no flash launch per batch,
     per-seed determinism, a profiled batch, and one full-width forward
     through the splash kernel against the same forward through the flash
     kernel.
Phase 3 also holds the training kernels (the forward with its lse, dQ with
its fused Δ, dK/dV) and the splash kernel (SD3's [4,24,4429,4429,64], ragged fp32
shapes, rows whose logits are all below -20) against their plain versions;
phase 4 runs one tiny train step and a tiny SD3 pipeline with a merged LoRA
on the card against the same on the CPU. Then a JSON line of per-kernel
numbers, the nvidia-smi line, and as the last line {"ok": true, "device":
{...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import zlib

# H100 SXM dense peaks (NVIDIA data sheet), for the bound of each kernel
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

# PixArt-α-512 attention shapes at serving batch 4
PIX_B, PIX_H, PIX_S, PIX_D, PIX_TXT = 4, 16, 1024, 72, 120
# SD3-Medium 1024² joint attention at serving batch 4: 4096 image + 333 text
# tokens (77 CLIP + 256 T5)
SD3_B, SD3_H, SD3_TXT, SD3_D = 4, 24, 333, 64
SD3_S = 4096 + SD3_TXT
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
# the lse of a row with live keys, fp32, kernel against plain: the same
# logits, exp by __expf or expf, the sums in another order
LSE_TOL = 1e-4
# fp32 gradients through the kernels against autograd of plain_attention,
# relative to each tensor's largest magnitude: the same sums in another order
GRAD_TOL = 1e-4
# the dQ kernel's Δ = rowsum(dO∘O) against attention_delta, relative to the
# largest |Δ|: fp32 sums of the same products in another order
DELTA_TOL = 1e-5


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


def time_turns(torch, fns: dict, rounds: int = 6, iters: int = 50) -> dict:
    """Time each callable of `fns` in turns: `rounds` rounds of `iters`
    launches each (CUDA-event mean per launch), the order reversed every
    other round (a, b, b, a, ...), after a warm-up of each. Returns, per
    name, the median, min and max of the rounds' means: a library call's
    time moves between calls, so one reading is no yardstick."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    runs = {name: [] for name in fns}
    for r in range(rounds):
        for name, fn in (list(fns.items()) if r % 2 == 0 else reversed(list(fns.items()))):
            runs[name].append(time_ms(torch, fn, iters, 0))
    return {name: {"median": statistics.median(v), "min": min(v), "max": max(v)}
            for name, v in runs.items()}


def spread(t: dict) -> str:
    return f"{t['median']:.4f} ms (min {t['min']:.4f}, max {t['max']:.4f})"


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


def _short_name(mangled: str) -> str:
    """`flash_fwd_sm90_kernel<80,1>` from the mangled name of a kernel
    template instance (its length-prefixed name, then the integer and bool
    template arguments)."""
    for m in re.finditer(r"(\d+)([A-Za-z_])", mangled):
        start, n = m.start(2), int(m.group(1))
        name = mangled[start:start + n]
        if name.endswith("_kernel") and mangled[start + n:start + n + 1] == "I":
            args = mangled[start + n + 1:].split("EE", 1)[0] + "E"
            return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', args))}>"
    return mangled


def _cuobjdump() -> str | None:
    import importlib.util

    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "cuobjdump"))
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        cands.append(os.path.join(spec.submodule_search_locations[0], "backends",
                                  "nvidia", "bin", "cuobjdump"))
    return next((c for c in cands if c and os.path.exists(c)), None)


def kernel_resources(libs: dict) -> dict:
    """Per kernel of each built library: registers, spill bytes and static
    shared memory from nvcc's -Xptxas -v report (this run's build log), and
    its HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS that
    cuobjdump -sass shows."""
    from tdm_tpu_torch.ops import _build

    tool = _cuobjdump()
    out = {}
    for name, path in libs.items():
        funcs = {}
        cur = None
        for ln in _build.build_log.get(name, {}).get("ptxas", "").splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
            if m:
                cur = funcs.setdefault(_short_name(m.group(1)), {})
            elif cur is not None and "spill stores" in ln:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
                cur.update(spill_stores=int(st), spill_loads=int(ld))
            elif cur is not None and "registers" in ln:
                cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
                smem = re.search(r"(\d+) bytes smem", ln)
                cur["static_smem"] = int(smem.group(1)) if smem else 0
        if tool:
            sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                                  text=True, timeout=120).stdout
            cur = None
            for ln in sass.splitlines():
                m = re.search(r"Function : (\w+)", ln)
                if m:
                    cur = funcs.setdefault(_short_name(m.group(1)), {})
                    cur.update(hgmma=0, hmma=0)
                elif cur is not None:
                    cur["hgmma"] += "HGMMA." in ln
                    cur["hmma"] += " HMMA." in ln
        out[name] = funcs
    return out


def phase_build() -> dict:
    """Build every kernel; print each kernel's registers, spills, shared
    memory and wgmma/mma.sync instruction counts; check that the bf16
    kernels of kernels 1-4 run on wgmma, that no mma.sync is left in their
    libraries and that the backward's bf16 kernels spill nothing."""
    import ctypes

    from tdm_tpu_torch.ops import _build

    names = _build.kernel_names()
    # a fresh build: ptxas reports registers and spills only while compiling
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.monotonic()
    libs = _build.build(names)
    secs = time.monotonic() - t0
    print(f"[build] {names} in {secs:.1f}s (nvcc sm_90a)", flush=True)
    res = kernel_resources(libs)
    for lib, funcs in res.items():
        for fn, r in funcs.items():
            print(f"[build]   {lib}: {fn} registers {r.get('registers', 'n/a')} spill "
                  f"{r.get('spill_stores', 'n/a')}/{r.get('spill_loads', 'n/a')} B static "
                  f"smem {r.get('static_smem', 'n/a')} B HGMMA {r.get('hgmma', 'n/a')} "
                  f"HMMA {r.get('hmma', 'n/a')}", flush=True)
    for lib in ("flash_fwd", "splash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        sm90 = {fn: r for fn, r in res[lib].items() if "sm90_kernel" in fn}
        check(bool(sm90) and all(r.get("hgmma", 0) > 0 for r in sm90.values()),
              f"{lib}: a bf16 kernel without HGMMA (wgmma) in its SASS: {sm90}")
        check(all(r.get("hmma", 0) == 0 for r in res[lib].values()),
              f"{lib}: mma.sync (HMMA) left in the library")
        if lib.startswith("flash_bwd"):
            check(all("spill_stores" in r and "spill_loads" in r for r in sm90.values()),
                  f"{lib}: ptxas reported no spills for a bf16 kernel: {sm90}")
            check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                      for r in sm90.values()), f"{lib}: a bf16 kernel spills: {sm90}")
    smem = {}
    for lib, fn_name, keys in (
            ("flash_fwd", "tdm_attn_fwd_smem_bytes", ((64,), (80,), (128,))),
            ("splash_fwd", "tdm_attn_fwd_smem_bytes", ((64,), (128,))),
            ("flash_bwd_dq", "tdm_flash_bwd_dq_smem_bytes", ((64,), (80,), (128,))),
            ("flash_bwd_dkv", "tdm_flash_bwd_dkv_smem_bytes",
             tuple((d, g) for d in (64, 80, 128) for g in (1, 2)))):
        fn = getattr(ctypes.CDLL(str(libs[lib])), fn_name)
        smem[lib] = {"/".join(map(str, key)): fn(*key) for key in keys}
        print(f"[build]   {lib}: dynamic shared memory per CTA by head dim"
              f"{' / consumer warpgroups' if lib == 'flash_bwd_dkv' else ''} {smem[lib]} B",
              flush=True)
    return {"resources": res, "dynamic_smem": smem}


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


def attention_work(b, h, sq, sk, d, item_bytes, live_keys, bias=True):
    """(bytes, operations) the function needs at this run's mask: q read and
    the output written once, k and v read once for each unmasked key, the
    key bias read once (when the kernel takes one); 4·d operations (two
    multiply-adds) per (query, unmasked key) pair. `live_keys` is the
    unmasked keys summed over the batch."""
    nbytes = item_bytes * h * d * (2 * b * sq + 2 * live_keys) + (4 * b * sk if bias else 0)
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

    fwd, _ = A._entry("tdm_flash_fwd")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, b, h, sq, sk, d, dtype, lengths, timed
        ("self", PIX_B, PIX_H, PIX_S, PIX_S, PIX_D, bf16, None, True),
        ("cross", PIX_B, PIX_H, PIX_S, PIX_TXT, PIX_D, bf16,
         [120, 77, 13, 0], True),
        ("odd", 2, 3, 1000, 77, 64, f32, [77, 40], False),
        ("odd_bf16", 2, 3, 1000, 77, 64, bf16, [77, 0], False),
        ("odd_d72_bf16", 3, 2, 333, 200, 72, bf16, [200, 129, 1], False),
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
                None if bias is None else bias.data_ptr(), out.data_ptr(), None,
                b, h, sq, sk, d, 1, stream)
        sdpa_mask = None if mask is None else mask.bool()[:, None, None, :]
        turns = time_turns(torch, {
            "kernel": lambda: fwd(*args),
            "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)})
        ms, lib_ms = turns["kernel"]["median"], turns["sdpa"]["median"]
        plain_ms = time_ms(torch, lambda: A.plain_attention(qs, k, v, bias), 20)
        live = sk * b if lengths is None else sum(lengths)
        nbytes, ops = attention_work(b, h, sq, sk, d, 2, live)
        bound, by = bound_ms(nbytes, ops)
        rec = {"shape": name, "dims": [b, h, sq, sk, d], "ms": ms,
               "ms_range": [turns["kernel"]["min"], turns["kernel"]["max"]],
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_ms_range": [turns["sdpa"]["min"], turns["sdpa"]["max"]],
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "rel_l2": rel, "bytes": nbytes, "ops": ops}
        shapes.append(rec)
        print(f"[kernels] flash_fwd {name} in turns with SDPA: kernel "
              f"{spread(turns['kernel'])} ({ms / bound:.1f}x bound, {ms / lib_ms:.2f}x "
              f"SDPA) | sdpa {spread(turns['sdpa'])} | plain_ms {plain_ms:.4f} | "
              f"bound_ms {bound:.5f} ({by})", flush=True)
    return {"max_abs_err": max_err, "shapes": shapes}


def attention_bwd_work(kernel, b, h, sq, sk, d, item_bytes, live_keys):
    """(bytes, operations) of one training kernel at this run's mask, each
    input read once and each output written once. `live_keys` is the
    unmasked keys summed over the batch; K and V are read for those keys
    only, and the products are counted per (query, unmasked key) pair:
      fwd_lse: q read, out written, K/V read, bias read, lse written;
               2 products (S, P·V) = 4·d operations per pair;
      dq:      q, dO and O read, dQ written, K/V read, lse read, Δ written,
               bias read; 3 products (S, dP, dS·K) = 6·d per pair (Δ's
               d multiply-adds per row are left out);
      dkv:     q, dO read, K/V read, dK and dV written in full, lse and Δ
               read, bias read; 4 products (S, Pᵀ·dO, dP, dSᵀ·Q) = 8·d."""
    rows = item_bytes * h * d * b * sq  # one [B,H,Sq,D] tensor
    kv = item_bytes * h * d * live_keys  # K or V over the unmasked keys
    full_k = item_bytes * h * d * b * sk
    row_f32 = 4 * b * h * sq  # lse or Δ
    bias = 4 * b * sk
    if kernel == "fwd_lse":
        return 2 * rows + 2 * kv + bias + row_f32, 4 * h * sq * d * live_keys
    if kernel == "dq":
        return 4 * rows + 2 * kv + 2 * row_f32 + bias, 6 * h * sq * d * live_keys
    if kernel == "dkv":
        return (2 * rows + 2 * kv + 2 * full_k + 2 * row_f32 + bias,
                8 * h * sq * d * live_keys)
    raise ValueError(kernel)


def compare_grad(torch, got, ref) -> tuple:
    """compare() for a gradient: bf16 by the same per-row rule; fp32 with
    max |kernel - plain| <= GRAD_TOL of the largest |plain| (a gradient is a
    sum of terms that cancel, so elementwise relative error means little)."""
    if got.dtype != torch.float32:
        return compare(torch, got, ref)
    diff = (got - ref).abs()
    err = diff.max().item()
    rel = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    top = ref.abs().max().item()
    if err > GRAD_TOL * top:
        return err, rel, f"max_abs_err {err:.3e} above {GRAD_TOL} of {top:.3e}"
    return err, rel, None


def compare_lse(torch, got, ref) -> tuple:
    """(max_abs_err, failure or None) of the kernel's lse against the plain
    version's: rows of an all-masked batch row hold exactly +1e30, the rest
    agree to LSE_TOL (fp32 logsumexp of the same logits, __expf and another
    order of sums)."""
    masked = ref >= 1e29
    if bool((got[masked] != ref[masked]).any()):
        return float("inf"), "an all-masked row's lse is not +1e30"
    if bool(masked.all()):
        return 0.0, None
    err = (got[~masked] - ref[~masked]).abs().max().item()
    if err > LSE_TOL:
        return err, f"lse max_abs_err {err:.3e} above {LSE_TOL}"
    return err, None


def phase_kernels_train(torch, seed: int) -> dict:
    """The training kernels (forward with lse, dQ with its fused Δ, dK/dV)
    against their plain versions at the training shapes and a sweep, the fp32
    gradients of FlashAttention against autograd of plain_attention, exact
    zeros on all-masked rows, and the times of each kernel, its plain
    version, its bound and SDPA's forward + backward."""
    import torch.nn.functional as F

    from tdm_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("self", PIX_B, PIX_H, PIX_S, PIX_S, PIX_D, bf16, None, True),
        ("cross", PIX_B, PIX_H, PIX_S, PIX_TXT, PIX_D, bf16, [120, 77, 13, 0], True),
        ("odd", 2, 3, 1000, 77, 64, f32, [77, 0], False),
        ("odd_bf16", 3, 2, 333, 200, 72, bf16, [200, 129, 0], False),
    ]
    for d in (8, 16, 36, 64, 100, 128):
        for dtype in (bf16, f32):
            cases.append((f"sweep_d{d}_{str(dtype).split('.')[-1]}", 2, 2, 130,
                          70, d, dtype, [70, 33], False))
    names = ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
    recs = {n: {"max_abs_err": 0.0, "shapes": []} for n in names}
    pair = []
    for name, b, h, sq, sk, d, dtype, lengths, timed in cases:
        q, k, v, mask, qs, bias = _attn_inputs(
            torch, gen, b, h, sq, sk, d, dtype, lengths)
        dout = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
        scale = 1.0 / d ** 0.5
        before = A.launch_counts()
        out, lse = A.flash_attention_fwd_lse(qs, k, v, bias)
        ref_out, ref_lse = A.plain_attention_lse(qs, k, v, bias)
        # the backward kernels and their plain versions on the same inputs
        # (the plain forward's output and lse; dK/dV fed the plain Δ)
        ref_dq, ref_delta = A.plain_attention_bwd_dq(qs, k, v, bias, dout, ref_out, ref_lse,
                                                     scale)
        ref_dk, ref_dv = A.plain_attention_bwd_dkv(qs, k, v, bias, dout, ref_lse, ref_delta)
        dq, delta = A.flash_attention_bwd_dq(qs, k, v, bias, dout, ref_out, ref_lse, scale)
        dk, dv = A.flash_attention_bwd_dkv(qs, k, v, bias, dout, ref_lse, ref_delta)
        # ... and driven by the forward kernel's own output and lse and the
        # dQ kernel's Δ, as in training
        dq_own, delta_own = A.flash_attention_bwd_dq(qs, k, v, bias, dout, out, lse, scale)
        dk_own, dv_own = A.flash_attention_bwd_dkv(qs, k, v, bias, dout, lse, delta_own)
        for w in A.WRAPPERS:  # comparison launches do not count
            w.launches = before[w.__name__]
        torch.cuda.synchronize()
        dims = f"[{b},{h},{sq},{sk},{d}] {str(dtype).split('.')[-1]}"
        results = {
            "flash_fwd_lse": [("out", out, ref_out)],
            "flash_bwd_dq": [("dq", dq, ref_dq), ("dq from the kernel's lse", dq_own, ref_dq)],
            "flash_bwd_dkv": [("dk", dk, ref_dk), ("dv", dv, ref_dv),
                              ("dk from the kernel's lse", dk_own, ref_dk),
                              ("dv from the kernel's lse", dv_own, ref_dv)],
        }
        lse_err, lse_bad = compare_lse(torch, lse, ref_lse)
        print(f"[kernels] flash_fwd_lse {name} {dims} lse max_abs_err "
              f"{lse_err:.3e} (limit {LSE_TOL}; all-masked rows exactly +1e30)",
              flush=True)
        check(lse_bad is None, f"flash_fwd_lse {name}: {lse_bad}")
        for label, got, ref in (("delta", delta, ref_delta),
                                ("delta from the kernel's output", delta_own,
                                 A.attention_delta(dout, out))):
            err = ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
            print(f"[kernels] flash_bwd_dq {name} {dims} {label}: max_abs_err {err:.3e} of "
                  f"the largest |Δ| (limit {DELTA_TOL})", flush=True)
            check(bool(torch.isfinite(got).all()) and err <= DELTA_TOL,
                  f"flash_bwd_dq {name} {label}: {err:.3e} > {DELTA_TOL}")
            recs["flash_bwd_dq"]["delta_max_err"] = max(
                recs["flash_bwd_dq"].get("delta_max_err", 0.0), err)
        for kern, outs in results.items():
            for label, got, ref in outs:
                check(bool(torch.isfinite(got).all()),
                      f"{kern} {name}: non-finite {label}")
                err, rel, bad = (compare(torch, got, ref) if kern == "flash_fwd_lse"
                                 else compare_grad(torch, got, ref))
                print(f"[kernels] {kern} {name} {dims} {label} max_abs_err "
                      f"{err:.3e} rel_l2 {rel:.3e}", flush=True)
                check(bad is None, f"{kern} {name} {label}: {bad}")
                recs[kern]["max_abs_err"] = max(recs[kern]["max_abs_err"], err)
        recs["flash_fwd_lse"]["max_abs_err"] = max(
            recs["flash_fwd_lse"]["max_abs_err"], lse_err)
        if lengths is not None:  # all-masked batch rows: exactly 0
            for i, n_live in enumerate(lengths):
                if n_live == 0:
                    check(not bool(out[i].any()) and not bool(dq[i].any())
                          and not bool(dk[i].any()) and not bool(dv[i].any()),
                          f"{name}: batch row {i} has no key but a non-zero "
                          f"output or gradient")
                check(not bool(dk[i, :, n_live:].any())
                      and not bool(dv[i, :, n_live:].any()),
                      f"{name}: a masked key got a gradient")
        if not timed:
            continue
        live = sk * b if lengths is None else sum(lengths)
        stream = torch.cuda.current_stream().cuda_stream
        bp = None if bias is None else bias.data_ptr()
        fwd, _ = A._entry("tdm_flash_fwd")
        fdq, _ = A._entry("tdm_flash_bwd_dq")
        fdkv, _ = A._entry("tdm_flash_bwd_dkv")
        calls = {
            "flash_fwd_lse": (
                lambda: fwd(qs.data_ptr(), k.data_ptr(), v.data_ptr(), bp,
                            out.data_ptr(), lse.data_ptr(), b, h, sq, sk, d, 1, stream),
                lambda: A.plain_attention_lse(qs, k, v, bias), "fwd_lse"),
            "flash_bwd_dq": (
                lambda: fdq(qs.data_ptr(), k.data_ptr(), v.data_ptr(), bp,
                            dout.data_ptr(), ref_out.data_ptr(), ref_lse.data_ptr(),
                            delta.data_ptr(), dq.data_ptr(), b, h, sq, sk, d, scale, 1,
                            stream),
                lambda: A.plain_attention_bwd_dq(qs, k, v, bias, dout, ref_out, ref_lse,
                                                 scale), "dq"),
            "flash_bwd_dkv": (
                lambda: fdkv(qs.data_ptr(), k.data_ptr(), v.data_ptr(), bp,
                             dout.data_ptr(), ref_lse.data_ptr(), ref_delta.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d, 1, stream),
                lambda: A.plain_attention_bwd_dkv(qs, k, v, bias, dout, ref_lse,
                                                  ref_delta), "dkv"),
        }
        # the yardsticks (the port never calls them), on the same inputs:
        # SDPA's forward on inputs that require grad beside the lse forward,
        # its backward alone (retain_graph on one forward) beside dQ + dK/dV,
        # and forward + backward beside the port's whole training attention
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        sdpa_mask = None if mask is None else mask.bool()[:, None, None, :]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask)

        sdpa_out = sdpa_fwd()
        turns = time_turns(torch, {
            **{kern: kfn for kern, (kfn, _, _) in calls.items()},
            "sdpa_fwd": sdpa_fwd,
            "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout,
                                                    retain_graph=True),
            "sdpa_fwd_bwd": lambda: torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), dout),
        })
        times = {}
        for kern, (_, pfn, work) in calls.items():
            ms = turns[kern]["median"]
            plain_ms = time_ms(torch, pfn, 10, 2)
            nbytes, ops = attention_bwd_work(work, b, h, sq, sk, d, 2, live)
            bound, by = bound_ms(nbytes, ops)
            times[kern] = ms
            recs[kern]["shapes"].append({
                "shape": name, "dims": [b, h, sq, sk, d], "ms": ms,
                "ms_range": [turns[kern]["min"], turns[kern]["max"]],
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "bytes": nbytes, "ops": ops})
            print(f"[kernels] {kern} {name} {spread(turns[kern])} ({ms / bound:.1f}x "
                  f"bound) plain_ms {plain_ms:.4f} bound_ms {bound:.5f} ({by})", flush=True)
        port_ms = sum(times.values())
        sdpa_fwd_ms = turns["sdpa_fwd"]["median"]
        rec = recs["flash_fwd_lse"]["shapes"][-1]
        rec["library_ms"] = sdpa_fwd_ms
        rec["library_ms_range"] = [turns["sdpa_fwd"]["min"], turns["sdpa_fwd"]["max"]]
        pair.append({"shape": name, "port_fwd_lse_dq_dkv_ms": port_ms,
                     "dq_plus_dkv_ms": times["flash_bwd_dq"] + times["flash_bwd_dkv"],
                     "sdpa_bwd_ms": turns["sdpa_bwd"]["median"],
                     "sdpa_bwd_ms_range": [turns["sdpa_bwd"]["min"], turns["sdpa_bwd"]["max"]],
                     "sdpa_fwd_bwd_ms": turns["sdpa_fwd_bwd"]["median"],
                     "sdpa_fwd_bwd_ms_range": [turns["sdpa_fwd_bwd"]["min"],
                                               turns["sdpa_fwd_bwd"]["max"]]})
        print(f"[kernels] flash_fwd_lse {name}: {times['flash_fwd_lse'] / sdpa_fwd_ms:.2f}x "
              f"SDPA's forward (grad) {spread(turns['sdpa_fwd'])}", flush=True)
        print(f"[kernels] training attention {name}: dq + dkv "
              f"{pair[-1]['dq_plus_dkv_ms']:.4f} ms vs SDPA backward alone "
              f"{spread(turns['sdpa_bwd'])}; port lse forward + dq (delta fused) + dkv "
              f"{port_ms:.4f} ms vs SDPA forward + backward "
              f"{spread(turns['sdpa_fwd_bwd'])}", flush=True)
    grad_check(torch, seed)
    return {"kernels": recs, "pair": pair}


def phase_kernels_splash(torch, seed: int) -> dict:
    """The splash kernel (kernel 4) against its plain version: SD3's joint
    attention [4,24,4429,4429,64] in bf16 (per batch row, as compare()),
    ragged shapes at D = 64 and 128 (fp32 and bf16), and rows whose real
    logits all lie below -32 (fp32 and bf16), where the TPU path's pad-key
    rescale fails. At the SD3 shape: the kernel's time, the flash kernel's
    (bias all zero) and SDPA's (the library yardstick) in turns, the plain
    version once, and the bound."""
    import torch.nn.functional as F

    from tdm_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    bf16, f32 = torch.bfloat16, torch.float32
    max_err = 0.0

    def held(name, q, k, v):
        nonlocal max_err
        before = A.splash_attention_fwd.launches
        out = A.splash_attention_fwd(q, k, v)
        A.splash_attention_fwd.launches = before  # comparison launches do not count
        ref = A.plain_splash_attention(q, k, v)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"splash {name}: non-finite output")
        err, rel, bad = compare(torch, out, ref)
        print(f"[kernels] splash_fwd {name} {list(q.shape[:3]) + [k.shape[2], q.shape[3]]} "
              f"{str(q.dtype).split('.')[-1]} max_abs_err {err:.3e} rel_l2 {rel:.3e}",
              flush=True)
        check(bad is None, f"splash {name}: {bad}")
        max_err = max(max_err, err)
        return out

    for name, (b, h, sq, sk, d) in (("odd_d64", (2, 3, 1000, 777, 64)),
                                    ("odd_d128", (2, 3, 1000, 777, 128)),
                                    ("odd_d64_bf16", (2, 3, 1000, 777, 64)),
                                    ("odd_d128_bf16", (2, 3, 1000, 777, 128)),
                                    ("tail13_d128_bf16", (2, 4, 333, 77, 128))):
        dtype = bf16 if name.endswith("bf16") else f32
        q, k, v, _, qs, _ = _attn_inputs(torch, gen, b, h, sq, sk, d, dtype, None)
        held(name, qs, k, v)
    # every real logit below -32: keys clustered round u, queries along -u
    u = torch.randn(64, generator=gen, device="cuda")
    u = u / u.norm()
    k = u + 0.05 * torch.randn(2, 3, 4429, 64, generator=gen, device="cuda")
    q = (-50.0 * u).expand(2, 3, 100, 64).contiguous()
    v = torch.randn(2, 3, 4429, 64, generator=gen, device="cuda")
    top = (q @ k.transpose(2, 3)).max().item()
    check(top < -32, f"negative-logit rows reach {top}")
    for dtype in (f32, bf16):
        held(f"logits_below_-32_{str(dtype).split('.')[-1]}", q.to(dtype), k.to(dtype),
             v.to(dtype))
    print(f"[kernels] splash_fwd rows with every logit <= {top:.1f}: exact against plain "
          f"(the TPU path's out / (1 - n_pad*exp(-lse)) is not carried over)", flush=True)

    # the SD3 shape
    b, h, s, d = SD3_B, SD3_H, SD3_S, SD3_D
    q, k, v, _, qs, _ = _attn_inputs(torch, gen, b, h, s, s, d, bf16, None)
    out = held("sd3", qs, k, v)
    stream = torch.cuda.current_stream().cuda_stream
    splash, _ = A._entry("tdm_splash_fwd")
    fwd, _ = A._entry("tdm_flash_fwd")
    zero_bias = torch.zeros(b, s, dtype=f32, device="cuda")
    flash_out = torch.empty_like(qs)
    turns = time_turns(torch, {
        "splash": lambda: splash(qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 b * h, s, s, d, 1, stream),
        "flash": lambda: fwd(qs.data_ptr(), k.data_ptr(), v.data_ptr(), zero_bias.data_ptr(),
                             flash_out.data_ptr(), None, b, h, s, s, d, 1, stream),
        "sdpa": lambda: F.scaled_dot_product_attention(q, k, v)})
    ms, flash_ms, lib_ms = (turns[n]["median"] for n in ("splash", "flash", "sdpa"))
    flash_err, _, flash_bad = compare(torch, flash_out, A.plain_splash_attention(qs, k, v))
    check(flash_bad is None, f"flash kernel at the SD3 shape: {flash_bad}")
    plain_ms = time_ms(torch, lambda: A.plain_splash_attention(qs, k, v), 1, 0)
    nbytes, ops = attention_work(b, h, s, s, d, 2, s * b, bias=False)
    bound, by = bound_ms(nbytes, ops)
    fb_bytes, fb_ops = attention_work(b, h, s, s, d, 2, s * b)
    flash_bound, _ = bound_ms(fb_bytes, fb_ops)
    print(f"[kernels] splash_fwd sd3 [{b},{h},{s},{s},{d}] in turns: splash "
          f"{spread(turns['splash'])} ({ms / bound:.2f}x bound, {ms / lib_ms:.2f}x SDPA, "
          f"{ops / ms / 1e9:.0f} TFLOP/s) | flash_fwd (bias all 0) {spread(turns['flash'])} "
          f"({flash_ms / lib_ms:.2f}x SDPA, max_abs_err {flash_err:.3e}) | sdpa "
          f"{spread(turns['sdpa'])} | plain_ms {plain_ms:.4f} (once) | bound_ms {bound:.5f} "
          f"({by})", flush=True)
    return {"max_abs_err": max_err, "ms": ms,
            "ms_range": [turns["splash"]["min"], turns["splash"]["max"]],
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_ms_range": [turns["sdpa"]["min"], turns["sdpa"]["max"]],
            "bound_ms": bound, "bound_by": by, "dims": [b, h, s, s, d], "bytes": nbytes,
            "ops": ops, "flash_ms": flash_ms,
            "flash_ms_range": [turns["flash"]["min"], turns["flash"]["max"]],
            "flash_bound_ms": flash_bound}


def grad_check(torch, seed: int) -> None:
    """fp32, small shape: the gradients of q, k and v through
    FlashAttention (the kernels) against autograd of plain_attention, both
    on the card, with a ragged and an all-masked batch row. Tolerance
    GRAD_TOL relative to each gradient's largest magnitude: the same fp32
    arithmetic in another order; the all-masked row's gradients are exactly
    0."""
    from tdm_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    b, h, sq, sk, d = 3, 2, 200, 77, 40
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
               for s in (sq, sk, sk))
    mask = (torch.arange(sk, device="cuda")[None]
            < torch.tensor([77, 30, 0], device="cuda")[:, None]).int()
    g = torch.randn(b, h, sq, d, generator=gen, device="cuda")
    before = A.launch_counts()
    grads = {}
    for impl in ("auto", "plain"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = A.attention(*leaves, mask, impl=impl)
        grads[impl] = (out, *torch.autograd.grad(out, leaves, g))
    launched = {n: A.launch_counts()[n] - before[n] for n in before}
    for w in A.WRAPPERS:
        w.launches = before[w.__name__]
    check(launched == {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 1,
                       "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
                       "splash_attention_fwd": 0},
          f"grad check launches {launched}")
    worst = 0.0
    for label, got, ref in zip(("out", "dq", "dk", "dv"), grads["auto"], grads["plain"]):
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        worst = max(worst, err)
        check(err <= GRAD_TOL, f"grad check {label}: {err:.3e} > {GRAD_TOL}")
        check(not bool(got[2].any()), f"grad check {label}: all-masked row not 0")
    print(f"[kernels] fp32 [{b},{h},{sq},{sk},{d}] FlashAttention (kernels) vs "
          f"autograd of plain_attention: out/dq/dk/dv max error {worst:.3e} of "
          f"the largest magnitude (limit {GRAD_TOL}); all-masked row exactly 0",
          flush=True)


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


def profile_batch(torch, pipe, cond, noise, kernel: str = "flash_fwd") -> dict:
    """Device time of one full batch (4 NFE + decode) by kernel, from
    torch.profiler's CUDA activity: busy time, the attention kernel's share
    (kernels whose name holds `kernel`) and the device's idle share of the
    batch's wall time."""
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
    attn_ms = sum(e.device_time_total for e in kernels if kernel in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    print(f"[profile] one batch of 4: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{kernel} {attn_ms:.1f} ms ({attn_ms / busy_ms:.3f} of busy), "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    for e in top:
        print(f"[profile]   {e.device_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "attention_ms": attn_ms,
            "idle_share": 1 - busy_ms / wall_ms, "launches": sum(e.count for e in kernels)}


@contextlib.contextmanager
def forced_attention(impl: str):
    """Every attention call of the models takes the route `impl`, whatever
    route its module asks for (here only: a comparison, not the main
    path)."""
    from tdm_tpu_torch.models import layers

    kernel_attention = layers.fused_attention

    def forced(q, k, v, key_mask=None, **kw):
        return kernel_attention(q, k, v, key_mask, **{**kw, "impl": impl})

    layers.fused_attention = forced
    try:
        yield
    finally:
        layers.fused_attention = kernel_attention


def full_forward_check(torch, transformer, seed: int) -> None:
    """One full-width forward of the served model with the kernel against
    the same forward with the plain attention, both on the card: bf16
    activations through 28 layers, so the check is relative (L2 error
    under 2%)."""
    import numpy as np

    from tdm_tpu_torch.ops import attention as A

    rng = np.random.default_rng(seed + 1)
    lat = torch.from_numpy(rng.standard_normal((4, 4, 64, 64)).astype(np.float32)).cuda()
    text = torch.from_numpy(rng.standard_normal((4, 120, 4096)).astype(np.float32)).cuda()
    mask = (torch.arange(120)[None] < torch.tensor([[120], [40], [3], [0]])).int().cuda()
    t = torch.tensor([899, 674, 449, 224], device="cuda")
    before = A.flash_attention_fwd.launches
    with torch.inference_mode():
        out = transformer(lat, t, text, mask).float()
        # the same forward with every Attention's call made plain, here only
        with forced_attention("plain"):
            ref = transformer(lat, t, text, mask).float()
    A.flash_attention_fwd.launches = before
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"[check] full-width forward, kernel vs plain attention: rel L2 "
          f"{rel:.3e}, finite {bool(torch.isfinite(out).all())}", flush=True)
    check(bool(torch.isfinite(out).all()) and rel < 2e-2,
          f"full-width forward disagrees: rel L2 {rel}")


def phase_reference_train(torch, seed: int) -> None:
    """One tiny TDM step (fp32, dmd) on the card (the kernels) against the
    same step on the CPU (the plain versions), from one state with the same
    draws and conditioning. Losses and grad norms to 1e-4 relative; the
    update of each role (new − old params) to 5e-3 in relative L2 and each
    weight to 25% of lr (Adam ε 1e-4, as tests/test_torch_port_train.py
    holds the step against JAX: fp32 roundoff in another order; a weight
    whose gradient is a near-cancelling sum moves by lr·δg/ε, measured up to
    16% of lr between card and CPU)."""
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.train import families, optim as topt, tdm

    lr = 1e-4
    runs = {}
    cpu_params = None
    for dev in ("cpu", "cuda"):
        bundle = families.build("pixart", tiny=True, seed=seed, device=dev)
        if cpu_params is None:
            cpu_params = bundle.init_params()
        teacher = {k: v.to(dev) for k, v in cpu_params.items()}
        gen = torch.Generator(device="cpu").manual_seed(seed + 3)
        config = tdm.TDMConfig()
        draws = tdm.make_draws(config, 3, bundle.sample_shape, gen, "cpu")
        draws = tdm.StepDraws(*(x.to(dev) for x in draws))
        text = torch.randn(3, bundle.seq_len, bundle.embed_dim, generator=gen).to(dev)
        mask = (torch.arange(bundle.seq_len)[None]
                < torch.tensor([[8], [3], [1]])).int().to(dev)
        uncond = (torch.zeros_like(text), torch.ones_like(mask))
        tx = topt.make_optimizer(lr, eps=1e-4)
        state = tdm.init_state(teacher, teacher, tx, tx)
        start = {r: {k: v.clone() for k, v in getattr(state, r).items()}
                 for r in ("student", "critic")}
        step = tdm.build_train_step(bundle.denoise_fn, teacher, bundle.schedule, config,
                                    tx, tx, sample_shape=bundle.sample_shape)
        before = A.launch_counts()
        state, metrics = step(state, draws, (text, mask), uncond)
        launched = {n: A.launch_counts()[n] - before[n] for n in before}
        for w in A.WRAPPERS:  # a check, not the main path
            w.launches = before[w.__name__]
        runs[dev] = (state, metrics, start, launched)
    (cs, cm, cstart, _), (gs, gm, gstart, glaunch) = runs["cpu"], runs["cuda"]
    # 2 layers x (self, cross): 7 no-grad forwards, 2 with grad
    want = {"flash_attention_fwd": 28, "flash_attention_fwd_lse": 8,
            "flash_attention_bwd_dq": 8, "flash_attention_bwd_dkv": 8,
            "splash_attention_fwd": 0}
    check(glaunch == want, f"tiny step launches {glaunch}, expected {want}")
    worst = {}
    for name in tdm.StepMetrics._fields:
        c, g = float(getattr(cm, name)), float(getattr(gm, name))
        worst[name] = abs(c - g) / max(abs(c), 1e-12)
        check(math.isfinite(g) and abs(c - g) <= 1e-4 * abs(c) + 1e-7,
              f"tiny step {name}: card {g} vs cpu {c}")
    upd = {}
    for role in ("student", "critic"):
        d_c = torch.cat([(getattr(cs, role)[k] - cstart[role][k]).flatten()
                         for k in cstart[role]])
        d_g = torch.cat([(getattr(gs, role)[k] - gstart[role][k]).cpu().flatten()
                         for k in cstart[role]])
        rel = float((d_g - d_c).norm() / d_c.norm())
        top = float((d_g - d_c).abs().max())
        upd[role] = (rel, top)
        check(float(d_c.abs().max()) > 0.5 * lr, f"tiny step: {role} did not move")
        check(rel <= 5e-3 and top <= 0.25 * lr,
              f"tiny step {role} update: rel L2 {rel:.3e}, max {top:.3e}")
    print(f"[reference] tiny TDM step (dmd) cuda (kernels: {glaunch}) vs cpu "
          f"(plain): metrics max rel err {max(worst.values()):.3e} (limit 1e-4); "
          f"update rel L2 / max: student {upd['student'][0]:.3e} / "
          f"{upd['student'][1]:.3e}, critic {upd['critic'][0]:.3e} / "
          f"{upd['critic'][1]:.3e} (limits 5e-3 / {0.25 * lr:.1e})", flush=True)


def seeded_lora(torch, model, rank: int, seed: int):
    """A LoRA on the default targets with both factors drawn from the seed
    (peft's init leaves b = 0, which would merge to nothing)."""
    from tdm_tpu_torch.lora import adapter

    gen = torch.Generator().manual_seed(seed)
    lora = adapter.init_lora(model, rank, generator=gen)
    for entry in lora.params.values():
        entry["b"] = 0.02 * torch.randn(entry["b"].shape, generator=gen)
    return lora


def phase_reference_sd3(torch, seed: int, workdir: str) -> None:
    """A tiny SD3 pipeline at head dim 64 (fp32, attn_impl='splash': the
    splash kernel on the card) with a merged kohya LoRA at 0.125, against
    the same pipeline on the CPU (the plain version): the sampler state is
    bf16 in both, so the latents agree to one bf16 ulp of their scale and
    the images to half a PNG step."""
    import dataclasses

    import numpy as np

    from tdm_tpu_torch.lora import io as lora_io
    from tdm_tpu_torch.models import mmdit_sd3
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines.sd3 import default_sd3_pipeline

    torch.manual_seed(seed)
    cfg = dataclasses.replace(mmdit_sd3.MMDiTConfig.tiny(), head_dim=64, attn_impl="splash")
    cpu = default_sd3_pipeline(cfg=cfg, device="cpu")
    gpu = default_sd3_pipeline(cfg=cfg, device="cuda")
    gpu.transformer.load_state_dict(cpu.transformer.state_dict())
    gpu.vae_decoder.load_state_dict(cpu.vae_decoder.state_dict())
    lora_file = os.path.join(workdir, "tiny_lora.safetensors")
    lora_io.save_kohya(seeded_lora(torch, cpu.transformer, 4, seed), lora_file)
    for pipe in (cpu, gpu):
        pipe.load_lora_weights(lora_file, adapter_name="tdm")
        pipe.set_adapters(["tdm"], [0.125])
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((3, 16, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((3, 21, cfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((3, cfg.pooled_dim)).astype(np.float32)
    kw = dict(prompt_embeds=(ctx, pooled), latents=lat, height=64, width=64)
    ref = cpu(**kw)
    before = A.launch_counts()
    got = gpu(**kw)
    torch.cuda.synchronize()
    launched = {n: A.launch_counts()[n] - before[n] for n in before}
    for w in A.WRAPPERS:  # a check, not the main path
        w.launches = before[w.__name__]
    dl = (got.latents.float().cpu() - ref.latents.float()).abs()
    scale = ref.latents.float().abs().max().item()
    di = (got.images.cpu() - ref.images).abs().max().item()
    print(f"[reference] tiny SD3 pipeline (head dim 64, LoRA at 0.125) cuda (splash kernel, "
          f"{launched['splash_attention_fwd']} launches) vs cpu (plain): latents max_abs_err "
          f"{dl.max().item():.3e} of scale {scale:.3g}, {(dl > 0).float().mean().item():.4f} "
          f"of elements differ; images max_abs_err {di:.3e}", flush=True)
    check(launched["splash_attention_fwd"] == cfg.num_layers * 4
          and launched["flash_attention_fwd"] == 0, f"tiny SD3 launches {launched}")
    check(dl.max().item() <= 2**-7 * scale, "tiny SD3 latents disagree")
    check((dl > 0).float().mean().item() < 0.01, "tiny SD3 latents disagree")
    check(di <= 2e-3, "tiny SD3 images disagree")


# per batch of 4 at 4 NFE: one joint attention in each of the 24 blocks
SD3_LAUNCHES_PER_BATCH = 24 * 4


def phase_sd3(torch, seed: int, workdir: str) -> dict:
    """Full-width SD3-Medium 1024² served over HTTP through the port with
    the splash kernel and a LoRA at the recipe's scale."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    import urllib.request

    from tdm_tpu_torch.data.prompts import EmbeddingCache
    from tdm_tpu_torch.lora import io as lora_io
    from tdm_tpu_torch.models import mmdit_sd3
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import save_pretrained
    from tdm_tpu_torch.pipelines.sd3 import default_sd3_pipeline
    from tdm_tpu_torch.serve import server as S

    # SD3-Medium (24 layers, hidden 1536, 24x64 heads, context 4096, pooled
    # 2048, bf16) with weights from the seed, TAESD3, the rank-64 LoRA
    t0 = time.monotonic()
    torch.manual_seed(seed)
    cfg = mmdit_sd3.MMDiTConfig(attn_impl="splash")
    check((cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.head_dim, cfg.context_dim,
           cfg.pooled_dim, cfg.sample_size) == (24, 1536, 24, 64, 4096, 2048, 128),
          "SD3-Medium widths")
    pipe = default_sd3_pipeline(cfg=cfg, device="cuda")
    n_params = sum(p.numel() for p in pipe.transformer.parameters())
    model_dir = os.path.join(workdir, "sd3_medium")
    save_pretrained(model_dir, pipe)
    lora = seeded_lora(torch, pipe.transformer, 64, seed)
    lora_file = os.path.join(workdir, "sd3_tdm_lora.safetensors")
    lora_io.save_kohya(lora, lora_file)
    lora_mb = os.path.getsize(lora_file) / 1e6
    del pipe
    torch.cuda.empty_cache()
    # an embedding cache of 8 prompts: 333 context tokens and a pooled vector
    rng = np.random.default_rng(seed)
    prompts = [f"prompt {i}" for i in range(8)]
    cache = os.path.join(workdir, "sd3_cache.npz")
    EmbeddingCache(
        rng.standard_normal((8, SD3_TXT, 4096)).astype(np.float16),
        np.ones((8, SD3_TXT), np.int32), prompts,
        pooled=rng.standard_normal((8, 2048)).astype(np.float16),
    ).save(cache)
    print(f"[sd3] wrote SD3-Medium ({n_params / 1e6:.1f}M params), a rank-64 kohya LoRA "
          f"({len(lora.params)} entries, {lora_mb:.0f} MB) and an 8-prompt pooled cache in "
          f"{time.monotonic() - t0:.1f}s", flush=True)

    t0 = time.monotonic()
    args = S.parse_args([
        "--model", model_dir, "--embedding_cache", cache, "--port", "0",
        "--batch_size", "4", "--max_delay_ms", "1000", "--warmup",
        "--lora", lora_file, "--lora_scale", "0.125",
    ])
    server = S.build_server(args).start()
    stats = server.batcher.stats
    pipe = server.batcher.pipe
    check(pipe.family == "sd3" and pipe.transformer.cfg.attn_impl == "splash"
          and pipe._active == (("tdm", 0.125),), "the served SD3 pipeline")
    print(f"[sd3] loaded, merged the LoRA and warmed in {time.monotonic() - t0:.1f}s "
          f"(warm-up batch {stats.last_batch_latency_s:.3f}s)", flush=True)

    def post(prompt, seed):
        body = json.dumps({"prompt": prompt, "seed": seed}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        t = time.monotonic()
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.loads(r.read())
        return out, time.monotonic() - t

    try:
        # the main path: counts to 0, 8 concurrent requests (two full
        # batches), then one request alone for determinism
        A.reset_launches()
        b0, pad0 = stats.batches, stats.rows_padded
        t0 = time.monotonic()
        with ThreadPoolExecutor(8) as ex:
            replies = list(ex.map(lambda i: post(prompts[i], 200 + i), range(8)))
        wall8 = time.monotonic() - t0
        batches8, padded8 = stats.batches - b0, stats.rows_padded - pad0
        batch_s = stats.last_batch_latency_s
        solo, solo_s = post(prompts[0], 200)
        launches = A.launch_counts()
        batches = stats.batches - b0
    finally:
        server.close()
    for reply, _ in replies + [(solo, solo_s)]:
        check(reply.get("format") == "png" and reply.get("shape") == [1024, 1024, 3],
              f"reply {str(reply)[:200]}")
        check_png(base64.b64decode(reply["image"]), 1024, 1024)
    check(batches8 == 2 and padded8 == 0, f"8 requests ran as {batches8} batches")
    check(solo["image"] == replies[0][0]["image"],
          "same (prompt, seed) gave different bytes in another batch")
    check(len({r["image"] for r, _ in replies}) == 8, "distinct seeds gave equal images")
    check(launches["splash_attention_fwd"] == SD3_LAUNCHES_PER_BATCH * batches
          and sum(launches.values()) == launches["splash_attention_fwd"],
          f"launches {launches} over {batches} batches, expected "
          f"{SD3_LAUNCHES_PER_BATCH} splash and nothing else per batch")
    lat = [s for _, s in replies]
    print(f"[sd3] 8 concurrent requests in {wall8:.3f}s as {batches8} batches "
          f"({8 / wall8:.2f} images/s), request latency {min(lat):.3f}-{max(lat):.3f}s, "
          f"last batch {batch_s:.3f}s; lone request {solo_s:.3f}s; same (prompt, seed) -> "
          f"same PNG bytes; launches {launches} = {SD3_LAUNCHES_PER_BATCH} splash x {batches} "
          f"batches", flush=True)
    cond = tuple(np.concatenate([x] * 4) for x in server.batcher.cond_fn(prompts[1]))
    prof = profile_batch(torch, pipe, cond, torch.randn(4, 16, 128, 128), kernel="splash_fwd")
    forward_rel = sd3_forward_check(torch, pipe.transformer, seed)
    return {"launches": launches["splash_attention_fwd"], "batches": batches,
            "launches_per_batch": SD3_LAUNCHES_PER_BATCH, "wall8_s": wall8,
            "images_per_s": 8 / wall8, "batch_s": batch_s, "solo_s": solo_s,
            "profile": prof, "splash_vs_flash_forward_rel_l2": forward_rel}


def sd3_forward_check(torch, transformer, seed: int) -> float:
    """One full-width SD3 forward (batch 4, the served LoRA merged) through
    the splash kernel against the same forward through the flash kernel,
    both bf16 on the card: two kernels' roundings through 24 layers, so the
    check is relative (L2 error under 2%)."""
    import numpy as np

    from tdm_tpu_torch.ops import attention as A

    rng = np.random.default_rng(seed + 2)
    lat = torch.from_numpy(rng.standard_normal((4, 16, 128, 128)).astype(np.float32)).cuda()
    ctx = torch.from_numpy(rng.standard_normal((4, SD3_TXT, 4096)).astype(np.float32)).cuda()
    pooled = torch.from_numpy(rng.standard_normal((4, 2048)).astype(np.float32)).cuda()
    t = torch.tensor([1000.0, 750.0, 500.0, 250.0], device="cuda")
    before = A.launch_counts()
    with torch.inference_mode():
        out = transformer(lat, t, ctx, pooled).float()
        with forced_attention("auto"):
            ref = transformer(lat, t, ctx, pooled).float()
    launched = {n: A.launch_counts()[n] - before[n] for n in before}
    for w in A.WRAPPERS:  # a check, not the main path
        w.launches = before[w.__name__]
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"[check] full-width SD3 forward, splash kernel vs flash kernel: rel L2 "
          f"{rel:.3e}, finite {bool(torch.isfinite(out).all())}, launches {launched}",
          flush=True)
    check(launched["splash_attention_fwd"] == 24 and launched["flash_attention_fwd"] == 24,
          f"forward check launches {launched}")
    check(bool(torch.isfinite(out).all()) and rel < 2e-2,
          f"full-width SD3 forward disagrees: rel L2 {rel}")
    return rel


TRAIN_STEPS = 3
# per step at batch 4, dmd, cfg 4.5, critic_updates 1: 7 forwards without
# grad (rollout x4, x0_gen_sg, teacher CFG probe at 2B, critic probe) and 2
# with grad (critic DSM, student loss), each 28 blocks x (self, cross)
TRAIN_LAUNCHES = {"flash_attention_fwd": 392, "flash_attention_fwd_lse": 112,
                  "flash_attention_bwd_dq": 112, "flash_attention_bwd_dkv": 112,
                  "splash_attention_fwd": 0}


def phase_train(torch, seed: int, workdir: str) -> dict:
    """Full-width PixArt-α-512 TDM training through the CLI's main():
    seeded weights, a seeded full-width embedding cache, batch 4, bf16,
    dmd, 3 steps. Per step: host and CUDA-event times and the kernels'
    launches (checked); step 3 under torch.profiler for device busy time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.data.prompts import EmbeddingCache
    from tdm_tpu_torch.ops import attention as A

    rng = np.random.default_rng(seed)
    lengths = np.array([120, 77, 33, 9, 120, 1, 56, 100])
    cache = os.path.join(workdir, "train_cache.npz")
    EmbeddingCache(
        rng.standard_normal((8, 120, 4096)).astype(np.float16),
        (np.arange(120)[None] < lengths[:, None]).astype(np.int32),
        [f"prompt {i}" for i in range(8)],
        uncond_embed=(0.1 * rng.standard_normal((120, 4096))).astype(np.float16),
        uncond_mask=(np.arange(120) < 1).astype(np.int32),  # the empty prompt: one token
    ).save(cache)
    for var in ("TDM_TINY_MODEL", "TDM_TAESD_DIR"):
        os.environ.pop(var, None)
    os.environ["TDM_EMBEDDING_CACHE"] = cache
    out = os.path.join(workdir, "train")
    free_gb = shutil.disk_usage(workdir).free / 1e9
    print(f"[train] {free_gb:.0f} GB free for the run's checkpoint", flush=True)
    steps = []
    watch = ("blocks.0.attn1.to_q.weight", "blocks.0.ff.proj_out.weight", "proj_out.weight")
    snap = {}

    def hook(step, run):
        before = A.launch_counts()
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            if step == TRAIN_STEPS else None
        if prof is not None:
            prof.__enter__()
        t0 = time.monotonic()
        ev0.record()
        state, metrics = run()
        ev1.record()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        busy_ms = None
        if prof is not None:
            prof.__exit__(None, None, None)
            kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            busy_ms = sum(e.device_time_total for e in kern) / 1e3
            flash = [e for e in kern if "flash_" in e.key]
            top = sorted(kern, key=lambda e: -e.device_time_total)[:10]
            for e in top + [e for e in flash if e not in top]:
                print(f"[profile]   {e.device_time_total / 1e3:8.2f} ms  x{e.count:<6d} "
                      f"{e.key[:90]}", flush=True)
            print(f"[profile] step {step}: device busy {busy_ms:.1f} ms, the flash "
                  f"kernels {sum(e.device_time_total for e in flash) / 1e3:.1f} ms, "
                  f"{sum(e.count for e in kern)} kernel launches", flush=True)
        rec = {"step": step, "host_s": wall, "event_ms": ev0.elapsed_time(ev1),
               "busy_ms": busy_ms,
               "launches": {n: A.launch_counts()[n] - before[n] for n in before},
               "metrics": {k: float(v) for k, v in metrics._asdict().items()}}
        if step == 1:
            snap.update({k: state.student[k].clone() for k in watch})
        if step == 2:
            rec["student_changed"] = all(
                bool((state.student[k] != snap[k]).any()) for k in watch)
        steps.append(rec)
        print(f"[train] step {step}: host {wall:.3f}s, CUDA events {rec['event_ms']:.1f} "
              f"ms, launches {rec['launches']}, {rec['metrics']}", flush=True)
        return state, metrics

    A.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    train_tdm.main([
        "--output_dir", out, "--max_train_steps", str(TRAIN_STEPS),
        "--train_batch_size", "4", "--mixed_precision", "bf16", "--loss_mode", "dmd",
        "--export_lora_rank", "0", "--seed", str(seed),
    ], step_hook=hook)
    total_s = time.monotonic() - t0
    launches = A.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    run_dir = out + "_cfg4.5_steps900"
    ckpt = os.path.join(run_dir, f"checkpoint-{TRAIN_STEPS}")
    ckpt_gb = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt)) / 1e9
    student_gb = os.path.getsize(os.path.join(run_dir, "student.safetensors")) / 1e9
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} steps ran")
    for rec in steps:
        check(rec["launches"] == TRAIN_LAUNCHES,
              f"step {rec['step']} launches {rec['launches']}, expected {TRAIN_LAUNCHES}")
        check(all(math.isfinite(v) for v in rec["metrics"].values()),
              f"step {rec['step']}: non-finite metrics {rec['metrics']}")
    check(steps[1]["student_changed"], "the student did not change in step 2")
    shutil.rmtree(run_dir, ignore_errors=True)  # the disk for the sd3 phase's weights
    # steps after the first that ran without the profiler (its own cost
    # inflates the profiled last step's wall time)
    plain = [r["host_s"] for r in steps[1:] if r["busy_ms"] is None]
    per_step = sum(plain) / len(plain)
    busy = steps[-1]["busy_ms"]
    span = steps[1]["event_ms"]
    idle = None if not busy else 1 - busy / span
    print(f"[train] PixArt-α-512 TDM (dmd, batch 4, bf16, seeded weights): "
          f"{per_step:.3f} s/step after the first, unprofiled ({3600 / per_step:.0f} "
          f"iters/hour), first step {steps[0]['host_s']:.3f} s, profiled step "
          f"{steps[-1]['host_s']:.3f} s, peak memory {peak_gb:.2f} GiB; "
          f"launches per step {TRAIN_LAUNCHES} (checked); step 2 CUDA-event span "
          f"{span:.1f} ms, step 3 device busy "
          + (f"{busy:.1f} ms -> idle share {idle:.3f}" if busy else "not measured")
          + f"; main() {total_s:.1f}s incl. a {ckpt_gb:.1f} GB checkpoint and a "
          f"{student_gb:.2f} GB fp16 student", flush=True)
    return {"s_per_step": per_step, "iters_per_hour": 3600 / per_step,
            "first_step_s": steps[0]["host_s"], "peak_gib": peak_gb,
            "idle_share": idle, "busy_ms": busy, "event_span_ms": span,
            "launches": launches, "launches_per_step": TRAIN_LAUNCHES,
            "checkpoint_gb": ckpt_gb, "main_s": total_s, "steps": steps}


def kernel_row(name, source, replaces, launches, rec, per, resources) -> dict:
    """One entry of the `kernels` JSON line: the times of the self and the
    cross shape summed (one PixArt block), the bound of their summed work,
    and the bf16 kernels' registers, spills and HGMMA/HMMA counts."""
    shapes = rec["shapes"]
    nbytes = sum(r["bytes"] for r in shapes)
    ops = sum(r["ops"] for r in shapes)
    bound, by = bound_ms(nbytes, ops)
    lib = [r.get("library_ms") for r in shapes]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "ms": sum(r["ms"] for r in shapes),
        "plain_ms": sum(r["plain_ms"] for r in shapes),
        "bound_ms": bound, "bound_by": by,
        "library_ms": None if None in lib else sum(lib),
        "per": per,
        "shapes": [{k: r.get(k) for k in ("shape", "dims", "ms", "ms_range", "plain_ms",
                                          "library_ms", "library_ms_range", "bound_ms",
                                          "bound_by")}
                   for r in shapes],
        "resources": resources,
    }


PHASES = ("kernels", "reference", "serve", "train", "sd3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (a subset prints no result line)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases: one or more of {PHASES}")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    workdir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    t_start = time.monotonic()
    try:
        dev = phase_device(torch)
        build = phase_build()
        if "kernels" in phases:
            kern = phase_kernels(torch, args.seed)
            ktrain = phase_kernels_train(torch, args.seed)
            ksplash = phase_kernels_splash(torch, args.seed)
        if "reference" in phases:
            phase_reference(torch, args.seed)
            phase_reference_train(torch, args.seed)
            phase_reference_sd3(torch, args.seed, workdir)
        if "serve" in phases:
            serve = phase_serve(torch, args.seed, workdir)
        if "train" in phases:
            train = phase_train(torch, args.seed, workdir)
        if "sd3" in phases:
            sd3 = phase_sd3(torch, args.seed, workdir)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[done] {time.monotonic() - t_start:.1f}s", flush=True)
    if phases != list(PHASES):
        print(f"chip_smoke: ran only {phases}; no result line", flush=True)
        return 0
    per_block = ("one PixArt block at batch 4: one self-attention call "
                 "[4,16,1024,1024,72] + one cross-attention call "
                 "[4,16,1024,120,72] (bf16)")
    no_lib = ("; library null: no one PyTorch call computes it alone (SDPA's "
              "backward alone against dQ + dK/dV, and SDPA forward + backward "
              "against the port's lse forward + dQ (delta fused) + dK/dV: "
              "training_attention)")
    kt, per_step = ktrain["kernels"], train["launches_per_step"]
    res = build["resources"]

    def bf16_kernels(lib, suffix=""):
        return {fn: r for fn, r in res[lib].items()
                if ("sm90" in fn or "bf16" in fn) and fn.endswith(suffix)}

    rows = [
        kernel_row("flash_fwd", "tdm_tpu_torch/csrc/flash_fwd.cu",
                   "tdm_tpu/ops/attention.py:291", serve["launches"], kern,
                   per_block + "; library = SDPA forward", bf16_kernels("flash_fwd", ",0>")),
        kernel_row("flash_fwd_lse", "tdm_tpu_torch/csrc/flash_fwd.cu",
                   "tdm_tpu/ops/attention.py:291", train["launches"]["flash_attention_fwd_lse"],
                   kt["flash_fwd_lse"],
                   per_block + "; library = SDPA forward on inputs that require grad",
                   bf16_kernels("flash_fwd", ",1>")),
        kernel_row("flash_bwd_dq", "tdm_tpu_torch/csrc/flash_bwd_dq.cu",
                   "tdm_tpu/ops/attention.py:600", train["launches"]["flash_attention_bwd_dq"],
                   kt["flash_bwd_dq"], per_block + no_lib, bf16_kernels("flash_bwd_dq")),
        kernel_row("flash_bwd_dkv", "tdm_tpu_torch/csrc/flash_bwd_dkv.cu",
                   "tdm_tpu/ops/attention.py:635", train["launches"]["flash_attention_bwd_dkv"],
                   kt["flash_bwd_dkv"], per_block + no_lib, bf16_kernels("flash_bwd_dkv")),
        {"name": "splash_fwd", "route": "cuda", "source": "tdm_tpu_torch/csrc/splash_fwd.cu",
         "replaces": "tdm_tpu/ops/attention.py:153", "launches": sd3["launches"],
         "launches_per_batch": sd3["launches_per_batch"],
         "max_abs_err": ksplash["max_abs_err"], "ms": ksplash["ms"],
         "plain_ms": ksplash["plain_ms"], "bound_ms": ksplash["bound_ms"],
         "bound_by": ksplash["bound_by"], "library_ms": ksplash["library_ms"],
         "per": ("one SD3-Medium joint attention call at batch 4 [4,24,4429,4429,64] "
                 "(bf16); library = SDPA forward; flash_ms = the flash kernel (bias "
                 "all 0) at the same shape"),
         "ms_range": ksplash["ms_range"], "library_ms_range": ksplash["library_ms_range"],
         "flash_ms": ksplash["flash_ms"], "flash_ms_range": ksplash["flash_ms_range"],
         "dims": ksplash["dims"], "resources": bf16_kernels("splash_fwd"),
         "dynamic_smem": build["dynamic_smem"]["splash_fwd"]},
    ]
    print(json.dumps({"kernels": rows, "training_attention": ktrain["pair"],
                      "serve": serve, "train": train, "sd3": sd3}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
