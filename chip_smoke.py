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
     CLI's main() at the JAX CLI's default flags, the teacher read from the
     transformer/ folder of a PixArt-α-512 diffusers checkout written from
     the seed (seeded embedding cache, batch 4, bf16, dmd, 3 steps): the
     teacher's load seconds by part, seconds per step, peak
     memory, the idle share of a step, and each training kernel's launches
     per step (checked); then the default rank-32 kohya LoRA export by
     truncated SVD: its seconds, its keys and one kernel's reconstruction
     against a float64 SVD (checked);
  7. train_lora: the same run with a rank-32 LoRA student, 8-bit Adam and
     gradient accumulation 2 (2 optimizer steps of 2 micro-steps): the
     attention launches of every micro-step, the factors unchanged inside
     each window, int8 moments and the rank-32 kohya file (checked);
     seconds per optimizer step, peak memory, the idle share and device
     launches of a profiled micro-step, and each optimizer's launches per
     update of the full-width critic and of the LoRA factors;
  8. sd3: a full-width SD3-Medium pipeline (24 layers, 24x64 heads, 1024²,
     bf16, attn_impl='splash'; the seeded weights of the SD3 checkout that
     phases 9 and 10 read too, converted and kept at fp16) with a seeded
     rank-64 kohya LoRA on the default targets, written in the tdm_tpu
     layout and served over HTTP with --lora_scale 0.125: 8 concurrent
     requests (two batches of 4), exactly 96 splash-kernel launches and no
     flash launch per batch,
     per-seed determinism, a profiled batch, and one full-width forward
     through the splash kernel against the same forward through the flash
     kernel;
  9. diffusers: stock diffusers checkouts at full width, written from the
     seed through the port's manifests (fp16 files, the released key
     layout): a tiny KL decoder on the card against the CPU (fp32, TF32
     off); PixArt-α-512 with its 4-channel AutoencoderKL served over HTTP
     from --model <checkout> (load seconds with the read and the conversion
     apart, 6 concurrent requests, PNG checks, per-seed determinism,
     exactly 224 flash-kernel launches per batch, a profiled batch with the
     KL decode's device time); SD3-Medium with its 16-channel AutoencoderKL
     through from_pretrained at the default attn_impl (load seconds, one
     warm batch of 4 at 1024² through the pipeline, timed, exactly 96
     flash-kernel launches and nothing else, finite images, a profiled
     batch with the decode's share and the kernel's ms per call);
 10. train_sd3: full-width SD3-Medium TDM training through the CLI's main()
     with the recipe's flags (--model_family sd3 at 512², batch 4, bf16,
     dmd, rank-32 LoRA student, 8-bit Adam, --gradient_checkpointing, 4
     steps), the teacher from the SD3 checkout's transformer/ folder, a
     seeded pooled cache and a seeded TAESD3 for one validation grid:
     load seconds, seconds per step, peak memory, the idle share and top
     device operations of a profiled step, each training kernel's launches
     per step (checked), and the kohya LoRA loaded back into the SD3
     pipeline;
 11. sd15: a small SD1.5 pipeline at head dims 80 and 160 with a merged
     LoRA, fp32, on the card against the CPU; then a full-width SD1.5
     diffusers checkout (the UNet at 320/640/1280/1280, 8 heads, context
     768, fp16, and its KL VAE, written from the seed through the port's
     manifests) served over HTTP from --model <checkout> with a seeded
     rank-64 kohya LoRA on the attention projections (--lora) and a CLIP-L
     embedding cache: 8 concurrent requests (two batches of 4 at 512², 4
     NFE, DPM-Solver++ on the scaled-linear grid) and one alone, PNGs that
     are not constant, per-seed determinism, exactly 128 kernel-1 launches
     and nothing else per batch, a profiled batch (48 of its launches at
     head dim 160, by kernel name), the KL decode alone, the load seconds,
     peak memory, and one full-width UNet forward against plain attention.
Phase 3 also holds kernel 1 at SD1.5's head dims 40, 136 and 160 (ragged,
masked and all-masked rows, bf16 and fp32) and times its eight SD1.5
shapes in turns with SDPA; it also holds the training kernels (the forward
with its lse, dQ with its fused Δ, dK/dV) at one PixArt block's shapes and
SD3 training's
[4,24,1178,1178,64] and [8,24,1178,1178,64] (the forward without lse too,
all timed in turns with SDPA), and the splash kernel (SD3's
[4,24,4429,4429,64], ragged fp32 shapes, rows whose logits are all below
-20) against their plain versions; phase 4 runs one tiny train step, the
same step with a LoRA student, 8-bit Adam and accumulation 2, one tiny sd3
step, and a tiny SD3 pipeline with a merged LoRA on the card against the
same on the CPU; phase 7 also trains the tiny PixArt model for 2 steps
through main() on the card with its prompts read from a .txt shard by the
native C++ loader (checked), and times that loader's host seconds per batch
against the Python batcher's. Then a JSON line of per-kernel
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
# SD3-Medium training at the CLI's default --resolution 512: 1024 image + 154
# T5 tokens of joint attention, the grad forwards at batch 4 and the
# teacher's CFG probe at 8
SD3T_B, SD3T_TXT = 4, 154
SD3T_S = 1024 + SD3T_TXT
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
# fp32 at SD1.5's head dims 40 and 160 (outputs are O(1) averages of v):
# max |kernel - plain| under 1e-5
SD15_F32_ATOL = 1e-5
# SD1.5 at 512², batch 4, 8 heads: its attention calls [B, H, Sq, Sk, D] by
# level (64² latent: 4096 tokens at width 320, D 40; 1024 at 640, D 80; 256
# at 1280, D 160; the mid block's 64 at D 160), each self-attention unmasked
# and each cross-attention over the 77 CLIP tokens, with the calls of each
# per batch of 4 NFE (5 transformers at D 40 and at D 80, 6 at D 160, one
# of them the mid block's)
SD15_B, SD15_H, SD15_TXT = 4, 8, 77
SD15_SHAPES = (  # name, sq, sk, d, calls per batch
    ("sd15_self_d40", 4096, 4096, 40, 20), ("sd15_cross_d40", 4096, SD15_TXT, 40, 20),
    ("sd15_self_d80", 1024, 1024, 80, 20), ("sd15_cross_d80", 1024, SD15_TXT, 80, 20),
    ("sd15_self_d160", 256, 256, 160, 20), ("sd15_cross_d160", 256, SD15_TXT, 160, 20),
    ("sd15_mid_self_d160", 64, 64, 160, 4), ("sd15_mid_cross_d160", 64, SD15_TXT, 160, 4),
)
# kernel 1's launches per SD1.5 batch (16 transformers, self + cross, 4 NFE)
# and those at head dim 160 (6 transformers)
SD15_LAUNCHES_PER_BATCH = 16 * 2 * 4
SD15_D160_PER_BATCH = 6 * 2 * 4
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
            ("flash_fwd", "tdm_attn_fwd_smem_bytes", ((64,), (80,), (128,), (160,))),
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


def sd3_train_cases(torch) -> list:
    """SD3-Medium training's joint attention at head dim 64, no key mask:
    the grad forwards' [4,24,1178,1178,64] and the CFG probe's batch of 8."""
    return [(f"sd3_train_b{b}", b, SD3_H, SD3T_S, SD3T_S, SD3_D, torch.bfloat16, None, True)
            for b in (SD3T_B, 2 * SD3T_B)]


def group_of(shape_name: str) -> str:
    """The path a timed shape belongs to: SD3 training, SD1.5 serving, or
    one PixArt block."""
    for group in ("sd3_train", "sd15"):
        if shape_name.startswith(group):
            return group
    return "pixart"


def phase_kernels(torch, seed: int) -> dict:
    """Hold the flash kernel against its plain version; time both, SDPA and
    the bound at the two PixArt shapes, SD3 training's two shapes and the
    eight SD1.5 serving shapes. SD1.5's head dims 40 (the 64-column panel)
    and 160 (three panels, 64-key tiles) and 136 are held on ragged shapes
    with a masked, a ragged and an all-masked batch row, bf16 and fp32 (fp32
    within SD15_F32_ATOL)."""
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
        *sd3_train_cases(torch),
        *((f"sd15_ragged_d{d}_{str(dt).split('.')[-1]}", 3, 2, 333, 200, d, dt,
           [200, 129, 0], False) for d in (40, 136, 160) for dt in (bf16, f32)),
        *((name, SD15_B, SD15_H, sq, sk, d, bf16, None if sq == sk else [sk] * SD15_B, True)
          for name, sq, sk, d, _ in SD15_SHAPES),
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
        check(not (name.startswith("sd15") and dtype == f32 and err > SD15_F32_ATOL),
              f"{name}: max_abs_err {err:.3e} above {SD15_F32_ATOL}")
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
        rec = {"shape": name, "group": group_of(name), "dims": [b, h, sq, sk, d], "ms": ms,
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
    against their plain versions at the training shapes (one PixArt block,
    SD3's two) and a sweep, the fp32
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
        *sd3_train_cases(torch),
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
                "shape": name, "group": group_of(name), "dims": [b, h, sq, sk, d], "ms": ms,
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
        pair.append({"shape": name, "dims": [b, h, sq, sk, d], "port_fwd_lse_dq_dkv_ms": port_ms,
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


def check_png(png: bytes, width: int, height: int):
    """A valid 8-bit RGB PNG of the given size: signature, chunk CRCs,
    IHDR, and an IDAT stream that inflates to one filter byte plus 3·width
    bytes per row. Returns its [H, W, 3] uint8 pixels (the server writes
    filter 0 on every row, which is checked)."""
    import numpy as np

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
    data = zlib.decompress(chunks[b"IDAT"])
    check(len(data) == h * (1 + 3 * w), "PNG data size")
    check(b"IEND" in chunks, "PNG IEND")
    rows = np.frombuffer(data, np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "PNG rows use filter 0")
    return rows[:, 1:].reshape(h, w, 3)


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


def pixart_cache(workdir: str, seed: int) -> tuple[str, list]:
    """An embedding cache of 8 prompts with ragged T5 masks (120 tokens at
    4096), written once per run: (its path, its prompts)."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache

    prompts = [f"prompt {i}" for i in range(8)]
    cache = os.path.join(workdir, "cache.npz")
    if not os.path.exists(cache):
        rng = np.random.default_rng(seed)
        lengths = np.array([120, 77, 33, 9, 120, 1, 56, 100])
        EmbeddingCache(
            rng.standard_normal((8, 120, 4096)).astype(np.float16),
            (np.arange(120)[None] < lengths[:, None]).astype(np.int32), prompts,
            uncond_embed=np.zeros((120, 4096), np.float16),
            uncond_mask=np.zeros(120, np.int32),
        ).save(cache)
    return cache, prompts


# the seeded weights of a checkout's KL VAE: at the transformers' 0.02 a
# full-width decode is ~0.02 wide and every PNG pixel the same; at 0.15 it
# spreads over about [-1, 1]
KL_WEIGHT_SCALE = 0.15


def write_checkout(root: str, family: str, cfg, vcfg, seed: int) -> tuple[float, int]:
    """A stock diffusers checkout at `root`: model_index.json, transformer/
    (SD1.5: unet/) and vae/ (an AutoencoderKL), each a config.json and one
    fp16 diffusion_pytorch_model.safetensors of seeded weights in the
    released checkpoint's key layout (the port's manifests, family pixart,
    sd3 or unet_sd15), written one tensor at a time. Returns (seconds,
    parameters)."""
    from tdm_tpu_torch.io import manifest

    t0 = time.monotonic()
    sub = "transformer"
    if family == "unet_sd15":  # SD1.5's int attention_head_dim is its head count
        sub, index = "unet", {"_class_name": "StableDiffusionPipeline"}
        tconf = {"_class_name": "UNet2DConditionModel", "in_channels": cfg.in_channels,
                 "out_channels": cfg.out_channels, "layers_per_block": cfg.layers_per_block,
                 "block_out_channels": list(cfg.block_widths),
                 "norm_num_groups": cfg.norm_groups, "cross_attention_dim": cfg.context_dim,
                 "attention_head_dim": cfg.num_heads}
    else:
        tconf = {"sample_size": cfg.sample_size, "patch_size": cfg.patch_size,
                 "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
                 "num_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                 "attention_head_dim": cfg.head_dim}
    if family == "pixart":
        index = {"_class_name": "PixArtAlphaPipeline"}
        tconf.update(_class_name="PixArtTransformer2DModel", caption_channels=cfg.caption_dim)
    elif family == "sd3":
        index = {"_class_name": "StableDiffusion3Pipeline"}
        tconf.update(_class_name="SD3Transformer2DModel", joint_attention_dim=cfg.context_dim,
                     pooled_projection_dim=cfg.pooled_dim,
                     pos_embed_max_size=cfg.pos_embed_max_size)
    vconf = {"_class_name": "AutoencoderKL", "latent_channels": vcfg.latent_channels,
             "block_out_channels": list(vcfg.block_widths),
             "layers_per_block": vcfg.layers_per_block, "norm_num_groups": vcfg.norm_groups,
             "scaling_factor": vcfg.scaling_factor,
             "shift_factor": vcfg.shift_factor if vcfg.shift_factor else None}
    n = 0
    for folder, conf in (("", index), (sub, tconf), ("vae", vconf)):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        with open(os.path.join(root, folder, "config.json" if folder else "model_index.json"),
                  "w") as f:
            json.dump(conf, f)
    n += manifest.write_synthetic(
        family, os.path.join(root, sub, "diffusion_pytorch_model.safetensors"), cfg, seed=seed)
    n += manifest.write_synthetic(
        "klvae", os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"),
        vcfg, seed=seed + 1, scale=KL_WEIGHT_SCALE)
    return time.monotonic() - t0, n


def pixart_checkout(workdir: str, seed: int) -> str:
    """The PixArt-α-512 checkout (28 layers, hidden 1152, 16x72 heads,
    caption 4096; its 4-channel AutoencoderKL [128, 256, 512, 512], scaling
    0.18215), written once per run."""
    from tdm_tpu_torch.models import pixart, vae

    root = os.path.join(workdir, "PixArt-XL-2-512x512")
    if not os.path.exists(os.path.join(root, "model_index.json")):
        cfg, vcfg = pixart.PixArtConfig(), vae.KLVAEConfig()
        check((cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.head_dim, cfg.caption_dim,
               tuple(vcfg.block_widths), vcfg.latent_channels, vcfg.scaling_factor)
              == (28, 1152, 16, 72, 4096, (128, 256, 512, 512), 4, 0.18215),
              "PixArt-α-512 and its VAE")
        secs, n = write_checkout(root, "pixart", cfg, vcfg, seed)
        gb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
                 for f in fs) / 1e9
        print(f"[checkout] wrote the PixArt-α-512 diffusers checkout ({n / 1e6:.1f}M "
              f"params, {gb:.2f} GB at fp16) in {secs:.1f}s", flush=True)
    return root


@contextlib.contextmanager
def timed_calls(torch, targets):
    """Each (object, attribute) of `targets` wrapped to add the seconds of
    its calls, the card synchronised after each, to times[attribute]."""
    times, saved = {}, []

    def wrap(fn, name):
        def wrapped(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                times[name] = times.get(name, 0.0) + time.monotonic() - t0
        return wrapped

    for obj, name in targets:
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, wrap(getattr(obj, name), name))
    try:
        yield times
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def load_targets():
    """What a checkout's load is made of: the whole of `_from_diffusers`,
    the safetensors reads and the strict converters."""
    from tdm_tpu_torch.io import convert
    from tdm_tpu_torch.pipelines import loading

    return [(loading, "_from_diffusers"), (convert, "load_torch_state_dict"),
            (convert, "pixart_params"), (convert, "sd3_params"), (convert, "klvae_params")]


def load_report(times: dict) -> dict:
    total = times["_from_diffusers"]
    read = times["load_torch_state_dict"]
    conv = sum(v for k, v in times.items() if k.endswith("_params"))
    return {"load_s": total, "read_s": read, "convert_s": conv,
            "convert_share": conv / total, "build_and_copy_s": total - read - conv}


def phase_serve(torch, seed: int, workdir: str) -> dict:
    """Full-width PixArt-α-512 served over HTTP through the port."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    import urllib.request

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
    cache, prompts = pixart_cache(workdir, seed)
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
    (kernels whose name holds `kernel`), the device's idle share of the
    batch's wall time, and the VAE decode's span by CUDA events around it
    (its kernels run back to back: `decode_alone` finds its device time
    equal to that span, where the profiler's attribution of kernels to a
    record_function range around the decode counted MMDiT kernels too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dec = pipe.vae_decoder
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed_decode(z, forward=dec.forward):
        events[0].record()
        out = forward(z)
        events[1].record()
        return out

    torch.cuda.synchronize()
    dec.forward = timed_decode
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            pipe(prompt_embeds=cond, latents=noise).images.cpu()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        del dec.forward
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("[profile] no device time in the trace: not measured", flush=True)
        return {}
    attn_ms = sum(e.device_time_total for e in kernels if kernel in e.key) / 1e3
    by_name = {e.key: e.count for e in kernels if kernel in e.key}
    decode_ms = events[0].elapsed_time(events[1])
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    print(f"[profile] one batch of 4: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{kernel} {attn_ms:.1f} ms ({attn_ms / busy_ms:.3f} of busy), "
          f"{type(dec).__name__} decode {decode_ms:.1f} ms by CUDA events "
          f"({decode_ms / busy_ms:.3f} of busy), "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    for e in top:
        print(f"[profile]   {e.device_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "attention_ms": attn_ms,
            "idle_share": 1 - busy_ms / wall_ms, "launches": sum(e.count for e in kernels),
            "decode_ms": decode_ms, "kernel_launches": by_name}


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


def tiny_step_inputs(torch, config, bundle, gen, dev) -> tuple:
    """A tiny step's draws and (cond, uncond) for 3 rows with text lengths
    8, 3 and 1, drawn on the CPU from `gen` and moved to `dev`."""
    from tdm_tpu_torch.train import tdm

    draws = tdm.make_draws(config, 3, bundle.sample_shape, gen, "cpu")
    draws = tdm.StepDraws(*(x.to(dev) for x in draws))
    text = torch.randn(3, bundle.seq_len, bundle.embed_dim, generator=gen).to(dev)
    mask = (torch.arange(bundle.seq_len)[None] < torch.tensor([[8], [3], [1]])).int().to(dev)
    return draws, (text, mask), (torch.zeros_like(text), torch.ones_like(mask))


def uncounted(A, fn) -> tuple:
    """fn()'s result and the kernel launches it made, which are then taken
    off the wrappers' counts: a check, not the main path."""
    before = A.launch_counts()
    out = fn()
    launched = {n: A.launch_counts()[n] - before[n] for n in before}
    for w in A.WRAPPERS:
        w.launches = before[w.__name__]
    return out, launched


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
        draws, cond, uncond = tiny_step_inputs(torch, config, bundle, gen, dev)
        tx = topt.make_optimizer(lr, eps=1e-4)
        state = tdm.init_state(teacher, teacher, tx, tx)
        start = {r: {k: v.clone() for k, v in getattr(state, r).items()}
                 for r in ("student", "critic")}
        step = tdm.build_train_step(bundle.denoise_fn, teacher, bundle.schedule, config,
                                    tx, tx, sample_shape=bundle.sample_shape)
        (state, metrics), launched = uncounted(A, lambda: step(state, draws, cond, uncond))
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
    reference_train_recipe(torch, seed, cpu_params, want)


def phase_reference_train_sd3(torch, seed: int) -> None:
    """One tiny sd3 TDM step (fp32, dmd, MSE; the flow schedule, pooled
    conditioning) on the card (the kernels) against the same step on the
    CPU (the plain versions), from one state with the same draws: the bounds
    of phase_reference_train. MSE, as the recipe check: under the Huber
    loss the student's grad norm is ill-conditioned at one critic update."""
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.train import families, optim as topt, tdm

    lr = 1e-4
    runs = {}
    cpu_params = None
    for dev in ("cpu", "cuda"):
        bundle = families.build("sd3", tiny=True, seed=seed, device=dev)
        if cpu_params is None:
            cpu_params = bundle.init_params()
        teacher = {k: v.to(dev) for k, v in cpu_params.items()}
        gen = torch.Generator(device="cpu").manual_seed(seed + 6)
        config = tdm.TDMConfig(use_huber=False)
        draws, (text, mask), (utext, umask) = tiny_step_inputs(torch, config, bundle, gen, dev)
        pooled = torch.randn(3, bundle.model.cfg.pooled_dim, generator=gen).to(dev)
        cond = bundle.cond_of(text, mask, pooled)
        uncond = bundle.cond_of(utext, umask, torch.zeros_like(pooled))
        tx = topt.make_optimizer(lr, eps=1e-4)
        state = tdm.init_state(teacher, teacher, tx, tx)
        start = {r: {k: v.clone() for k, v in getattr(state, r).items()}
                 for r in ("student", "critic")}
        step = tdm.build_train_step(bundle.denoise_fn, teacher, bundle.schedule, config,
                                    tx, tx, sample_shape=bundle.sample_shape)
        (state, metrics), launched = uncounted(A, lambda: step(state, draws, cond, uncond))
        runs[dev] = (state, metrics, start, launched)
    (cs, cm, cstart, _), (gs, gm, gstart, glaunch) = runs["cpu"], runs["cuda"]
    # 2 joint blocks: 7 no-grad forwards, 2 with grad
    want = {"flash_attention_fwd": 14, "flash_attention_fwd_lse": 4,
            "flash_attention_bwd_dq": 4, "flash_attention_bwd_dkv": 4,
            "splash_attention_fwd": 0}
    check(glaunch == want, f"tiny sd3 step launches {glaunch}, expected {want}")
    worst = {}
    for name in tdm.StepMetrics._fields:
        c, g = float(getattr(cm, name)), float(getattr(gm, name))
        worst[name] = abs(c - g) / max(abs(c), 1e-12)
        check(math.isfinite(g) and abs(c - g) <= 1e-4 * abs(c) + 1e-7,
              f"tiny sd3 step {name}: card {g} vs cpu {c}")
    upd = {}
    for role in ("student", "critic"):
        d_c = torch.cat([(getattr(cs, role)[k] - cstart[role][k]).flatten()
                         for k in cstart[role]])
        d_g = torch.cat([(getattr(gs, role)[k] - gstart[role][k]).cpu().flatten()
                         for k in cstart[role]])
        rel = float((d_g - d_c).norm() / d_c.norm())
        top = float((d_g - d_c).abs().max())
        upd[role] = (rel, top)
        check(float(d_c.abs().max()) > 0.5 * lr, f"tiny sd3 step: {role} did not move")
        check(rel <= 5e-3 and top <= 0.25 * lr,
              f"tiny sd3 step {role} update: rel L2 {rel:.3e}, max {top:.3e}")
    print(f"[reference] tiny sd3 TDM step (dmd, MSE, flow schedule) cuda (kernels: "
          f"{glaunch}) vs cpu (plain): metrics max rel err {max(worst.values()):.3e} (limit "
          f"1e-4); update rel L2 / max: student {upd['student'][0]:.3e} / "
          f"{upd['student'][1]:.3e}, critic {upd['critic'][0]:.3e} / "
          f"{upd['critic'][1]:.3e} (limits 5e-3 / {0.25 * lr:.1e})", flush=True)


def q8_decoded(torch, q, shape):
    """A packed moment's fp32 values and each one's bound on its
    quantization error, one int8 code step at its magnitude:
    (2·sqrt(|x|/s) + 1/254)·s/254, s the block's absmax scale."""
    from tdm_tpu_torch.train import optim as topt

    x = topt.q8_dequantize(q, shape).cpu()
    s = q.scales.cpu().repeat_interleave(topt.Q8_BLOCK)[:x.numel()].reshape(shape)
    return x, (2 * torch.sqrt(x.abs() / s.clamp(min=1e-30)) + 1 / 254) * s / 254


def state_to(torch, obj, dev):
    """A copy of a (nested) train state with every tensor on `dev`."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(dev, copy=True)
    if isinstance(obj, dict):
        return {k: state_to(torch, v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(state_to(torch, v, dev) for v in obj))
    return obj


def q8_moments(torch, opt, params: dict) -> dict:
    """'{mu|nu} {name}' → (fp32 values, one-code-step bound) on the CPU for
    every quantized moment of an accumulating 8-bit optimizer (q8_decoded)."""
    from tdm_tpu_torch.train import optim as topt

    out = {}
    for m in ("mu", "nu"):
        for k, q in topt.leaf_moments(getattr(opt.inner, m), params).items():
            if isinstance(q, topt.Q8Moment):
                check(q.values.dtype == torch.int8, f"{m} {k}: codes are {q.values.dtype}")
                out[f"{m} {k}"] = q8_decoded(torch, q, params[k].shape)
    return out


def reference_train_recipe(torch, seed: int, cpu_params: dict, want: dict) -> None:
    """The tiny step of phase_reference_train with a rank-4 LoRA student
    (both factors seeded), 8-bit Adam and accumulation 2, two windows (four
    micro-steps) on the card against the CPU, the packed 8-bit update cut
    into slices of 40 blocks (several on the tiny critic, some holding two
    leaves). Window 1 starts from zero moments; window 2 starts on both
    sides from the CPU's state after window 1 (its stored int8 codes
    copied to the card), so its update reads stored codes from the same
    inputs. Bounds as the plain tiny step: losses and grad norms to 1e-4
    relative at every micro-step; inside a window every parameter keeps its
    bits; each window's update (new − old params) of each role to 5e-3
    relative L2 and each weight to 25% of lr. The requantized moments may
    differ by one code where a value sits at a rounding boundary, so after
    each window each decoded moment is held within one code step of each
    side (q8_decoded) plus 1e-6 of the leaf's largest value. The loss is
    MSE, as in tests/test_torch_port_train.py's 8-bit step: under the Huber
    loss (c = 1e-3) the student's grad norm of micro-step 3 differed by
    1.2e-4 and 2.6e-4 relative between card and CPU, the second time from
    the same state, while the plain step's differs by 4.1e-5."""
    from tdm_tpu_torch import lora as lora_lib
    from tdm_tpu_torch.io import from_jax
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.train import families, optim as topt, tdm

    lr = 1e-4
    roles = ("student", "critic")
    runs = {}
    full_slice = topt._SLICE
    topt._SLICE = 40 * topt.Q8_BLOCK
    try:
        for dev in ("cpu", "cuda"):
            bundle = families.build("pixart", tiny=True, seed=seed, device=dev)
            teacher = {k: v.to(dev) for k, v in cpu_params.items()}
            lora = seeded_lora(torch, bundle.model, 4, seed + 5)
            factors = {k: v.to(dev) for k, v in lora_lib.factors(lora).items()}
            tx = topt.make_optimizer(lr, eps=1e-4, eight_bit=True, accumulation_steps=2)
            config = tdm.TDMConfig(use_huber=False)
            step = tdm.build_train_step(
                bundle.denoise_fn, teacher, bundle.schedule, config, tx, tx,
                sample_shape=bundle.sample_shape, student_denoise_fn=lora_lib.wrap_denoise_fn(
                    bundle.denoise_fn, lora, stacks=from_jax.layer_stacks(bundle.model.cfg)))
            gen = torch.Generator(device="cpu").manual_seed(seed + 4)
            runs[dev] = {"state": tdm.init_state(factors, teacher, tx, tx), "step": step,
                         "inputs": [tiny_step_inputs(torch, config, bundle, gen, dev)
                                    for _ in range(4)],
                         "params": [], "metrics": [], "launched": [], "moments": []}

        def snapshot(run):
            run["params"].append({r: {k: v.cpu().clone()
                                      for k, v in getattr(run["state"], r).items()}
                                  for r in roles})

        for run in runs.values():
            snapshot(run)
        for i in range(4):
            if i == 2:  # window 2 starts from the CPU's state on both sides
                runs["cuda"]["state"] = state_to(torch, runs["cpu"]["state"], "cuda")
                runs["cuda"]["params"][-1] = runs["cpu"]["params"][-1]
            for run in runs.values():
                draws, cond, uncond = run["inputs"][i]
                (run["state"], metrics), launched = uncounted(
                    A, lambda: run["step"](run["state"], draws, cond, uncond))
                run["metrics"].append(metrics)
                run["launched"].append(launched)
                snapshot(run)
                if i % 2:
                    st = run["state"]
                    run["moments"].append({r: q8_moments(torch, getattr(st, f"{r}_opt"),
                                                         getattr(st, r)) for r in roles})
    finally:
        topt._SLICE = full_slice
    cpu, card = runs["cpu"], runs["cuda"]
    worst, upd = 0.0, {}
    for i, (cm, gm, glaunch) in enumerate(zip(cpu["metrics"], card["metrics"],
                                              card["launched"])):
        check(glaunch == want, f"tiny recipe micro-step {i + 1} launches {glaunch}")
        for name in tdm.StepMetrics._fields:
            c, g = float(getattr(cm, name)), float(getattr(gm, name))
            worst = max(worst, abs(c - g) / max(abs(c), 1e-12))
            check(math.isfinite(g) and abs(c - g) <= 1e-4 * abs(c) + 1e-7,
                  f"tiny recipe micro-step {i + 1} {name}: card {g} vs cpu {c}")
    cp, gp = cpu["params"], card["params"]
    for role in roles:
        for window, lo in ((1, 0), (2, 2)):
            for k in cp[lo][role]:
                check(torch.equal(cp[lo + 1][role][k], cp[lo][role][k])
                      and torch.equal(gp[lo + 1][role][k], gp[lo][role][k]),
                      f"tiny recipe: {role} {k} changed at micro-step {lo + 1}")
            d_c = torch.cat([(cp[lo + 2][role][k] - cp[lo][role][k]).flatten()
                             for k in cp[lo][role]])
            d_g = torch.cat([(gp[lo + 2][role][k] - gp[lo][role][k]).flatten()
                             for k in cp[lo][role]])
            rel = float((d_g - d_c).norm() / d_c.norm())
            top = float((d_g - d_c).abs().max())
            upd[(role, window)] = (rel, top)
            check(float(d_c.abs().max()) > 0.5 * lr,
                  f"tiny recipe: {role} did not move in window {window}")
            check(rel <= 5e-3 and top <= 0.25 * lr,
                  f"tiny recipe {role} window {window} update: rel L2 {rel:.3e}, max {top:.3e}")
    n_q = 0
    for window, (cmom, gmom) in enumerate(zip(cpu["moments"], card["moments"]), 1):
        for role in roles:
            for key, (x_c, e_c) in cmom[role].items():
                n_q += window == 2
                x_g, e_g = gmom[role][key]
                bound = e_c + e_g + 1e-6 * float(x_c.abs().max())
                check(bool(((x_g - x_c).abs() <= bound).all()),
                      f"tiny recipe window {window} {role} {key}: card and cpu moments "
                      "differ by more than one int8 code step")
    for role in roles:
        gopt = getattr(card["state"], f"{role}_opt")
        check((gopt.mini_step, gopt.gradient_step, gopt.inner.count) == (0, 2, 2),
              f"tiny recipe {role}: counters {gopt.mini_step, gopt.gradient_step}")
        check(gopt.inner.mu.codes.is_cuda and gopt.inner.nu.codes.is_cuda,
              f"tiny recipe {role}: moments not on the card")
    check(n_q > 0, "tiny recipe: no quantized moment")
    print(f"[reference] tiny TDM recipe step (rank-4 LoRA, 8-bit Adam, accumulation 2; 2 "
          f"windows of 2 micro-steps, slices of 40 blocks; window 2 from the cpu's state) "
          f"cuda vs cpu: metrics max rel err {worst:.3e} (limit 1e-4); bits kept inside each "
          f"window; update rel L2 / max, windows 1 and 2: " + "; ".join(
              f"{role} {upd[(role, 1)][0]:.3e} / {upd[(role, 1)][1]:.3e}, "
              f"{upd[(role, 2)][0]:.3e} / {upd[(role, 2)][1]:.3e}" for role in roles)
          + f" (limits 5e-3 / {0.25 * lr:.1e}); {n_q} int8 moments within one code step "
          "after each window", flush=True)


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
    from tdm_tpu_torch.io import convert, from_jax, params as params_io
    from tdm_tpu_torch.lora import io as lora_io
    from tdm_tpu_torch.models import mmdit_sd3, vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.serve import server as S

    # SD3-Medium (24 layers, hidden 1536, 24x64 heads, context 4096, pooled
    # 2048, bf16) in the tdm_tpu layout: the seeded transformer of the SD3
    # checkout (written once per run, shared with the diffusers and
    # train_sd3 phases) converted to the JAX package's tree and kept at the
    # checkout's fp16, a seeded TAESD3 decoder, the rank-64 LoRA
    root, _, _ = sd3_checkout(workdir, seed)
    t0 = time.monotonic()
    cfg = mmdit_sd3.MMDiTConfig(attn_impl="splash")
    check((cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.head_dim, cfg.context_dim,
           cfg.pooled_dim, cfg.sample_size) == (24, 1536, 24, 64, 4096, 2048, 128),
          "SD3-Medium widths")
    model_dir = os.path.join(workdir, "sd3_medium")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "pipeline.json"), "w") as f:
        json.dump({"family": "sd3", "model": {"attn_impl": "splash"}, "vae": {}}, f)
    tree = from_jax.flatten_tree(convert.sd3_params(
        convert.load_torch_state_dict(os.path.join(root, "transformer")),
        scan_layers=cfg.scan_layers))
    n_params = sum(a.size for a in tree.values())
    params_io.save_file(tree, os.path.join(model_dir, "transformer.safetensors"))
    del tree
    torch.manual_seed(seed)
    params_io.save_file(
        from_jax.jax_layout(vae.TAESDDecoder(vae.TAESDConfig.taesd3()).state_dict()),
        os.path.join(model_dir, "vae_decoder.safetensors"))
    lora = seeded_lora(torch, mmdit_sd3.SD3Transformer2D(cfg, device="meta"), 64, seed)
    lora_file = os.path.join(workdir, "sd3_tdm_lora.safetensors")
    lora_io.save_kohya(lora, lora_file)
    lora_mb = os.path.getsize(lora_file) / 1e6
    # an embedding cache of 8 prompts: 333 context tokens and a pooled vector
    rng = np.random.default_rng(seed)
    prompts = [f"prompt {i}" for i in range(8)]
    cache = os.path.join(workdir, "sd3_cache.npz")
    EmbeddingCache(
        rng.standard_normal((8, SD3_TXT, 4096)).astype(np.float16),
        np.ones((8, SD3_TXT), np.int32), prompts,
        pooled=rng.standard_normal((8, 2048)).astype(np.float16),
    ).save(cache)
    print(f"[sd3] wrote SD3-Medium ({cfg.num_layers} layers, {n_params / 1e6:.1f}M params "
          f"from the checkout, fp16) in the tdm_tpu layout, a rank-64 kohya LoRA "
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
    check(pipe.family == "sd3" and pipe.transformer.cfg == cfg
          and isinstance(pipe.vae_decoder, vae.TAESDDecoder)
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


# per batch of 4 at 4 NFE: a self and a cross attention in each of the 28
# PixArt blocks
PIXART_LAUNCHES_PER_BATCH = 28 * 2 * 4
# the KL decoder on the card against the CPU, fp32 with TF32 off: the same
# convs, GroupNorms and softmax by other algorithms, relative L2
KL_REL_L2 = 1e-5


def kl_decoder_check(torch, seed: int) -> dict:
    """A tiny KL decoder (4 latent channels, and SD3's 16 at narrow widths)
    on the card against the same decoder and weights on the CPU, fp32 with
    TF32 off: relative L2 under KL_REL_L2, and finite."""
    import dataclasses

    import numpy as np

    from tdm_tpu_torch.io import convert, from_jax, manifest
    from tdm_tpu_torch.models import vae

    out = {}
    for name, vcfg in (("tiny", vae.KLVAEConfig.tiny()),
                       ("sd3_narrow", dataclasses.replace(
                           vae.KLVAEConfig.sd3(), block_widths=(32, 64, 64), norm_groups=8))):
        sd = manifest.synthetic_state_dict("klvae", vcfg, seed=seed, scale=0.3)
        flat = convert.flatten(convert.klvae_params(
            sd, layers_per_block=vcfg.layers_per_block, n_stages=len(vcfg.block_widths)
        )["decoder"])
        z = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (2, vcfg.latent_channels, 24, 20)).astype(np.float32))
        got = {}
        for dev in ("cpu", "cuda"):
            dec = vae.KLDecoder(vcfg, device=dev)
            dec.load_state_dict(from_jax.state_dict_from_jax(flat, dec))
            with torch.inference_mode():
                got[dev] = dec(z.to(dev)).cpu()
        rel = ((got["cuda"] - got["cpu"]).norm() / got["cpu"].norm()).item()
        print(f"[diffusers] KL decoder {name} {list(got['cuda'].shape)} fp32 card vs CPU: "
              f"rel L2 {rel:.3e} (limit {KL_REL_L2})", flush=True)
        check(bool(torch.isfinite(got["cuda"]).all()) and rel <= KL_REL_L2,
              f"the KL decoder ({name}) on the card disagrees with the CPU: rel L2 {rel}")
        out[name] = rel
    return out


def decode_alone(torch, pipe, shape: tuple, seed: int) -> dict:
    """The pipeline's VAE decode of one batch of latents of `shape` alone
    (the cost does not depend on the values): its device time and launches
    under torch.profiler, and its CUDA-event time warm (mean of 3), a
    check on the `vae_decode` range of a profiled batch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(shape, device="cuda", generator=gen)
    dec = pipe.vae_decoder
    flops = [0]

    def count(module, args, out):  # 2 operations per multiply-add
        if isinstance(module, torch.nn.Conv2d):
            flops[0] += 2 * out.numel() * module.in_channels * math.prod(module.kernel_size)
        elif isinstance(module, torch.nn.Linear):
            flops[0] += 2 * out.numel() * module.in_features
        else:  # the mid-block's one-head attention: q·kᵀ and p·v over h·w positions
            b, c, h, w = args[0].shape
            flops[0] += 2 * 2 * b * (h * w) ** 2 * c

    hooks = [m.register_forward_hook(count) for m in dec.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
             or type(m).__name__ == "_MidAttention"]
    with torch.inference_mode():
        dec(z)
        for hook in hooks:
            hook.remove()
        out, launches, device_ms = count_device_work(torch, lambda: dec(z))
        event_ms = time_ms(torch, lambda: dec(z), iters=3, warmup=1)
    check(bool(torch.isfinite(out).all()), f"{type(dec).__name__} decode is not finite")
    rate = flops[0] / (device_ms * 1e-3)
    print(f"[diffusers] {type(dec).__name__} decode alone {list(shape)} -> "
          f"{list(out.shape)} fp32: {device_ms:.1f} ms of device time over {launches} "
          f"launches, {event_ms:.1f} ms by CUDA events (mean of 3); {flops[0] / 1e12:.2f} "
          f"TFLOP in its convs, linears and attention products, {rate / 1e12:.1f} TFLOP/s "
          f"= {rate / PEAK_OPS_S['float32']:.2f} of the fp32 peak", flush=True)
    return {"device_ms": device_ms, "launches": launches, "event_ms": event_ms,
            "tflop": flops[0] / 1e12, "tflop_s": rate / 1e12}


def diffusers_pixart(torch, seed: int, workdir: str) -> dict:
    """The PixArt-α-512 checkout served over HTTP from --model <checkout>:
    the load (its read and conversion apart), 6 concurrent requests (two
    batches of 4, one padded), PNGs, per-seed determinism, the flash
    kernel's launches per batch, and a profiled batch with the KL decode."""
    from concurrent.futures import ThreadPoolExecutor
    import urllib.request

    import numpy as np

    from tdm_tpu_torch.models import vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.serve import server as S

    root = pixart_checkout(workdir, seed)
    cache, prompts = pixart_cache(workdir, seed)
    t0 = time.monotonic()
    args = S.parse_args([
        "--model", root, "--embedding_cache", cache, "--port", "0",
        "--batch_size", "4", "--max_delay_ms", "1000", "--warmup",
    ])
    with timed_calls(torch, load_targets()) as times:
        server = S.build_server(args).start()
    up_s = time.monotonic() - t0
    load = load_report(times)
    stats, pipe = server.batcher.stats, server.batcher.pipe
    check(isinstance(pipe.vae_decoder, vae.KLDecoder) and pipe.vae_range == "pm1"
          and pipe.vae_scaling == 0.18215 and pipe.vae_decoder.cfg.dtype == torch.float32
          and pipe.transformer.cfg.dtype == torch.bfloat16, "the served PixArt checkout")
    print(f"[diffusers] PixArt-α-512 checkout loaded in {load['load_s']:.2f}s (safetensors "
          f"read {load['read_s']:.2f}s, conversion {load['convert_s']:.3f}s = "
          f"{load['convert_share']:.3f} of the load, modules and copy to the card "
          f"{load['build_and_copy_s']:.2f}s); server up and warm in {up_s:.1f}s (warm-up "
          f"batch {stats.last_batch_latency_s:.3f}s)", flush=True)

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
        # the main path: counts to 0, 6 concurrent requests, then one alone
        A.reset_launches()
        b0, pad0 = stats.batches, stats.rows_padded
        t0 = time.monotonic()
        with ThreadPoolExecutor(6) as ex:
            replies = list(ex.map(lambda i: post(prompts[i], 300 + i), range(6)))
        wall6 = time.monotonic() - t0
        batches6 = stats.batches - b0
        solo, solo_s = post(prompts[0], 300)
        launches = A.launch_counts()
        batches = stats.batches - b0
        solo_batch_s = stats.last_batch_latency_s
    finally:
        server.close()
    for reply, _ in replies + [(solo, solo_s)]:
        check(reply.get("format") == "png" and reply.get("shape") == [512, 512, 3],
              f"reply {str(reply)[:200]}")
        check_png(base64.b64decode(reply["image"]), 512, 512)
    check(batches6 == 2 and stats.rows_padded - pad0 == 2 + 3,
          f"6 requests ran as {batches6} batches")
    check(solo["image"] == replies[0][0]["image"],
          "same (prompt, seed) gave different bytes in another batch")
    check(len({r["image"] for r, _ in replies}) == 6, "distinct seeds gave equal images")
    check(launches["flash_attention_fwd"] == PIXART_LAUNCHES_PER_BATCH * batches
          and sum(launches.values()) == launches["flash_attention_fwd"],
          f"launches {launches} over {batches} batches, expected "
          f"{PIXART_LAUNCHES_PER_BATCH} flash_fwd and nothing else per batch")
    lat = [t for _, t in replies]
    print(f"[diffusers] PixArt checkout: 6 concurrent requests in {wall6:.3f}s as "
          f"{batches6} batches ({6 / wall6:.2f} images/s), request latency "
          f"{min(lat):.3f}-{max(lat):.3f}s; lone request {solo_s:.3f}s, its batch "
          f"{solo_batch_s:.3f}s; same (prompt, seed) -> same PNG bytes; launches "
          f"{launches} = {PIXART_LAUNCHES_PER_BATCH} flash_fwd x {batches} batches", flush=True)
    cond = tuple(np.concatenate([x] * 4) for x in server.batcher.cond_fn(prompts[1]))
    prof = profile_batch(torch, pipe, cond, torch.randn(4, 4, 64, 64))
    decode = decode_alone(torch, pipe, (4, 4, 64, 64), seed)
    return {"load": load, "up_s": up_s, "decode": decode,
            "launches": launches["flash_attention_fwd"], "batches": batches, "launches_per_batch": PIXART_LAUNCHES_PER_BATCH,
            "wall6_s": wall6, "images_per_s": 6 / wall6, "batch_s": solo_batch_s,
            "solo_s": solo_s, "profile": prof}


def sd3_checkout(workdir: str, seed: int) -> tuple[str, float, int]:
    """The SD3-Medium checkout (24 layers, hidden 1536, 24x64 heads, context
    4096, pooled 2048; its 16-channel AutoencoderKL, scaling 1.5305, shift
    0.0609), written once per run: (its root, the seconds and parameters of
    the write, 0 when it was there)."""
    from tdm_tpu_torch.models import mmdit_sd3, vae

    cfg, vcfg = mmdit_sd3.MMDiTConfig(), vae.KLVAEConfig.sd3()
    check((cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.head_dim, cfg.attn_impl,
           cfg.context_dim, cfg.pooled_dim, vcfg.latent_channels, vcfg.scaling_factor,
           vcfg.shift_factor)
          == (24, 1536, 24, 64, "auto", 4096, 2048, 16, 1.5305, 0.0609),
          "SD3-Medium and its VAE")
    root = os.path.join(workdir, "stable-diffusion-3-medium-diffusers")
    if os.path.exists(os.path.join(root, "model_index.json")):
        return root, 0.0, 0
    secs, n = write_checkout(root, "sd3", cfg, vcfg, seed)
    print(f"[checkout] wrote the SD3-Medium diffusers checkout ({n / 1e6:.1f}M params at "
          f"fp16) in {secs:.1f}s", flush=True)
    return root, secs, n


def diffusers_sd3(torch, seed: int, workdir: str) -> dict:
    """The SD3-Medium checkout (24 layers, hidden 1536, 24x64 heads; its
    16-channel AutoencoderKL, scaling 1.5305, shift 0.0609) through
    from_pretrained at the default attn_impl ('auto': the flash kernel):
    the load, then one warm batch of 4 at 1024² through the pipeline, timed,
    with the kernel's launches counted, and one profiled."""
    import numpy as np

    from tdm_tpu_torch.models import vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import from_pretrained

    root, secs, n = sd3_checkout(workdir, seed)
    torch.cuda.empty_cache()
    with timed_calls(torch, load_targets()) as times:
        pipe = from_pretrained(root)
    load = load_report(times)
    check(pipe.family == "sd3" and pipe.transformer.cfg.attn_impl == "auto"
          and pipe.transformer.cfg.dtype == torch.bfloat16
          and isinstance(pipe.vae_decoder, vae.KLDecoder)
          and (pipe.vae_scaling, pipe.vae_shift, pipe.vae_range) == (1.5305, 0.0609, "pm1"),
          "the SD3 checkout's pipeline")
    print(f"[diffusers] SD3-Medium checkout loaded in {load['load_s']:.2f}s (safetensors "
          f"read {load['read_s']:.2f}s, conversion {load['convert_s']:.3f}s = "
          f"{load['convert_share']:.3f} of the load, modules and copy to the card "
          f"{load['build_and_copy_s']:.2f}s)", flush=True)
    rng = np.random.default_rng(seed + 3)
    cond = (rng.standard_normal((4, SD3_TXT, 4096)).astype(np.float16),
            rng.standard_normal((4, 2048)).astype(np.float16))
    noise = torch.from_numpy(rng.standard_normal((4, 16, 128, 128)).astype(np.float32))
    call = dict(prompt_embeds=cond, latents=noise, height=1024, width=1024)
    pipe(**call)  # warm
    torch.cuda.synchronize()
    # the main path: counts to 0, one batch of 4, read just after
    A.reset_launches()
    t0 = time.monotonic()
    images = pipe(**call).images.cpu()
    batch_s = time.monotonic() - t0
    launches = A.launch_counts()
    check(launches["flash_attention_fwd"] == SD3_LAUNCHES_PER_BATCH
          and sum(launches.values()) == SD3_LAUNCHES_PER_BATCH,
          f"SD3 checkout batch launches {launches}, expected {SD3_LAUNCHES_PER_BATCH} "
          "flash_fwd and nothing else")
    check(tuple(images.shape) == (4, 1024, 1024, 3) and bool(torch.isfinite(images).all())
          and images.std().item() > 0.01, f"SD3 checkout images {tuple(images.shape)}")
    print(f"[diffusers] SD3 checkout: one batch of 4 at 1024² in {batch_s:.3f}s "
          f"({4 / batch_s:.2f} images/s), images finite (std {images.std().item():.3f}); "
          f"launches {launches}", flush=True)
    prof = profile_batch(torch, pipe, cond, noise)
    per_call = prof["attention_ms"] / SD3_LAUNCHES_PER_BATCH if prof else None
    if per_call is not None:
        print(f"[diffusers] SD3 checkout: flash_fwd {per_call:.3f} ms per call at "
              f"[4,24,{SD3_S},{SD3_S},64] in the profiled batch", flush=True)
    decode = decode_alone(torch, pipe, (4, 16, 128, 128), seed)
    del pipe
    torch.cuda.empty_cache()
    return {"load": load, "checkout_write_s": secs, "decode": decode, "params": n,
            "batch_s": batch_s, "images_per_s": 4 / batch_s, "launches": launches["flash_attention_fwd"],
            "launches_per_batch": SD3_LAUNCHES_PER_BATCH, "profile": prof,
            "flash_fwd_ms_per_call": per_call}


def phase_diffusers(torch, seed: int, workdir: str) -> dict:
    """Stock diffusers checkouts at full width: the KL decoder on the card
    against the CPU, PixArt-α-512 served over HTTP from its checkout, and
    SD3-Medium at 1024² from its checkout through the pipeline."""
    return {"kl_check": kl_decoder_check(torch, seed),
            "pixart": diffusers_pixart(torch, seed, workdir),
            "sd3": diffusers_sd3(torch, seed, workdir)}


# ---------------------------------------------------------------------------
# SD1.5 / Dreamshaper served from a diffusers checkout
# ---------------------------------------------------------------------------


def sd15_reference(torch, seed: int, workdir: str) -> dict:
    """A small SD1.5 pipeline whose levels run at head dims 80 and 160 (one
    head over widths 80/160), fp32, with a merged kohya LoRA on its
    attention projections, on the card (kernel 1's fp32 path) against the
    same pipeline on the CPU (the plain version): the sampler state is bf16
    in both, so the latents agree to one bf16 ulp of their scale and the
    images to half a PNG step."""
    import dataclasses

    import numpy as np

    from tdm_tpu_torch.lora import io as lora_io
    from tdm_tpu_torch.models import unet_sd15, vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import SD15Pipeline

    torch.manual_seed(seed)
    cfg = dataclasses.replace(unet_sd15.UNetConfig.tiny(), block_widths=(80, 160), num_heads=1)
    pipes = [SD15Pipeline(unet_sd15.UNet2DCondition(cfg, device=dev),
                          vae_decoder=vae.KLDecoder(vae.KLVAEConfig.tiny(), device=dev),
                          device=dev) for dev in ("cpu", "cuda")]
    cpu, gpu = pipes
    gpu.unet.load_state_dict(cpu.unet.state_dict())
    gpu.vae_decoder.load_state_dict(cpu.vae_decoder.state_dict())
    lora_file = os.path.join(workdir, "tiny_sd15_lora.safetensors")
    lora_io.save_kohya(sd15_lora(torch, cpu.unet, 4, seed), lora_file)
    for pipe in pipes:
        pipe.load_lora_weights(lora_file, adapter_name="tdm")
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((3, SD15_TXT, cfg.context_dim)).astype(np.float32)
    mask = (np.arange(SD15_TXT)[None] < np.array([[77], [9], [0]])).astype(np.int32)
    kw = dict(prompt_embeds=(ctx, mask), latents=lat, height=128, width=128)
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
    print(f"[sd15] small SD1.5 pipeline (head dims 80/160, fp32, LoRA) cuda (kernel 1, "
          f"{launched['flash_attention_fwd']} launches) vs cpu (plain): latents max_abs_err "
          f"{dl.max().item():.3e} of scale {scale:.3g}, {(dl > 0).float().mean().item():.4f} of "
          f"elements differ; images max_abs_err {di:.3e}", flush=True)
    check(launched["flash_attention_fwd"] == 4 * 2 * 4 and sum(launched.values()) == 4 * 2 * 4,
          f"small SD1.5 pipeline launches {launched}")
    check(dl.max().item() <= 2**-7 * scale, "small SD1.5 latents disagree")
    check((dl > 0).float().mean().item() < 0.01, "small SD1.5 latents disagree")
    check(di <= 2e-3, "small SD1.5 images disagree")
    return {"latents_max_abs_err": dl.max().item(), "images_max_abs_err": di}


def sd15_lora(torch, unet, rank: int, seed: int):
    """A LoRA of `rank` on the UNet's attention projections (to_q, to_k,
    to_v, to_out of every self and cross attention), both factors drawn
    from the seed."""
    from tdm_tpu_torch.lora import adapter

    gen = torch.Generator().manual_seed(seed)
    lora = adapter.init_lora(
        unet, rank, generator=gen,
        target=lambda path, shape: path[-1] in ("to_q", "to_k", "to_v", "to_out"))
    for entry in lora.params.values():
        entry["b"] = 0.02 * torch.randn(entry["b"].shape, generator=gen)
    return lora


def sd15_checkout(torch, workdir: str, seed: int) -> tuple[str, float, int]:
    """The SD1.5 checkout (the UNet at widths 320/640/1280/1280, 2 layers a
    block, 8 heads, context 768, GroupNorm 32; the 4-channel AutoencoderKL
    [128, 256, 512, 512], scaling 0.18215) as `StableDiffusionPipeline`
    ships it: model_index.json, unet/ and vae/, each a config.json and one
    fp16 safetensors file of seeded weights in the released key layout.
    Returns (its root, the seconds and parameters of the write)."""
    from tdm_tpu_torch.models import unet_sd15, vae

    cfg, vcfg = unet_sd15.UNetConfig(), vae.KLVAEConfig()
    check((tuple(cfg.block_widths), cfg.layers_per_block, cfg.num_heads, cfg.context_dim,
           cfg.norm_groups, cfg.dtype, tuple(vcfg.block_widths), vcfg.scaling_factor)
          == ((320, 640, 1280, 1280), 2, 8, 768, 32, torch.bfloat16, (128, 256, 512, 512),
              0.18215), "SD1.5 and its VAE")
    root = os.path.join(workdir, "stable-diffusion-v1-5")
    secs, n = write_checkout(root, "unet_sd15", cfg, vcfg, seed)
    print(f"[checkout] wrote the SD1.5 diffusers checkout ({n / 1e6:.1f}M params at fp16) "
          f"in {secs:.1f}s", flush=True)
    return root, secs, n


def sd15_cache(workdir: str, seed: int) -> tuple[str, list]:
    """An embedding cache of 8 prompts: CLIP-L last hidden states [77, 768]
    with every token live, as SD1.5's UNet attends them."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache

    prompts = [f"sd15 prompt {i}" for i in range(8)]
    cache = os.path.join(workdir, "clip_cache.npz")
    rng = np.random.default_rng(seed + 5)
    EmbeddingCache(rng.standard_normal((8, SD15_TXT, 768)).astype(np.float16),
                   np.ones((8, SD15_TXT), np.int32), prompts).save(cache)
    return cache, prompts


def sd15_forward_check(torch, unet, seed: int) -> float:
    """One full-width UNet forward at 512², batch 4, with kernel 1 against
    the same forward with the plain attention, both on the card: bf16
    through 16 transformers and 22 ResBlocks, so the check is relative (L2
    error under 2%)."""
    import numpy as np

    from tdm_tpu_torch.ops import attention as A

    rng = np.random.default_rng(seed + 7)
    lat = torch.from_numpy(rng.standard_normal((4, 4, 64, 64)).astype(np.float32)).cuda()
    ctx = torch.from_numpy(rng.standard_normal((4, SD15_TXT, 768)).astype(np.float32)).cuda()
    mask = torch.ones(4, SD15_TXT, dtype=torch.int32, device="cuda")
    t = torch.tensor([999, 749, 500, 250], device="cuda")
    before = A.launch_counts()
    with torch.inference_mode():
        out = unet(lat, t, ctx, mask).float()
        with forced_attention("plain"):
            ref = unet(lat, t, ctx, mask).float()
    for w in A.WRAPPERS:  # a check, not the main path
        w.launches = before[w.__name__]
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"[sd15] full-width UNet forward, kernel vs plain attention: rel L2 {rel:.3e}, "
          f"finite {bool(torch.isfinite(out).all())}", flush=True)
    check(bool(torch.isfinite(out).all()) and rel < 2e-2,
          f"full-width UNet forward disagrees: rel L2 {rel}")
    return rel


def phase_sd15(torch, seed: int, workdir: str) -> dict:
    """SD1.5 served over HTTP from a full-width diffusers checkout with a
    rank-64 kohya LoRA merged at load: 8 concurrent requests (two batches
    of 4) and one alone, PNGs that are not constant, per-seed determinism,
    kernel 1's launches per batch (128, 48 at head dim 160, and nothing
    else), a profiled batch, the KL decode alone, and one full-width forward
    against plain attention."""
    from concurrent.futures import ThreadPoolExecutor
    import urllib.request

    import numpy as np

    from tdm_tpu_torch.io import convert
    from tdm_tpu_torch.lora import io as lora_io
    from tdm_tpu_torch.models import unet_sd15, vae
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.serve import server as S

    torch.cuda.empty_cache()
    reference = sd15_reference(torch, seed, workdir)
    root, write_s, n_params = sd15_checkout(torch, workdir, seed)
    cache, prompts = sd15_cache(workdir, seed)
    lora_file = os.path.join(workdir, "sd15_tdm_lora.safetensors")
    lora = sd15_lora(torch, unet_sd15.UNet2DCondition(device="meta"), 64, seed)
    lora_io.save_kohya(lora, lora_file)
    t0 = time.monotonic()
    args = S.parse_args([
        "--model", root, "--lora", lora_file, "--embedding_cache", cache, "--port", "0",
        "--batch_size", "4", "--max_delay_ms", "1000", "--warmup",
    ])
    with timed_calls(torch, load_targets() + [(convert, "unet_sd15_params")]) as times:
        server = S.build_server(args).start()
    up_s = time.monotonic() - t0
    load = load_report(times)
    stats, pipe = server.batcher.stats, server.batcher.pipe
    check(pipe.family == "sd15" and pipe.unet.cfg == unet_sd15.UNetConfig()
          and isinstance(pipe.vae_decoder, vae.KLDecoder) and pipe.vae_range == "pm1"
          and pipe.vae_scaling == 0.18215 and pipe.vae_decoder.cfg.dtype == torch.float32
          and pipe._active == (("tdm", 1.0),), "the served SD1.5 checkout")
    print(f"[sd15] SD1.5 checkout with a rank-64 LoRA ({len(lora.params)} projections) loaded "
          f"in {load['load_s']:.2f}s (safetensors read {load['read_s']:.2f}s, conversion "
          f"{load['convert_s']:.3f}s, modules and copy to the card "
          f"{load['build_and_copy_s']:.2f}s); server up and warm in {up_s:.1f}s (warm-up "
          f"batch {stats.last_batch_latency_s:.3f}s)", flush=True)

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
        # the main path: counts to 0, 8 concurrent requests, then one alone
        A.reset_launches()
        b0, pad0 = stats.batches, stats.rows_padded
        t0 = time.monotonic()
        with ThreadPoolExecutor(8) as ex:
            replies = list(ex.map(lambda i: post(prompts[i], 500 + i), range(8)))
        wall8 = time.monotonic() - t0
        batches8 = stats.batches - b0
        full_batch_s = stats.last_batch_latency_s
        solo, solo_s = post(prompts[0], 500)
        launches = A.launch_counts()
        batches = stats.batches - b0
    finally:
        server.close()
    stds, pixels = [], []
    for reply, _ in replies + [(solo, solo_s)]:
        check(reply.get("format") == "png" and reply.get("shape") == [512, 512, 3],
              f"reply {str(reply)[:200]}")
        pixels.append(check_png(base64.b64decode(reply["image"]), 512, 512).astype(np.int16))
        stds.append(float(pixels[-1].std()))
    solo_diff = np.abs(pixels[-1] - pixels[0])
    check(min(stds) > 1.0, f"a served image is (nearly) constant: pixel std {min(stds)}")
    check(batches8 == 2 and stats.rows_padded - pad0 == 3,
          f"8 requests ran as {batches8} batches")
    check(solo["image"] == replies[0][0]["image"],
          f"same (prompt, seed) gave different bytes in another batch: "
          f"{int((solo_diff > 0).sum())} of {solo_diff.size} pixel values differ, by at most "
          f"{int(solo_diff.max())}")
    check(len({r["image"] for r, _ in replies}) == 8, "distinct seeds gave equal images")
    check(launches["flash_attention_fwd"] == SD15_LAUNCHES_PER_BATCH * batches
          and sum(launches.values()) == launches["flash_attention_fwd"],
          f"launches {launches} over {batches} batches, expected "
          f"{SD15_LAUNCHES_PER_BATCH} flash_fwd and nothing else per batch")
    lat = [t for _, t in replies]
    print(f"[sd15] 8 concurrent requests in {wall8:.3f}s as {batches8} batches of 4 "
          f"({8 / wall8:.2f} images/s), request latency {min(lat):.3f}-{max(lat):.3f}s, "
          f"last full batch {full_batch_s:.3f}s; lone request {solo_s:.3f}s; same (prompt, "
          f"seed) -> same PNG bytes; pixel std {min(stds):.1f}-{max(stds):.1f}; launches "
          f"{launches} = {SD15_LAUNCHES_PER_BATCH} flash_fwd x {batches} batches", flush=True)
    cond = tuple(np.concatenate([x] * 4) for x in server.batcher.cond_fn(prompts[1]))
    noise = torch.randn(4, 4, 64, 64)
    with torch.inference_mode():
        images = pipe(prompt_embeds=cond, latents=noise).images.cpu()
    check(tuple(images.shape) == (4, 512, 512, 3) and bool(torch.isfinite(images).all())
          and images.std().item() > 0.01, f"SD1.5 images {tuple(images.shape)}")
    torch.cuda.reset_peak_memory_stats()
    prof = profile_batch(torch, pipe, cond, noise)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_dim = {dp: sum(c for k, c in prof.get("kernel_launches", {}).items()
                      if f"flash_fwd_sm90_kernel<{dp}," in k) for dp in (64, 80, 160)}
    if prof:
        check(sum(prof["kernel_launches"].values()) == SD15_LAUNCHES_PER_BATCH
              and by_dim[160] == SD15_D160_PER_BATCH and by_dim[64] == by_dim[80] == 40,
              f"profiled SD1.5 batch: kernel 1 launches {prof['kernel_launches']}")
        print(f"[sd15] profiled batch: kernel 1 launches by padded head dim {by_dim} "
              f"(D 40 reads DP 64); peak device memory {peak_gb:.2f} GB", flush=True)
    decode = decode_alone(torch, pipe, (4, 4, 64, 64), seed)
    rel = sd15_forward_check(torch, pipe.unet, seed)
    del pipe
    torch.cuda.empty_cache()
    return {"reference": reference, "load": load, "up_s": up_s, "checkout_write_s": write_s,
            "params": n_params, "lora_projections": len(lora.params),
            "launches": launches["flash_attention_fwd"], "batches": batches,
            "launches_per_batch": SD15_LAUNCHES_PER_BATCH, "launches_by_head_dim": by_dim,
            "wall8_s": wall8, "images_per_s": 8 / wall8, "batch_s": full_batch_s,
            "solo_s": solo_s, "profile": prof, "peak_gb": peak_gb, "decode": decode,
            "forward_rel_l2": rel}


TRAIN_STEPS = 3
# per step at batch 4, dmd, cfg 4.5, critic_updates 1: 7 forwards without
# grad (rollout x4, x0_gen_sg, teacher CFG probe at 2B, critic probe) and 2
# with grad (critic DSM, student loss), each 28 blocks x (self, cross)
TRAIN_LAUNCHES = {"flash_attention_fwd": 392, "flash_attention_fwd_lse": 112,
                  "flash_attention_bwd_dq": 112, "flash_attention_bwd_dkv": 112,
                  "splash_attention_fwd": 0}
# the train_lora phase: rank-32 LoRA student, 8-bit Adam, 2 micro-steps per
# optimizer step, 2 optimizer steps
LORA_RANK, LORA_ACCUM, LORA_STEPS = 32, 2, 2
# the export's rank-32 reconstruction of one ΔW against float64's optimum
EXPORT_TOL = 1e-3


def train_env(seed: int, workdir: str) -> None:
    """A seeded full-width embedding cache (8 prompts of 120 T5 tokens at
    4096, ragged masks, a one-token empty prompt) as $TDM_EMBEDDING_CACHE,
    and the full-size model (no $TDM_TINY_MODEL, no validation decoder)."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache

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


def count_device_work(torch, fn) -> tuple:
    """(result, device work items launched, their device ms) of one call
    of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return out, sum(e.count for e in kern), sum(e.device_time_total for e in kern) / 1e3


def step_hook(torch, records: list, profile_at: int, tag: str, after=None):
    """A `step_hook` for train_tdm.main: each call (a micro-step) timed by
    the host clock and CUDA events, its kernels' launches counted, the
    `profile_at`-th call under torch.profiler (device busy time, every
    device launch, the top kernels); `after(rec, state)` sees each call's
    record and state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tdm_tpu_torch.ops import attention as A

    def hook(step, run):
        n = len(records) + 1
        before = A.launch_counts()
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            if n == profile_at else None
        if prof is not None:
            prof.__enter__()
        t0 = time.monotonic()
        ev0.record()
        state, metrics = run()
        ev1.record()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        rec = {"step": step, "micro": n, "host_s": wall, "event_ms": ev0.elapsed_time(ev1),
               "busy_ms": None,
               "launches": {k: A.launch_counts()[k] - before[k] for k in before},
               "metrics": {k: float(v) for k, v in metrics._asdict().items()}}
        if prof is not None:
            prof.__exit__(None, None, None)
            kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            rec["busy_ms"] = sum(e.device_time_total for e in kern) / 1e3
            rec["all_launches"] = sum(e.count for e in kern)
            flash = [e for e in kern if "flash_" in e.key]
            top = sorted(kern, key=lambda e: -e.device_time_total)[:10]
            for e in top + [e for e in flash if e not in top]:
                print(f"[profile]   {e.device_time_total / 1e3:8.2f} ms  x{e.count:<6d} "
                      f"{e.key[:90]}", flush=True)
            print(f"[profile] {tag} micro-step {n}: device busy {rec['busy_ms']:.1f} ms, "
                  f"the flash kernels {sum(e.device_time_total for e in flash) / 1e3:.1f} "
                  f"ms, {rec['all_launches']} device launches", flush=True)
        if after is not None:
            after(rec, state)
        records.append(rec)
        print(f"[{tag}] step {step} (micro-step {n}): host {wall:.3f}s, CUDA events "
              f"{rec['event_ms']:.1f} ms, launches {rec['launches']}, {rec['metrics']}",
              flush=True)
        return state, metrics

    return hook


def check_train_records(records: list, n: int) -> None:
    check(len(records) == n, f"{len(records)} micro-steps ran, expected {n}")
    for rec in records:
        check(rec["launches"] == TRAIN_LAUNCHES,
              f"micro-step {rec['micro']} launches {rec['launches']}, expected {TRAIN_LAUNCHES}")
        check(all(math.isfinite(v) for v in rec["metrics"].values()),
              f"micro-step {rec['micro']}: non-finite metrics {rec['metrics']}")


def kohya_pieces(torch, path: str, rank: int) -> int:
    """The adapted (kernel, layer) pairs of a kohya file, checking that each
    has its three keys and rank-`rank` factors."""
    from tdm_tpu_torch.io import params as params_io

    flat = params_io.load_file(path)
    downs = [k for k in flat if k.endswith(".lora_down.weight")]
    for k in downs:
        up = k.replace(".lora_down.", ".lora_up.")
        check(up in flat and k.replace(".lora_down.weight", ".alpha") in flat,
              f"{path}: {k} lacks its up factor or alpha")
        check(flat[k].shape[0] == rank and flat[up].shape[1] == rank,
              f"{path}: {k} has rank {flat[k].shape[0]}, expected {rank}")
    check(len(flat) == 3 * len(downs), f"{path}: {len(flat)} keys for {len(downs)} pieces")
    return len(downs)


def phase_train(torch, seed: int, workdir: str) -> dict:
    """Full-width PixArt-α-512 TDM training through the CLI's main() at the
    JAX CLI's default flags, the teacher read from the PixArt checkout's
    transformer/ folder (--pretrained_model_name_or_path; its load timed
    by part): seeded weights, a seeded full-width embedding
    cache, batch 4, bf16, dmd, 3 steps, then the export of the rank-32
    kohya LoRA by truncated SVD (--export_lora_rank 32, the default). Per
    step: host and CUDA-event times and the kernels' launches (checked);
    step 3 under torch.profiler for device busy time. The export: its
    seconds, its key count (3 per adapted kernel and layer), and one
    kernel's rank-32 reconstruction against a float64 SVD of its ΔW."""
    from tdm_tpu_torch import lora as lora_lib
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.ops import attention as A

    teacher_dir = os.path.join(pixart_checkout(workdir, seed), "transformer")
    train_env(seed, workdir)
    out = os.path.join(workdir, "train")
    free_gb = shutil.disk_usage(workdir).free / 1e9
    print(f"[train] {free_gb:.0f} GB free for the run's checkpoint", flush=True)
    steps = []
    watch = ("blocks.0.attn1.to_q.weight", "blocks.0.ff.proj_out.weight", "proj_out.weight")
    snap = {}

    def after(rec, state):
        if rec["micro"] == 1:
            snap.update({k: state.student[k].clone() for k in watch})
        if rec["micro"] == 2:
            rec["student_changed"] = all(
                bool((state.student[k] != snap[k]).any()) for k in watch)

    export = {}
    extract = lora_lib.extract_lora

    def timed_extract(model, base, tuned, rank, **kw):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        lora = extract(model, base, tuned, rank, **kw)
        torch.cuda.synchronize()
        export["s"] = time.monotonic() - t0
        key, mpath = "blocks.0.attn1.to_q.weight", "blocks/attn1/to_q"
        export["delta"] = (tuned[key].float() - base[key].float()).T.double().cpu()
        export["ab"] = (lora.params[mpath]["a"][0].double()
                        @ lora.params[mpath]["b"][0].double()).cpu()
        export["pieces"] = sum(e["a"].shape[0] if e["a"].dim() == 3 else 1
                               for e in lora.params.values())
        return lora

    A.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    lora_lib.extract_lora = timed_extract
    # the teacher's load: the directory's read, the conversion, the carry and
    # the copy into the module on the card (nothing else in the run loads)
    load_parts = [(convert, "load_torch_state_dict"), (convert, "pixart_params"),
                  (from_jax, "state_dict_from_jax"), (torch.nn.Module, "load_state_dict")]
    try:
        with timed_calls(torch, load_parts) as teacher_times:
            train_tdm.main([
                "--output_dir", out, "--max_train_steps", str(TRAIN_STEPS),
                "--train_batch_size", "4", "--mixed_precision", "bf16", "--loss_mode", "dmd",
                "--seed", str(seed), "--pretrained_model_name_or_path", teacher_dir,
            ], step_hook=step_hook(torch, steps, TRAIN_STEPS, "train", after))
    finally:
        lora_lib.extract_lora = extract
    total_s = time.monotonic() - t0
    check(set(teacher_times) == {name for _, name in load_parts},
          f"the teacher was not loaded from {teacher_dir}: {teacher_times}")
    teacher_s = sum(teacher_times.values())
    print(f"[train] teacher from {teacher_dir}: loaded in {teacher_s:.2f}s (safetensors read "
          f"{teacher_times['load_torch_state_dict']:.2f}s, conversion "
          f"{teacher_times['pixart_params']:.3f}s, carry "
          f"{teacher_times['state_dict_from_jax']:.2f}s, copy into the module "
          f"{teacher_times['load_state_dict']:.2f}s)", flush=True)
    launches = A.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    run_dir = out + "_cfg4.5_steps900"
    ckpt = os.path.join(run_dir, f"checkpoint-{TRAIN_STEPS}")
    ckpt_gb = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt)) / 1e9
    student_gb = os.path.getsize(os.path.join(run_dir, "student.safetensors")) / 1e9
    check_train_records(steps, TRAIN_STEPS)
    check(steps[1]["student_changed"], "the student did not change in step 2")
    check("s" in export, "the LoRA export did not run")
    pieces = kohya_pieces(torch, os.path.join(run_dir, "tdm_lora.safetensors"), 32)
    check(pieces == export["pieces"], f"kohya file: {pieces} pieces, the export made "
                                      f"{export['pieces']}")
    delta = export["delta"]
    sv = torch.linalg.svdvals(delta)
    norm = float(delta.norm())
    opt_err = float(sv[32:].norm()) / norm
    err = float((delta - export["ab"]).norm()) / norm
    print(f"[train] export: rank-32 kohya LoRA of {pieces} (kernel, layer) pieces "
          f"({3 * pieces} keys) in {export['s']:.2f} s; blocks.0 attn1.to_q rank-32 "
          f"relative error {err:.6f} against the float64 optimum {opt_err:.6f} "
          f"(limit +-{EXPORT_TOL})", flush=True)
    check(abs(err - opt_err) <= EXPORT_TOL,
          f"the rank-32 export of blocks.0 attn1.to_q: relative error {err}, optimum {opt_err}")
    shutil.rmtree(run_dir, ignore_errors=True)  # the disk for the later phases
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
          + f"; main() {total_s:.1f}s incl. a {ckpt_gb:.1f} GB checkpoint, a "
          f"{student_gb:.2f} GB fp16 student and the export", flush=True)
    return {"s_per_step": per_step, "iters_per_hour": 3600 / per_step,
            "teacher_load_s": teacher_s, "teacher_load": teacher_times,
            "first_step_s": steps[0]["host_s"], "peak_gib": peak_gb,
            "idle_share": idle, "busy_ms": busy, "event_span_ms": span,
            "launches": launches, "launches_per_step": TRAIN_LAUNCHES,
            "all_launches_per_step": steps[-1].get("all_launches"),
            "checkpoint_gb": ckpt_gb, "main_s": total_s,
            "export": {"s": export["s"], "pieces": pieces, "keys": 3 * pieces,
                       "rel_err": err, "optimal_rel_err": opt_err},
            "steps": steps}


def optimizer_work(torch, params: dict, seed: int) -> dict:
    """Device launches and device ms of one update of each optimizer the
    training path builds, on `params` with seeded gradients, each after a
    warm-up update of its own: clip + AdamW, clip + 8-bit Adam, and 8-bit
    Adam under accumulation 2 (a micro-step inside the window, then the one
    that updates); and apply_updates. The parameters are not changed."""
    from tdm_tpu_torch.train import optim as topt

    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads = {k: 1e-3 * torch.randn(p.shape, generator=gen, device=p.device)
             for k, p in params.items()}
    out = {"leaves": len(params), "elements": sum(p.numel() for p in params.values())}
    for name, kw in (("adamw", {}), ("adam8bit", {"eight_bit": True}),
                     ("adam8bit_accum", {"eight_bit": True, "accumulation_steps": LORA_ACCUM})):
        tx = topt.make_optimizer(1e-5, **kw)
        opt = tx.init(params)
        phases = ("inside_window", "updating") if "accumulation_steps" in kw else ("update",)
        for _ in phases:  # warm-up: one window
            _, opt = tx.update(grads, opt, params)
        out[name] = {}
        for phase in phases:
            (updates, opt), n, ms = count_device_work(
                torch, lambda: tx.update(grads, opt, params))
            out[name][phase] = {"launches": n, "device_ms": ms}
        del opt
    dests = {k: p.clone() for k, p in params.items()}
    _, n, ms = count_device_work(torch, lambda: topt.apply_updates(dests, updates))
    out["apply_updates"] = {"launches": n, "device_ms": ms}
    return out


def prompts_txt(workdir: str, n: int = 64) -> str:
    """A .txt prompt shard of `n` lines, one prompt each."""
    path = os.path.join(workdir, "prompts.txt")
    with open(path, "w") as f:
        f.writelines(f"a photo of object {i} on a table, studio light\n" for i in range(n))
    return path


def phase_train_lora(torch, seed: int, workdir: str) -> dict:
    """Full-width PixArt-α-512 TDM training of a rank-32 LoRA student with
    8-bit Adam and gradient accumulation 2 through the CLI's main(): batch 4,
    bf16, dmd, 2 optimizer steps of 2 micro-steps each. Checks: the
    attention launches of every micro-step equal the train phase's, the
    factors keep their bits in micro-steps 1 and 3 and change in 2 and 4,
    every quantized moment is int8, finite metrics, a kohya file of rank-32
    factors. Reports seconds per optimizer step, peak memory, the device
    busy time, idle share and device launches of micro-step 2 (profiled),
    and each optimizer's launches per update of the critic and the factors."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.train import tdm as tdm_mod

    train_env(seed, workdir)
    out = os.path.join(workdir, "train_lora")
    records, prev, last = [], {}, {}
    init_state = tdm_mod.init_state

    def capture_init(student, *a, **kw):
        prev.update({k: v.clone() for k, v in student.items()})
        return init_state(student, *a, **kw)

    def after(rec, state):
        rec["factors_changed"] = any(not torch.equal(state.student[k], v)
                                     for k, v in prev.items())
        prev.update({k: v.clone() for k, v in state.student.items()})
        rec["mini_step"] = state.student_opt.mini_step
        last["state"] = state

    A.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tdm_mod.init_state = capture_init
    try:
        train_tdm.main([
            "--output_dir", out, "--max_train_steps", str(LORA_STEPS),
            "--train_batch_size", "4", "--mixed_precision", "bf16", "--loss_mode", "dmd",
            "--train_lora_rank", str(LORA_RANK), "--use_8bit_adam",
            "--gradient_accumulation_steps", str(LORA_ACCUM), "--seed", str(seed),
        ], step_hook=step_hook(torch, records, 2, "train_lora", after))
    finally:
        tdm_mod.init_state = init_state
    total_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    run_dir = out + "_cfg4.5_steps900"
    ckpt = os.path.join(run_dir, f"checkpoint-{LORA_STEPS}")
    ckpt_gb = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt)) / 1e9
    check_train_records(records, LORA_STEPS * LORA_ACCUM)
    changed = [r["factors_changed"] for r in records]
    check(changed == [False, True] * LORA_STEPS,
          f"factors changed after micro-steps {changed}, expected only at each 2nd")
    state = last["state"]
    for role in ("student", "critic"):
        inner = getattr(state, f"{role}_opt").inner
        for m in ("mu", "nu"):
            q = getattr(inner, m)
            check(q.codes.dtype == torch.int8 and q.codes.is_cuda,
                  f"{role} {m}: codes {q.codes.dtype} on {q.codes.device}")
    check(bool(state.critic_opt.inner.nu.codes.ne(0).any()), "the critic's ν codes are all 0")
    pieces = kohya_pieces(torch, os.path.join(run_dir, "tdm_lora.safetensors"), LORA_RANK)
    opt_work = {"critic": optimizer_work(torch, state.critic, seed),
                "student": optimizer_work(torch, state.student, seed)}
    del state, last["state"]
    shutil.rmtree(run_dir, ignore_errors=True)
    per_opt_step = records[2]["host_s"] + records[3]["host_s"]
    busy = records[1]["busy_ms"]
    span = records[3]["event_ms"]
    idle = None if not busy else 1 - busy / span
    print(f"[train_lora] PixArt-α-512 TDM, rank-{LORA_RANK} LoRA student, 8-bit Adam, "
          f"accumulation {LORA_ACCUM} (dmd, batch 4, bf16): {per_opt_step:.3f} s per "
          f"optimizer step (micro-steps 3+4, unprofiled), micro-steps "
          + ", ".join(f"{r['host_s']:.3f}" for r in records)
          + f" s; peak memory {peak_gb:.2f} GiB; micro-step 2 device busy "
          + (f"{busy:.1f} ms against micro-step 4's CUDA-event span {span:.1f} ms -> "
             f"idle share {idle:.3f}" if busy else "not measured")
          + f", {records[1].get('all_launches')} device launches; attention launches per "
          f"micro-step {TRAIN_LAUNCHES} (checked); factors changed {changed} (checked); "
          f"kohya file {pieces} rank-{LORA_RANK} pieces; main() {total_s:.1f}s incl. a "
          f"{ckpt_gb:.2f} GB checkpoint", flush=True)
    for role, work in opt_work.items():
        print(f"[train_lora] one update of the {role}'s parameters ({work['leaves']} "
              f"leaves, {work['elements']} elements): "
              f"{json.dumps({k: v for k, v in work.items() if isinstance(v, dict)})}",
              flush=True)
    native = native_loader_run(torch, seed, workdir)
    return {"s_per_optimizer_step": per_opt_step, "micro_step_s": [r["host_s"] for r in records],
            "peak_gib": peak_gb, "busy_ms": busy, "event_span_ms": span, "idle_share": idle,
            "all_launches_per_micro_step": records[1].get("all_launches"),
            "launches_per_micro_step": TRAIN_LAUNCHES, "factors_changed": changed,
            "kohya_pieces": pieces, "checkpoint_gb": ckpt_gb, "main_s": total_s,
            "optimizers": opt_work, "records": records, "native_loader": native}


def native_loader_run(torch, seed: int, workdir: str) -> dict:
    """The native C++ prompt loader on PixArt's training path, apart from
    the full-width runs (which read the embedding cache): 2 steps of the
    tiny PixArt model through the CLI's main() on the card with a .txt
    shard as --train_data_dir (hash pseudo-embeddings), every step's batch
    checked to come from the native loader; then the host seconds per
    batch of 4 at PixArt's 120 tokens of the native loader against the
    Python batcher the CLI takes without it, the same shard, seed and hash
    tokenizer, medians of 5 rounds of 200 batches taken in turns (the
    embedding lookup after it is the same for both and left out)."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.data import native_loader, prompts, tokenizer

    shard = prompts_txt(workdir)
    served = []
    native_next = native_loader.NativePromptLoader.__next__

    def counted_next(self):
        batch = native_next(self)
        served.append(len(batch["prompts"]))
        return batch

    cache = os.environ.pop("TDM_EMBEDDING_CACHE", None)
    os.environ["TDM_TINY_MODEL"] = "1"
    native_loader.NativePromptLoader.__next__ = counted_next
    out = os.path.join(workdir, "train_native")
    t0 = time.monotonic()
    try:
        train_tdm.main(["--output_dir", out, "--max_train_steps", "2",
                        "--train_batch_size", "4", "--seed", str(seed),
                        "--train_data_dir", shard])
    finally:
        native_loader.NativePromptLoader.__next__ = native_next
        os.environ.pop("TDM_TINY_MODEL")
        if cache is not None:
            os.environ["TDM_EMBEDDING_CACHE"] = cache
    main_s = time.monotonic() - t0
    shutil.rmtree(out + "_cfg4.5_steps900", ignore_errors=True)
    check(served == [4, 4], f"the native loader served batches {served}, expected one "
                            "of 4 per step")
    tok = tokenizer.HashTokenizer()
    loaders = {
        "native": native_loader.NativePromptLoader(shard, 4, tokenizer=tok, max_length=120,
                                                   seed=seed),
        "python": iter(prompts.PromptBatcher(prompts.load_prompts(shard), 4, tokenizer=tok,
                                             max_length=120, seed=seed)),
    }
    secs = {name: [] for name in loaders}
    try:
        for name, it in loaders.items():  # warm: the C++ thread fills its ring
            next(it)
        for _ in range(5):
            for name, it in loaders.items():
                t = time.perf_counter()
                for _ in range(200):
                    next(it)
                secs[name].append((time.perf_counter() - t) / 200)
    finally:
        loaders["native"].close()
    per_batch = {name: sorted(v)[len(v) // 2] for name, v in secs.items()}
    print(f"[train_lora] native loader ({native_loader.library_path().name}): a tiny "
          f"PixArt run through main() on the card read its prompts from {shard} "
          f"({len(served)} batches of 4, checked; main() {main_s:.1f}s); host time per "
          f"batch of 4 at 120 tokens, medians of 5 rounds of 200 in turns: native "
          f"{per_batch['native'] * 1e6:.1f} us ({min(secs['native']) * 1e6:.1f}-"
          f"{max(secs['native']) * 1e6:.1f}), Python batcher "
          f"{per_batch['python'] * 1e6:.1f} us ({min(secs['python']) * 1e6:.1f}-"
          f"{max(secs['python']) * 1e6:.1f})", flush=True)
    return {"batches": len(served), "main_s": main_s, "per_batch_s": per_batch,
            "rounds_s": secs}


# the train_sd3 phase: the recipe's rank-32 LoRA student, 8-bit Adam,
# --gradient_checkpointing, accumulation 1, 4 optimizer steps at batch 4
SD3_TRAIN_STEPS, SD3_LORA_RANK = 4, 32
# per SD3 step (dmd, cfg 4.5, one critic update): 7 forwards without grad
# (rollout x4, x0_gen_sg, the teacher's CFG probe at 2B, the critic probe)
# and 2 with grad (critic DSM, student loss), each 24 joint attentions; the
# checkpointed blocks run their grad forward again in the backward
SD3_TRAIN_LAUNCHES = {"flash_attention_fwd": 7 * 24, "flash_attention_fwd_lse": 2 * 2 * 24,
                      "flash_attention_bwd_dq": 2 * 24, "flash_attention_bwd_dkv": 2 * 24,
                      "splash_attention_fwd": 0}


def sd3_train_env(seed: int, workdir: str) -> str:
    """A seeded full-width SD3 embedding cache as $TDM_EMBEDDING_CACHE: 8
    prompts of 154 T5 tokens at 4096 with pooled CLIP vectors [8, 2048], the
    empty prompt's embedding and pooled vector, and dedicated rows with
    pooled vectors for the 4 default validation prompts; and a seeded TAESD3
    (a diffusers AutoencoderTiny directory, 16 latent channels) as
    $TDM_TAESD_DIR. Returns the TAESD3 directory."""
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache
    from tdm_tpu_torch.io import manifest
    from tdm_tpu_torch.models import vae
    from tdm_tpu_torch.utils import config as cfg_lib

    rng = np.random.default_rng(seed + 20)
    n, L = 8, SD3T_TXT
    lengths = np.array([154, 77, 33, 9, 154, 1, 56, 100])
    val = list(cfg_lib.TrainConfig.validation_prompts)
    cache = os.path.join(workdir, "sd3_train_cache.npz")
    EmbeddingCache(
        rng.standard_normal((n, L, 4096)).astype(np.float16),
        (np.arange(L)[None] < lengths[:, None]).astype(np.int32),
        [f"prompt {i}" for i in range(n)],
        uncond_embed=(0.1 * rng.standard_normal((L, 4096))).astype(np.float16),
        uncond_mask=(np.arange(L) < 1).astype(np.int32),
        pooled=rng.standard_normal((n, 2048)).astype(np.float16),
        uncond_pooled=(0.1 * rng.standard_normal(2048)).astype(np.float16),
        val_prompts=val,
        val_embeds=rng.standard_normal((len(val), L, 4096)).astype(np.float16),
        val_masks=np.ones((len(val), L), np.int32),
        val_pooled=rng.standard_normal((len(val), 2048)).astype(np.float16),
    ).save(cache)
    taesd = os.path.join(workdir, "taesd3")
    os.makedirs(taesd, exist_ok=True)
    with open(os.path.join(taesd, "config.json"), "w") as f:
        json.dump({"_class_name": "AutoencoderTiny", "latent_channels": 16,
                   "decoder_block_out_channels": [64] * 4,
                   "num_decoder_blocks": [3, 3, 3, 1]}, f)
    manifest.write_synthetic("taesd", os.path.join(taesd, "diffusion_pytorch_model.safetensors"),
                             vae.TAESDConfig.taesd3(), seed=seed + 21, scale=0.05)
    os.environ.pop("TDM_TINY_MODEL", None)
    os.environ["TDM_EMBEDDING_CACHE"] = cache
    os.environ["TDM_TAESD_DIR"] = taesd
    return taesd


def phase_train_sd3(torch, seed: int, workdir: str) -> dict:
    """Full-width SD3-Medium TDM training through the CLI's main() with the
    recipe's flags: --model_family sd3 at the default --resolution 512
    (latent 16x64x64, 1024 + 154 tokens), batch 4, bf16 compute on fp32
    masters, dmd, a rank-32 LoRA student, 8-bit Adam,
    --gradient_checkpointing, accumulation 1, 4 optimizer steps; the
    teacher read from the SD3 checkout's transformer/ folder (its load timed
    by part); a seeded pooled cache; one validation grid at step 4 through a
    seeded TAESD3. Per step: host and CUDA-event times and the kernels'
    launches (checked against SD3_TRAIN_LAUNCHES); step 3 under
    torch.profiler (device busy time, idle share, the top device
    operations). Then the kohya LoRA: rank-32 factors on every adapted
    piece, loaded back into the port's SD3 pipeline from the same checkout
    (every key resolved to a kernel of SD3's module names and merged)."""
    from tdm_tpu_torch.cli import train_tdm
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.lora import adapter, io as lora_io
    from tdm_tpu_torch.ops import attention as A
    from tdm_tpu_torch.pipelines import from_pretrained

    root, _, _ = sd3_checkout(workdir, seed)
    teacher_dir = os.path.join(root, "transformer")
    sd3_train_env(seed, workdir)
    out = os.path.join(workdir, "train_sd3")
    steps = []
    load_parts = [(convert, "load_torch_state_dict"), (convert, "sd3_params"),
                  (from_jax, "state_dict_from_jax"), (torch.nn.Module, "load_state_dict")]
    torch.cuda.empty_cache()
    A.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with timed_calls(torch, load_parts) as load_times:
        train_tdm.main([
            "--output_dir", out, "--model_family", "sd3", "--max_train_steps",
            str(SD3_TRAIN_STEPS), "--train_batch_size", str(SD3T_B), "--mixed_precision", "bf16",
            "--loss_mode", "dmd", "--train_lora_rank", str(SD3_LORA_RANK), "--use_8bit_adam",
            "--gradient_checkpointing", "--gradient_accumulation_steps", "1",
            "--validation_steps", str(SD3_TRAIN_STEPS), "--seed", str(seed),
            "--pretrained_model_name_or_path", teacher_dir,
        ], step_hook=step_hook(torch, steps, 3, "train_sd3"))
    total_s = time.monotonic() - t0
    launches = A.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(len(steps) == SD3_TRAIN_STEPS, f"{len(steps)} SD3 steps ran")
    for rec in steps:
        check(rec["launches"] == SD3_TRAIN_LAUNCHES,
              f"SD3 step {rec['step']} launches {rec['launches']}, expected "
              f"{SD3_TRAIN_LAUNCHES}")
        check(all(math.isfinite(v) for v in rec["metrics"].values()),
              f"SD3 step {rec['step']}: non-finite metrics {rec['metrics']}")
    run_dir = out + "_cfg4.5_steps900"
    for k in (4, 1):  # 4 validation prompts at 512²: a 2 x 2 grid
        with open(os.path.join(run_dir, f"validation_step{SD3_TRAIN_STEPS}_{k}nfe.png"),
                  "rb") as f:
            check_png(f.read(), 1024, 1024)
    ckpt = os.path.join(run_dir, f"checkpoint-{SD3_TRAIN_STEPS}")
    ckpt_gb = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt)) / 1e9
    lora_path = os.path.join(run_dir, "tdm_lora.safetensors")
    pieces = kohya_pieces(torch, lora_path, SD3_LORA_RANK)
    torch.cuda.empty_cache()
    # the file's names against SD3's: every key resolves to a kernel of the
    # checkout's transformer and the pipeline merges it (load_lora_weights
    # raises on a weight the transformer lacks)
    pipe = from_pretrained(root)
    lora = lora_io.load_lora(lora_path, model=pipe.transformer)
    adapted = adapter.adapted_keys(lora, from_jax.layer_stacks(pipe.transformer.cfg))
    check(len(adapted) == pieces, f"the kohya file's {pieces} pieces: {len(adapted)} resolved")
    pipe.load_lora_weights(lora_path, adapter_name="tdm")
    pipe.set_adapters(["tdm"], [1.0])
    del pipe, lora
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir, ignore_errors=True)
    plain = [r["host_s"] for r in steps[1:] if r["busy_ms"] is None]
    per_step = sum(plain) / len(plain)
    busy = steps[2]["busy_ms"]
    span = steps[1]["event_ms"]
    idle = None if not busy else 1 - busy / span
    load_s = sum(load_times.values())
    print(f"[train_sd3] teacher from {teacher_dir} (and the TAESD3 decoder): loaded in "
          f"{load_s:.2f}s (safetensors read {load_times.get('load_torch_state_dict', 0):.2f}s, "
          f"conversion {load_times.get('sd3_params', 0):.3f}s, carry "
          f"{load_times.get('state_dict_from_jax', 0):.2f}s, copy into the module "
          f"{load_times.get('load_state_dict', 0):.2f}s)", flush=True)
    print(f"[train_sd3] SD3-Medium TDM at 512² (dmd, batch {SD3T_B}, bf16, rank-"
          f"{SD3_LORA_RANK} LoRA student, 8-bit Adam, gradient checkpointing, seeded "
          f"weights): {per_step:.3f} s/step after the first, unprofiled (steps 2 and 4; "
          f"{3600 / per_step:.0f} iters/hour), first step {steps[0]['host_s']:.3f} s, "
          f"profiled step 3 {steps[2]['host_s']:.3f} s; peak memory {peak_gb:.2f} GiB; "
          f"launches per step {SD3_TRAIN_LAUNCHES} (checked); step 2 CUDA-event span "
          f"{span:.1f} ms, step 3 device busy "
          + (f"{busy:.1f} ms -> idle share {idle:.3f}" if busy else "not measured")
          + f", {steps[2].get('all_launches')} device launches; kohya file {pieces} rank-"
          f"{SD3_LORA_RANK} pieces, every one resolved and merged by the SD3 pipeline; "
          f"validation grids checked; main() {total_s:.1f}s incl. a {ckpt_gb:.2f} GB "
          f"checkpoint", flush=True)
    return {"s_per_step": per_step, "iters_per_hour": 3600 / per_step,
            "first_step_s": steps[0]["host_s"], "peak_gib": peak_gb, "idle_share": idle,
            "busy_ms": busy, "event_span_ms": span,
            "all_launches_per_step": steps[2].get("all_launches"),
            "launches": launches, "launches_per_step": SD3_TRAIN_LAUNCHES,
            "load_s": load_s, "load": load_times, "kohya_pieces": pieces,
            "checkpoint_gb": ckpt_gb, "main_s": total_s, "steps": steps}


SHAPE_KEYS = ("shape", "dims", "ms", "ms_range", "plain_ms", "library_ms", "library_ms_range",
              "bound_ms", "bound_by")


def kernel_row(name, source, replaces, launches, rec, per, resources, sd3_launches) -> dict:
    """One entry of the `kernels` JSON line: the times of the self and the
    cross shape summed (one PixArt block), the bound of their summed work,
    and the bf16 kernels' registers, spills and HGMMA/HMMA counts; under
    `sd3_train`, each SD3 training shape alone with the kernel's launches
    per SD3 step (`sd3_launches`)."""
    shapes = [r for r in rec["shapes"] if r["group"] == "pixart"]
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
        "shapes": [{k: r.get(k) for k in SHAPE_KEYS} for r in shapes],
        "sd3_train": {"launches_per_step": sd3_launches,
                      "shapes": [{k: r.get(k) for k in SHAPE_KEYS} for r in rec["shapes"]
                                 if r["group"] == "sd3_train"]},
        "resources": resources,
    }


PHASES = ("kernels", "reference", "serve", "train", "train_lora", "sd3", "diffusers",
          "train_sd3", "sd15")


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
            phase_reference_train_sd3(torch, args.seed)
            phase_reference_sd3(torch, args.seed, workdir)
        if "serve" in phases:
            serve = phase_serve(torch, args.seed, workdir)
        if "train" in phases:
            train = phase_train(torch, args.seed, workdir)
        if "train_lora" in phases:
            train_lora = phase_train_lora(torch, args.seed, workdir)
        if "sd3" in phases:
            sd3 = phase_sd3(torch, args.seed, workdir)
        if "diffusers" in phases:
            diffusers = phase_diffusers(torch, args.seed, workdir)
        if "train_sd3" in phases:
            train_sd3 = phase_train_sd3(torch, args.seed, workdir)
        if "sd15" in phases:
            sd15 = phase_sd15(torch, args.seed, workdir)
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
    kt = ktrain["kernels"]
    res = build["resources"]
    sd3_step = train_sd3["launches_per_step"]

    def by_path(wrapper):
        return {"train": train["launches"][wrapper],
                "train_sd3": train_sd3["launches"][wrapper]}

    def bf16_kernels(lib, suffix=""):
        return {fn: r for fn, r in res[lib].items()
                if ("sm90" in fn or "bf16" in fn) and fn.endswith(suffix)}

    rows = [
        kernel_row("flash_fwd", "tdm_tpu_torch/csrc/flash_fwd.cu",
                   "tdm_tpu/ops/attention.py:291", serve["launches"], kern,
                   per_block + "; library = SDPA forward", bf16_kernels("flash_fwd", ",0>"),
                   sd3_step["flash_attention_fwd"])
        | {"launches_by_path": {
            "serve": serve["launches"], "diffusers_pixart": diffusers["pixart"]["launches"],
            "diffusers_sd3": diffusers["sd3"]["launches"],
            **by_path("flash_attention_fwd"), "sd15": sd15["launches"]},
           "sd15": {"launches_per_batch": SD15_LAUNCHES_PER_BATCH,
                    "calls_per_batch": {name: calls for name, *_, calls in SD15_SHAPES},
                    "launches_by_head_dim": sd15["launches_by_head_dim"],
                    "shapes": [{k: r.get(k) for k in SHAPE_KEYS} for r in kern["shapes"]
                               if r["group"] == "sd15"]},
           "dynamic_smem": build["dynamic_smem"]["flash_fwd"]},
        kernel_row("flash_fwd_lse", "tdm_tpu_torch/csrc/flash_fwd.cu",
                   "tdm_tpu/ops/attention.py:291", train["launches"]["flash_attention_fwd_lse"],
                   kt["flash_fwd_lse"],
                   per_block + "; library = SDPA forward on inputs that require grad",
                   bf16_kernels("flash_fwd", ",1>"), sd3_step["flash_attention_fwd_lse"])
        | {"launches_by_path": by_path("flash_attention_fwd_lse")},
        kernel_row("flash_bwd_dq", "tdm_tpu_torch/csrc/flash_bwd_dq.cu",
                   "tdm_tpu/ops/attention.py:600", train["launches"]["flash_attention_bwd_dq"],
                   kt["flash_bwd_dq"], per_block + no_lib, bf16_kernels("flash_bwd_dq"),
                   sd3_step["flash_attention_bwd_dq"])
        | {"launches_by_path": by_path("flash_attention_bwd_dq")},
        kernel_row("flash_bwd_dkv", "tdm_tpu_torch/csrc/flash_bwd_dkv.cu",
                   "tdm_tpu/ops/attention.py:635", train["launches"]["flash_attention_bwd_dkv"],
                   kt["flash_bwd_dkv"], per_block + no_lib, bf16_kernels("flash_bwd_dkv"),
                   sd3_step["flash_attention_bwd_dkv"])
        | {"launches_by_path": by_path("flash_attention_bwd_dkv")},
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
                      "serve": serve, "train": train, "train_lora": train_lora, "sd3": sd3,
                      "diffusers": diffusers, "train_sd3": train_sd3, "sd15": sd15}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
