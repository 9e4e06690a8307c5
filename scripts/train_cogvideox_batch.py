#!/usr/bin/env python3
"""Time full-width CogVideoX-2B TDM training at a chosen batch on one GPU.

Runs the training CLI's main() as `chip_smoke.py`'s train_cogvideox phase
does (--model_family cogvideox --num_frames 49, bf16 on fp32 masters, dmd,
a rank-64 LoRA student, 8-bit Adam, --gradient_checkpointing, no LR
warm-up; the teacher from a seeded CogVideoX-2B checkout's transformer/
folder, a seeded T5 cache with ragged masks), at --batch for --steps
optimizer steps, and prints each step's host seconds and CUDA-event span,
the seconds per step after the first, the kernels' launches per step and
the peak `max_memory_allocated`, with the card's name and power limit. An
out-of-memory error is reported as such with the peak reached. Run from the
repository root:

    python3 scripts/train_cogvideox_batch.py --batch 4 --steps 2
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as smoke
    from tdm_tpu_torch.cli import train_tdm

    if not torch.cuda.is_available():
        print("train_cogvideox_batch: no CUDA device", file=sys.stderr)
        return 2
    print(smoke.nvidia_smi_line(), flush=True)
    workdir = os.path.join(HERE, "build", "train_cogvideox_batch")
    os.makedirs(workdir, exist_ok=True)
    steps: list = []
    result = {"batch": args.batch, "steps": args.steps}
    try:
        root, _, _ = smoke.cogvideox_checkout(torch, workdir, args.seed)
        smoke.cog_train_env(args.seed, workdir)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        try:
            train_tdm.main([
                "--output_dir", os.path.join(workdir, "run"), "--model_family", "cogvideox",
                "--num_frames", "49", "--max_train_steps", str(args.steps),
                "--train_batch_size", str(args.batch), "--mixed_precision", "bf16",
                "--loss_mode", "dmd", "--gradient_checkpointing", "--train_lora_rank",
                str(smoke.COG_LORA_RANK), "--use_8bit_adam", "--lr_warmup_steps", "0",
                "--seed", str(args.seed),
                "--pretrained_model_name_or_path", os.path.join(root, "transformer"),
            ], step_hook=smoke.step_hook(torch, steps, 0, f"batch {args.batch}"))
            result["main_s"] = time.monotonic() - t0
        except torch.cuda.OutOfMemoryError as e:
            result["out_of_memory"] = str(e).splitlines()[0]
        result["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        result["host_s"] = [r["host_s"] for r in steps]
        result["event_ms"] = [r["event_ms"] for r in steps]
        if len(steps) > 1:
            result["s_per_step"] = sum(result["host_s"][1:]) / (len(steps) - 1)
        if steps:
            result["launches_per_step"] = steps[-1]["launches"]
    finally:
        os.environ.pop("TDM_TAESD_DIR", None)
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0 if "out_of_memory" not in result else 1


if __name__ == "__main__":
    sys.exit(main())
