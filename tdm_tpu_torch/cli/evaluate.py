"""CLIP-score evaluation CLI of the port: student against teacher quality.

Port of `tdm_tpu/cli/evaluate.py`, with its flags:

    python -m tdm_tpu_torch.cli.evaluate \\
        --model <pipeline-dir> --clip_model <clip-vit-large-patch14 dir> \\
        --prompt "a cat" "a dog" --num_inference_steps 4 --seed 8888 \\
        --compare_teacher --teacher_steps 28 --teacher_guidance 7.0 \\
        [--quant int8] [--device cpu]

Generates an image for each prompt with the few-step student's settings
(the README recipes: 4 NFE, cfg 1, LoRA scale 0.125) and scores each
(prompt, image) pair with the CLIP score (`eval/clip_score.py`; a video's
middle frame is scored). With `--compare_teacher` it runs the same prompts
and seed again in teacher mode (the adapter at scale 0, `--teacher_steps`,
`--teacher_guidance`: the reference's own baseline protocol), restores the
student's scale, and reports the difference of the means.

Prints one JSON object (`--output` writes it too, `--save_images` the
scored PNGs). The CLIP folder needs a tokenizer: a hash bundle
(`tdm_tokenizer.json`) or HF tokenizer files, which need `transformers`.
Runs on the CUDA device unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True,
                   help="pipeline dir, diffusers checkpoint dir, or repo id")
    p.add_argument("--clip_model", required=True,
                   help="HF CLIPModel dir (e.g. clip-vit-large-patch14) for the "
                        "scoring towers")
    p.add_argument("--prompt", nargs="+", default=None)
    p.add_argument("--prompts_file", default=None,
                   help="newline-separated prompts (overrides --prompt)")
    p.add_argument("--negative_prompt", nargs="+", default=None)
    p.add_argument("--num_inference_steps", type=int, default=4)
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--seed", type=int, default=8888)
    p.add_argument("--lora", default=None)
    p.add_argument("--lora_scale", type=float, default=0.125)
    p.add_argument("--flow_shift", type=float, default=None)
    p.add_argument("--embedding_cache", default=None)
    p.add_argument("--quant", default=None, choices=(None, "int8"))
    p.add_argument("--compare_teacher", action="store_true",
                   help="also score teacher-mode generations (adapters off, "
                        "--teacher_steps/--teacher_guidance) on the same prompts "
                        "and seed")
    p.add_argument("--teacher_steps", type=int, default=28)
    p.add_argument("--teacher_guidance", type=float, default=7.0)
    p.add_argument("--output", default=None, help="write the JSON here too")
    p.add_argument("--save_images", default=None, help="directory for the scored PNGs")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p.parse_args(argv)


def _score_run(pipe, scorer, prompts, neg, call, cache, tag, save_dir):
    import numpy as np

    from tdm_tpu_torch.cli.generate import run_pipeline
    from tdm_tpu_torch.train import validation

    out = run_pipeline(pipe, prompts, neg, dict(call), embedding_cache=cache)
    if out.images is None:
        raise SystemExit(
            "CLIP score needs decoded images, but this pipeline has no VAE "
            "decoder attached (it returned raw latents) — load a pipeline "
            "dir that bundles VAE params"
        )
    imgs = out.images
    if imgs.dim() == 5:  # video [B, F, H, W, 3]: score the middle frame
        imgs = imgs[:, imgs.shape[1] // 2]
    scores = scorer.score(imgs, prompts)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        host = imgs.float().cpu().numpy()
        for i in range(len(prompts)):
            path = os.path.join(save_dir, f"{tag}_{i:03d}.png")
            validation.save_png(path, (np.clip(host[i], 0, 1) * 255).astype(np.uint8))
    return scores


def _summary(steps: int, guidance: float, scores) -> dict:
    return {"steps": steps, "guidance_scale": guidance,
            "clip_scores": [round(float(s), 4) for s in scores],
            "clip_score_mean": round(float(scores.mean()), 4)}


def main(argv: Optional[list[str]] = None) -> None:
    args = parse_args(argv)

    from tdm_tpu_torch.cli.generate import load_pipeline
    from tdm_tpu_torch.device import resolve_device
    from tdm_tpu_torch.eval import CLIPScorer

    device = resolve_device(args.device)  # CUDA unless asked otherwise, before any load
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    elif args.prompt:
        prompts = list(args.prompt)
    else:
        raise SystemExit("pass --prompt or --prompts_file")
    neg = list(args.negative_prompt) if args.negative_prompt else None

    scorer = CLIPScorer.from_pretrained(args.clip_model, device=device)
    if scorer.tokenizer is None:
        raise SystemExit(
            f"{args.clip_model} has no tokenizer files — CLIP score needs "
            "text embeddings for the evaluated prompts"
        )
    pipe = load_pipeline(args.model, device=device, lora=args.lora,
                         lora_scale=args.lora_scale, quant=args.quant)

    call = dict(num_inference_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale, seed=args.seed)
    for k in ("height", "width", "flow_shift"):
        v = getattr(args, k)
        if v is not None:
            call[k] = v

    student = _score_run(pipe, scorer, prompts, neg, call, args.embedding_cache,
                         "student", args.save_images)
    result = {"prompts": prompts,
              "student": _summary(args.num_inference_steps, args.guidance_scale, student)}

    if args.compare_teacher:
        # the teacher baseline: the adapter off, many steps at a high cfg,
        # on the same prompts and seed
        if args.lora:
            pipe.set_adapters(["tdm"], [0.0])
        tcall = dict(call, num_inference_steps=args.teacher_steps,
                     guidance_scale=args.teacher_guidance)
        teacher = _score_run(pipe, scorer, prompts, neg, tcall, args.embedding_cache,
                             "teacher", args.save_images)
        if args.lora:
            pipe.set_adapters(["tdm"], [args.lora_scale])
        result["teacher"] = _summary(args.teacher_steps, args.teacher_guidance, teacher)
        result["student_minus_teacher"] = round(float(student.mean() - teacher.mean()), 4)

    text = json.dumps(result)
    print(text)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
