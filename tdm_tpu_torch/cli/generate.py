"""Few-step inference CLI of the port: the README recipes as one command.

Port of `tdm_tpu/cli/generate.py`, with its flags:

    python -m tdm_tpu_torch.cli.generate \\
        --model <pipeline-dir | diffusers-dir | org/name> \\
        --prompt "a cat" --num_inference_steps 4 --seed 8888 \\
        --lora tdm_lora.safetensors --lora_scale 0.125 \\
        --output out/cat.png [--quant int8] [--device cpu]

It covers the reference's three inference recipes with their knobs: SD3
(LoRA scale 0.125, flow_shift 1-6, guidance_scale 1.0, seed 8888),
Dreamshaper/SD1.5 (seed 317) and CogVideoX (49 frames, 4 steps, a GIF at
fps 8), and PixArt. The conditioning comes from the pipeline's attached
text encoders when it has them, else from an offline embedding cache built
with `python -m tdm_tpu_torch.cli.build_cache`. One output is written to
`--output` when it names a .png or .gif; several go into the directory
`--output` as 000.png, 001.png, ... (or .gif); `--output_type latent`
writes the fp32 latents as one .npy. PNGs and GIFs go through the port's
stdlib encoders (`train/validation.py`).

Runs on the CUDA device unless `--device cpu` is given. `--tp N` runs the
denoiser Megatron-cut over N processes (`parallel/tp.py`), one per local
GPU (cuda:0..N-1; every rank on the named card under `--device cuda:K`,
or on the CPU under `--device cpu`): this process is rank 0, encodes,
draws the noise and decodes, and starts the N−1 followers itself once the
conditioning is ready (or joins the world torchrun or TDM_* formed); the
JAX CLI's checks come first ("--tp N: only M local devices", "--tp N
shards nothing"). `--compilation_cache` is accepted so that the JAX
package's commands run unchanged, and does nothing here.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
from typing import Optional


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True,
                   help="pipeline dir, diffusers checkpoint dir, or repo id")
    p.add_argument("--prompt", nargs="+", required=True)
    p.add_argument("--negative_prompt", nargs="+", default=None)
    p.add_argument("--num_inference_steps", type=int, default=4)
    p.add_argument("--num_images_per_prompt", type=int, default=1,
                   help="N outputs per prompt in one batched call (videos per "
                        "prompt on the video pipeline)")
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--num_frames", type=int, default=None,
                   help="video pipelines only (CogVideoX: 49)")
    p.add_argument("--fps", type=int, default=8, help="GIF export rate")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--lora", default=None,
                   help="kohya/diffusers LoRA safetensors to load")
    p.add_argument("--lora_scale", type=float, default=1.0,
                   help="adapter scale (TDM releases use 0.125)")
    p.add_argument("--solver", default=None, choices=(None, "dpm", "unipc", "fewstep"),
                   help="sampler: dpm (DPM-Solver++ 2M, default), unipc "
                        "(UniPC predictor-corrector), fewstep (PixArt TDM grid)")
    p.add_argument("--flow_shift", type=float, default=None,
                   help="SD3 DPM-Solver sigma shift (recipe: 1-6)")
    p.add_argument("--embedding_cache", default=None,
                   help="offline text embedding cache (.npz from cli/build_cache) "
                        "used when the pipeline has no text encoders attached")
    p.add_argument("--output", default="out.png",
                   help="output file (single output) or directory")
    p.add_argument("--output_type", default=None, choices=(None, "image", "video", "latent"))
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel over N processes, one per local GPU")
    p.add_argument("--quant", default=None, choices=(None, "int8"),
                   help="dynamic int8 products for the denoiser's large linear "
                        "layers (ops/quant.py)")
    p.add_argument("--revision", default=None)
    p.add_argument("--model_config", default=None,
                   help="JSON dict of config overrides for diffusers-layout "
                        'checkpoints, e.g. \'{"attn_impl": "splash"}\'')
    p.add_argument("--compilation_cache", default="auto",
                   help="the JAX package's XLA compile cache; accepted and "
                        "ignored (the port compiles nothing ahead of time)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p.parse_args(argv)


def _cached_embeds(cache, cache_path: str, prompts: list[str]):
    """(embeds [B, L, D] fp32, masks [B, L] int32, pooled [B, P] fp32 or
    None) looked up by exact prompt text."""
    import numpy as np

    idx = []
    for pr in prompts:
        try:
            idx.append(cache.prompts.index(pr))
        except ValueError:
            raise SystemExit(
                f"prompt {pr!r} is not in the embedding cache "
                f"({cache_path}); rebuild it with cli/build_cache"
            ) from None
    sel = np.asarray(idx)
    pooled = cache.pooled[sel].astype(np.float32) if cache.pooled is not None else None
    return cache.embeds[sel].astype(np.float32), cache.masks[sel].astype(np.int32), pooled


def run_pipeline(pipe, prompts: list[str], neg_prompts: Optional[list[str]], call: dict, *,
                 embedding_cache: Optional[str] = None, before_call=None):
    """prompts → PipelineOutput, the conditioning from the pipeline's
    attached text encoders or, failing that, an offline embedding cache.
    `call` holds pipeline kwargs (steps, cfg, seed, ...); keys the pipeline
    does not take are dropped; `before_call()`, when given, runs once the
    conditioning's checks have passed, just before the pipeline's call.
    Shared by the generate and evaluate CLIs."""
    before_call = before_call or (lambda: None)
    import numpy as np

    from tdm_tpu_torch.data.prompts import EmbeddingCache, pack_family_cond
    from tdm_tpu_torch.serve.batcher import has_encoders

    accepted = inspect.signature(type(pipe).__call__).parameters
    call = {k: v for k, v in call.items() if k in accepted}
    if has_encoders(pipe):
        if neg_prompts is not None:
            if "negative_prompt" not in accepted:
                raise SystemExit(f"{type(pipe).__name__} does not take a negative prompt")
            call["negative_prompt"] = neg_prompts
        before_call()
        return pipe(prompts, **call)
    if not embedding_cache:
        raise SystemExit(
            "this pipeline has no text encoders attached — pass "
            "--embedding_cache (built with cli/build_cache) or load a "
            "pipeline dir that bundles encoders"
        )
    cache = EmbeddingCache.load(embedding_cache)
    fam = getattr(pipe, "family", "")

    def pack(e, m, p):
        return pack_family_cond(fam, e, m, p, error=SystemExit)

    embeds, masks, pooled = _cached_embeds(cache, embedding_cache, prompts)
    negative = None
    if neg_prompts is not None:
        negative = pack(*_cached_embeds(cache, embedding_cache, neg_prompts))
    elif call.get("guidance_scale", 1.0) != 1.0 and cache.uncond_embed is not None:
        # CFG with no explicit negative: the cache's empty-prompt rows
        ue = np.broadcast_to(cache.uncond_embed[None], embeds.shape).astype(np.float32)
        um = np.broadcast_to(cache.uncond_mask[None], masks.shape).astype(np.int32)
        up = None
        if pooled is not None:
            up = (np.broadcast_to(cache.uncond_pooled[None], pooled.shape).astype(np.float32)
                  if cache.uncond_pooled is not None else np.zeros_like(pooled))
        negative = pack(ue, um, up)
    if negative is not None:
        if "negative_embeds" not in accepted:
            raise SystemExit(f"{type(pipe).__name__} does not take negative embeds")
        call["negative_embeds"] = negative
    before_call()
    return pipe(prompt_embeds=pack(embeds, masks, pooled), **call)


def load_pipeline(model: str, *, device=None, revision=None, model_config=None, lora=None,
                  lora_scale: float = 1.0, quant=None, denoiser_only: bool = False):
    """`from_pretrained` with the fp32 precision rule set first (as the
    server sets it), the LoRA loaded as adapter 'tdm' at its scale, and
    `pipe.quant` set. Shared by the generate and evaluate CLIs."""
    from tdm_tpu_torch.device import set_fp32_precision
    from tdm_tpu_torch.pipelines import from_pretrained

    set_fp32_precision()  # the decoders' fp32 convolutions in full fp32, as in JAX
    kwargs = {"model_config": model_config} if model_config else {}
    pipe = from_pretrained(model, device=device, revision=revision,
                           denoiser_only=denoiser_only, **kwargs)
    if lora:
        pipe.load_lora_weights(lora, adapter_name="tdm")
        pipe.set_adapters(["tdm"], [lora_scale])
    if quant:
        pipe.quant = quant
    return pipe


def main(argv: Optional[list[str]] = None) -> None:
    args = parse_args(argv)
    import numpy as np
    import torch

    from tdm_tpu_torch.device import resolve_device
    from tdm_tpu_torch.train import validation

    device = resolve_device(args.device)  # CUDA unless asked otherwise, before any load
    n_tp = args.tp if args.tp and args.tp > 1 else 1

    def load(dev, denoiser_only=False):
        return load_pipeline(
            args.model, device=dev, revision=args.revision,
            model_config=json.loads(args.model_config) if args.model_config else None,
            lora=args.lora, lora_scale=args.lora_scale, quant=args.quant,
            denoiser_only=denoiser_only)

    if n_tp > 1:
        from tdm_tpu_torch.parallel import tp as tp_lib

        if tp_lib.is_follower():  # a rank of the world rank 0 started: its calls
            tp_lib.run_follower(n_tp, device, lambda dev: load(dev, True))
            return
        if device.type == "cuda" and device.index is None:
            n_dev = torch.cuda.device_count()
            if n_tp > n_dev:
                raise SystemExit(f"--tp {args.tp}: only {n_dev} local devices")
    pipe = load(device)
    world = None
    if n_tp > 1:
        if not tp_lib.plan(pipe.denoiser, n_tp):
            raise SystemExit(
                f"--tp {args.tp} shards nothing: no attention/FF projection "
                f"dim is divisible by {args.tp} — the run would be "
                "replicated with zero speedup. Pick a divisor of the "
                "model's head and FF dims"
            )

    def start_tp():
        nonlocal world
        if n_tp > 1:
            world = tp_lib.launch("tdm_tpu_torch.cli.generate",
                                  list(sys.argv[1:] if argv is None else argv), n_tp, device)
            pipe.tensor_parallel = world.tp

    call = dict(num_inference_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale, seed=args.seed)
    for k in ("height", "width", "num_frames", "flow_shift", "output_type"):
        v = getattr(args, k)
        if v is not None:
            call[k] = v
    accepted = inspect.signature(type(pipe).__call__).parameters
    if args.num_images_per_prompt != 1:
        # image pipelines take num_images_per_prompt, the video pipeline
        # num_videos_per_prompt: run_pipeline keeps the accepted one
        if "num_images_per_prompt" not in accepted and "num_videos_per_prompt" not in accepted:
            raise SystemExit(f"{type(pipe).__name__} has no --num_images_per_prompt knob")
        call["num_images_per_prompt"] = args.num_images_per_prompt
        call["num_videos_per_prompt"] = args.num_images_per_prompt
    if args.solver is not None:
        if "solver" not in accepted:
            raise SystemExit(f"{type(pipe).__name__} has no --solver knob")
        call["solver"] = args.solver
    neg = list(args.negative_prompt) if args.negative_prompt is not None else None
    try:
        out = run_pipeline(pipe, list(args.prompt), neg, call,
                           embedding_cache=args.embedding_cache, before_call=start_tp)
    finally:
        if world is not None:
            world.stop()

    result = out.images if out.images is not None else out.latents
    imgs = result.float().cpu().numpy()
    if call.get("output_type") == "latent":
        path = args.output if args.output.endswith(".npy") else args.output + ".npy"
        np.save(path, imgs)
        print(f"wrote {path} {imgs.shape}")
        return
    is_video = imgs.ndim == 5  # [B, F, H, W, 3]
    n_out = imgs.shape[0]  # len(prompts) × num_images_per_prompt
    ext = ".gif" if is_video else ".png"
    if n_out == 1 and args.output.lower().endswith((".png", ".gif")):
        targets = [args.output]
    else:
        os.makedirs(args.output, exist_ok=True)
        targets = [os.path.join(args.output, f"{i:03d}{ext}") for i in range(n_out)]
    for i, path in enumerate(targets):
        if is_video:
            validation.save_video_gif(path, imgs[i], fps=args.fps)
        else:
            validation.save_png(path, (np.clip(imgs[i], 0, 1) * 255).astype(np.uint8))
        print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
