"""Build an offline text-embedding cache for image-free TDM training and
cache-served pipelines.

Port of `tdm_tpu/cli/build_cache.py`. The T5 path (PixArt's encoder):

    python -m tdm_tpu_torch.cli.build_cache \\
        --prompts prompts.jsonl --caption_column prompt \\
        --t5 /ckpts/t5-xxl            # HF folder: safetensors + tokenizer \\
        --out cache.npz --max_length 120

The pipeline path (any family; an SD3 cache carries the pooled CLIP-L/G
vectors the MMDiT takes as its second conditioning):

    python -m tdm_tpu_torch.cli.build_cache \\
        --prompts prompts.txt --pipeline /ckpts/sd3-medium --family sd3 \\
        --out cache.npz

Both write the `.npz` that the trainer (`$TDM_EMBEDDING_CACHE`) and the
server (`--embedding_cache`) of either package read: fp16 rows per prompt,
the empty prompt's uncond_* rows and the validation prompts' rows. Runs on
the CUDA device unless given `--device cpu`. The T5 path's tokenizer is an
`HFTokenizer`, which needs `transformers`; the pipeline path uses the
pipeline's own tokenizers (a bundle's `{"kind": "hash"}` one needs nothing).
"""

from __future__ import annotations

import argparse
import sys


def _build_via_pipeline(args, prompt_list, dev) -> None:
    """Encode with the pipeline's own `encode_prompt` (the serving path), so
    the cache matches live conditioning. Its return per family: pixart and
    sd15 (embeds, mask); sd3 (context, pooled); cogvideox embeds."""
    import numpy as np

    from tdm_tpu_torch.data import prompts as data_prompts
    from tdm_tpu_torch.pipelines import from_pretrained

    pipe = from_pretrained(args.pipeline, device=dev)
    # the family comes from the pipeline; an explicit --family must agree (a
    # wrong one would unpack encode_prompt's return wrongly)
    fam = pipe.family
    if args.family and fam != args.family:
        raise SystemExit(
            f"--family {args.family} does not match the loaded pipeline "
            f"(family {fam!r}); drop the flag or fix it"
        )
    to_np = data_prompts.to_numpy

    def enc(chunk: list[str]):
        out = pipe.encode_prompt(chunk)
        if fam == "sd3":
            ctx = to_np(out[0]).astype(np.float16)
            return ctx, np.ones(ctx.shape[:2], np.int64), to_np(out[1]).astype(np.float16)
        if fam == "cogvideox":
            e = to_np(out).astype(np.float16)
            return e, np.ones(e.shape[:2], np.int64), None
        return to_np(out[0]).astype(np.float16), to_np(out[1]), None

    bs = args.batch_size
    embeds, masks, pooled = data_prompts.chunked_encode(prompt_list, enc, bs)
    u_e, u_m, u_p = enc([""] * bs)
    val_prompts = list(args.validation_prompts or [])
    v_e = v_m = v_p = None
    if val_prompts:
        v_e, v_m, v_p = data_prompts.chunked_encode(val_prompts, enc, bs)
    cache = data_prompts.EmbeddingCache(
        embeds, masks, list(prompt_list),
        uncond_embed=u_e[0], uncond_mask=u_m[0], pooled=pooled,
        uncond_pooled=u_p[0] if u_p is not None else None,
        val_prompts=val_prompts, val_embeds=v_e, val_masks=v_m, val_pooled=v_p,
    )
    cache.save(args.out)
    extra = "" if cache.pooled is None else f", pooled {cache.pooled.shape}"
    print(f"wrote {args.out}: {len(cache.prompts)} prompts, "
          f"embeds {cache.embeds.shape}{extra}", flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prompts", required=True, help=".txt or .jsonl prompt file")
    p.add_argument("--caption_column", default="prompt")
    p.add_argument("--t5", default=None,
                   help="local HF T5 checkpoint folder (weights + tokenizer)")
    p.add_argument("--pipeline", default=None,
                   help="pipeline folder or diffusers checkout: encode with the "
                        "family's own encode_prompt (SD3: stores pooled vectors)")
    p.add_argument("--family", default=None, choices=("pixart", "sd15", "sd3", "cogvideox"),
                   help="the pipeline's family for --pipeline (derived from the "
                        "pipeline when omitted; a given one must agree)")
    p.add_argument("--out", required=True, help="output .npz cache path")
    p.add_argument("--validation_prompts", nargs="*", default=[
        # the train CLI's fixed grid prompts, embedded under dedicated keys
        # so validation grids render the same prompts every time
        "a photo of a cat", "a photo of a dog",
        "a photo of a panda", "a photo of a pikachu",
    ])
    p.add_argument("--dataset_config_name", default=None,
                   help="HF dataset config for --prompts dataset names")
    p.add_argument("--max_length", type=int, default=120)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--d_model", type=int, default=4096)
    p.add_argument("--num_layers", type=int, default=24)
    p.add_argument("--num_heads", type=int, default=64)
    p.add_argument("--d_ff", type=int, default=10240)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    if (args.t5 is None) == (args.pipeline is None):
        p.error("exactly one of --t5 / --pipeline is required")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from tdm_tpu_torch.data import prompts as data_prompts
    from tdm_tpu_torch.device import resolve_device, set_fp32_precision

    dev = resolve_device(args.device)
    set_fp32_precision()  # as the server: a cache row and a live encode alike
    prompt_list = data_prompts.load_prompts(
        args.prompts, caption_column=args.caption_column,
        max_samples=args.max_samples, dataset_config_name=args.dataset_config_name,
    )
    with torch.inference_mode():
        if args.pipeline is not None:
            _build_via_pipeline(args, prompt_list, dev)
            return
        _build_via_t5(args, prompt_list, dev)


def _build_via_t5(args, prompt_list, dev) -> None:
    """An HF T5 folder at bf16, every parameter rounded to bf16 as the JAX
    CLI casts its whole tree (the RMSNorm scales and the relative bias too)."""
    import torch

    from tdm_tpu_torch.data import prompts as data_prompts
    from tdm_tpu_torch.data.tokenizer import HFTokenizer
    from tdm_tpu_torch.io import convert, from_jax
    from tdm_tpu_torch.models import t5 as t5_lib

    tokenizer = HFTokenizer(args.t5)
    cfg = t5_lib.T5Config(
        d_model=args.d_model, num_layers=args.num_layers, num_heads=args.num_heads,
        d_ff=args.d_ff, d_kv=args.d_model // args.num_heads,
    )
    encoder = t5_lib.T5Encoder(cfg, device=dev)
    from_jax.load_from_jax(
        convert.flatten(convert.t5_encoder_params(convert.load_torch_state_dict(args.t5))),
        encoder)
    for p in encoder.parameters():
        p.copy_(p.to(torch.bfloat16))
    cache = data_prompts.EmbeddingCache.build(
        prompt_list, tokenizer,
        lambda ids, mask: encoder(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)),
        max_length=args.max_length, batch_size=args.batch_size,
        val_prompts=args.validation_prompts,
    )
    cache.save(args.out)
    print(f"wrote {args.out}: {len(cache.prompts)} prompts, "
          f"embeds {cache.embeds.shape}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
