"""Checkpoint conversion CLI: HF-layout safetensors → a tdm_tpu param file.

    python -m tdm_tpu_torch.cli.convert_checkpoint \
        --family pixart --src /path/to/transformer/ --dst pixart.tdm.safetensors

Port of `tdm_tpu/cli/convert_checkpoint.py`, with its flags and family
table: an explicit offline conversion whose output is the JAX package's
param file ('/'-joined tree keys, scan-stacked unless `--no_scan`), which
`io/params.load_params` of either package reads and the weight carry
(`io/from_jax.load_from_jax`) puts into the port's modules.

Check a checkpoint before converting (headers only: the whole key/shape
inventory against the converter's expectation, no weights read; exits 1
with a report on a mismatch):

    python -m tdm_tpu_torch.cli.convert_checkpoint \
        --family sd3 --check-manifest /path/to/model.safetensors

Back to the torch layout (a full-weight student into diffusers):

    python -m tdm_tpu_torch.cli.convert_checkpoint \
        --family pixart --reverse --src student.safetensors --dst transformer.safetensors

Host work only (numpy, the port's own safetensors reader and writer), so
there is no `--device`. Without `--dtype`, a checkpoint whose float entries
are all BF16 is written as BF16, as the JAX CLI keeps a bfloat16 source's
dtype; any other keeps each entry's dtype.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import numpy as np

FAMILIES = {
    "pixart": "pixart_params",
    "sd3": "sd3_params",
    "unet_sd15": "unet_sd15_params",
    "klvae": "klvae_params",
    "taesd": "taesd_params",
    "cogvideox": "cogvideox_params",
    "vae3d": "vae3d_decoder_params",
    "t5": "t5_encoder_params",
    "clip": "clip_text_params",
}

# --check-manifest names (io/manifest.py); taesd3 / vae3d_decoder exist only
# as manifest inventories (converted via 'taesd' / 'vae3d' above)
_CHECK_FAMILIES = ("taesd3", "vae3d_decoder")


def _float_codes(path: str) -> set[str]:
    """The dtype codes of the float entries of a safetensors file or of a
    directory's files (headers only)."""
    files = ([path] if os.path.isfile(path) else
             [os.path.join(path, f) for f in sorted(os.listdir(path))
              if f.endswith(".safetensors")])
    codes = set()
    for f in files:
        with open(f, "rb") as fh:
            header = json.loads(fh.read(int.from_bytes(fh.read(8), "little")))
        codes |= {v["dtype"] for k, v in header.items()
                  if k != "__metadata__" and v["dtype"] in ("F64", "F32", "F16", "BF16")}
    return codes


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main(argv=None) -> None:
    from tdm_tpu_torch.io import convert, params as params_io

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", required=True,
                   choices=sorted(list(FAMILIES) + list(_CHECK_FAMILIES)))
    p.add_argument("--src", help="safetensors file or HF checkpoint directory")
    p.add_argument("--dst", help="output .safetensors path")
    p.add_argument("--check-manifest", metavar="PATH",
                   help="validate a checkpoint's key/shape inventory "
                        "(safetensors file/dir, header-only, or a captured "
                        "manifest .json) against the converter's "
                        "expectation; exits 1 with a report on mismatch")
    p.add_argument("--strip-prefix", default=None,
                   help="with --check-manifest: strip this key prefix "
                        "(e.g. 'transformer.') before comparing")
    p.add_argument("--dtype", default=None,
                   help="cast float weights (float16, float32, bfloat16)")
    p.add_argument("--no_scan", action="store_true",
                   help="keep per-layer (unrolled) layout instead of the "
                        "scan-stacked default")
    p.add_argument("--reverse", action="store_true",
                   help="tdm_tpu param file → diffusers/torch state-dict "
                        "safetensors (full-weight students back into the "
                        f"torch ecosystem; families: {sorted(convert.TO_TORCH)})")
    args = p.parse_args(argv)

    if args.check_manifest:
        from tdm_tpu_torch.io import manifest

        fam = {"vae3d": "vae3d_decoder"}.get(args.family, args.family)
        if fam not in manifest.MANIFEST_FAMILIES:
            p.error(f"--check-manifest supports {sorted(manifest.MANIFEST_FAMILIES)}")
        actual = manifest.load_manifest(args.check_manifest)
        problems = manifest.check_manifest(fam, actual, strip_prefix=args.strip_prefix)
        if problems:
            print(f"{args.check_manifest}: {len(problems)} problem(s) vs "
                  f"the {args.family} converter's expectation:")
            for line in problems[:50]:
                print(f"  {line}")
            if len(problems) > 50:
                print(f"  ... and {len(problems) - 50} more")
            raise SystemExit(1)
        print(f"{args.check_manifest}: OK — {len(actual)} keys match the "
              f"{args.family} inventory")
        return
    if not args.src or not args.dst:
        p.error("--src and --dst are required (unless --check-manifest)")
    if args.family not in FAMILIES:
        p.error(f"family {args.family!r} is check-manifest-only; convert with "
                f"{'taesd' if args.family == 'taesd3' else 'vae3d'}")

    dtype = args.dtype
    if dtype is None and _float_codes(args.src) == {"BF16"}:
        dtype = params_io.BFLOAT16
    if args.reverse:
        inv = convert.TO_TORCH.get(args.family)
        if inv is None:
            p.error(f"--reverse supports {sorted(convert.TO_TORCH)} (LoRA "
                    "artifacts interchange via lora/io.py save_kohya instead)")
        sd = inv(params_io.load_params(args.src))
        params_io.save_params(sd, args.dst, dtype=dtype)
        n = sum(v.size for v in sd.values())
        print(f"wrote {args.dst}: {n/1e6:.1f}M params ({args.family}, torch layout)")
        return

    sd = convert.load_torch_state_dict(args.src)
    fn = getattr(convert, FAMILIES[args.family])
    kwargs = {}
    if "scan_layers" in inspect.signature(fn).parameters:
        kwargs["scan_layers"] = not args.no_scan
    tree = fn(sd, **kwargs)
    params_io.save_params(tree, args.dst, dtype=dtype)
    n = sum(np.asarray(x).size for x in _leaves(tree))
    print(f"wrote {args.dst}: {n/1e6:.1f}M params ({args.family})")


if __name__ == "__main__":
    main(sys.argv[1:])
