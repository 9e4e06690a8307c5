"""Offline text-embedding cache and the family conditioning format.

The port's own copy of the serving path's part of `tdm_tpu/data/prompts.py`
(numpy only): `EmbeddingCache` reads and writes the `.npz` that the JAX
package's `cli/build_cache` builds — embeds [N, L, D], masks [N, L],
prompts [N], and the empty prompt's `uncond_embed` [L, D] / `uncond_mask`
[L] for the CFG branch (an SD3 cache's pooled vectors are not read: slice
3) — and `pack_family_cond` turns cache rows into the conditioning the
pipeline takes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def pack_family_cond(family: str, embeds, masks):
    """Cache rows → the family's conditioning: (embeds, mask) for PixArt."""
    if family in ("sd3", "cogvideox"):
        raise NotImplementedError(
            f"{family} conditioning is not ported yet: ROADMAP.md queue 1, "
            + ("slice 3 (SD3)" if family == "sd3" else "slice 5 (CogVideoX)")
        )
    return (embeds, masks)


class EmbeddingCache:
    """Per-prompt T5 embeddings, encoded once offline."""

    def __init__(
        self,
        embeds: np.ndarray,
        masks: np.ndarray,
        prompts: list[str],
        uncond_embed: Optional[np.ndarray] = None,
        uncond_mask: Optional[np.ndarray] = None,
    ):
        self.embeds = embeds  # [N, L, D]
        self.masks = masks  # [N, L]
        self.prompts = list(prompts)
        self.uncond_embed = uncond_embed  # [L, D] or None
        self.uncond_mask = uncond_mask  # [L] or None

    def save(self, path: str) -> None:
        extra = {}
        if self.uncond_embed is not None:
            extra["uncond_embed"] = self.uncond_embed
            extra["uncond_mask"] = self.uncond_mask
        np.savez_compressed(
            path, embeds=self.embeds, masks=self.masks,
            prompts=np.asarray(self.prompts, dtype=object), **extra,
        )

    @staticmethod
    def load(path: str) -> "EmbeddingCache":
        # the prompts array is a pickled object array: load only caches this
        # project's tools wrote
        z = np.load(path, allow_pickle=True)
        return EmbeddingCache(
            z["embeds"], z["masks"], [str(p) for p in z["prompts"]],
            uncond_embed=z["uncond_embed"] if "uncond_embed" in z else None,
            uncond_mask=z["uncond_mask"] if "uncond_mask" in z else None,
        )
