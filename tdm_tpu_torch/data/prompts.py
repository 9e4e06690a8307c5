"""Prompt data: prompt lists, the prompt batcher, the offline
text-embedding cache and the family conditioning format.

The port's own copy of `tdm_tpu/data/prompts.py` for the PixArt paths (numpy
only): `load_prompts` reads .txt / .jsonl files and in-memory lists (an HF
dataset name raises: slice 7), `PromptBatcher` is the shuffling per-host
batcher, and `EmbeddingCache` reads and writes the `.npz` that the JAX
package's `cli/build_cache` builds — embeds [N, L, D], masks [N, L],
prompts [N], the empty prompt's `uncond_embed` [L, D] / `uncond_mask` [L]
for the CFG branch, the dedicated validation rows (val_prompts,
val_embeds, val_masks), and an SD3 cache's pooled CLIP vectors (pooled
[N, P], uncond_pooled [P], val_pooled [V, P]). `pack_family_cond` turns
cache rows into the conditioning the pipeline takes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np


def load_prompts(
    source,
    *,
    caption_column: str = "prompt",
    max_samples: Optional[int] = None,
    dataset_config_name: Optional[str] = None,
) -> list[str]:
    """Prompt strings from a list, a .txt file (one prompt a line) or a
    .jsonl file (the caption column of each row)."""
    if isinstance(source, (list, tuple)):
        prompts = [str(p) for p in source]
    elif os.path.isfile(source) and source.endswith(".txt"):
        with open(source) as f:
            prompts = [line.strip() for line in f if line.strip()]
    elif os.path.isfile(source) and source.endswith(".jsonl"):
        prompts = []
        with open(source) as f:
            for line in f:
                if line.strip():
                    prompts.append(str(json.loads(line)[caption_column]))
    else:
        raise NotImplementedError(
            f"prompt source {source!r}: HF datasets and other formats are not "
            "ported yet (ROADMAP.md queue 1, slice 7); pass a .txt or .jsonl "
            "file, or an embedding cache"
        )
    if max_samples is not None:
        prompts = prompts[:max_samples]
    if not prompts:
        raise ValueError(f"no prompts loaded from {source!r}")
    return prompts


@dataclass
class PromptBatcher:
    """Infinite shuffling batcher over a (host-sharded) prompt list: yields
    dict(prompts, input_ids, attention_mask) with a tokenizer, else the raw
    prompts; reshuffles each epoch, deterministic under `seed`."""

    prompts: Sequence[str]
    batch_size: int
    tokenizer: Optional[object] = None
    max_length: int = 120
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        shard = list(self.prompts)[self.host_index :: self.host_count]
        if not shard:
            raise ValueError(
                f"host {self.host_index}/{self.host_count} got an empty shard"
            )
        self._shard = shard

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self.host_index)
        n = len(self._shard)
        while True:
            order = rng.permutation(n)
            for start in range(0, n - self.batch_size + 1, self.batch_size):
                batch_prompts = [self._shard[i] for i in order[start : start + self.batch_size]]
                out = {"prompts": batch_prompts}
                if self.tokenizer is not None:
                    ids, mask = self.tokenizer(batch_prompts, max_length=self.max_length)
                    out["input_ids"] = np.asarray(ids)
                    out["attention_mask"] = np.asarray(mask)
                yield out
            if n < self.batch_size:
                raise ValueError(f"batch_size {self.batch_size} > shard size {n}")


def pack_family_cond(family: str, embeds, masks, pooled=None, *, error: type = ValueError):
    """Cache rows → the family's conditioning: (embeds, pooled) for SD3,
    which needs a cache with pooled vectors (`error` otherwise), (embeds,
    mask) for PixArt (T5 [B, 120, 4096]) and SD1.5 (CLIP-L [B, 77, 768])."""
    if family == "cogvideox":
        raise NotImplementedError(
            "cogvideox conditioning is not ported yet: ROADMAP.md queue 1, "
            "slice 5 (CogVideoX)"
        )
    if family == "sd3":
        if pooled is None:
            raise error(
                "SD3 conditioning needs the pooled CLIP vector and this cache "
                "has none; rebuild it with `build_cache --pipeline <sd3 checkpoint>`"
            )
        return (embeds, pooled)
    return (embeds, masks)


class EmbeddingCache:
    """Per-prompt text embeddings (T5; CLIP + T5 with pooled vectors for
    SD3), encoded once offline."""

    def __init__(
        self,
        embeds: np.ndarray,
        masks: np.ndarray,
        prompts: list[str],
        uncond_embed: Optional[np.ndarray] = None,
        uncond_mask: Optional[np.ndarray] = None,
        pooled: Optional[np.ndarray] = None,
        uncond_pooled: Optional[np.ndarray] = None,
        val_prompts: Optional[list[str]] = None,
        val_embeds: Optional[np.ndarray] = None,
        val_masks: Optional[np.ndarray] = None,
        val_pooled: Optional[np.ndarray] = None,
    ):
        self.embeds = embeds  # [N, L, D]
        self.masks = masks  # [N, L]
        self.prompts = list(prompts)
        self.uncond_embed = uncond_embed  # [L, D] or None
        self.uncond_mask = uncond_mask  # [L] or None
        self.pooled = pooled  # [N, P] or None (SD3's pooled CLIP)
        self.uncond_pooled = uncond_pooled  # [P] or None
        # dedicated rows of the fixed validation prompts
        self.val_prompts = list(val_prompts) if val_prompts else []
        self.val_embeds = val_embeds  # [V, L, D] or None
        self.val_masks = val_masks  # [V, L] or None
        self.val_pooled = val_pooled  # [V, P] or None

    def save(self, path: str) -> None:
        extra = {}
        if self.uncond_embed is not None:
            extra["uncond_embed"] = self.uncond_embed
            extra["uncond_mask"] = self.uncond_mask
        if self.pooled is not None:
            extra["pooled"] = self.pooled
            if self.uncond_pooled is not None:
                extra["uncond_pooled"] = self.uncond_pooled
        if self.val_prompts:
            extra["val_prompts"] = np.asarray(self.val_prompts, dtype=object)
            extra["val_embeds"] = self.val_embeds
            extra["val_masks"] = self.val_masks
            if self.val_pooled is not None:
                extra["val_pooled"] = self.val_pooled
        np.savez_compressed(
            path, embeds=self.embeds, masks=self.masks,
            prompts=np.asarray(self.prompts, dtype=object), **extra,
        )

    @staticmethod
    def load(path: str) -> "EmbeddingCache":
        # the prompts array is a pickled object array: load only caches this
        # project's tools wrote
        z = np.load(path, allow_pickle=True)

        def opt(name):
            return z[name] if name in z else None

        return EmbeddingCache(
            z["embeds"], z["masks"], [str(p) for p in z["prompts"]],
            uncond_embed=opt("uncond_embed"), uncond_mask=opt("uncond_mask"),
            pooled=opt("pooled"), uncond_pooled=opt("uncond_pooled"),
            val_prompts=[str(p) for p in z["val_prompts"]] if "val_prompts" in z else None,
            val_embeds=opt("val_embeds"), val_masks=opt("val_masks"),
            val_pooled=opt("val_pooled"),
        )

    def validation_rows(
        self, prompts: Sequence[str]
    ) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """(embeds [V,L,D] fp32, masks [V,L] int32, pooled [V,P] fp32 or
        None) of the fixed validation prompts: the dedicated rows first,
        then the main rows; a prompt in neither raises, since grids must
        render the same fixed prompts every time (reference
        src/main.py:416-431). The pooled rows come from `val_pooled` and
        `pooled` alike, and are None where any prompt's row has none."""
        e_rows, m_rows, p_rows, missing = [], [], [], []
        for p in prompts:
            if p in self.val_prompts:
                i = self.val_prompts.index(p)
                e_rows.append(self.val_embeds[i])
                m_rows.append(self.val_masks[i])
                p_rows.append(None if self.val_pooled is None else self.val_pooled[i])
            elif p in self.prompts:
                i = self.prompts.index(p)
                e_rows.append(self.embeds[i])
                m_rows.append(self.masks[i])
                p_rows.append(None if self.pooled is None else self.pooled[i])
            else:
                missing.append(p)
        if missing:
            raise KeyError(
                f"validation prompts {missing!r} not in the embedding cache — "
                "rebuild it with cli/build_cache (it embeds "
                "--validation_prompts under dedicated keys)"
            )
        pooled = (None if any(r is None for r in p_rows)
                  else np.stack(p_rows).astype(np.float32))
        return (np.stack(e_rows).astype(np.float32),
                np.stack(m_rows).astype(np.int32), pooled)

    def batches(
        self, batch_size: int, *, seed: int = 0, host_index: int = 0, host_count: int = 1
    ) -> Iterator[tuple]:
        """Yields shuffled (embeds fp32 [B,L,D], masks [B,L]) batches of this
        host's rows, forever, reshuffled each epoch; (embeds, masks, pooled
        fp32 [B,P]) when the cache carries pooled vectors (SD3)."""
        idx_all = np.arange(len(self.prompts))[host_index::host_count]
        rng = np.random.default_rng(seed + host_index)
        while True:
            order = rng.permutation(len(idx_all))
            for s in range(0, len(idx_all) - batch_size + 1, batch_size):
                sel = idx_all[order[s : s + batch_size]]
                out = (self.embeds[sel].astype(np.float32), self.masks[sel])
                if self.pooled is not None:
                    out = out + (self.pooled[sel].astype(np.float32),)
                yield out
