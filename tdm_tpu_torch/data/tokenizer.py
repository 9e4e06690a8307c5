"""Tokenizers with the framework's call convention
    tokenizer(texts, max_length) -> (ids [B, L] int32, mask [B, L] int32),
padded to `max_length` and truncated, as the reference drives
`T5Tokenizer(..., padding='max_length', truncation=True)`.

The port's own copy of `tdm_tpu/data/tokenizer.py` (numpy only):
`HFTokenizer` wraps a local `transformers` tokenizer folder (T5
sentencepiece, CLIP BPE) and imports `transformers` only when one is made;
without that package it raises ImportError naming it, and never falls back
to another tokenizer. `HashTokenizer` is the dependency-free deterministic
word hash for tests and smoke runs.
"""

from __future__ import annotations

import zlib

import numpy as np


class HFTokenizer:
    """A local HF tokenizer folder (never fetched from the network)."""

    def __init__(self, path: str, **kwargs):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                f"HFTokenizer({path!r}) needs the `transformers` package, which is "
                "not installed; install it, or pass a tokenizer of your own "
                "(e.g. data.tokenizer.HashTokenizer for smoke runs)"
            ) from e
        self.path = path  # kept so save_pretrained can bundle it again
        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True, **kwargs)

    def __call__(self, texts, max_length: int):
        out = self._tok(
            list(texts), max_length=max_length, padding="max_length",
            truncation=True, return_tensors="np",
        )
        return out["input_ids"].astype(np.int32), out["attention_mask"].astype(np.int32)


class HashTokenizer:
    """Deterministic word-hash tokenizer (tests and smoke runs only): stable
    across processes (crc32, not PYTHONHASHSEED-dependent `hash`)."""

    def __init__(self, vocab_size: int = 30000, eos_id: int | None = None):
        self.vocab_size = vocab_size
        self.eos_id = vocab_size - 1 if eos_id is None else eos_id

    def _word_id(self, w: str) -> int:
        return zlib.crc32(w.encode()) % (self.vocab_size - 2) + 1

    def __call__(self, texts, max_length: int):
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            toks = [self._word_id(w) for w in t.split()][: max_length - 1]
            ids[i, : len(toks)] = toks
            ids[i, len(toks)] = self.eos_id
            mask[i, : len(toks) + 1] = 1
        return ids, mask
