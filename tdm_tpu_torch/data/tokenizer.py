"""The training CLI's stand-in tokenizer.

The port's own copy of `HashTokenizer` from `tdm_tpu/data/tokenizer.py`
(numpy only): a deterministic word-hash tokenizer for smoke runs without a
T5 embedding cache, with the framework's call convention
    tokenizer(texts, max_length) -> (ids [B, L] int32, mask [B, L] int32).
The transformers-backed tokenizers wait for slice 7 (text encoders).
"""

from __future__ import annotations

import zlib

import numpy as np


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
