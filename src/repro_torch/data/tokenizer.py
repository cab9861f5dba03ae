"""Byte-level tokenizer with media placeholder tokens.

Vocab: 256 byte values + specials.  Large-vocab configs simply leave the
upper ids unused — the tokenizer never emits ids ≥ 256 + n_specials, so it
is valid for every assigned architecture.  (The port's own copy of the JAX
package's ``data/tokenizer.py``.)
"""
from __future__ import annotations

import numpy as np

PAD, BOS, EOS, IMG, AUDIO = 0, 1, 2, 3, 4
N_SPECIAL = 8


class ByteTokenizer:
    def __init__(self, vocab_size: int = 512):
        if vocab_size < 256 + N_SPECIAL:
            raise ValueError(f"vocab_size {vocab_size} < {256 + N_SPECIAL}")
        self.vocab_size = vocab_size

    def encode(self, text: str, *, bos: bool = False) -> np.ndarray:
        ids = [b + N_SPECIAL for b in text.encode("utf-8")]
        if bos:
            ids = [BOS] + ids
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) - N_SPECIAL for i in ids
                   if int(i) >= N_SPECIAL)
        return bs.decode("utf-8", errors="replace")
