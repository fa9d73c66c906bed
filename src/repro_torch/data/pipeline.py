"""Data pipeline: byte-level tokenizer + synthetic corpus + batch iterator.

The synthetic corpus is a mixture of (a) Zipf-sampled "vocabulary" text with
Markov structure (so a ~100M model trains to a visibly dropping loss) and
(b) repeated shared prefixes — the prefix-reuse pattern §6.2 of the paper
identifies as Harvest's best case for KV caching.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np


class ByteTokenizer:
    """UTF-8 byte tokenizer with a small reserved-special region."""

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self.OFFSET

    def encode(self, text: str, bos: bool = True) -> List[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        return ([self.BOS] if bos else []) + ids

    def decode(self, ids) -> str:
        bs = bytes(max(0, int(i) - self.OFFSET) for i in ids
                   if int(i) >= self.OFFSET)
        return bs.decode("utf-8", errors="replace")


@dataclass
class SyntheticCorpus:
    """Markov-structured token stream with shared-prefix injection."""

    vocab_size: int
    seed: int = 0
    order_vocab: int = 512          # working vocabulary (Zipf head)
    shared_prefix_rate: float = 0.25
    prefix_len: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.order_vocab, self.vocab_size - 1)
        # sparse Markov transitions: each token has a few likely successors
        self._succ = rng.integers(1, v, size=(v, 4))
        self._zipf_p = (1.0 / np.arange(1, v + 1)) ** 1.1
        self._zipf_p /= self._zipf_p.sum()
        self._v = v
        self._shared_prefix = rng.integers(1, v, size=self.prefix_len)
        self._rng = rng

    def sample_sequence(self, length: int) -> np.ndarray:
        rng = self._rng
        out = np.empty(length, np.int64)
        start = 0
        if rng.random() < self.shared_prefix_rate:
            n = min(self.prefix_len, length)
            out[:n] = self._shared_prefix[:n]
            start = n
        tok = int(rng.choice(self._v, p=self._zipf_p))
        for i in range(start, length):
            if rng.random() < 0.15:
                tok = int(rng.choice(self._v, p=self._zipf_p))
            else:
                tok = int(self._succ[tok % self._v, rng.integers(4)])
            out[i] = tok
        return out % self.vocab_size


def make_batches(corpus: SyntheticCorpus, batch: int, seq_len: int,
                 num_batches: Optional[int] = None) -> Iterator[dict]:
    """Yields train batches: tokens (b, s), labels = next token, positions."""
    n = 0
    positions = np.broadcast_to(np.arange(seq_len), (batch, seq_len)).copy()
    while num_batches is None or n < num_batches:
        seqs = np.stack([corpus.sample_sequence(seq_len + 1)
                         for _ in range(batch)])
        yield {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
            "positions": positions.astype(np.int32),
        }
        n += 1
