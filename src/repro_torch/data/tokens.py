"""Synthetic LM token pipeline: the port's copy of `repro.data.tokens`.

A Zipf-distributed stream with injected copy patterns gives the model
something learnable (the loss drops measurably within a few hundred
steps). The draws are numpy's ``default_rng(seed)`` stream in the
reference's order, so every batch is bit-equal to the reference's. The
batches are numpy int32 arrays; nothing here touches a device (the train
loop moves each batch).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    batch_size: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_period: int = 64     # every copy_period tokens, repeat a window
    copy_len: int = 16


class SyntheticTokenPipeline:
    """Yields ``{"tokens": [B, S], "targets": [B, S]}`` int32 batches, the
    targets the tokens shifted by one."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        # Zipf over the vocab, truncated + renormalised
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def _sequence(self, n: int) -> np.ndarray:
        cfg = self.cfg
        toks = self._rng.choice(cfg.vocab_size, size=n, p=self._p)
        # inject copy structure: window repeats → learnable induction
        for start in range(cfg.copy_period, n - cfg.copy_len,
                           cfg.copy_period):
            src = start - cfg.copy_period
            toks[start:start + cfg.copy_len] = toks[src:src + cfg.copy_len]
        return toks.astype(np.int32)

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        while True:
            seqs = np.stack([self._sequence(cfg.seq_len + 1)
                             for _ in range(cfg.batch_size)])
            yield {"tokens": seqs[:, :-1], "targets": seqs[:, 1:]}

    def batches(self, num: int) -> Iterator[dict]:
        it = iter(self)
        for _ in range(num):
            yield next(it)
