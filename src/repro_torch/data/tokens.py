"""Deterministic synthetic token pipeline for LM training (a copy of
:mod:`repro.data.tokens`, numpy only).

Every batch is a pure function of (seed, step) — restart-safe by
construction: after checkpoint restore at step k, the stream resumes at the
exact batch k+1 on any host layout.  The generator synthesizes structured
sequences (a Zipfian unigram mix with short-range repetition) so tiny models
have something learnable — loss decreases measurably within a few hundred
steps, which the integration tests assert.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["TokenStream"]


class TokenStream:
    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, repeat_period: int = 16,
                 extras: Optional[Dict[str, tuple]] = None):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.repeat_period = repeat_period
        self.extras = extras or {}
        # Zipf-ish unigram distribution
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self._p = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        base = rng.choice(self.vocab_size, size=(self.batch, self.seq_len + 1),
                          p=self._p).astype(np.int32)
        # inject learnable short-range structure: token at t repeats t-P
        # with high probability in the second half of each period
        t = np.arange(self.seq_len + 1)
        recall = (t % self.repeat_period) >= self.repeat_period // 2
        src = np.maximum(t - self.repeat_period // 2, 0)
        gate = rng.random((self.batch, self.seq_len + 1)) < 0.8
        rep = base[:, src]
        tokens_full = np.where(recall[None, :] & gate, rep, base)
        out = {"tokens": tokens_full[:, :-1],
               "labels": tokens_full[:, 1:].astype(np.int32)}
        for name, shape in self.extras.items():
            out[name] = rng.standard_normal((self.batch, *shape)).astype(
                np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
