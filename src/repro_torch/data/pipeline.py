"""Deterministic, seekable synthetic token stream (counterpart of
``repro.data.pipeline``, without the jax sharding helpers).

Batch ``i`` is a pure function of ``(seed, i)`` drawn with numpy's
Philox, so the port and the reference produce byte-identical tokens.
Tokens follow per-sequence topic unigrams with copy-previous and
offset-8 repeat moves, so the loss has learnable structure.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DataCursor:
    """Stream position: the data is a pure function of it, so a
    checkpoint stores only this (``to_json`` in its manifest)."""

    step: int = 0

    def advance(self) -> "DataCursor":
        return DataCursor(self.step + 1)

    def to_json(self) -> dict:
        return {"step": self.step}

    @staticmethod
    def from_json(d: dict) -> "DataCursor":
        return DataCursor(int(d["step"]))


def _philox(seed: int, step: int):
    return np.random.Generator(np.random.Philox(key=seed, counter=step))


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_topics: int = 16
    topic_vocab: int = 512

    def batch_slice(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of global batch ``step``; each row draws from
        its own Philox counter, so any row split gives the same data."""
        n = hi - lo
        tv = min(self.topic_vocab, self.vocab)
        out = np.empty((n, self.seq_len), np.int32)
        for r, i in enumerate(range(lo, hi)):
            rng = _philox(self.seed, step * (1 << 24) + i)
            topic = int(rng.integers(0, self.n_topics))
            off = (topic * tv) % max(self.vocab - tv, 1)
            toks = (rng.integers(0, tv, size=self.seq_len)
                    + off).astype(np.int32)
            u = rng.random(self.seq_len)
            for t in range(1, self.seq_len):
                if u[t] < 0.25:
                    toks[t] = toks[t - 1]
                elif t >= 8 and u[t] < 0.35:
                    toks[t] = toks[t - 8]
            out[r] = toks
        return out % self.vocab

    def batch(self, cursor: DataCursor, *, device) -> dict:
        """The whole global batch at ``cursor`` as a tensor dict."""
        toks = self.batch_slice(cursor.step, 0, self.global_batch)
        return {"tokens": torch.from_numpy(toks).to(device)}
