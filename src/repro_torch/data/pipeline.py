"""Deterministic, seekable, shardable synthetic token stream
(counterpart of ``repro.data.pipeline``).

Batch ``i`` is a pure function of ``(seed, i)`` drawn with numpy's
Philox, so the port and the reference produce byte-identical tokens.
Tokens follow per-sequence topic unigrams with copy-previous and
offset-8 repeat moves, so the loss has learnable structure. Each row
draws from its own counter, so a rank generates only its own rows of the
global batch (:func:`make_global_batch`), as the reference's hosts do.
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

    def host_slice(self, step: int, rank: int, world: int) -> np.ndarray:
        """Rank ``rank`` of ``world``'s equal share of global batch
        ``step`` (the reference's per-host slice)."""
        per = self.global_batch // world
        return self.batch_slice(step, rank * per, (rank + 1) * per)

    def batch(self, cursor: DataCursor, *, device) -> dict:
        """The whole global batch at ``cursor`` as a tensor dict."""
        toks = self.batch_slice(cursor.step, 0, self.global_batch)
        return {"tokens": torch.from_numpy(toks).to(device)}


def batch_shard(mesh) -> tuple:
    """``(shard, n)``: this rank's shard of the batch and the shard count,
    over the batch axes the mesh has (``pod``, ``data``, combined
    row-major). Ranks that differ only along other axes (``model``) hold
    the same shard."""
    from repro_torch.dist.api import BATCH_AXES, axis_sizes

    sizes = axis_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    shard, n = 0, 1
    for a in (a for a in BATCH_AXES if a in sizes):
        shard = shard * sizes[a] + coord[a]
        n *= sizes[a]
    return shard, n


def batch_rows_of(global_batch: int, mesh) -> tuple:
    """``(lo, hi)``: this rank's rows of a global batch of
    ``global_batch`` rows, split evenly over the batch shards
    (:func:`batch_shard`)."""
    shard, n = batch_shard(mesh)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split "
                         f"over {n} batch shards")
    per = global_batch // n
    return shard * per, (shard + 1) * per


def make_global_batch(ds: SyntheticTokens, cursor: DataCursor, mesh, *,
                      device, extras: dict | None = None) -> dict:
    """This rank's rows of global batch ``cursor`` over the mesh's batch
    axes (:func:`batch_rows_of`), generated for this rank only, as the
    reference's ``make_global_batch`` fills each device's shard; without
    a mesh the whole batch. ``extras`` are added as given."""
    lo, hi = (0, ds.global_batch) if mesh is None else \
        batch_rows_of(ds.global_batch, mesh)
    out = {"tokens": torch.from_numpy(
        ds.batch_slice(cursor.step, lo, hi)).to(device)}
    if extras:
        out.update(extras)
    return out
