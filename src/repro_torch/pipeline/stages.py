"""Host-side stage partitioner: layer stack -> pipeline stages
(counterpart of ``repro.pipeline.stages``).

The paper's substrate (PipeLayer, Sec. II-C) maps each layer's
crossbar groups to pipeline segments so FP/BP of consecutive batches
overlap across layers.  Here the "segment" is a ``stage`` mesh slice:
the transformer block stack is cut into contiguous stages balanced by
a per-layer FLOP cost model (the same cost-driven assignment idiom as
``solve/partition.make_plan``'s greedy-LPT — pipeline stages must stay
*contiguous*, so the balancing is a min-max boundary DP rather than
free LPT placement), with the embedding pinned to the first stage and
the vocab head pinned to the last.  The partition unit is the family's
*atom*: a layer for the uniform scanned stacks, a pattern unit for
hybrid, and the concatenated encoder+decoder layer sequence for
whisper (contiguity pins encoders to leading stages, decoders to
trailing ones).

Everything is computed from the config's abstract shapes — no
allocation, no tracing — and the resulting :class:`StagePartition` is
purely static: the executor (``pipeline/schedule.py``) gives each stage
rank the atom range it holds and runs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


def layer_flops(cfg: ModelConfig, kind: str) -> float:
    """Per-token forward matmul FLOPs of one decoder layer of ``kind``
    (the relative weight the balancer needs; constants cancel).
    ``enc``/``dec`` are the whisper encoder/decoder layers (ungated
    2-matmul MLP; the decoder adds the cross-attention)."""
    d, f = cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = 2.0 * (d * h * hd + 2 * d * kv * hd + h * hd * d)
    mlp = 2.0 * 3 * d * f
    if kind in ("attn", "local"):
        return attn + mlp
    if kind == "moe":
        return attn + 2.0 * cfg.top_k * 3 * d * f + 2.0 * d * cfg.n_experts
    if kind == "mamba":
        di, n, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
        return 2.0 * (d * 2 * di + di * (dr + 2 * n) + dr * di + di * d)
    if kind == "rec":
        lw = cfg.lru_width_
        return 2.0 * (2 * d * lw + 2 * lw * lw + lw * d) + mlp
    if kind == "enc":
        return attn + 2.0 * 2 * d * f
    if kind == "dec":
        return 2 * attn + 2.0 * 2 * d * f
    raise ValueError(kind)


def embed_flops(cfg: ModelConfig) -> float:
    """Embedding-side cost pinned to stage 0 (gather ~ free; the VLM
    image projection is the only real matmul)."""
    if cfg.family == "vlm" and cfg.vision_dim:
        return 2.0 * cfg.vision_dim * cfg.d_model
    return 0.0


def head_flops(cfg: ModelConfig) -> float:
    """Vocab projection cost pinned to the last stage."""
    return 2.0 * cfg.d_model * cfg.vocab


@dataclasses.dataclass(frozen=True)
class StagePartition:
    """Contiguous *atom* ranges per stage, with per-stage balanced cost.

    The atom depends on the family — ``"layer"`` for the uniform
    scanned decoder stacks, ``"unit"`` for the hybrid pattern unit
    (``len(cfg.pattern)`` sublayers cut atomically so the scanned unit
    stack slices cleanly), ``"encdec"`` for whisper, where the atom
    sequence is the concatenation ``[enc_0..enc_{Ne-1}, dec_0...]`` —
    contiguity then automatically pins encoder layers to the leading
    stages and decoder layers to the trailing ones.

    ``boundaries``: length ``n_stages + 1``; stage ``s`` owns atoms
    ``[boundaries[s], boundaries[s+1])``.  ``costs`` includes the
    embed/head pins on the first/last stage (and the hybrid tail).
    """

    n_stages: int
    boundaries: Tuple[int, ...]
    costs: Tuple[float, ...]
    atom: str = "layer"
    n_enc_atoms: int = 0

    @property
    def n_layers(self) -> int:
        return self.boundaries[-1]

    def layers_of(self, s: int) -> range:
        return range(self.boundaries[s], self.boundaries[s + 1])

    def layer_counts(self) -> Tuple[int, ...]:
        return tuple(self.boundaries[s + 1] - self.boundaries[s]
                     for s in range(self.n_stages))

    def enc_dec_counts(self, s: int) -> Tuple[int, int]:
        """(encoder, decoder) atom counts of stage ``s`` (audio only)."""
        a, b = self.boundaries[s], self.boundaries[s + 1]
        ne = max(0, min(b, self.n_enc_atoms) - min(a, self.n_enc_atoms))
        return ne, (b - a) - ne

    @property
    def uniform(self) -> bool:
        """Equal atom counts per stage (the reference's SPMD executor
        pads and masks the other partitions; the port's stage ranks each
        hold exactly their own atoms, so it runs both alike). Whisper
        never counts as uniform: even with equal totals the enc/dec split
        differs per stage."""
        if self.atom == "encdec":
            return False
        return len(set(self.layer_counts())) == 1

    @property
    def imbalance(self) -> float:
        """max/mean stage cost — 1.0 is perfectly balanced."""
        return max(self.costs) / (sum(self.costs) / len(self.costs))

    def summary(self) -> dict:
        out = {
            "n_stages": self.n_stages,
            "atom": self.atom,
            "boundaries": list(self.boundaries),
            "atom_counts": list(self.layer_counts()),
            "stage_gflops_per_token": [round(c / 1e9, 4)
                                       for c in self.costs],
            "imbalance": round(self.imbalance, 4),
        }
        if self.atom == "encdec":
            out["enc_dec_counts"] = [list(self.enc_dec_counts(s))
                                     for s in range(self.n_stages)]
        return out


def _min_max_boundaries(costs: np.ndarray, n_stages: int,
                        first_extra: float, last_extra: float
                        ) -> Tuple[int, ...]:
    """Min-max contiguous partition (DP over boundary positions).

    ``dp[k][i]`` = best achievable max-stage-cost splitting layers
    ``[0, i)`` into ``k`` stages; the first/last stage carry the pinned
    embed/head extras.  L and S are small (<= a few hundred / <= 64),
    so the O(S * L^2) DP is instant at build time.
    """
    L = len(costs)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def seg(i, j, k):                     # cost of layers [i, j) as stage k
        c = prefix[j] - prefix[i]
        if k == 0:
            c += first_extra
        if k == n_stages - 1:
            c += last_extra
        return c

    INF = float("inf")
    dp = np.full((n_stages + 1, L + 1), INF)
    cut = np.zeros((n_stages + 1, L + 1), np.int64)
    dp[0][0] = 0.0
    for k in range(1, n_stages + 1):
        for i in range(k, L - (n_stages - k) + 1):
            for j in range(k - 1, i):
                c = max(dp[k - 1][j], seg(j, i, k - 1))
                if c < dp[k][i]:
                    dp[k][i] = c
                    cut[k][i] = j
    bounds = [L]
    i = L
    for k in range(n_stages, 0, -1):
        i = int(cut[k][i])
        bounds.append(i)
    return tuple(reversed(bounds))


def _atom_costs(cfg: ModelConfig) -> Tuple[np.ndarray, str, int, float]:
    """(per-atom costs, atom kind, n_enc_atoms, extra last-stage cost).

    * dense/vlm/moe/ssm — atom = one layer.
    * hybrid — atom = one pattern unit (the scanned unit stack can only
      slice at unit boundaries); the ragged tail sublayers run on the
      last stage alongside the head, so their cost joins ``last_extra``.
    * audio — atoms = all encoder layers then all decoder layers; a
      contiguous cut over that sequence is exactly the enc-leading /
      dec-trailing placement the channel layout needs.
    """
    from repro_torch.models.lm import layer_plan  # deferred: no cycle

    if cfg.family == "audio":
        costs = np.array(
            [layer_flops(cfg, "enc")] * cfg.n_enc_layers
            + [layer_flops(cfg, "dec")] * cfg.n_dec_layers, np.float64)
        return costs, "encdec", cfg.n_enc_layers, 0.0
    kinds = layer_plan(cfg)
    if cfg.family == "hybrid":
        unit = tuple(cfg.pattern)
        n_units = cfg.n_layers // len(unit)
        unit_cost = sum(layer_flops(cfg, k) for k in unit)
        tail_cost = sum(layer_flops(cfg, k)
                        for k in kinds[n_units * len(unit):])
        return (np.full(n_units, unit_cost, np.float64), "unit", 0,
                float(tail_cost))
    costs = np.array([layer_flops(cfg, k) for k in kinds], np.float64)
    return costs, "layer", 0, 0.0


def partition_stages(cfg: ModelConfig, n_stages: int,
                     *, require_uniform: bool = False) -> StagePartition:
    """Balanced contiguous stage partition of ``cfg``'s atom stack.

    Built from abstract shapes only.  ``require_uniform`` restricts the
    cut points to equal atom counts per stage and raises a clear error
    when ``n_atoms % n_stages != 0``; the free min-max DP otherwise
    places boundaries wherever the cost model says (e.g. one layer
    fewer on the head-pinned last stage); each stage rank then holds its
    own atom count.
    """
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    costs, atom, n_enc, tail_extra = _atom_costs(cfg)
    n_atoms = len(costs)
    if n_stages > n_atoms:
        raise ValueError(
            f"{n_stages} stages > {n_atoms} {atom} atoms ({cfg.name})")
    last_extra = head_flops(cfg) + tail_extra
    if require_uniform:
        if n_atoms % n_stages:
            raise ValueError(
                f"uniform partition needs equal {atom}s per stage: "
                f"{cfg.name} has {n_atoms}, not divisible by "
                f"{n_stages} stages")
        per = n_atoms // n_stages
        bounds = tuple(per * s for s in range(n_stages + 1))
    else:
        bounds = _min_max_boundaries(costs, n_stages, embed_flops(cfg),
                                     last_extra)
    stage_costs = []
    for s in range(n_stages):
        c = float(costs[bounds[s]:bounds[s + 1]].sum())
        if s == 0:
            c += embed_flops(cfg)
        if s == n_stages - 1:
            c += last_extra
        stage_costs.append(c)
    return StagePartition(n_stages=n_stages, boundaries=bounds,
                          costs=tuple(stage_costs), atom=atom,
                          n_enc_atoms=n_enc)
