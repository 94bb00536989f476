"""Stash bookkeeping for the pipeline: buffer slots + weight versions
(counterpart of ``repro.pipeline.stash``).

Two kinds of state ride across pipeline ticks:

* **Activation stashes** — each in-flight microbatch holds exactly one
  saved tensor per stage (the stage *input*; backward recomputes the
  stage forward from it, so the stash is the whole per-microbatch
  memory bill).  :class:`SlotAllocator` is the host-side free-list
  ``schedule.make_schedule`` uses to assign every stash/ring access a
  *static* slot index; its high-water mark is the stage's stash capacity, and
  per stage it equals the schedule's peak
  in-flight microbatch count (GPipe: ``M``; 1F1B: ``min(M, S - s)`` —
  the memory argument for 1F1B).

* **Weight versions** — PipeLayer-style exactly-once semantics: the
  backward of microbatch ``m`` must run against the *same weights* its
  forward saw, and every microbatch contributes to exactly one update.
  :class:`WeightStash` tracks (version used at forward, version live
  at backward) per microbatch.  The synchronous GPipe/1F1B schedules
  satisfy this trivially — the update is applied at the step boundary,
  after the drain — and ``Schedule.verify_exactly_once`` drives a
  WeightStash over the whole tick grid at build time to prove it.  An
  asynchronous (PipeDream-style) schedule would need ``depth`` stashed
  weight versions and a live WeightStash that elastic recovery resets;
  with today's synchronous schedules no run-time instance exists —
  every step is drained, so ``runtime/loop.py``'s checkpoint restore
  already discards any partial step (in-flight microbatches are never
  replayed against new weights).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Tuple


class SlotAllocator:
    """Deterministic free-list slot allocator (host-side, static).

    ``alloc()`` returns the smallest free slot; ``free()`` returns it to
    the pool.  ``peak`` is the high-water slot count — the capacity the
    ring buffer must be allocated with.
    """

    def __init__(self) -> None:
        self._free: List[int] = []
        self._next = 0
        self._live: set = set()
        self.peak = 0

    def alloc(self) -> int:
        if self._free:
            s = heapq.heappop(self._free)
        else:
            s = self._next
            self._next += 1
            self.peak = max(self.peak, self._next)
        self._live.add(s)
        return s

    def free(self, s: int) -> None:
        if s not in self._live:
            raise ValueError(f"slot {s} freed but not live")
        self._live.remove(s)
        heapq.heappush(self._free, s)

    @property
    def n_live(self) -> int:
        return len(self._live)


@dataclasses.dataclass(frozen=True)
class StashPlan:
    """Static buffer sizing of one pipeline schedule (per-stage).

    ``act_depth[s]``  peak in-flight microbatches at stage ``s`` — the
                      number of stage-input activations stashed for
                      backward (README documents the memory formula
                      ``depth * mb * T * d_model * bytes(dtype)``).
    ``recv_depth[s]`` peak queued forward activations (arrived from
                      stage ``s-1``, not yet consumed).
    ``grad_depth[s]`` peak queued backward cotangents.

    The executor keeps each stage's stash at its own depth (a stage
    rank holds only the inputs in flight on it).
    """

    act_depth: Tuple[int, ...]
    recv_depth: Tuple[int, ...]
    grad_depth: Tuple[int, ...]

    @property
    def act_cap(self) -> int:
        return max(self.act_depth)

    @property
    def recv_cap(self) -> int:
        return max(max(self.recv_depth), 1)

    @property
    def grad_cap(self) -> int:
        return max(max(self.grad_depth), 1)


class ExactlyOnceViolation(AssertionError):
    """A microbatch's backward saw different weights than its forward,
    or an update ran with microbatches still in flight."""


class WeightStash:
    """Weight-version ledger enforcing exactly-once update semantics.

    ``forward(mb)`` records the live version for ``mb``; ``backward(mb)``
    checks the live version still matches (and that ``mb`` is in
    flight); ``commit_update()`` advances the version and requires the
    pipe to be drained.  ``depth`` bounds the number of distinct
    versions in flight (1 for the synchronous schedules; a PipeDream
    variant would raise it)."""

    def __init__(self, depth: int = 1):
        self.depth = depth
        self.version = 0
        self._inflight: Dict[int, int] = {}      # mb -> forward version

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def forward(self, mb: int) -> int:
        if mb in self._inflight:
            raise ExactlyOnceViolation(
                f"microbatch {mb} forwarded twice without a backward")
        self._inflight[mb] = self.version
        versions = set(self._inflight.values())
        if len(versions) > self.depth:
            raise ExactlyOnceViolation(
                f"{len(versions)} weight versions in flight exceeds "
                f"stash depth {self.depth}")
        return self.version

    def backward(self, mb: int) -> int:
        if mb not in self._inflight:
            raise ExactlyOnceViolation(
                f"backward for microbatch {mb} without a forward")
        v = self._inflight.pop(mb)
        if v != self.version:
            raise ExactlyOnceViolation(
                f"microbatch {mb}: forward used weight version {v} but "
                f"version {self.version} is live at backward (stash "
                f"depth {self.depth} cannot cover the gap)")
        return v

    def commit_update(self) -> int:
        if self._inflight:
            raise ExactlyOnceViolation(
                f"weight update with {len(self._inflight)} microbatches "
                f"in flight: {sorted(self._inflight)}")
        self.version += 1
        return self.version

    def reset(self) -> None:
        """Recovery: drop in-flight microbatches (their partial work is
        discarded with the restored checkpoint, never double-applied)."""
        self._inflight.clear()
