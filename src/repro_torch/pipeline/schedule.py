"""Static pipeline schedules (GPipe / 1F1B) and their executor
(counterpart of ``repro.pipeline.schedule``).

The whole schedule is decided host-side: a tick grid ``(n_ticks,
n_stages)`` where every cell is IDLE, a FWD of one microbatch, or a BWD
of one microbatch, plus *static* slot indices for every buffer access
(activation stash, forward-receive ring, grad-receive ring); this half
is the reference's, unchanged.

The executor (:func:`make_pipeline_grads_fn`) is the image of the
reference's one ``shard_map`` program: each stage is its own rank (or
its own ``(data, model)`` ranks), holding exactly its own atoms
(``dist.sharding.StageShards``), so no stack is padded or masked. Each
rank walks its own column of the tick grid:

* FWD: its input from ``recv_rd`` (stage 0 embeds the microbatch), that
  input stashed at ``stash_wr``, the stage forward without autograd
  (the last stage skips it: its output would go nowhere);
* BWD: the stage forward recomputed from ``stash_rd`` under autograd,
  with the reference's objective, ``loss / M`` on the last stage and
  the vjp with the cotangent from ``grad_rd`` elsewhere; fp32 gradients
  accumulated in microbatch order (so GPipe and 1F1B run the same
  operations in the same order);
* every tick where any stage receives, one ``dist.api.stage_transfer``
  over the ``stage`` submesh moves activations to ``s+1`` and cotangents
  to ``s-1`` in the compute dtype (an idle rank sends zeros).

The loss is summed over ``stage``, then averaged over the data ranks;
the shared leaves' gradients (the embedding, the head, the final norms)
are summed over ``stage`` and every gradient averaged over the data
ranks. ``model`` composes inside a stage as under ``--model-parallel``:
the executor binds the model submesh for the seams, and ``stage``, so
that the MoE layers route by the reference's in-stage rule
(``dist.api.in_hint_guard``). :func:`stats_pass` runs the K-FAC
statistics pass through the stages (one microbatch: S forwards, then S
backwards), each stage tapping its own linears.

Schedule shapes (both synchronous — the weight update applies after the
drain, which is what keeps a pipelined step numerically a gradient-
accumulation step):

  gpipe   fill all M forwards, then drain all M backwards;
          peak stash M at stage 0.
  1f1b    warmup ``min(S-1-s, M)`` forwards per stage, then steady
          one-forward-one-backward, then drain; same 2(M+S-1) ticks and
          the same (S-1)/(M+S-1) bubble fraction as GPipe but peak
          stash only ``min(M, S-s)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.dist.api import (DATA, MODEL, STAGE, all_reduce, axis_sizes,
                                  hint_guard, mesh_ndev, stage_transfer)
from repro_torch.pipeline.stages import StagePartition
from repro_torch.pipeline.stash import SlotAllocator, StashPlan, WeightStash

IDLE, FWD, BWD = 0, 1, 2

SCHEDULES = ("gpipe", "1f1b")


# ---------------------------------------------------------------------------
# Schedule construction (host-side, static)
# ---------------------------------------------------------------------------

def _stage_sequences(kind: str, S: int, M: int):
    """Per-stage ordered op lists [(op, mb), ...]."""
    seqs = []
    for s in range(S):
        if kind == "gpipe":
            seq = [(FWD, m) for m in range(M)] + \
                  [(BWD, m) for m in range(M)]
        elif kind == "1f1b":
            w = min(S - 1 - s, M)
            seq = [(FWD, m) for m in range(w)]
            for i in range(M - w):
                seq.append((FWD, w + i))
                seq.append((BWD, i))
            seq += [(BWD, m) for m in range(M - w, M)]
        else:
            raise ValueError(
                f"unknown schedule {kind!r}; pick one of {SCHEDULES}")
        seqs.append(seq)
    return seqs


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static tick grid + buffer slot maps for one (kind, S, M).

    All arrays are ``(n_ticks, n_stages)`` int32; -1 marks
    not-applicable.  ``op``/``mb`` say what each stage does at each
    tick.  Slot maps (indices into per-stage ring buffers):

      ``stash_wr``  FWD writes its stage input here,
      ``stash_rd``  BWD reads it back,
      ``recv_st``   where the activation arriving from stage-1's tick
                    lands (receiver side),
      ``recv_rd``   FWD's input slot (stages > 0),
      ``grad_st``   where the cotangent arriving from stage+1 lands,
      ``grad_rd``   BWD's incoming-cotangent slot (stages < S-1).
    """

    kind: str
    n_stages: int
    n_micro: int
    op: np.ndarray
    mb: np.ndarray
    stash_wr: np.ndarray
    stash_rd: np.ndarray
    recv_st: np.ndarray
    recv_rd: np.ndarray
    grad_st: np.ndarray
    grad_rd: np.ndarray
    stash_plan: StashPlan

    @property
    def n_ticks(self) -> int:
        return int(self.op.shape[0])

    def idle_ticks(self, s: int) -> int:
        return int((self.op[:, s] == IDLE).sum())

    @property
    def bubble_fraction(self) -> float:
        """Idle share of the tick grid — equals the classic
        (S-1)/(M+S-1) fill/drain bubble for both schedules."""
        return float((self.op == IDLE).sum()) / self.op.size

    def peak_stash(self, s: int) -> int:
        return self.stash_plan.act_depth[s]

    def summary(self) -> dict:
        return {
            "kind": self.kind,
            "n_stages": self.n_stages,
            "n_micro": self.n_micro,
            "n_ticks": self.n_ticks,
            "bubble_fraction": round(self.bubble_fraction, 4),
            "peak_stash": list(self.stash_plan.act_depth),
        }

    # -- invariants --------------------------------------------------------

    def check(self) -> None:
        """Dependency + exactly-once structural validation."""
        S, M = self.n_stages, self.n_micro
        tick_f = np.full((M, S), -1)
        tick_b = np.full((M, S), -1)
        for t in range(self.n_ticks):
            for s in range(S):
                o, m = int(self.op[t, s]), int(self.mb[t, s])
                if o == FWD:
                    assert tick_f[m, s] < 0, f"F({m},{s}) twice"
                    tick_f[m, s] = t
                elif o == BWD:
                    assert tick_b[m, s] < 0, f"B({m},{s}) twice"
                    tick_b[m, s] = t
        assert (tick_f >= 0).all() and (tick_b >= 0).all(), \
            "some microbatch never ran"
        for m in range(M):
            for s in range(S):
                if s > 0:
                    assert tick_f[m, s] > tick_f[m, s - 1], \
                        f"F({m},{s}) before its input exists"
                    assert tick_b[m, s] < tick_b[m, s - 1], \
                        f"B({m},{s - 1}) before its cotangent exists"
                assert tick_b[m, s] > tick_f[m, s], \
                    f"B({m},{s}) before F({m},{s})"

    def verify_exactly_once(self) -> None:
        """Drive a :class:`WeightStash` per stage over the grid: every
        microbatch's backward sees the weights its forward saw, and the
        end-of-step update finds the pipe drained (PipeLayer's
        exactly-once contract).  Raises ``ExactlyOnceViolation``."""
        stashes = [WeightStash(depth=1) for _ in range(self.n_stages)]
        for t in range(self.n_ticks):
            for s in range(self.n_stages):
                o, m = int(self.op[t, s]), int(self.mb[t, s])
                if o == FWD:
                    stashes[s].forward(m)
                elif o == BWD:
                    stashes[s].backward(m)
        for st in stashes:
            st.commit_update()


def make_schedule(kind: str, n_stages: int, n_micro: int) -> Schedule:
    """Build + validate the static schedule for (kind, S, M)."""
    S, M = n_stages, n_micro
    if S < 1 or M < 1:
        raise ValueError(f"need n_stages>=1 and n_micro>=1, got "
                         f"({S}, {M})")
    seqs = _stage_sequences(kind, S, M)

    # -- greedy tick simulation -------------------------------------------
    ptr = [0] * S
    tick_f: Dict[Tuple[int, int], int] = {}
    tick_b: Dict[Tuple[int, int], int] = {}
    grid: list = []
    t = 0
    limit = 4 * (M + S) + 8
    while any(ptr[s] < len(seqs[s]) for s in range(S)):
        if t >= limit:                      # pragma: no cover - safety
            raise RuntimeError(f"schedule {kind} did not converge")
        row = []
        for s in range(S):
            cell = (IDLE, -1)
            if ptr[s] < len(seqs[s]):
                o, m = seqs[s][ptr[s]]
                if o == FWD:
                    ready = s == 0 or tick_f.get((m, s - 1), t) < t
                else:
                    ready = (tick_f.get((m, s), t) < t and
                             (s == S - 1 or tick_b.get((m, s + 1), t) < t))
                if ready:
                    cell = (o, m)
            row.append(cell)
        for s, (o, m) in enumerate(row):    # commit after the full scan
            if o == FWD:
                tick_f[(m, s)] = t
                ptr[s] += 1
            elif o == BWD:
                tick_b[(m, s)] = t
                ptr[s] += 1
        grid.append(row)
        t += 1

    T = len(grid)
    op = np.full((T, S), IDLE, np.int32)
    mb = np.full((T, S), -1, np.int32)
    for t in range(T):
        for s in range(S):
            op[t, s], mb[t, s] = grid[t][s]

    # -- static buffer slots ----------------------------------------------
    stash_wr = np.full((T, S), -1, np.int32)
    stash_rd = np.full((T, S), -1, np.int32)
    recv_st = np.full((T, S), -1, np.int32)
    recv_rd = np.full((T, S), -1, np.int32)
    grad_st = np.full((T, S), -1, np.int32)
    grad_rd = np.full((T, S), -1, np.int32)
    act_al = [SlotAllocator() for _ in range(S)]
    recv_al = [SlotAllocator() for _ in range(S)]
    grad_al = [SlotAllocator() for _ in range(S)]
    act_slot: Dict[Tuple[int, int], int] = {}
    recv_slot: Dict[Tuple[int, int], int] = {}
    grad_slot: Dict[Tuple[int, int], int] = {}
    for t in range(T):
        # 1) consumptions this tick free their slots (reads happen
        #    during compute, before the end-of-tick transfers land)
        for s in range(S):
            o, m = int(op[t, s]), int(mb[t, s])
            if o == FWD:
                stash_wr[t, s] = act_slot[(m, s)] = act_al[s].alloc()
                if s > 0:
                    slot = recv_slot.pop((m, s))
                    recv_rd[t, s] = slot
                    recv_al[s].free(slot)
            elif o == BWD:
                slot = act_slot.pop((m, s))
                stash_rd[t, s] = slot
                act_al[s].free(slot)
                if s < S - 1:
                    slot = grad_slot.pop((m, s))
                    grad_rd[t, s] = slot
                    grad_al[s].free(slot)
        # 2) arrivals at the end of this tick allocate receiver slots
        for s in range(S):
            o, m = int(op[t, s]), int(mb[t, s])
            if o == FWD and s < S - 1:
                recv_st[t, s + 1] = recv_slot[(m, s + 1)] = \
                    recv_al[s + 1].alloc()
            elif o == BWD and s > 0:
                grad_st[t, s - 1] = grad_slot[(m, s - 1)] = \
                    grad_al[s - 1].alloc()

    plan = StashPlan(
        act_depth=tuple(a.peak for a in act_al),
        recv_depth=tuple(a.peak for a in recv_al),
        grad_depth=tuple(a.peak for a in grad_al),
    )
    sched = Schedule(kind=kind, n_stages=S, n_micro=M, op=op, mb=mb,
                     stash_wr=stash_wr, stash_rd=stash_rd,
                     recv_st=recv_st, recv_rd=recv_rd,
                     grad_st=grad_st, grad_rd=grad_rd, stash_plan=plan)
    sched.check()
    sched.verify_exactly_once()
    return sched


# ---------------------------------------------------------------------------
# Executor: each rank runs its stage's column of the grid
# ---------------------------------------------------------------------------

class _Stage:
    """One stage rank's model pieces: its forward (the first stage's
    front, its atoms, the hybrid tail on the last stage) and the last
    stage's head."""

    def __init__(self, cfg, st):
        from repro_torch.models import lm, whisper

        self.cfg, self.st = cfg, st
        self.audio = cfg.family == "audio"
        self.mod = whisper if self.audio else lm
        self.first, self.last = st.stage == 0, st.last
        self.dtype = lm.compute_dtype(cfg)

    def channel(self, batch) -> tuple:
        """The transfer's shape: (rows, time (whisper: frames + tokens),
        d_model)."""
        b, t = batch["tokens"].shape
        if self.audio:
            t += batch["enc_embeds"].shape[1]
        return (b, t, self.cfg.d_model)

    def forward(self, p, x_in, batch, taps=None, collect=False,
                block=None):
        """``(y, stats)``: this stage's forward of ``batch`` (``x_in``
        the previous stage's output; None on the first stage)."""
        cfg, mod = self.cfg, self.mod
        kw = dict(taps=taps, collect=collect, soi_block=block)
        if self.audio:
            x0 = (mod.stage_channel_init(cfg, p, batch) if self.first
                  else x_in)
            return mod.stage_slice_forward(
                cfg, p, x0, batch["enc_embeds"].shape[1], **kw)
        pos = mod.batch_positions(batch)
        x0 = mod.embed_inputs(cfg, p, batch) if self.first else x_in
        y, stats = mod.stage_slice_forward(cfg, p, x0, pos, **kw)
        if self.last and cfg.family == "hybrid":
            y, tail = mod.tail_forward(cfg, p, y, pos, **kw)
            stats = {**tail, **stats}
        return y, stats

    def head(self, p, y, batch) -> torch.Tensor:
        return self.mod.head_loss(self.cfg, p, y, batch)


def _shared_sum(grads: dict, loss: torch.Tensor, st) -> torch.Tensor:
    """Sum the shared leaves' gradients and the loss over the stage ranks,
    in place (one flat fp32 all-reduce); returns the loss."""
    shared = [k for k in grads if not st.local(k)]
    flat = torch.cat([grads[k].reshape(-1) for k in shared]
                     + [loss.reshape(1)])
    all_reduce(flat, st.mesh)
    ofs = 0
    for k in shared:
        n = grads[k].numel()
        grads[k].copy_(flat[ofs:ofs + n].reshape(grads[k].shape))
        ofs += n
    return flat[-1]


def _bound(mesh) -> dict:
    """The submeshes a stage rank binds: ``stage``, and ``data``/``model``
    where they hold several ranks."""
    sizes = axis_sizes(mesh)
    axes = {STAGE: mesh[STAGE]}
    for a in (DATA, MODEL):
        if sizes.get(a, 1) > 1:
            axes[a] = mesh[a]
    return axes


def make_pipeline_grads_fn(cfg, part: StagePartition, sched: Schedule,
                           mesh, shards=None):
    """The executor of ``sched`` on this rank (see the module's
    docstring).

    Returns ``fn(params, micro) -> (loss, grads)``: ``params`` this
    rank's leaves (``dist.sharding.StageShards``; ``shards`` this rank's
    layout, built from ``mesh`` and ``part`` when not given), ``micro``
    this rank's rows in the :func:`repro_torch.pipeline.microbatch.
    split_microbatches` layout; ``(loss, grads)`` those of gradient
    accumulation (``launch.steps.make_train_step``): the mean of the
    microbatch losses and the gradients averaged 1/M a microbatch in
    microbatch order, over the global batch (reduced over the data
    ranks), ``grads`` for this rank's leaves. ``fn.peak_stash`` is the
    most stage inputs the last call held at once (the schedule's
    ``stash_plan.act_depth`` of this stage)."""
    from repro_torch.dist import sharding

    S, M = sched.n_stages, sched.n_micro
    if part.n_stages != S:
        raise ValueError(f"partition has {part.n_stages} stages, "
                         f"schedule has {S}")
    sizes = axis_sizes(mesh)
    if sizes.get(STAGE) != S:
        raise ValueError(
            f"mesh axis 'stage' is {sizes.get(STAGE)}, schedule wants "
            f"{S}; build the mesh with launch.mesh.make_pipeline_mesh")
    st = shards or sharding.stage_shards(cfg, mesh, part)
    s = st.stage
    stage = _Stage(cfg, st)
    axes = _bound(mesh)
    data = axes.get(DATA)
    inv_m = 1.0 / M
    # the ticks where some stage receives: every stage rank transfers
    moving = [bool((sched.recv_st[t] >= 0).any()
                   or (sched.grad_st[t] >= 0).any())
              for t in range(sched.n_ticks)]

    def backward(params, x_in, batch, dy):
        """The BWD unit: ``(loss_mb or None, param grads, input
        cotangent or None)``."""
        with torch.enable_grad():
            p = {k: v.detach().requires_grad_(True)
                 for k, v in params.items()}
            xi = None if x_in is None else \
                x_in.detach().requires_grad_(True)
            y, _ = stage.forward(p, xi, batch)
            loss_mb = None
            if stage.last:
                loss_mb = stage.head(p, y, batch)
                outs, gouts = [loss_mb * inv_m], None
            else:
                outs, gouts = [y], [dy]
            ins = list(p.values()) + ([] if xi is None else [xi])
            got = torch.autograd.grad(outs, ins, grad_outputs=gouts,
                                      allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(p.items(), got)}
        dx = None if xi is None else got[-1].to(stage.dtype)
        return (None if loss_mb is None else loss_mb.detach()), grads, dx

    def run(params, micro):
        first = {k: v[0] for k, v in micro.items()}
        device = first["tokens"].device
        zeros = torch.zeros(stage.channel(first), dtype=stage.dtype,
                            device=device)
        stash: Dict[int, object] = {}
        recv: Dict[int, torch.Tensor] = {}
        dgrad: Dict[int, torch.Tensor] = {}
        peak = 0
        g_acc = {k: torch.zeros(v.shape, dtype=torch.float32,
                                device=v.device) for k, v in params.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(sched.n_ticks):
            o, m = int(sched.op[t, s]), int(sched.mb[t, s])
            y_send = dx_send = None
            if o != IDLE:
                batch = {k: v[m] for k, v in micro.items()}
            if o == FWD:
                # the stage input: the microbatch on the first stage
                x_in = batch if stage.first else \
                    recv.pop(int(sched.recv_rd[t, s]))
                stash[int(sched.stash_wr[t, s])] = x_in
                peak = max(peak, len(stash))
                if not stage.last:
                    with torch.no_grad():
                        y_send = stage.forward(
                            params, None if stage.first else x_in,
                            batch)[0].to(stage.dtype)
            elif o == BWD:
                x_in = stash.pop(int(sched.stash_rd[t, s]))
                dy = None if stage.last else \
                    dgrad.pop(int(sched.grad_rd[t, s]))
                loss_mb, grads, dx_send = backward(
                    params, None if stage.first else x_in, batch, dy)
                for k, g in grads.items():
                    g_acc[k].add_(g.to(torch.float32))
                del grads
                if loss_mb is not None:
                    loss_acc = loss_acc + loss_mb * inv_m
            if S > 1 and moving[t]:
                y_r, dx_r = stage_transfer(
                    zeros if y_send is None else y_send,
                    zeros if dx_send is None else dx_send, st.mesh)
                if sched.recv_st[t, s] >= 0:
                    recv[int(sched.recv_st[t, s])] = y_r
                if sched.grad_st[t, s] >= 0:
                    dgrad[int(sched.grad_st[t, s])] = dx_r
        pipeline_grads.peak_stash = peak
        loss = _shared_sum(g_acc, loss_acc, st) if S > 1 else loss_acc
        if data is not None:
            from repro_torch.launch.steps import reduce_shares

            order = list(g_acc)
            w = 1.0 / mesh_ndev(data)
            red = reduce_shares([g_acc[k] for k in order] + [loss], data,
                                [w] * (len(order) + 1))
            g_acc, loss = dict(zip(order, red[:-1])), red[-1]
        return loss, g_acc

    def pipeline_grads(params, micro):
        with hint_guard(axes):
            return run(params, micro)

    pipeline_grads.peak_stash = 0
    return pipeline_grads


def stats_pass(cfg, st, params, taps, batch, soi_block=None,
               collect=True):
    """The K-FAC statistics pass through the stages: ``batch`` (this
    rank's subsample rows, one microbatch) forward through every stage
    with each stage's ``taps`` and its A statistics collected (the
    blocked Grams, or with ``collect="cols"`` the blocked tokens), then
    backward from the last stage's loss; returns ``(loss, acts,
    tap_grads)`` for this stage's linears (``kfac.stats_grams``'s pass),
    the loss summed over the stage ranks (the last stage's). Every stage
    rank takes part in each of the 2 (S - 1) transfers. Runs outside the
    stage program (the reference's statistics graph does too): the caller
    binds only ``data`` and ``model``."""
    stage = _Stage(cfg, st)
    s, S = st.stage, st.n_stages
    zeros = torch.zeros(stage.channel(batch), dtype=stage.dtype,
                        device=batch["tokens"].device)
    names = list(taps)
    x_in = y = acts = dy = None
    with torch.enable_grad():
        for t in range(S):
            if s == t:
                if x_in is not None:
                    x_in = x_in.detach().requires_grad_(True)
                y, acts = stage.forward(params, x_in, batch, taps=taps,
                                        collect=collect, block=soi_block)
            if t < S - 1:
                prev, _ = stage_transfer(
                    y.detach().to(stage.dtype) if s == t else zeros, zeros,
                    st.mesh)
                if s == t + 1:
                    x_in = prev
        loss = torch.zeros((), dtype=torch.float32, device=zeros.device)
        for t in reversed(range(S)):
            dx = None
            if s == t:
                if stage.last:
                    loss = stage.head(params, y, batch)
                    outs, gouts = [loss], None
                else:
                    outs, gouts = [y], [dy]
                ins = [taps[n] for n in names] + \
                    ([] if x_in is None else [x_in])
                got = torch.autograd.grad(outs, ins, grad_outputs=gouts,
                                          allow_unused=True)
                tap_grads = {n: torch.zeros_like(taps[n]) if g is None else g
                             for n, g in zip(names, got)}
                dx = None if x_in is None else got[-1].to(stage.dtype)
            if t > 0:
                _, nxt = stage_transfer(zeros, zeros if dx is None else dx,
                                        st.mesh)
                if s == t - 1:
                    dy = nxt
    loss = all_reduce(loss.detach().to(torch.float32).reshape(1).clone(),
                      st.mesh)[0]
    return loss, acts, tap_grads
