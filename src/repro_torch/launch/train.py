"""End-to-end training driver: K-FAC (or the SGD baseline), the
fault-tolerant loop with checkpoints, and synthetic data (counterpart of
``repro.launch.train``).

  python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 4 \\
      --batch 8 --seq 256 --stats-every 2 --inv-every 2

runs the full-width model on CUDA; ``--smoke --device cpu`` runs the
reduced config on the CPU. The cadence follows the paper (Fig. 8): every
step runs FP/BP/WU; the SU stage (factor statistics) runs every
``--stats-every`` steps and the INV stage (composed-precision block
inverses) every ``--inv-every`` steps, in the order stats, inv, train.
INV goes through the ``neumann_inv`` kernel in every mode. The pooled WU
goes through the ``fused_precond`` kernel at ``--precision fp32|hilo``;
the kernel is the hi/lo scheme, so the integer-sliced precisions
(``int8``) take the pooled ``quantize.lowp_einsum`` route instead, and
``--no-fused-wu`` the per-leaf einsums. On the card the kernels cannot
be turned off.

``--async-inv`` makes the refresh staleness-tolerant and double-buffered
(``solve.AsyncInverseRefresher``): step N preconditions with the inverses
of the factors as of step N - ``--inv-every``, and each refresh runs on a
side CUDA stream beside the following steps. ``--dist-inv`` routes the
refresh through the block-parallel solver, which on one device is the
replicated refresh.

Under ``torchrun`` (``WORLD_SIZE`` > 1) the program trains data-parallel:
it initialises the process group (NCCL when each rank has a card of its
own, gloo on ``--device cpu`` or when ranks share cards, or
``--dist-backend``), puts each rank on ``cuda:{LOCAL_RANK % cards}``,
builds ``launch.mesh.make_dev_mesh()`` and
replicates the params; each rank takes its rows of the global batch,
the loss, gradients and factor Grams are reduced over the ranks, and
with ``--dist-inv`` each rank inverts its share of the blocks. Rank 0
prints the JSON and writes the checkpoints::

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen1.5-0.5b --dist-inv --steps 4 --batch 8 --seq 256

``--model-parallel N`` splits each model group of ``N`` ranks of the
``(data, model)`` mesh megatron-style (``dist.sharding.model_spec_dim``):
attention and MLP weights are sliced, and the MoE experts on their
expert dim (expert parallelism: each rank routes to its ``E / N``
experts, the router replicated), each rank's K-FAC factor blocks (and
expert factor stacks) follow its weight slice, and with ``--dist-inv``
each block of the full factor tree is inverted on exactly one rank::

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
      --arch qwen1.5-0.5b --model-parallel 2 --dist-inv --steps 4

``--pp N`` cuts the layer stack into ``N`` contiguous stages over the
``stage`` axis of a ``(stage, data, model)`` mesh
(``launch.mesh.make_pipeline_mesh``; ``--model-parallel`` then works
inside a stage) and streams each rank's rows through ``--pp-schedule``'s
microbatch schedule (``repro_torch.pipeline``); each stage rank holds
only its own layers' params, K-FAC factors, inverses and WU tiles::

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
      --arch qwen1.5-0.5b --pp 2 --pp-schedule 1f1b --dist-inv --steps 4

``--smw``, ``--async-inv`` and ``--optimizer sgd`` run on every mesh
above: ``--smw``'s columns are gathered over the data ranks and its drift
reduced over the mesh, so that every rank's gate falls back alike;
``--async-inv``'s refresh runs its collectives on groups of its own
(``dist.api.side_lane``), and under ``--pp`` is dispatched just before the
pipeline step (``pipeline.kfac_glue.bubble_refresh``); the SGD baseline
reduces its gradients over the data ranks and slices the model as K-FAC
does. ``--optimizer sgd`` under ``--pp`` raises (the reference's
message).

A world that is not a multiple of the model x stage group trains on its
largest mesh (``runtime.elastic.largest_mesh``: a power-of-two data
axis); the ranks left over print a line and exit 0. ``--inject-failure-at
N --inject-lost K`` drills a loss of ``K`` ranks: the survivors re-form
the largest mesh without the last ``K`` ranks, restore the last
checkpoint onto it and replay (``runtime.TrainLoop``), and the ranks left
out exit 0. A real lost process is recovered by ``torchrun
--max-restarts``: the restarted group resumes from the last checkpoint on
the largest mesh of its world.

``--smw`` replaces the stats/inv cadence with the incremental SOI path:
every step runs one rank-k program (SU with column factors, factor EMA,
Woodbury inverse update through the ``smw_update`` kernel, drift probe)
and a host gate re-inverts fully through ``neumann_inv`` on the first
step and whenever the lagged drift exceeds ``--smw-drift-budget``.

Every step runs inside ``runtime.TrainLoop``: a checkpoint every
``--ckpt-every`` steps when ``--ckpt-dir`` is given, a step watchdog,
and recovery from the last checkpoint with an exactly-once replay of the
data (drill it with ``--inject-failure-at N``). ``--obs``/``--obs-dir``
turn on the telemetry spine (``repro_torch.obs``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable

import torch

from repro_torch import obs as obs_mod
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import kfac, quantize
from repro_torch.core.kfac import KFACConfig
from repro_torch.data.pipeline import (DataCursor, SyntheticTokens,
                                       batch_shard, make_global_batch)
from repro_torch.dist import sharding
from repro_torch.dist.api import (DATA, MODEL, MULTI_GPU_ITEM, STAGE,
                                  axis_sizes, mesh_group, mesh_ndev,
                                  side_lane)
from repro_torch.kernels import ops
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.steps import TrainState
from repro_torch.pipeline import kfac_glue
from repro_torch.runtime import DeviceLoss, LoopConfig, TrainLoop
from repro_torch.runtime.elastic import in_mesh
from repro_torch.solve.async_refresh import (AsyncInverseRefresher,
                                             SMWRefresher)
from repro_torch.solve.smw import SMWConfig


def fp32_matmuls() -> None:
    """The reference computes its fp32 products in full fp32: keep TF32
    off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"--device cpu to run on the CPU")
    return dev


def _phase_timer(device: torch.device, obs, phase_s: dict,
                 async_inv: bool = False) -> Callable:
    """``timed(name, fn)``: run ``fn`` as one phase of a step. Its wall
    seconds, between a device synchronise before and one after (so they
    are device times too, and a phase nested in another times its own
    work only), go into ``phase_s[name]``; with obs on, also a
    ``phase:<name>`` span and a ``train_phase_s`` sample.

    With ``async_inv`` the fences wait for the current stream only, not
    for the refresh on its side stream, and the ``inv`` phase is timed
    as dispatch (no fence): fencing it would serialise the overlap it
    exists for, as the reference's dispatch-timed phases say."""
    hist = obs.histogram(
        "train_phase_s",
        "per-phase wall, fenced (stats/inv/smw/train, and wu in train)") \
        if obs.enabled else None

    def sync():
        if device.type != "cuda":
            return
        if async_inv:
            torch.cuda.current_stream(device).synchronize()
        else:
            torch.cuda.synchronize(device)

    def timed(name, fn):
        fenced = not (async_inv and name == "inv")
        if fenced:
            sync()
        t0 = time.perf_counter()
        with obs.span(f"phase:{name}",
                      cat="compute" if fenced else "dispatch"):
            out = fn()
            if fenced:
                sync()
        dt = time.perf_counter() - t0
        phase_s[name] = dt
        if hist is not None:
            hist.observe(dt, phase=name)
        return out

    return timed


@dataclasses.dataclass
class KFACProgram:
    """K-FAC program: INV through ``neumann_inv`` and the WU on
    :attr:`wu_route` (the kernels' plain versions when ``device`` is the
    CPU).

    ``fused_wu``: the pooled WU plan (default); ``False`` runs the
    per-leaf einsums. With the plan, ``kcfg.precision`` chooses the
    route: the ``fused_precond`` kernel at fp32 and hilo, the pooled
    ``lowp_einsum`` at the integer-sliced precisions, which the kernel
    cannot compute.

    ``smw``: incremental SOI. The stats/inv cadences are replaced by one
    rank-k program per step (``steps.make_smw_step``, its Woodbury
    update through the ``smw_update`` kernel) gated by
    :class:`SMWRefresher`, which re-inverts fully on the first step and
    whenever the lagged drift exceeds ``smw_drift_budget``;
    ``smw_rank`` caps the columns per update.

    ``async_inv``: the staleness-tolerant double-buffered refresh
    (:class:`AsyncInverseRefresher`): at each inv trigger step N swaps in
    the inverses of the factors as of step N - ``inv_every`` and
    dispatches the next refresh, which on the card runs on a side stream
    beside the following steps. Excludes ``smw``.

    ``dist_inv``: the refresh through the block-parallel solver
    (``steps.make_inv_refresh(distributed=True)``); on one device that is
    the replicated refresh, as in the reference.

    ``mesh``: a ``(data, model)`` DeviceMesh (``launch.mesh``), every
    rank running this program on its own ``device``: each step's batch
    is this rank's rows of the global batch (``data.make_global_batch``),
    the SU subsample the global rows ``[:stats_batch]`` this rank holds,
    and the loss, gradients and Grams are reduced over the ranks of the
    data axis (``launch.steps``); with ``dist_inv`` each rank inverts its
    share of the blocks. A model axis of several ranks adds tensor
    parallelism (:attr:`shards`, ``dist.sharding.ModelShards``): the
    state holds this rank's slices (the params made whole from the seed
    and sliced), the model reduces through its seams, and
    :meth:`full_state`/:meth:`local_state` carry a state to and from
    the full model's, the layout of a checkpoint; the moe family's
    experts are sliced over the model ranks (expert parallelism). With
    ``smw`` each rank updates its blocks from the global subsample's
    columns (``steps.make_smw_step``), and the drift is reduced over the
    mesh; with ``async_inv`` the refresh's collectives run on the side
    lane's groups (``dist.api.side_lane``). :meth:`remesh`
    rebuilds the program on a re-formed mesh (``runtime.elastic``).

    ``pp`` > 1 (a ``(stage, data, model)`` ``mesh`` of ``pp`` stages,
    ``launch.mesh.make_pipeline_mesh``): pipeline parallelism. The
    free partition cuts the layer stack into ``pp`` stages and
    :attr:`shards` is this rank's ``dist.sharding.StageShards`` (with
    the model slices inside the stage): the state holds the stage's
    leaves, each train step streams ``n_micro = max(train_accum, pp)``
    microbatches of this rank's rows through ``pp_schedule``
    (``steps.make_pipeline_step``), the statistics pass goes through the
    stages, and with ``dist_inv`` each stage's ``(data, model)`` ranks
    invert its blocks between them. With ``async_inv`` each refresh is
    dispatched just before the pipeline step
    (``pipeline.kfac_glue.bubble_refresh``), whose ``pp_bubble_ticks``
    and ``pp_bubble_fraction`` join the metrics; with ``smw`` the columns
    come from the statistics pass through the stages.

    ``obs``: phase spans and the ``train_phase_s`` histogram."""

    cfg: Any
    kcfg: KFACConfig
    seed: int = 0
    device: str = "cuda"
    smw: bool = False
    smw_drift_budget: float = 0.05
    smw_rank: int = 64
    fused_wu: bool = True
    async_inv: bool = False
    dist_inv: bool = False
    obs: Any = None
    mesh: Any = None
    pp: int = 1
    pp_schedule: str = "1f1b"

    def __post_init__(self):
        if self.smw and self.async_inv:
            raise ValueError(
                "--smw refreshes the inverses inside every step; there "
                "is no inv cadence left for --async-inv to overlap")
        #: this rank's layout: tensor parallelism's ModelShards, pipeline
        #: parallelism's StageShards (None without either)
        self.shards = None
        self.data_mesh = self.mesh
        if self.pp > 1 and self.mesh is None:
            raise ValueError("pp > 1 needs a mesh with a 'stage' axis "
                             "(launch.mesh.make_pipeline_mesh)")
        if self.mesh is not None:
            sizes = axis_sizes(self.mesh)
            mp = sizes.get(MODEL, 1)
            pp = sizes.get(STAGE, 1)
            if pp != self.pp:
                raise ValueError(f"pp={self.pp} but the mesh has {pp} "
                                 f"stages")
            if batch_shard(self.mesh)[1] * mp * pp != mesh_ndev(self.mesh) \
                    or ((mp > 1 or pp > 1)
                        and not set(sizes) <= {STAGE, DATA, MODEL}):
                raise NotImplementedError(
                    f"a mesh {sizes} with axes other than stage, data and "
                    f"model holding several ranks: only pipeline, data "
                    f"and tensor parallelism are ported ({MULTI_GPU_ITEM})")
            if pp > 1:
                self.shards = steps_mod.pipeline_shards(
                    self.cfg, self.mesh, pp, self.kcfg.block_size)
            else:
                shapes = steps_mod.init_params(self.cfg, generator=None,
                                               device="meta")
                self.shards = sharding.model_shards(
                    self.cfg, self.mesh, shapes, self.kcfg.block_size)
            if self.shards is not None:
                # the gradients and Grams reduce over the ranks holding
                # the same slices; one such rank reduces nothing
                self.data_mesh = (self.mesh[DATA] if sizes[DATA] > 1
                                  else None)
        self.device = resolve_device(str(self.device))
        if self.obs is None:
            self.obs = obs_mod.NULL
        quantize.precision_kind(self.kcfg.precision)   # raises if unknown
        fp32_matmuls()
        self._smw = None
        self._refresher = None

    @property
    def wu_route(self) -> str:
        """``"fused_precond"`` (the kernel), ``"einsum"`` (pooled
        ``lowp_einsum``) or ``"per_leaf"``."""
        if not self.fused_wu:
            return "per_leaf"
        kind = quantize.precision_kind(self.kcfg.precision)
        return "fused_precond" if kind in ("fp32", "hilo") else "einsum"

    @property
    def model_parallel(self) -> int:
        """The model axis's rank count (1 without tensor parallelism)."""
        return 1 if self.shards is None else self.shards.mp

    def remesh(self, mesh) -> "KFACProgram":
        """This program rebuilt on a re-formed ``mesh`` (a recovery's,
        ``runtime.elastic``): this rank's layout, groups and step
        functions anew; the state comes from the checkpoint."""
        return dataclasses.replace(self, mesh=mesh)

    def init_state(self) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = steps_mod.init_params(self.cfg, generator=gen,
                                       device=self.device)
        if self.shards is not None:
            params = steps_mod.local_params(params, self.shards)
        return TrainState(params, kfac.init(
            params, steps_mod.kfac_specs(self.cfg, self.shards), self.kcfg))

    def full_state(self, state: TrainState) -> TrainState:
        """The full model's state from every rank's parts (every rank
        calls; the state itself without tensor or pipeline parallelism):
        what a checkpoint holds, whatever the mesh."""
        like = (steps_mod.state_like(self.cfg, self.kcfg) if self.pp > 1
                else None)
        return steps_mod.full_state(state, self.shards, like)

    def local_state(self, state: TrainState) -> TrainState:
        """A full state (a restored checkpoint) cut to this rank's
        parts."""
        return steps_mod.local_state(state, self.shards)

    def make_step(self, state: TrainState):
        """``step_fn(state, batch) -> (state, metrics)``; metrics carry
        the loss and ``phase_s``, each phase's fenced wall seconds:
        ``stats``, ``inv`` and ``train``, or with ``smw`` ``smw``,
        ``inv`` (on a fallback) and ``train``; ``wu``, the WU inside
        ``train``, in both. With ``async_inv``, ``inv`` is the dispatch
        of the refresh."""
        kcfg = self.kcfg
        phase_s: dict = {}
        timed = _phase_timer(self.device, self.obs, phase_s,
                             async_inv=self.async_inv)
        shards = self.shards
        wu_plan = (steps_mod.make_wu_plan_for(self.cfg, state,
                                              shards=shards)
                   if self.fused_wu else None)
        mesh = self.mesh
        use_kernel = self.wu_route == "fused_precond"
        if self.pp > 1:
            train = steps_mod.make_pipeline_step(
                self.cfg, kcfg, mesh=mesh, pp=self.pp,
                schedule=self.pp_schedule, wu_plan=wu_plan,
                use_kernel=use_kernel, timer=timed, shards=shards)
            # each stage inverts its own blocks over its (data, model)
            # ranks
            refresh = steps_mod.make_inv_refresh(
                self.cfg, kcfg, mesh=mesh[DATA, MODEL],
                distributed=self.dist_inv, shards=shards.model)
        else:
            train = steps_mod.make_train_step(
                self.cfg, kcfg, wu_plan=wu_plan, use_kernel=use_kernel,
                timer=timed, data_mesh=self.data_mesh, shards=shards)
            refresh = steps_mod.make_inv_refresh(
                self.cfg, kcfg, mesh=mesh, distributed=self.dist_inv,
                shards=shards)
        #: the train step function (under ``pp``, its ``grads_fn`` is the
        #: executor, whose ``peak_stash`` a caller may read)
        self.train_fn = train
        stats = steps_mod.make_stats_step(self.cfg, kcfg,
                                          data_mesh=self.data_mesh,
                                          shards=shards)
        shard, n_shards = batch_shard(mesh) if mesh is not None else (0, 1)

        self._refresher = None
        if self.async_inv:
            # the spare seeds the double buffer: the first dispatch (step
            # 0, inside the watchdog's warm-up) already writes into
            # buffers it is given, as every later one does
            spare = {n: {k: torch.zeros_like(t) for k, t in d.items()}
                     for n, d in state.kfac.inverses.items()}

            def refresh_into(factors, buf):
                # on a mesh the refresh's collectives run on groups of
                # their own, beside the step's on the main stream
                with side_lane():
                    return refresh(factors, out=buf)

            self._refresher = AsyncInverseRefresher(
                refresh_into=refresh_into, spare_buffers=spare,
                obs=self.obs)
        refresher = self._refresher
        sched = getattr(train, "schedule", None)

        self._smw = None
        if self.smw:
            scfg = SMWConfig(drift_budget=self.smw_drift_budget,
                             rank=self.smw_rank, use_kernel=True)
            smw_step = steps_mod.make_smw_step(
                self.cfg, kcfg, scfg, data_mesh=self.data_mesh,
                shards=shards, mesh=mesh)
            self._smw = SMWRefresher(
                lambda st, b: timed("smw", lambda: smw_step(st, *b)),
                lambda factors: timed("inv", lambda: refresh(factors)),
                drift_budget=self.smw_drift_budget, obs=self.obs)
        smw_ref = self._smw

        def subsample(batch):
            # the SU's sequences and tokens, and the VLM's image rows,
            # whisper's frames (all of them) and M-RoPE positions with
            # them: the global batch's rows [:stats_batch], of which a
            # rank holds those in its own rows; with the share of the
            # subsample's rows they are, and the subsample's rows
            b = batch["tokens"].shape[0]
            lo = shard * b
            total = min(b * n_shards, kcfg.stats_batch)
            sb = max(min(b, total - lo), 0)
            ss = min(batch["tokens"].shape[1], kcfg.stats_seq)
            out = {"tokens": batch["tokens"][:sb, :ss]}
            for k in ("img_embeds", "enc_embeds"):
                if k in batch:
                    out[k] = batch[k][:sb]
            if "positions" in batch:
                out["positions"] = batch["positions"][:, :sb, :ss]
            return out, sb / total, total

        def step_fn(state: TrainState, batch):
            i = state.kfac.step
            phase_s.clear()
            metrics: dict = {}
            if smw_ref is not None:
                state, m = smw_ref.step(state, subsample(batch))
                metrics.update(m)
            else:
                if i % kcfg.stats_every == 0:
                    state, m = timed("stats", lambda: stats(
                        state, *subsample(batch)))
                    metrics.update(m)
                if i % kcfg.inv_every == 0 and sched is not None \
                        and refresher is not None:
                    # pipelined: dispatched just before the pipeline step,
                    # so that the refresh runs beside its bubbles
                    kst, info = timed("inv", lambda: kfac_glue.bubble_refresh(
                        refresher, state.kfac, sched))
                    state = dataclasses.replace(state, kfac=kst)
                    metrics.update(info)
                elif i % kcfg.inv_every == 0 and refresher is not None:
                    state = dataclasses.replace(state, kfac=timed(
                        "inv", lambda: refresher.step(state.kfac)))
                elif i % kcfg.inv_every == 0:
                    kst = state.kfac
                    inv = timed("inv", lambda: refresh(kst.factors))
                    state = dataclasses.replace(
                        state, kfac=dataclasses.replace(kst, inverses=inv))
            state, m = timed("train", lambda: train(state, batch))
            metrics.update(m)
            metrics["phase_s"] = dict(phase_s)
            return state, metrics

        return step_fn

    @property
    def refresher(self):
        """The :class:`AsyncInverseRefresher` of the last
        :meth:`make_step` (``async_inv``), else None."""
        return self._refresher

    # -- lifecycle hooks of runtime.TrainLoop --------------------------------

    def flush_async(self, state: TrainState) -> TrainState:
        """The state to checkpoint: with ``async_inv`` the in-flight
        refresh folded in (``peek``: the live refresher keeps its swap,
        so the checkpoint cadence never changes the trajectory), else
        the state itself."""
        if self._refresher is None:
            return state
        return dataclasses.replace(state,
                                   kfac=self._refresher.peek(state.kfac))

    def reset_async(self) -> None:
        """Recovery hook: drop the in-flight refresh (the restored
        factors are not what it inverts), and force the SMW gate's next
        step to fall back (a restored inverse tree is un-probed)."""
        if self._refresher is not None:
            self._refresher.reset()
        if self._smw is not None:
            self._smw.reset()


@dataclasses.dataclass
class SGDProgram:
    """First-order baseline (the paper's GPU-1st / PipeLayer side):
    heavy-ball SGD on the whole model, state ``(params, momentum)``,
    the same initial weights as :class:`KFACProgram` for a seed. Its
    ``phase_s`` has the one phase ``train``.

    ``mesh``: a ``(data, model)`` DeviceMesh, as :class:`KFACProgram`'s:
    each rank takes its rows of the global batch and the gradients are
    reduced over the data ranks; a model axis of several ranks slices
    the model megatron-style (:attr:`shards`, at the slicing rule's
    divisibility alone: the baseline has no K-FAC blocks to keep
    whole), with :meth:`full_state`/:meth:`local_state` for
    checkpoints. The baseline never pipelines (a ``stage`` axis of
    several ranks raises, as the reference's CLI refuses ``--pp``)."""

    cfg: Any
    lr: float = 1e-2
    seed: int = 0
    device: str = "cuda"
    obs: Any = None
    mesh: Any = None

    def __post_init__(self):
        self.device = resolve_device(str(self.device))
        if self.obs is None:
            self.obs = obs_mod.NULL
        fp32_matmuls()
        #: this rank's model slices (None without tensor parallelism)
        self.shards = None
        self.data_mesh = self.mesh
        if self.mesh is not None:
            sizes = axis_sizes(self.mesh)
            if sizes.get(STAGE, 1) > 1:
                raise SystemExit("--pp > 1 is a KFACProgram feature; the "
                                 "SGD baseline runs monolithic")
            if not set(sizes) <= {DATA, MODEL}:
                raise NotImplementedError(
                    f"a mesh {sizes} with axes other than data and model: "
                    f"only data and tensor parallelism are ported for the "
                    f"SGD baseline ({MULTI_GPU_ITEM})")
            shapes = steps_mod.init_params(self.cfg, generator=None,
                                           device="meta")
            self.shards = sharding.model_shards(self.cfg, self.mesh, shapes,
                                                block_size=1)
            if self.shards is not None:
                self.data_mesh = (self.mesh[DATA] if sizes[DATA] > 1
                                  else None)

    @property
    def model_parallel(self) -> int:
        return 1 if self.shards is None else self.shards.mp

    def remesh(self, mesh) -> "SGDProgram":
        """This program rebuilt on a re-formed ``mesh``."""
        return dataclasses.replace(self, mesh=mesh)

    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = steps_mod.init_params(self.cfg, generator=gen,
                                       device=self.device)
        if self.shards is not None:
            params = sharding.local_params(params, self.shards)
        return params, {k: torch.zeros_like(p) for k, p in params.items()}

    def full_state(self, state):
        """The full model's ``(params, momentum)`` (every rank calls)."""
        if self.shards is None:
            return state
        return tuple(sharding.full_params(t, self.shards) for t in state)

    def local_state(self, state):
        """A full state cut to this rank's slices."""
        if self.shards is None:
            return state
        return tuple(sharding.local_params(t, self.shards) for t in state)

    def make_step(self, state):
        del state
        phase_s: dict = {}
        timed = _phase_timer(self.device, self.obs, phase_s)
        sgd = steps_mod.make_sgd_step(self.cfg, self.lr,
                                      data_mesh=self.data_mesh,
                                      shards=self.shards)

        def step_fn(state, batch):
            phase_s.clear()
            state, metrics = timed("train", lambda: sgd(state, batch))
            metrics["phase_s"] = dict(phase_s)
            return state, metrics

        return step_fn


def run(program: KFACProgram | SGDProgram, ds: SyntheticTokens,
        n_steps: int,
        on_step: Callable[[TrainState, dict], None] | None = None):
    """The plain driver, without ``runtime.TrainLoop``'s checkpoints,
    watchdog and recovery: init the state and take ``n_steps`` steps on
    ``ds`` (on a program's ``mesh``, this rank's rows of each batch) with
    a :class:`KFACProgram` or an :class:`SGDProgram`; returns
    the final state and one history record per step (loss, per-phase
    seconds, K-FAC's grad norm, and on the SMW path the drift and
    fallback flag). ``on_step(state, record)`` is called after each
    step."""
    state = program.init_state()
    step_fn = program.make_step(state)
    cursor = DataCursor()
    history = []
    mesh = getattr(program, "mesh", None)
    for _ in range(n_steps):
        batch = (ds.batch(cursor, device=program.device) if mesh is None
                 else make_global_batch(ds, cursor, mesh,
                                        device=program.device))
        state, m = step_fn(state, batch)
        cursor = cursor.advance()
        rec = {"step": cursor.step, "loss": float(m["loss"]),
               "phase_s": m["phase_s"]}
        if "grad_norm" in m:
            rec["grad_norm"] = float(m["grad_norm"])
            rec["nu"] = float(m["nu"])
        if "smw_drift" in m:
            rec["smw_drift"] = float(m["smw_drift"])
            rec["smw_fallback"] = m["smw_fallback"]
        history.append(rec)
        if on_step is not None:
            on_step(state, rec)
    return state, history


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    help="architecture id (configs.ARCHS); whisper-tiny "
                         "needs frame embeddings, which the synthetic "
                         "token stream does not make (as in the "
                         "reference's CLI): it trains through run()")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; raises if CUDA is asked for and "
                         "absent")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--optimizer", choices=("kfac", "sgd"),
                    default="kfac")
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--damping", type=float, default=0.03)
    ap.add_argument("--stats-every", type=int, default=10)
    ap.add_argument("--inv-every", type=int, default=10)
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--dist-inv", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="block-parallel SOI inversion through the "
                         "solver: each rank inverts its share of the "
                         "blocks; on one device the replicated refresh")
    ap.add_argument("--dist-backend", default=None,
                    help="process-group backend under torchrun "
                         "(WORLD_SIZE > 1); default nccl when each rank "
                         "has a card of its own, gloo on --device cpu "
                         "or when ranks share cards")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel ranks a model group under "
                         "torchrun: attention and MLP sliced "
                         "megatron-style, MoE experts over the ranks, "
                         "each rank's factor blocks following its slice")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel stages: the layer stack is "
                         "partitioned over a 'stage' mesh axis and "
                         "microbatches stream through a static "
                         "schedule (repro_torch.pipeline); 1 = "
                         "monolithic")
    ap.add_argument("--pp-schedule", choices=("gpipe", "1f1b"),
                    default="1f1b",
                    help="microbatch schedule: gpipe (fill then "
                         "drain) or 1f1b (same bubble, min stash)")
    ap.add_argument("--async-inv", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="staleness-tolerant double-buffered inverse "
                         "refresh on a side CUDA stream, overlapping the "
                         "train steps")
    ap.add_argument("--fused-wu", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="pooled WU plan: one batched two-sided product "
                         "per block pool (the fused_precond kernel at "
                         "fp32/hilo); --no-fused-wu runs per-leaf "
                         "einsums")
    ap.add_argument("--smw", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="incremental SOI: rank-k SMW inverse update "
                         "every step (no stats/inv cadence), with a "
                         "drift-gated full re-inversion fallback")
    ap.add_argument("--smw-drift-budget", type=float, default=0.05,
                    help="probe-residual level that triggers the full "
                         "re-inversion on the SMW path")
    ap.add_argument("--smw-rank", type=int, default=64,
                    help="max rank per SMW update; larger token sets are "
                         "strided down to this many columns")
    ap.add_argument("--precision", default="fp32",
                    choices=quantize.PRECISIONS,
                    help="WU product precision: fp32; hilo = bf16 limb "
                         "products; int8 = exact bit-sliced integer "
                         "products (24-bit codes in 8-bit slices), on "
                         "the pooled einsum route")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; a run resumes from the "
                         "latest checkpoint in it. None (the default) "
                         "writes no checkpoints, and a recovery restarts "
                         "from the initial state")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="fault drill: raise DeviceLoss at this step")
    ap.add_argument("--inject-lost", type=int, default=0,
                    help="the drill's lost ranks: under torchrun the "
                         "survivors re-form the largest mesh without "
                         "that many ranks from the tail of the world "
                         "(runtime.elastic); 0 restores on the same mesh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the run summary JSON (with the per-step "
                         "history) here")
    ap.add_argument("--obs", action="store_true",
                    help="enable the telemetry spine: phase spans, "
                         "step metrics, recovery/straggler events")
    ap.add_argument("--obs-dir", default=None,
                    help="write JSONL events + Prometheus snapshot + "
                         "Chrome trace here (implies --obs)")
    ap.add_argument("--obs-annotate", action="store_true",
                    help="also enter torch.profiler.record_function for "
                         "every span")
    args = ap.parse_args(argv)

    if args.pp > 1 and args.optimizer != "kfac":
        raise SystemExit("--pp > 1 is a KFACProgram feature; the "
                         "SGD baseline runs monolithic")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    group = args.pp * args.model_parallel
    if world < group:
        flags = [f"{f} {n}" for f, n in (("--pp", args.pp),
                                          ("--model-parallel",
                                           args.model_parallel)) if n > 1]
        raise ValueError(f"{' x '.join(flags)} needs at least {group} "
                         f"ranks (torchrun), not {world}")
    # the telemetry spine on rank 0 only (the ranks' steps are the same)
    rank0 = int(os.environ.get("RANK", "0")) == 0
    obs = obs_mod.from_args(args) if rank0 else obs_mod.NULL
    mesh = None
    if world > 1:
        mesh, device = init_ranks(args.device, args.dist_backend,
                                  model=args.model_parallel, pp=args.pp,
                                  obs=obs)
    else:
        device = resolve_device(args.device)
    try:
        if mesh is not None and not in_mesh(mesh):
            # a world that is not a multiple of the model x stage group
            # trains on its largest mesh; the ranks left over leave
            shape = dict(zip(mesh.mesh_dim_names,
                             (int(n) for n in mesh.mesh.shape)))
            print(f"rank {torch.distributed.get_rank()} of {world}: outside "
                  f"the largest mesh {shape}; exiting", flush=True)
            return {"excluded": True, "mesh": shape}
        return _main(args, device, mesh, obs)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def params_digest(params) -> str:
    """sha256 of the params' bytes in tree order: equal digests are
    bitwise-equal params (ranks kept in step)."""
    import hashlib

    h = hashlib.sha256()
    for k in kfac.tree_order(params):
        h.update(params[k].detach().cpu().contiguous().view(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def init_ranks(device: str, backend: str | None = None, model: int = 1,
               pp: int = 1, obs=None):
    """Under torchrun: the process group (``backend``, default
    ``dist.spawn.backend_for``'s: NCCL when every rank has a card of its
    own, gloo on the CPU or when ranks share cards) from the environment
    torchrun sets, this rank's device (``cuda:{LOCAL_RANK % cards}``) and
    the largest ``(data, model)`` dev mesh over the world, ``model`` ranks
    a model group, or with ``pp`` > 1 the ``(stage, data, model)``
    pipeline mesh (``obs`` records it): ``(mesh, device)``. A rank the
    mesh leaves out gets no coordinate."""
    import torch.distributed as dist

    from repro_torch.dist.spawn import backend_for, rank_device
    from repro_torch.launch.mesh import make_dev_mesh, make_pipeline_mesh

    dev = resolve_device(device)
    world = int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        dev = rank_device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or backend_for(dev.type, world))
    if dev.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // dist.get_world_size()))
    if pp > 1:
        return make_pipeline_mesh(pp, model, obs=obs), dev
    return make_dev_mesh(model, obs=obs), dev


def _main(args, device, mesh, obs):
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if cfg.family == "audio":
        raise ValueError(
            f"{args.arch} trains on frame embeddings (enc_embeds), which "
            f"the CLI's synthetic token stream does not make (nor does "
            f"the reference's); drive launch.train.run with a dataset "
            f"that adds them")
    kcfg = KFACConfig(
        lr=args.lr, damping=args.damping,
        stats_every=args.stats_every, inv_every=args.inv_every,
        block_size=min(args.block_size, cfg.soi_block),
        stats_batch=args.batch, stats_seq=args.seq,
        precision=args.precision)
    if args.optimizer == "kfac":
        program = KFACProgram(cfg, kcfg, seed=args.seed, device=device,
                              smw=args.smw,
                              smw_drift_budget=args.smw_drift_budget,
                              smw_rank=args.smw_rank,
                              fused_wu=args.fused_wu,
                              async_inv=args.async_inv,
                              dist_inv=args.dist_inv, obs=obs, mesh=mesh,
                              pp=args.pp, pp_schedule=args.pp_schedule)
    else:
        program = SGDProgram(cfg, lr=args.lr, seed=args.seed,
                             device=device, obs=obs, mesh=mesh)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)

    fired = []

    def inject(step):
        if step == args.inject_failure_at and not fired:
            fired.append(step)
            raise DeviceLoss(args.inject_lost, "injected failure drill")

    # On the CPU the kernels' plain versions make a refresh step tens of
    # times slower than a plain one, on cores other processes share: a
    # deadline relative to the median step would trip on healthy steps.
    loop = TrainLoop(
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every,
                   model_parallel=args.model_parallel,
                   pipeline_parallel=args.pp,
                   hang_factor=10.0 if device.type == "cuda" else None),
        program, ds,
        inject=inject if args.inject_failure_at >= 0 else None, obs=obs)
    result = loop.run()
    history = result["history"]
    if result.get("excluded"):
        # left out of a mesh re-formed after a loss
        print(f"rank {torch.distributed.get_rank()}: excluded at step "
              f"{result['excluded_at_step']} by the re-formed mesh "
              f"{result['mesh']}", flush=True)
        return result
    # the full model's params (gathered over the model and stage ranks),
    # on the program of the last mesh
    program, mesh = loop.program, loop.mesh
    full = program.full_state(loop.final_state)
    digest = params_digest(full.params if args.optimizer == "kfac"
                           else full[0])
    digests = [digest]
    if mesh is not None:
        digests = [None] * mesh_ndev(mesh)
        torch.distributed.all_gather_object(digests, digest,
                                            group=mesh_group(mesh))
    summary = {
        "arch": cfg.name, "optimizer": args.optimizer,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "batch": args.batch, "seq": args.seq,
        "ranks": 1 if mesh is None else mesh_ndev(mesh),
        "pp": args.pp, "pp_schedule": args.pp_schedule,
        "block_size": kcfg.block_size, "precision": args.precision,
        **({"wu_route": program.wu_route, "smw": args.smw,
            "async_inv": args.async_inv, "dist_inv": args.dist_inv}
           if args.optimizer == "kfac" else {}),
        **({"n_dispatched": program.refresher.n_dispatched,
            "n_swapped": program.refresher.n_swapped}
           if args.optimizer == "kfac" and args.async_inv else {}),
        **{k: v for k, v in result.items() if k != "history"},
        "losses": [h["loss"] for h in history],
        "params_digest": digests,
        "kernel_launches": ops.launch_counts(),
    }
    if args.smw and args.optimizer == "kfac":
        summary["smw_drift"] = [h["smw_drift"] for h in history]
        summary["smw_fallback"] = [h["smw_fallback"] for h in history]
    summary["history"] = history
    if not rank0:
        return summary
    print(json.dumps({k: v for k, v in summary.items() if k != "history"},
                     indent=1))
    if summary["losses"]:
        print(f"loss: first={summary['losses'][0]:.4f} "
              f"last={summary['losses'][-1]:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    if obs.enabled:
        paths = obs.flush(summary={
            "kind": "train_summary",
            **{k: v for k, v in summary.items() if k != "history"}})
        print(obs.console("train summary"))
        if paths:
            print(json.dumps({"obs_artifacts": paths}, indent=1))
        obs.close()
    return summary


if __name__ == "__main__":
    main()
