"""Fault-tolerant training loop: checkpoint/restart and a step watchdog
(counterpart of ``repro.runtime.loop``).

The loop owns generic train *state* (a tree of tensors, see
``checkpoint.store``) and a *program*:

    program.device                      -> where the state and batches live
    program.init_state()                -> state
    program.make_step(state)            -> step_fn(state, batch) -> (state, metrics)

Recovery policy:

* every ``ckpt_every`` steps (and after the last) the state is
  snapshotted to the host and written asynchronously (atomic on disk;
  the data cursor rides in the manifest); ``ckpt_dir=None`` writes
  none;
* a failed step of a recoverable kind (:func:`_recoverable`) triggers:
  1. the buffered metrics of the steps that completed are read into
     the history (no recoverable failure leaves the card unreadable),
  2. the program's ``reset_async`` hook, if any,
  3. a restore of the last checkpoint onto the program's device (or a
     fresh init when there is none),
  4. a replay of the data stream from the restored cursor
     (deterministic pipeline => exactly-once optimizer updates);
* after ``max_failures`` consecutive failures the loop re-raises.

On a program with a ``mesh`` each rank's batch is its rows of the global
batch (``data.make_global_batch``); the mesh's first rank alone writes
the checkpoints, and a recovery waits for its writes, then a barrier
over the mesh, then every rank restores the same files, so that every
rank resumes alike.
Under tensor or pipeline parallelism a checkpoint holds the full model's
state: at each save every rank takes part in the program's
``full_state`` (the slices gathered over the model ranks, the stages'
parts over the stage ranks), and a restore is cut back to the rank's
parts by its ``local_state``, so a checkpoint does not depend on the
mesh. ``LoopConfig.model_parallel`` and ``pipeline_parallel`` must match
the program's model and stage axes, as the reference's loop builds its
mesh from them. The ranks agree on failure twice a step, where none has
a collective in flight: after the ``inject`` hook and after the step's
watchdog (:meth:`TrainLoop._agree`). A recoverable failure on any rank
there is a recovery on every rank. One raised inside a rank's step, in
the middle of its collectives, is not recoverable in the process (its
peers wait in the step's reductions) and re-raises as a
``RuntimeError``; a restart of the group under ``torchrun
--max-restarts`` recovers it from the last checkpoint.

Elastic re-meshing (the reference's): the ranks also agree on the
failure's ``lost`` count (a ``DeviceLoss``'s, MAX-reduced with the
flag). When it is not 0, ``exclude += lost`` and every rank calls
``mesh_fn(exclude=exclude)`` (default ``runtime.elastic.elastic_mesh``
at the config's model and stage degrees), which re-forms the largest
mesh over the surviving ranks. A rank left out leaves :meth:`run` with
a summary saying so (``excluded``, the step, the new shape). Every other
rank rebuilds the program on the new mesh (its ``remesh(mesh)`` hook)
and restores the last checkpoint, which its ``local_state`` cuts to the
rank's new layout: a rank's place, and under pipeline parallelism its
stage, may change, so nothing of the old layout's state is carried
over. Re-forming a mesh needs every rank of the world (``DeviceMesh``
makes its groups on each): once ranks have left, a further loss raises
``DeviceLoss``.

Every other exception re-raises at once, a kernel's launch or build
error included: a CUDA error that poisons the context cannot be
recovered in the process, and retrying a faulty kernel would only hide
it.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional, Protocol, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.data import DataCursor, SyntheticTokens, make_global_batch
from repro_torch.dist.api import all_reduce, mesh_ndev, mesh_ranks
from repro_torch.obs import NULL as NULL_OBS, Observability, TapBuffer
from repro_torch.obs.trace import wait_for
from repro_torch.runtime.elastic import DeviceLoss, elastic_mesh, in_mesh
from repro_torch.runtime.watchdog import StepDeadlineExceeded, StepWatchdog

log = logging.getLogger("repro_torch.runtime")


class Program(Protocol):
    """Optional hooks (duck-typed, used when present): ``flush_async
    (state) -> state`` folds in-flight background work into the state
    before a checkpoint; ``reset_async()`` drops it on recovery; a true
    ``async_inv`` says that work runs on a side stream, so the step
    fence waits for the current stream only; ``full_state(state)`` and
    ``local_state(state)`` carry a state to and from the layout a
    checkpoint holds; ``model_parallel`` and ``pp`` are the model and
    stage axes' rank counts; ``remesh(mesh)`` returns the program
    rebuilt on a re-formed mesh."""

    device: Any

    def init_state(self) -> Any: ...

    def make_step(self, state) -> Callable: ...


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    max_failures: int = 3
    model_parallel: int = 1
    # pipeline (stage) degree: must match the program's stage axis, as
    # model_parallel its model axis; both are kept across re-meshes
    pipeline_parallel: int = 1
    log_every: int = 10
    straggler_factor: float = 2.0
    # the step deadline is hang_factor x the median healthy step (after
    # the watchdog's warmup; None: no such deadline), or hard_deadline_s
    # if that is shorter
    hang_factor: Optional[float] = 10.0
    hard_deadline_s: Optional[float] = None


class TrainLoop:
    def __init__(
        self,
        cfg: LoopConfig,
        program: Program,
        dataset: SyntheticTokens,
        *,
        inject: Optional[Callable[[int], None]] = None,
        obs: Optional[Observability] = None,
        mesh_fn: Optional[Callable[..., Any]] = None,
    ):
        """``inject(step)`` is the fault-drill hook: tests and the CLI's
        ``--inject-failure-at`` raise DeviceLoss/StepDeadlineExceeded
        from it to exercise recovery. ``mesh_fn(exclude=)`` re-forms the
        mesh after a loss (every rank calls it; default
        ``elastic_mesh`` at the config's degrees, on the program's mesh's
        device type)."""
        self.cfg = cfg
        self.program = program
        self.dataset = dataset
        self.device = torch.device(program.device)
        self.obs = obs if obs is not None else NULL_OBS
        self.inject = inject
        self.mesh = getattr(program, "mesh", None)
        if mesh_fn is None and self.mesh is not None:
            device_type = self.mesh.device_type

            def mesh_fn(exclude=0):
                return elastic_mesh(cfg.model_parallel,
                                    pp=cfg.pipeline_parallel,
                                    exclude=exclude, obs=self.obs,
                                    device_type=device_type)
        self.mesh_fn = mesh_fn
        #: ranks dropped from the tail of the world by re-meshes, and the
        #: last re-formed mesh's shape
        self.exclude = 0
        self._remeshed = None
        self._check_program()
        self.ckpt = self._checkpointer()
        #: the state after the last step of :meth:`run`
        self.final_state = None
        self.watchdog = StepWatchdog(
            straggler_factor=cfg.straggler_factor,
            hang_factor=cfg.hang_factor,
            hard_deadline_s=cfg.hard_deadline_s,
            obs=self.obs)
        self.metrics_history: list = []
        self.n_recoveries = 0
        # device metrics buffered per step, drained in one batched
        # transfer per log_every window (repro_torch.obs.taps)
        self._taps = TapBuffer()
        if self.obs.enabled:
            self._c_steps = self.obs.counter(
                "train_steps_total", "completed train steps")
            self._c_recov = self.obs.counter(
                "train_recoveries_total", "checkpoint-restores")
            self._c_ckpt = self.obs.counter(
                "train_checkpoints_total", "async checkpoint snapshots")

    def _check_program(self):
        cfg, program = self.cfg, self.program
        mp = getattr(program, "model_parallel", 1)
        if mp != cfg.model_parallel:
            raise ValueError(
                f"LoopConfig.model_parallel={cfg.model_parallel} but the "
                f"program's mesh has {mp} model ranks")
        pp = getattr(program, "pp", 1)
        if pp != cfg.pipeline_parallel:
            raise ValueError(
                f"LoopConfig.pipeline_parallel={cfg.pipeline_parallel} but "
                f"the program's mesh has {pp} stages")

    def _checkpointer(self):
        """The checkpoint writer on the mesh's first rank (every rank
        without a mesh), else None."""
        writer = self.mesh is None \
            or torch.distributed.get_rank() == mesh_ranks(self.mesh)[0]
        return (CheckpointManager(self.cfg.ckpt_dir, keep=self.cfg.keep)
                if self.cfg.ckpt_dir is not None and writer else None)

    def _drain_taps(self):
        """One batched transfer for every buffered step; record ALL of
        them in the history. Returns the last drained row, or None."""
        last = None
        for tag, m in self._taps.drain():
            row = {"step": tag, **m}
            self.metrics_history.append(row)
            last = row
            if self.obs.enabled:
                self.obs.write({"kind": "train_step", **row})
                for k, v in m.items():
                    if isinstance(v, float):
                        self.obs.gauge(f"train_{k}").set(v)
        return last

    # -- lifecycle ---------------------------------------------------------

    def _restore(self):
        like = self.program.init_state()      # structure donor
        with self.obs.span("ckpt_restore", fence=self._fence_target()):
            state, manifest = restore(self.cfg.ckpt_dir, like)
            local = getattr(self.program, "local_state", None)
            if local is not None:
                state = local(state)
        cursor = DataCursor.from_json(manifest["meta"]["cursor"])
        log.info("restored step %d onto %s", manifest["step"], self.device)
        return state, cursor

    def _start(self):
        if self.cfg.ckpt_dir is not None \
                and latest_step(self.cfg.ckpt_dir) is not None:
            state, cursor = self._restore()
        else:
            state, cursor = self.program.init_state(), DataCursor(0)
        return state, cursor, self.program.make_step(state)

    def _fence_target(self):
        """What a step waits for: the device, or with a program that
        overlaps a side stream (``async_inv``) the current stream only,
        as the reference's step fence blocks on the train state, never
        on the independent refresh."""
        if self.device.type == "cuda" \
                and getattr(self.program, "async_inv", False):
            return torch.cuda.current_stream(self.device)
        return self.device

    def _fence(self):
        wait_for(self._fence_target())

    def _body(self, step_fn, state, batch):
        """One step, fenced. Under a mesh a recoverable failure raised
        here, amid the step's collectives, re-raises as a RuntimeError:
        the other ranks cannot meet this rank at :meth:`_agree`."""
        try:
            out = step_fn(state, batch)
            self._fence()
            return out
        except Exception as e:  # noqa: BLE001
            if self.mesh is not None and _recoverable(e):
                raise RuntimeError(
                    f"rank {torch.distributed.get_rank()}: "
                    f"{type(e).__name__} inside a data-parallel step is not "
                    f"recoverable across ranks in the process (its peers "
                    f"wait in the step's collectives); restart the group "
                    f"under torchrun --max-restarts to resume from the "
                    f"last checkpoint") from e
            raise

    def _agree(self, failure: Optional[BaseException], step: int
               ) -> Tuple[Optional[BaseException], int]:
        """``(failure, lost)``. Under a mesh every rank's ``failure`` flag
        and its ``lost`` count (a DeviceLoss's), MAX-reduced together, so
        that a recoverable failure on one rank is a recovery on every
        rank (a rank that did not fail gets a :class:`PeerFailure`) and
        every rank excludes the same count. Called where no rank has a
        collective in flight."""
        lost = int(getattr(failure, "lost", 0) or 0)
        if self.mesh is None:
            return failure, lost
        flag = torch.tensor([int(failure is not None), lost],
                            dtype=torch.int32, device=self.device)
        all_reduce(flag, self.mesh, "max")
        failed, lost = (int(v) for v in flag.tolist())
        if failure is None and failed:
            failure = PeerFailure(f"another rank failed at step {step}")
        return failure, lost

    def _remesh(self, lost: int, step: int) -> bool:
        """Re-form the mesh without ``lost`` more ranks (every rank
        calls) and rebuild the program on it; False when this rank is
        left out."""
        world = torch.distributed.get_world_size()
        if mesh_ndev(self.mesh) < world:
            raise DeviceLoss(lost, (
                f"cannot re-form the mesh at step {step}: it needs every "
                f"rank of the world, and {world - mesh_ndev(self.mesh)} "
                f"have left; restart the group under torchrun "
                f"--max-restarts to resume from the last checkpoint"))
        remesh = getattr(self.program, "remesh", None)
        if remesh is None:
            raise DeviceLoss(lost, "the program has no remesh hook")
        self.exclude += lost
        mesh = self.mesh_fn(exclude=self.exclude)
        self._remeshed = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        if not in_mesh(mesh):
            return False
        self.program = remesh(mesh)
        self.mesh = mesh
        self._check_program()
        self.ckpt = self._checkpointer()
        log.warning("re-meshed onto %s after losing %d ranks",
                    self._remeshed, lost)
        return True

    # -- main --------------------------------------------------------------

    def _summary(self, cursor, t_start) -> Dict[str, Any]:
        out = {
            "steps": cursor.step,
            "wall_s": time.monotonic() - t_start,
            "recoveries": self.n_recoveries,
            "model_parallel": self.cfg.model_parallel,
            "pipeline_parallel": self.cfg.pipeline_parallel,
            "stragglers": self.watchdog.n_stragglers,
        }
        if self.mesh is not None:
            out["mesh"] = dict(zip(self.mesh.mesh_dim_names,
                                   (int(n) for n in self.mesh.mesh.shape)))
            out["excluded_ranks"] = self.exclude
        if self.ckpt is not None:
            out["ckpt_write_s"] = list(self.ckpt.write_s)
        out["history"] = self.metrics_history
        return out

    def run(self) -> Dict[str, Any]:
        failures = 0
        state, cursor, step_fn = self._start()
        t_start = time.monotonic()

        while cursor.step < self.cfg.total_steps:
            step = cursor.step
            failure = None
            try:
                if self.inject is not None:
                    self.inject(step)
            except Exception as e:  # noqa: BLE001
                if not _recoverable(e):
                    raise
                failure = e
            failure, lost = self._agree(failure, step)
            if failure is None:
                try:
                    batch = (self.dataset.batch(cursor, device=self.device)
                             if self.mesh is None else make_global_batch(
                                 self.dataset, cursor, self.mesh,
                                 device=self.device))
                    with self.watchdog.step(), \
                            self.obs.span("train_step", args={"step": step}):
                        state, metrics = self._body(step_fn, state, batch)
                except Exception as e:  # noqa: BLE001
                    if not _recoverable(e):
                        raise
                    failure = e
                failure, lost = self._agree(failure, step)
            if failure is not None:
                e = failure
                failures += 1
                self.n_recoveries += 1
                # the steps that completed before the failure stay in
                # the history: a recoverable failure leaves the card
                # readable (a poisoned context is not recoverable)
                self._drain_taps()
                if self.obs.enabled:
                    self._c_recov.inc()
                    self.obs.event("recovery", step=step,
                                   error=type(e).__name__, lost=lost)
                log.warning("step %d failed (%s); recovery %d/%d",
                            step, type(e).__name__, failures,
                            self.cfg.max_failures)
                if failures > self.cfg.max_failures:
                    raise e
                if self.ckpt is not None:
                    self.ckpt.wait()
                if self.mesh is not None:
                    # the writer's files are on disk before any rank
                    # reads
                    all_reduce(torch.zeros(1, device=self.device),
                               self.mesh)
                if self.cfg.ckpt_dir is None \
                        or latest_step(self.cfg.ckpt_dir) is None:
                    log.warning(
                        "recovery with no checkpoint: restarting from "
                        "fresh init, %d steps of progress replayed", step)
                reset = getattr(self.program, "reset_async", None)
                if reset is not None:
                    reset()
                # release the failed run's tensors before the restore
                # allocates the new ones
                state = step_fn = None
                if lost and self.mesh is not None \
                        and not self._remesh(lost, step):
                    log.warning("rank %d left out of the re-formed mesh %s",
                                torch.distributed.get_rank(),
                                self._remeshed)
                    return {**self._summary(cursor, t_start),
                            "excluded": True, "excluded_at_step": step,
                            "mesh": self._remeshed}
                state, cursor, step_fn = self._start()
                # fresh timing window: the first post-restore step must
                # not trip the hang deadline; the cumulative counters
                # (n_steps / n_stragglers) survive
                self.watchdog.reset_window()
                continue

            failures = 0
            cursor = cursor.advance()
            if self.obs.enabled:
                self._c_steps.inc()
            if self.watchdog.last_was_straggler:
                log.warning("straggler step %d (%d so far)", step,
                            self.watchdog.n_stragglers)
                if self.obs.enabled:
                    self.obs.event("straggler", step=step)
            # push device metrics without reading them (no sync); drain
            # the whole window in ONE transfer at the log cadence
            self._taps.push(step, metrics)
            if step % self.cfg.log_every == 0:
                last = self._drain_taps()
                if last is not None:
                    log.info("step %d %s", last["step"],
                             {k: v for k, v in last.items()
                              if k != "step"})
            if self.cfg.ckpt_dir is not None and (
                    cursor.step % self.cfg.ckpt_every == 0
                    or cursor.step == self.cfg.total_steps):
                # snapshot with in-flight background work folded in,
                # without rebinding the live state (the trajectory must
                # not depend on the checkpoint cadence); the full
                # model's state, gathered by every rank
                flush = getattr(self.program, "flush_async", None)
                save_state = flush(state) if flush is not None else state
                full = getattr(self.program, "full_state", None)
                if full is not None:
                    save_state = full(save_state)
                if self.ckpt is not None:
                    with self.obs.span("ckpt_save_dispatch",
                                       args={"step": cursor.step}):
                        self.ckpt.save_async(
                            cursor.step, save_state,
                            meta={"cursor": cursor.to_json()})
                    if self.obs.enabled:
                        self._c_ckpt.inc()
                del save_state

        self._drain_taps()   # tail of the last (partial) window
        if self.ckpt is not None:
            self.ckpt.wait()
        self.final_state = state
        return self._summary(cursor, t_start)


class PeerFailure(RuntimeError):
    """Another rank of the mesh failed this step recoverably: this rank
    recovers with it."""


def _recoverable(e: BaseException) -> bool:
    """Only known failure classes trigger checkpoint-restore: the
    repo's own fault types (a lost device, a missed step deadline) and
    the card running out of memory (the counterpart of XLA's
    ``RESOURCE_EXHAUSTED``). Everything else re-raises to the caller,
    a kernel's launch or build error (``RuntimeError`` from
    ``kernels.build.CudaLibrary``) included."""
    return isinstance(e, (DeviceLoss, StepDeadlineExceeded,
                          torch.cuda.OutOfMemoryError))
