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
batch (``data.make_global_batch``); rank 0 alone writes the
checkpoints, and a recovery waits for its writes, then a barrier, then
every rank restores the same files, so that every rank resumes alike.
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
the middle of its collectives, is not recoverable across ranks (its
peers wait in the step's reductions) and re-raises as a
``RuntimeError``.

Every other exception re-raises at once, a kernel's launch or build
error included: a CUDA error that poisons the context cannot be
recovered in the process, and retrying a faulty kernel would only hide
it.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional, Protocol

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.data import DataCursor, SyntheticTokens, make_global_batch
from repro_torch.dist.api import all_reduce
from repro_torch.obs import NULL as NULL_OBS, Observability, TapBuffer
from repro_torch.obs.trace import wait_for
from repro_torch.runtime.elastic import DeviceLoss
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
    stage axes' rank counts."""

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
    # model_parallel its model axis (a recovery restores every rank from
    # the checkpoint onto the same mesh; re-meshing is ROADMAP Queue 1
    # item 8.3)
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
    ):
        """``inject(step)`` is the fault-drill hook: tests and the CLI's
        ``--inject-failure-at`` raise DeviceLoss/StepDeadlineExceeded
        from it to exercise recovery."""
        self.cfg = cfg
        self.program = program
        self.dataset = dataset
        self.device = torch.device(program.device)
        self.obs = obs if obs is not None else NULL_OBS
        self.inject = inject
        self.mesh = getattr(program, "mesh", None)
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
        writer = self.mesh is None or torch.distributed.get_rank() == 0
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
                     if cfg.ckpt_dir is not None and writer else None)
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
                    f"recoverable across ranks (elastic recovery: ROADMAP "
                    f"Queue 1 item 8)") from e
            raise

    def _agree(self, failure: Optional[BaseException], step: int):
        """Under a mesh: every rank's ``failure`` flag, MAX-reduced, so
        that a recoverable failure on one rank is a recovery on every
        rank (a rank that did not fail gets a :class:`PeerFailure`).
        Called where no rank has a collective in flight."""
        if self.mesh is None:
            return failure
        flag = torch.tensor([int(failure is not None)], dtype=torch.int32,
                            device=self.device)
        all_reduce(flag, self.mesh, "max")
        if failure is None and int(flag.item()):
            failure = PeerFailure(f"another rank failed at step {step}")
        return failure

    # -- main --------------------------------------------------------------

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
            failure = self._agree(failure, step)
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
                failure = self._agree(failure, step)
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
                                   error=type(e).__name__,
                                   lost=getattr(e, "lost", 0))
                log.warning("step %d failed (%s); recovery %d/%d",
                            step, type(e).__name__, failures,
                            self.cfg.max_failures)
                if failures > self.cfg.max_failures:
                    raise e
                if self.ckpt is not None:
                    self.ckpt.wait()
                if self.mesh is not None:
                    # rank 0's files are on disk before any rank reads
                    torch.distributed.barrier()
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
        return {
            "steps": cursor.step,
            "wall_s": time.monotonic() - t_start,
            "recoveries": self.n_recoveries,
            "model_parallel": self.cfg.model_parallel,
            "pipeline_parallel": self.cfg.pipeline_parallel,
            "stragglers": self.watchdog.n_stragglers,
            **({"ckpt_write_s": list(self.ckpt.write_s)}
               if self.ckpt is not None else {}),
            "history": self.metrics_history,
        }


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
