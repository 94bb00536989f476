"""Run a function on several ranks of a fresh process group, from one
process: the port's stand-in for the reference's forced multi-device
host platform (benchmarks, tests, ``chip_smoke.py``'s ``dist`` phase).

  results = run_ranks(fn, world=2, device="cpu", args=(...))

spawns ``world`` processes (start method ``spawn``); each initialises a
process group through a ``file://`` store in a fresh temporary directory
and calls ``fn(rank, world, *args)`` (``fn`` a module-level function);
the return values come back in rank order (``start_ranks`` starts them
and returns a handle whose ``results()`` waits, so that the caller works
meanwhile). Backends: gloo on the CPU
(each rank one intra-op thread), NCCL when each rank has a card of its
own, gloo when the ranks share cards (NCCL refuses two ranks on one
device; gloo moves CUDA tensors through the host, and every kernel still
runs on the card). A rank that fails fails the call, with its traceback;
the other ranks are stopped.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch


def backend_for(device: str, world: int) -> str:
    """gloo on the CPU or when the ranks share cards, else NCCL."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def default_world(device: str, cpu_world: int) -> int:
    """The rank count of a benchmark's probe: ``cpu_world`` on the CPU,
    one rank a card when there are several, else two ranks sharing the
    one card."""
    if torch.device(device).type != "cuda":
        return cpu_world
    return max(torch.cuda.device_count(), 2)


def rank_device(device: str, rank: int) -> torch.device:
    """This rank's device: the CPU, or card ``rank % device_count``."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _entry(fn, rank, world, store, backend, device, out, args):
    import torch.distributed as dist

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device, rank))
    else:
        torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            res = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001  (reported to the parent)
        res = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(out + ".tmp", out)
    if res[0] != "ok":
        raise SystemExit(1)


def run_ranks(fn: Callable, world: int, *, device: str = "cpu",
              args: Sequence[Any] = (), timeout: float = 600.0) -> list:
    """``[fn(rank, world, *args) for each rank]``, each on its own rank of
    a ``world``-rank process group (:func:`backend_for`; see the module's
    docstring). Results are pickled: return host objects."""
    return start_ranks(fn, world, device=device, args=args,
                       timeout=timeout).results()


class Ranks:
    """Ranks started by :func:`start_ranks`, running beside the caller.
    :meth:`results` waits for them once; a later call returns the same
    list, or raises the same error."""

    def __init__(self, fn, world, device, args, timeout):
        backend = backend_for(device, world)
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        self._timeout = timeout
        self._deadline = time.monotonic() + timeout
        self._outs = [os.path.join(self._tmp, f"rank{r}.pkl")
                      for r in range(world)]
        ctx = torch.multiprocessing.get_context("spawn")
        self._procs = [ctx.Process(target=_entry, args=(
            fn, r, world, os.path.join(self._tmp, "store"), backend,
            device, self._outs[r], tuple(args))) for r in range(world)]
        self._done = None
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self._stop()
            raise

    def _stop(self):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def wait(self) -> None:
        """Wait for the ranks to end; :meth:`results` raises a failure."""
        try:
            self.results()
        except RuntimeError:
            pass

    def results(self) -> list:
        if self._done is None:
            try:
                self._done = ("ok", self._collect())
            except RuntimeError as e:
                self._done = ("error", e)
            finally:
                self._stop()
        if self._done[0] == "error":
            raise self._done[1]
        return self._done[1]

    def _collect(self) -> list:
        """Wait for the ranks (a failed rank stops the others) and read
        their results in rank order."""
        procs, outs = self._procs, self._outs
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break              # a rank failed: the others may hang
            if time.monotonic() > self._deadline:
                break
            time.sleep(0.05)
        errors = []
        for r, p in enumerate(procs):
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
            if os.path.exists(outs[r]):
                with open(outs[r], "rb") as f:
                    status, val = pickle.load(f)
                if status != "ok":
                    errors.append(f"rank {r}:\n{val}")
            else:
                errors.append(f"rank {r}: no result (exit code "
                              f"{p.exitcode}; stopped after a failure or "
                              f"the {self._timeout:.0f} s limit)")
        if errors:
            raise RuntimeError(f"{len(errors)} of {len(procs)} ranks "
                               f"failed:\n" + "\n".join(errors))
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f)[1])
        return results


def start_ranks(fn: Callable, world: int, *, device: str = "cpu",
                args: Sequence[Any] = (), timeout: float = 600.0) -> Ranks:
    """:func:`run_ranks` started without waiting: the ranks run beside
    the caller until :meth:`Ranks.results`."""
    return Ranks(fn, world, device, args, timeout)
