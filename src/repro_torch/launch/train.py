"""End-to-end training driver on one GPU: K-FAC (or the SGD baseline),
the fault-tolerant loop with checkpoints, and synthetic data
(counterpart of ``repro.launch.train``).

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
import time
from typing import Any, Callable

import torch

from repro_torch import obs as obs_mod
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import kfac, quantize
from repro_torch.core.kfac import KFACConfig
from repro_torch.data.pipeline import DataCursor, SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.steps import TrainState
from repro_torch.runtime import DeviceLoss, LoopConfig, TrainLoop
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
    """Single-device K-FAC program: INV through ``neumann_inv`` and the
    WU on :attr:`wu_route` (the kernels' plain versions when ``device``
    is the CPU).

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

    def __post_init__(self):
        if self.smw and self.async_inv:
            raise ValueError(
                "--smw refreshes the inverses inside every step; there "
                "is no inv cadence left for --async-inv to overlap")
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

    def init_state(self) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = steps_mod.init_params(self.cfg, generator=gen,
                                       device=self.device)
        return TrainState(params, kfac.init(
            params, steps_mod.kfac_specs(self.cfg), self.kcfg))

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
        wu_plan = (steps_mod.make_wu_plan_for(self.cfg, state)
                   if self.fused_wu else None)
        train = steps_mod.make_train_step(
            self.cfg, kcfg, wu_plan=wu_plan,
            use_kernel=self.wu_route == "fused_precond", timer=timed)
        stats = steps_mod.make_stats_step(self.cfg, kcfg)
        refresh = steps_mod.make_inv_refresh(self.cfg, kcfg,
                                             distributed=self.dist_inv)

        self._refresher = None
        if self.async_inv:
            # the spare seeds the double buffer: the first dispatch (step
            # 0, inside the watchdog's warm-up) already writes into
            # buffers it is given, as every later one does
            spare = {n: {k: torch.zeros_like(t) for k, t in d.items()}
                     for n, d in state.kfac.inverses.items()}
            self._refresher = AsyncInverseRefresher(
                refresh_into=lambda factors, buf: refresh(factors, out=buf),
                spare_buffers=spare, obs=self.obs)
        refresher = self._refresher

        self._smw = None
        if self.smw:
            scfg = SMWConfig(drift_budget=self.smw_drift_budget,
                             rank=self.smw_rank, use_kernel=True)
            smw_step = steps_mod.make_smw_step(self.cfg, kcfg, scfg)
            self._smw = SMWRefresher(
                lambda st, b: timed("smw", lambda: smw_step(st, b)),
                lambda factors: timed("inv", lambda: refresh(factors)),
                drift_budget=self.smw_drift_budget, obs=self.obs)
        smw_ref = self._smw

        def subsample(batch):
            # the SU's sequences and tokens, and the VLM's image rows,
            # whisper's frames (all of them) and M-RoPE positions with
            # them
            sb = min(batch["tokens"].shape[0], kcfg.stats_batch)
            ss = min(batch["tokens"].shape[1], kcfg.stats_seq)
            out = {"tokens": batch["tokens"][:sb, :ss]}
            for k in ("img_embeds", "enc_embeds"):
                if k in batch:
                    out[k] = batch[k][:sb]
            if "positions" in batch:
                out["positions"] = batch["positions"][:, :sb, :ss]
            return out

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
                        state, subsample(batch)))
                    metrics.update(m)
                if i % kcfg.inv_every == 0 and refresher is not None:
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
    ``phase_s`` has the one phase ``train``."""

    cfg: Any
    lr: float = 1e-2
    seed: int = 0
    device: str = "cuda"
    obs: Any = None

    def __post_init__(self):
        self.device = resolve_device(str(self.device))
        if self.obs is None:
            self.obs = obs_mod.NULL
        fp32_matmuls()

    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = steps_mod.init_params(self.cfg, generator=gen,
                                       device=self.device)
        return params, {k: torch.zeros_like(p) for k, p in params.items()}

    def make_step(self, state):
        del state
        phase_s: dict = {}
        timed = _phase_timer(self.device, self.obs, phase_s)
        sgd = steps_mod.make_sgd_step(self.cfg, self.lr)

        def step_fn(state, batch):
            phase_s.clear()
            state, metrics = timed("train", lambda: sgd(state, batch))
            metrics["phase_s"] = dict(phase_s)
            return state, metrics

        return step_fn


def run(program: KFACProgram, ds: SyntheticTokens, n_steps: int,
        on_step: Callable[[TrainState, dict], None] | None = None):
    """The plain driver, without ``runtime.TrainLoop``'s checkpoints,
    watchdog and recovery: init the state and take ``n_steps`` steps on
    ``ds``; returns the final state and one history record per step (loss, grad norm,
    per-phase seconds, and on the SMW path the drift and fallback
    flag). ``on_step(state, record)`` is called after each step."""
    state = program.init_state()
    step_fn = program.make_step(state)
    cursor = DataCursor()
    history = []
    for _ in range(n_steps):
        state, m = step_fn(state, ds.batch(cursor, device=program.device))
        cursor = cursor.advance()
        rec = {"step": cursor.step, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "phase_s": m["phase_s"]}
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
                         "solver; on one device the replicated refresh")
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

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if cfg.family == "audio":
        raise ValueError(
            f"{args.arch} trains on frame embeddings (enc_embeds), which "
            f"the CLI's synthetic token stream does not make (nor does "
            f"the reference's); drive launch.train.run with a dataset "
            f"that adds them")
    obs = obs_mod.from_args(args)
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
                              dist_inv=args.dist_inv, obs=obs)
    else:
        program = SGDProgram(cfg, lr=args.lr, seed=args.seed,
                             device=device, obs=obs)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)

    fired = []

    def inject(step):
        if step == args.inject_failure_at and not fired:
            fired.append(step)
            raise DeviceLoss(0, "injected failure drill")

    # On the CPU the kernels' plain versions make a refresh step tens of
    # times slower than a plain one, on cores other processes share: a
    # deadline relative to the median step would trip on healthy steps.
    loop = TrainLoop(
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every,
                   hang_factor=10.0 if device.type == "cuda" else None),
        program, ds,
        inject=inject if args.inject_failure_at >= 0 else None, obs=obs)
    result = loop.run()
    history = result["history"]
    summary = {
        "arch": cfg.name, "optimizer": args.optimizer,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "batch": args.batch, "seq": args.seq,
        "block_size": kcfg.block_size, "precision": args.precision,
        **({"wu_route": program.wu_route, "smw": args.smw,
            "async_inv": args.async_inv, "dist_inv": args.dist_inv}
           if args.optimizer == "kfac" else {}),
        **({"n_dispatched": program.refresher.n_dispatched,
            "n_swapped": program.refresher.n_swapped}
           if args.optimizer == "kfac" and args.async_inv else {}),
        **{k: v for k, v in result.items() if k != "history"},
        "losses": [h["loss"] for h in history],
        "kernel_launches": ops.launch_counts(),
    }
    if args.smw and args.optimizer == "kfac":
        summary["smw_drift"] = [h["smw_drift"] for h in history]
        summary["smw_fallback"] = [h["smw_fallback"] for h in history]
    print(json.dumps(summary, indent=1))
    if summary["losses"]:
        print(f"loss: first={summary['losses'][0]:.4f} "
              f"last={summary['losses'][-1]:.4f}")
    summary["history"] = history
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
