"""K-FAC training driver on one GPU (counterpart of ``repro.launch.train``).

  python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 4 \\
      --batch 8 --seq 256 --stats-every 2 --inv-every 2

runs the full-width model on CUDA; ``--smoke --device cpu`` runs the
reduced config on the CPU. The cadence follows the paper (Fig. 8): every
step runs FP/BP/WU; the SU stage (factor statistics) runs every
``--stats-every`` steps and the INV stage (composed-precision block
inverses) every ``--inv-every`` steps, in the order stats, inv, train.
INV goes through the ``neumann_inv`` kernel and the pooled WU through
the ``fused_precond`` kernel; on the card they cannot be turned off.

``--smw`` replaces the stats/inv cadence with the incremental SOI path:
every step runs one rank-k program (SU with column factors, factor EMA,
Woodbury inverse update through the ``smw_update`` kernel, drift probe)
and a host gate re-inverts fully through ``neumann_inv`` on the first
step and whenever the lagged drift exceeds ``--smw-drift-budget``.

Checkpointing, the step watchdog and elastic recovery of the reference's
``runtime.TrainLoop`` are not ported yet; a plain step loop drives the
program.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import kfac
from repro_torch.core.kfac import KFACConfig
from repro_torch.data.pipeline import DataCursor, SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.steps import TrainState
from repro_torch.models import lm
from repro_torch.solve.async_refresh import SMWRefresher
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


@dataclasses.dataclass
class KFACProgram:
    """Single-device K-FAC program: pooled WU through ``fused_precond``
    and INV through ``neumann_inv`` (the kernels' plain versions when
    ``device`` is the CPU).

    ``smw``: incremental SOI. The stats/inv cadences are replaced by one
    rank-k program per step (``steps.make_smw_step``, its Woodbury
    update through the ``smw_update`` kernel) gated by
    :class:`SMWRefresher`, which re-inverts fully on the first step and
    whenever the lagged drift exceeds ``smw_drift_budget``;
    ``smw_rank`` caps the columns per update."""

    cfg: Any
    kcfg: KFACConfig
    seed: int = 0
    device: str = "cuda"
    smw: bool = False
    smw_drift_budget: float = 0.05
    smw_rank: int = 64

    def __post_init__(self):
        self.device = resolve_device(str(self.device))
        fp32_matmuls()
        self._smw = None

    def init_state(self) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = lm.init(self.cfg, generator=gen, device=self.device)
        return TrainState(params, kfac.init(
            params, lm.kfac_specs(self.cfg), self.kcfg))

    def make_step(self, state: TrainState):
        """``step_fn(state, batch) -> (state, metrics)``; metrics carry
        the loss and ``phase_s``, each phase's wall seconds (ended by a
        device synchronise, so they are device times too): ``stats``,
        ``inv`` and ``train``, or with ``smw`` ``smw``, ``inv`` (on a
        fallback) and ``train``."""
        kcfg, dev = self.kcfg, self.device
        wu_plan = steps_mod.make_wu_plan_for(self.cfg, state)
        train = steps_mod.make_train_step(self.cfg, kcfg, wu_plan=wu_plan,
                                          use_kernel=True)
        stats = steps_mod.make_stats_step(self.cfg, kcfg)
        refresh = steps_mod.make_inv_refresh(self.cfg, kcfg)
        phase_s: dict = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            phase_s[name] = time.perf_counter() - t0
            return out

        self._smw = None
        if self.smw:
            scfg = SMWConfig(drift_budget=self.smw_drift_budget,
                             rank=self.smw_rank, use_kernel=True)
            smw_step = steps_mod.make_smw_step(self.cfg, kcfg, scfg)
            self._smw = SMWRefresher(
                lambda st, b: timed("smw", lambda: smw_step(st, b)),
                lambda factors: timed("inv", lambda: refresh(factors)),
                drift_budget=self.smw_drift_budget)
        smw_ref = self._smw

        def subsample(batch):
            sb = min(batch["tokens"].shape[0], kcfg.stats_batch)
            ss = min(batch["tokens"].shape[1], kcfg.stats_seq)
            return {"tokens": batch["tokens"][:sb, :ss]}

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
                if i % kcfg.inv_every == 0:
                    kst = state.kfac
                    inv = timed("inv", lambda: refresh(kst.factors))
                    state = dataclasses.replace(
                        state, kfac=dataclasses.replace(kst, inverses=inv))
            state, m = timed("train", lambda: train(state, batch))
            metrics.update(m)
            metrics["phase_s"] = dict(phase_s)
            return state, metrics

        return step_fn

    def reset_async(self) -> None:
        """Elastic-recovery hook of the reference: force the SMW gate's
        next step to fall back (a restored inverse tree is un-probed)."""
        if self._smw is not None:
            self._smw.reset()


def run(program: KFACProgram, ds: SyntheticTokens, n_steps: int,
        on_step: Callable[[TrainState, dict], None] | None = None):
    """Init the state and take ``n_steps`` steps on ``ds``; returns the
    final state and one history record per step (loss, grad norm,
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; raises if CUDA is asked for and "
                         "absent")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--damping", type=float, default=0.03)
    ap.add_argument("--stats-every", type=int, default=10)
    ap.add_argument("--inv-every", type=int, default=10)
    ap.add_argument("--block-size", type=int, default=128)
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the run summary JSON here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    kcfg = KFACConfig(
        lr=args.lr, damping=args.damping,
        stats_every=args.stats_every, inv_every=args.inv_every,
        block_size=min(args.block_size, cfg.soi_block),
        stats_batch=args.batch, stats_seq=args.seq)
    program = KFACProgram(cfg, kcfg, seed=args.seed, device=device,
                          smw=args.smw,
                          smw_drift_budget=args.smw_drift_budget,
                          smw_rank=args.smw_rank)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)

    t0 = time.perf_counter()
    _, history = run(program, ds, args.steps)
    summary = {
        "arch": cfg.name, "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "steps": args.steps, "batch": args.batch, "seq": args.seq,
        "block_size": kcfg.block_size, "smw": args.smw,
        "wall_s": time.perf_counter() - t0,
        "losses": [h["loss"] for h in history],
        "kernel_launches": ops.launch_counts(),
        "history": history,
    }
    if args.smw:
        summary["smw_drift"] = [h["smw_drift"] for h in history]
        summary["smw_fallback"] = [h["smw_fallback"] for h in history]
    print(json.dumps({k: v for k, v in summary.items() if k != "history"},
                     indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
