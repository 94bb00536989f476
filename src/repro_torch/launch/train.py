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

Checkpointing, the step watchdog and elastic recovery of the reference's
``runtime.TrainLoop`` are not ported yet; a plain step loop drives the
program.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import kfac
from repro_torch.core.kfac import KFACConfig
from repro_torch.data.pipeline import DataCursor, SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.steps import TrainState
from repro_torch.models import lm


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
    ``device`` is the CPU)."""

    cfg: Any
    kcfg: KFACConfig
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(str(self.device))
        fp32_matmuls()

    def init_state(self) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = lm.init(self.cfg, generator=gen, device=self.device)
        return TrainState(params, kfac.init(
            params, lm.kfac_specs(self.cfg), self.kcfg))

    def make_step(self, state: TrainState):
        """``step_fn(state, batch) -> (state, metrics)``; metrics carry
        the loss and ``phase_s``, each phase's wall seconds (ended by a
        device synchronise, so they are device times too)."""
        kcfg, dev = self.kcfg, self.device
        wu_plan = steps_mod.make_wu_plan_for(self.cfg, state)
        train = steps_mod.make_train_step(self.cfg, kcfg, wu_plan=wu_plan,
                                          use_kernel=True)
        stats = steps_mod.make_stats_step(self.cfg, kcfg)
        refresh = steps_mod.make_inv_refresh(self.cfg, kcfg)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def subsample(batch):
            sb = min(batch["tokens"].shape[0], kcfg.stats_batch)
            ss = min(batch["tokens"].shape[1], kcfg.stats_seq)
            return {"tokens": batch["tokens"][:sb, :ss]}

        def step_fn(state: TrainState, batch):
            i = state.kfac.step
            metrics: dict = {"phase_s": {}}

            def timed(name, fn):
                t0 = time.perf_counter()
                out = fn()
                sync()
                metrics["phase_s"][name] = time.perf_counter() - t0
                return out

            if i % kcfg.stats_every == 0:
                state, m = timed("stats", lambda: stats(state,
                                                        subsample(batch)))
                metrics.update(m)
            if i % kcfg.inv_every == 0:
                kst = state.kfac
                inv = timed("inv", lambda: refresh(kst.factors))
                state = dataclasses.replace(
                    state, kfac=dataclasses.replace(kst, inverses=inv))
            state, m = timed("train", lambda: train(state, batch))
            metrics.update(m)
            return state, metrics

        return step_fn


def run(program: KFACProgram, ds: SyntheticTokens, n_steps: int):
    """Init the state and take ``n_steps`` steps on ``ds``; returns the
    final state and one history record per step (loss, grad norm,
    per-phase seconds)."""
    state = program.init_state()
    step_fn = program.make_step(state)
    cursor = DataCursor()
    history = []
    for _ in range(n_steps):
        state, m = step_fn(state, ds.batch(cursor, device=program.device))
        cursor = cursor.advance()
        history.append({"step": cursor.step, "loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "phase_s": m["phase_s"]})
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
    program = KFACProgram(cfg, kcfg, seed=args.seed, device=device)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)

    t0 = time.perf_counter()
    _, history = run(program, ds, args.steps)
    summary = {
        "arch": cfg.name, "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "steps": args.steps, "batch": args.batch, "seq": args.seq,
        "block_size": kcfg.block_size,
        "wall_s": time.perf_counter() - t0,
        "losses": [h["loss"] for h in history],
        "kernel_launches": ops.launch_counts(),
        "history": history,
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "history"},
                     indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
