"""End-to-end example (counterpart of ``examples/train_kfac_100m.py``):
K-FAC second-order training of a ~100M-parameter LM for a few hundred
steps on the synthetic pipeline, with checkpointing, the step watchdog,
and a mid-run injected failure with recovery from the last checkpoint
(``runtime.TrainLoop``).

The ~100M model is a llama3.2-family config (GQA + SwiGLU) at short
sequence length; ``--smoke`` takes a ~2M stand-in. The K-FAC block size
is ``min(256, cfg.soi_block)``, as in the reference: 256 for the 100M
model, which the CUDA kernels take on their large route (sides of
129..1024).

  python -m repro_torch.examples.train_kfac_100m [--smoke] \\
      [--steps 200] [--seq 128] [--batch 8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kfac import KFACConfig


def config_100m() -> ModelConfig:
    """~100M params: 8 layers, d=512, llama-style (GQA + SwiGLU)."""
    return ModelConfig(
        name="llama-100m", family="dense",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab=65536, rope_theta=500000.0,
        soi_block=256, attn_chunk=512,
    )


def config_smoke() -> ModelConfig:
    """~2M params: the CI-sized stand-in for quick sync/async A-Bs."""
    return ModelConfig(
        name="llama-100m-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=384, vocab=4096, rope_theta=500000.0,
        soi_block=64, attn_chunk=128,
    )


def kfac_config(cfg: ModelConfig, batch: int, seq: int) -> KFACConfig:
    """The example's K-FAC settings, block ``min(256, cfg.soi_block)``."""
    return KFACConfig(lr=2e-2, damping=0.05,
                      block_size=min(256, cfg.soi_block),
                      stats_every=10, inv_every=10,
                      stats_batch=batch, stats_seq=seq)


def train(cfg: ModelConfig, kcfg: KFACConfig, *, steps: int, batch: int,
          seq: int, ckpt_dir: str, inject_at: int = -1,
          dist_inv: bool = False, async_inv: bool = False,
          device="cuda") -> dict:
    """``steps`` K-FAC steps through ``TrainLoop`` with a checkpoint
    every 25 steps in ``ckpt_dir`` and, if ``inject_at >= 0``, one
    device loss at that step. Returns the loop's summary (``history``
    holds one row per executed step, replays included)."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import KFACProgram, resolve_device
    from repro_torch.runtime import DeviceLoss, LoopConfig, TrainLoop

    device = resolve_device(str(device))
    program = KFACProgram(cfg, kcfg, seed=0, device=device,
                          dist_inv=dist_inv, async_inv=async_inv)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                         seed=0)
    fired = []

    def inject(step):
        if inject_at >= 0 and step == inject_at and not fired:
            fired.append(step)
            print(f"\n=== injecting device failure at step {step}: "
                  f"expect checkpoint restore + continue ===\n")
            raise DeviceLoss(0, "drill")

    # on the CPU the plain inverse makes a refresh step many times a
    # plain one: no median-relative hang deadline there (as the CLI)
    loop = TrainLoop(
        LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=25,
                   log_every=10,
                   hang_factor=10.0 if device.type == "cuda" else None),
        program, ds, inject=inject)
    return loop.run()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + short run (CI-sized)")
    ap.add_argument("--steps", type=int, default=None,
                    help="default: 200 (24 with --smoke)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--dist-inv", action="store_true",
                    help="block-parallel SOI inversion (repro_torch.solve)")
    ap.add_argument("--async-inv", action="store_true",
                    help="double-buffered staleness-tolerant refresh")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a temporary directory, removed at exit")
    ap.add_argument("--fresh", action="store_true",
                    help="clear the checkpoint dir first")
    ap.add_argument("--inject-failure-at", type=int, default=None,
                    help="default: steps//2, -1 under --smoke "
                         "(set -1 to disable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    defaults = (24, 4, 32) if args.smoke else (200, 8, 128)
    cfg = config_smoke() if args.smoke else config_100m()
    for name, default in zip(("steps", "batch", "seq"), defaults):
        if getattr(args, name) is None:
            setattr(args, name, default)
    if args.inject_failure_at is None:
        inject_at = -1 if args.smoke else args.steps // 2
    else:
        inject_at = args.inject_failure_at

    n_params = cfg.param_count()
    print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M  "
          f"dist_inv={args.dist_inv}  async_inv={args.async_inv}")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = args.ckpt_dir or os.path.join(tmp, "ckpt")
        if args.fresh and os.path.isdir(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        summary = train(cfg, kfac_config(cfg, args.batch, args.seq),
                        steps=args.steps, batch=args.batch, seq=args.seq,
                        ckpt_dir=ckpt_dir, inject_at=inject_at,
                        dist_inv=args.dist_inv, async_inv=args.async_inv,
                        device=args.device)

    hist = summary["history"]
    losses = [h["loss"] for h in hist if "loss" in h]
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "history"}, indent=1))
    print(f"loss: start={losses[0]:.3f} end={losses[-1]:.3f} "
          f"(drop {losses[0] - losses[-1]:+.3f})")
    assert losses[-1] < losses[0], "loss should improve over the run"
    if inject_at >= 0:
        assert summary["recoveries"] >= 1, "failure drill did not fire"
    print("train_kfac_100m OK")
    return summary


if __name__ == "__main__":
    main()
