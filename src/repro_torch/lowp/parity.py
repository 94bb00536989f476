"""fp32 reference-parity harness for the low-precision training path
(counterpart of ``repro.lowp.parity``).

The error budget for ``--precision hilo|int8`` is **>= 16 effective bits
on the preconditioned update**: run the same WU at fp32 and at the low
precision from *identical* state and measure
``core.precision_inv.achieved_bits`` on the output. Two harnesses:

* :func:`update_parity` — the budget's unit of account. One warmed
  training state (stats pass + inverse refresh, so the inverses are
  real, not the identity init that would make parity trivial), one
  gradient, ``kfac.precondition`` at fp32 vs the candidate precision,
  per-leaf achieved bits on every factored update.
* :func:`trajectory_parity` — two complete training runs from shared
  init and identical data, per-step achieved bits between the
  parameters. Divergence grows with steps (training is chaotic), so
  trajectory curves rank precisions rather than gate on a bit count.

Both run the pooled einsum WU route (``lowp_einsum``) at every
precision, so the comparison isolates the products' precision; the
warm state's inverse refresh runs ``neumann_inv`` on ``device``.
Dense LM archs only: the harness feeds token batches.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import kfac
from repro_torch.core.kfac import KFACConfig
from repro_torch.core.precision_inv import achieved_bits
from repro_torch.data import DataCursor, SyntheticTokens
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.steps import TrainState
from repro_torch.launch.train import fp32_matmuls, resolve_device
from repro_torch.models import lm

__all__ = ["update_parity", "trajectory_parity"]


def _base_kcfg(cfg, block_size: int, batch: int, seq: int) -> KFACConfig:
    return KFACConfig(block_size=min(block_size, cfg.soi_block),
                      stats_batch=batch, stats_seq=seq,
                      stats_every=1, inv_every=1)


def _batch(cfg, batch: int, seq: int, seed: int, device, step: int = 0):
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=seq,
                         global_batch=batch, seed=seed)
    return ds.batch(DataCursor(step), device=device)


def _warm_state(cfg, kcfg: KFACConfig, batch, seed: int,
                device) -> TrainState:
    """Init + one stats pass + one inverse refresh: the factors hold
    real Gram statistics and the inverses are genuinely non-identity —
    the state every precision variant starts from."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init(cfg, generator=gen, device=device)
    state = TrainState(params, kfac.init(params, lm.kfac_specs(cfg), kcfg))
    state, _ = steps_mod.make_stats_step(cfg, kcfg)(state, batch)
    return steps_mod.make_inv_step(cfg, kcfg)(state)


def _grads(cfg, state: TrainState, batch) -> dict:
    p = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    with torch.enable_grad():
        loss, _ = lm.loss_fn(cfg, p, batch)
        grads = torch.autograd.grad(loss, list(p.values()))
    return dict(zip(p, grads))


def _factored_bits(out: dict, ref: dict, specs) -> dict:
    return {name: float(achieved_bits(
                out[name].detach().cpu().double().numpy(),
                ref[name].detach().cpu().double().numpy()))
            for name in out if name in specs}


def update_parity(precision: str, *, arch: str = "qwen1.5-0.5b",
                  batch: int = 4, seq: int = 32, block_size: int = 64,
                  seed: int = 0, fused: bool = True,
                  kcfg: Optional[KFACConfig] = None,
                  device: str = "cuda") -> dict:
    """Achieved bits of one preconditioned update vs the fp32 path, on
    the smoke config of ``arch``.

    Returns ``{"min_bits", "mean_bits", "per_leaf", "precision"}`` —
    ``min_bits`` is the acceptance number (worst factored leaf).
    """
    dev = resolve_device(device)
    fp32_matmuls()
    cfg = get_smoke_config(arch)
    kcfg = kcfg or _base_kcfg(cfg, block_size, batch, seq)
    kcfg = replace(kcfg, precision="fp32")
    bt = _batch(cfg, batch, seq, seed, dev)
    state = _warm_state(cfg, kcfg, bt, seed, dev)
    grads = _grads(cfg, state, bt)
    specs = lm.kfac_specs(cfg)
    wu_plan = steps_mod.make_wu_plan_for(cfg, state) if fused else None

    def pre(p):
        return kfac.precondition(grads, state.kfac, specs,
                                 replace(kcfg, precision=p), wu_plan=wu_plan)

    bits = _factored_bits(pre(precision), pre("fp32"), specs)
    return {"precision": precision,
            "min_bits": min(bits.values()),
            "mean_bits": float(np.mean(list(bits.values()))),
            "per_leaf": bits}


def trajectory_parity(precision: str, *, arch: str = "qwen1.5-0.5b",
                      steps: int = 4, batch: int = 4, seq: int = 32,
                      block_size: int = 64, seed: int = 0,
                      kcfg: Optional[KFACConfig] = None,
                      device: str = "cuda") -> dict:
    """Per-step achieved bits of a full low-precision training
    trajectory against the fp32 trajectory from shared init.

    Every step runs the complete cadence — stats, inverse refresh,
    train — at the candidate precision (the refresh is the composed
    hi/lo inversion in every mode; the knob moves the WU products).
    Returns per-step ``bits`` (worst factored leaf, parameters) and the
    two loss histories.
    """
    dev = resolve_device(device)
    fp32_matmuls()
    cfg = get_smoke_config(arch)
    kcfg = kcfg or _base_kcfg(cfg, block_size, batch, seq)
    specs = lm.kfac_specs(cfg)

    def run(p):
        kc = replace(kcfg, precision=p)
        state = _warm_state(cfg, kc, _batch(cfg, batch, seq, seed, dev),
                            seed, dev)
        train = steps_mod.make_train_step(
            cfg, kc, wu_plan=steps_mod.make_wu_plan_for(cfg, state))
        stats = steps_mod.make_stats_step(cfg, kc)
        inv = steps_mod.make_inv_step(cfg, kc)
        traj, losses = [], []
        for i in range(steps):
            bt = _batch(cfg, batch, seq, seed, dev, step=i + 1)
            state, _ = stats(state, bt)
            state = inv(state)
            state, m = train(state, bt)
            traj.append(state.params)
            losses.append(float(m["loss"]))
        return traj, losses

    ref_traj, ref_losses = run("fp32")
    lp_traj, lp_losses = run(precision)
    bits = [min(_factored_bits(lp, ref, specs).values())
            for lp, ref in zip(lp_traj, ref_traj)]
    return {"precision": precision, "steps": steps, "bits": bits,
            "loss_fp32": ref_losses, "loss_lowp": lp_losses}
