"""Paper Sec. VI-C convergence claim (counterpart of
``benchmarks/kfac_convergence.py``): K-FAC with the composed-precision
inversion reaches a target loss in fewer steps than first-order SGD on
the same model and data. The paper's vehicle is ResNet/ImageNet epochs;
here a reduced LM on the synthetic pipeline, plus the
autoencoder-class quadratic probe where second order is ~1 step.

On the card the K-FAC arm of :func:`lm_probe` runs both training
kernels: ``neumann_inv`` once a refresh and ``fused_precond`` (the
pooled WU) once a step."""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.benchmarks.common import print_csv


def quadratic_probe(n: int = 64, steps: int = 40, seed: int = 0,
                    device="cuda"):
    """Ill-conditioned quadratic: SGD crawls, Newton (the composed
    inverse) jumps. The paper's 'second order uses curvature' argument
    in its purest form."""
    from repro_torch.core.precision_inv import composed_inverse

    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    evals = np.logspace(-2, 1.0, n)
    h = (q * evals) @ q.T
    h = torch.as_tensor((h + h.T) / 2, dtype=torch.float32, device=device)
    x0 = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=device)

    def loss(x):
        return 0.5 * x @ h @ x

    lr = float(1.8 / evals.max())
    x = x0
    sgd_losses = [float(loss(x))]
    for _ in range(steps):
        x = x - lr * (h @ x)
        sgd_losses.append(float(loss(x)))

    h_inv = composed_inverse(h, 1e-4, ns_iters=20, taylor_terms=4,
                             refine_steps=2)
    x = x0
    newton_losses = [float(loss(x))]
    for _ in range(3):
        x = x - h_inv @ (h @ x)
        newton_losses.append(float(loss(x)))

    target = sgd_losses[0] * 1e-3
    sgd_steps = next((i for i, l in enumerate(sgd_losses) if l < target),
                     steps + 1)
    newton_steps = next((i for i, l in enumerate(newton_losses)
                         if l < target), 4)
    return {"probe": "quadratic", "target": "1e-3 of init",
            "sgd_steps": sgd_steps, "kfac_steps": newton_steps,
            "speedup_x": round(sgd_steps / max(newton_steps, 1), 1)}


def steps_to_target(*arms):
    """The probe's target, 70% of the best finite drop below the first
    arm's first loss, and each arm's first step under it (one past its
    run where it never gets there)."""
    best = min(l for losses in arms for l in losses if math.isfinite(l))
    tgt = arms[0][0] - 0.7 * (arms[0][0] - best)
    return tgt, [next((i for i, l in enumerate(losses) if l < tgt),
                      len(losses) + 1) for losses in arms]


def lm_probe(steps: int = 60, seed: int = 0, device="cuda", params=None):
    """Reduced-LM steps to loss: K-FAC against SGD, same data order.

    ``params``: the initial weights (a flat dict, moved to ``device``);
    by default the model's init from ``seed``. The result carries the
    reference's keys and both arms' losses."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import kfac as kfac_mod
    from repro_torch.core.kfac import KFACConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.steps import TrainState
    from repro_torch.launch.train import fp32_matmuls, resolve_device

    dev = resolve_device(str(device))
    fp32_matmuls()
    cfg = get_smoke_config("qwen2-0.5b")
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=64, global_batch=8,
                         seed=seed)
    kcfg = KFACConfig(lr=0.08, damping=0.1, block_size=32,
                      stats_every=5, inv_every=5, ema_decay=0.8,
                      stats_batch=8, stats_seq=64)
    specs = steps_mod.kfac_specs(cfg)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = steps_mod.init_params(cfg, generator=gen, device=dev)
    params0 = {k: v.to(dev) for k, v in params.items()}

    def fresh_kfac():
        return TrainState(params0, kfac_mod.init(params0, specs, kcfg))

    train = steps_mod.make_train_step(
        cfg, kcfg, wu_plan=steps_mod.make_wu_plan_for(cfg, fresh_kfac()),
        use_kernel=True)
    stats = steps_mod.make_stats_step(cfg, kcfg)
    inv = steps_mod.make_inv_step(cfg, kcfg)
    sgd = steps_mod.make_sgd_step(cfg, lr=0.3)

    def batch(i):
        return {"tokens": torch.from_numpy(ds.batch_slice(i, 0, 8)).to(dev)}

    def run_kfac():
        state = fresh_kfac()
        losses = []
        for i in range(steps):
            b = batch(i)
            if i % kcfg.stats_every == 0:
                state, _ = stats(state, b)
            if i % kcfg.inv_every == 0:
                state = inv(state)
            state, m = train(state, b)
            losses.append(float(m["loss"]))
        return losses

    def run_sgd():
        state = (params0, {k: torch.zeros_like(p)
                           for k, p in params0.items()})
        losses = []
        for i in range(steps):
            state, m = sgd(state, batch(i))
            losses.append(float(m["loss"]))
        return losses

    lk = run_kfac()
    ls = run_sgd()
    _, (k_steps, s_steps) = steps_to_target(lk, ls)
    return {"probe": "smoke_lm", "target": "70% of best drop",
            "sgd_steps": s_steps, "kfac_steps": k_steps,
            "speedup_x": round(s_steps / max(k_steps, 1), 2),
            "kfac_final": round(lk[-1], 3),
            "sgd_final": round(ls[-1], 3),
            "note": "60-step smoke run: the early phase is "
                    "embedding-dominated (first-order regime) where "
                    "tuned SGD leads; the paper's claim - and the "
                    "quadratic probe above - concern the "
                    "curvature-dominated phase (epochs-to-accuracy), "
                    "which a smoke run cannot reach",
            "kfac_losses": lk, "sgd_losses": ls}


def rows(fast: bool = False, device="cuda"):
    out = [quadratic_probe(device=device)]
    if not fast:
        out.append(lm_probe(device=device))
    return out


def main(device="cuda"):
    print_csv("sec6c_kfac_convergence", rows(device=device))


if __name__ == "__main__":
    main()
