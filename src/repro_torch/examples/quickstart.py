"""Quickstart: the paper's technique in 60 lines (counterpart of
``examples/quickstart.py``).

1. Build a Tikhonov-damped SOI block (what K-FAC hands the hardware).
2. Invert it three ways:
     a. float64 linalg (reference),
     b. plain bf16 (the "8-bit INV crossbar": too coarse, paper Fig. 3),
     c. RePAST composed precision (low-precision primitives + Loop A/x/b,
        paper Sec. III), on the faithful fixed-point circuit model and
        on the device: ``precision_inv.composed_inverse``, every product
        from bf16 hi/lo partials (the plain library function, as the
        reference's step).
3. Use it: one K-FAC-preconditioned step on an ill-conditioned
   quadratic vs plain SGD.

  python -m repro_torch.examples.quickstart [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.precision_inv import (
    CircuitConfig,
    achieved_bits,
    composed_inverse,
    faithful_inv_apply,
    quantize_problem,
)
from repro_torch.launch.train import fp32_matmuls, resolve_device


def run(device="cuda", n: int = 256) -> dict:
    """Every step; returns the printed numbers."""
    device = resolve_device(str(device))
    fp32_matmuls()
    rng = np.random.default_rng(0)

    # -- 1. a damped SOI block ---------------------------------------------
    m = rng.standard_normal((n, n))
    A = m @ m.T / n
    lam = 0.03 * np.trace(A) / n
    A += lam * np.eye(n)
    b = rng.standard_normal(n)

    x_ref = np.linalg.solve(A, b)

    # -- 2a. faithful circuit model (4-bit cells, 4-bit DAC, 8-bit ADC) ----
    # n_taylor: the paper's 18 covers 99% of ITS matrix ensemble (Fig. 4b);
    # this demo's kappa~130 block needs a few more Loop-A rounds, the knob
    # the paper exposes for exactly this purpose (Sec. III-A.3).
    cfg = CircuitConfig(n_taylor=26)
    Aq, bq = quantize_problem(A, b, cfg)
    x_circuit = faithful_inv_apply(A, b, cfg)
    bits_circuit = achieved_bits(x_circuit, np.linalg.solve(Aq, bq))

    # -- 2b. plain low precision (what a bare 8-bit INV crossbar gives) ----
    A_bf16 = torch.from_numpy(A).to(torch.bfloat16).double().numpy()
    x_low = np.linalg.solve(A_bf16, b)
    bits_low = achieved_bits(x_low, x_ref)

    # -- 2c. the device: composed-precision inverse, all products bf16 -----
    M = composed_inverse(torch.from_numpy(A.astype(np.float32)).to(device),
                         0.0, ns_iters=20, taylor_terms=4,
                         refine_steps=2).cpu().double().numpy()
    x_dev = M @ b
    bits_dev = achieved_bits(x_dev, x_ref)

    print("target accuracy (paper):          >= 16 bits")
    print(f"plain bf16 primitive alone:       {bits_low:5.1f} bits")
    print(f"faithful circuit (Loop A/x/b):    {bits_circuit:5.1f} bits")
    label = f"composed precision ({device.type}):"
    print(f"{label:34s}{bits_dev:5.1f} bits")

    # -- 3. why second order: one preconditioned step vs SGD ---------------
    g = A @ rng.standard_normal(n)          # a gradient with curvature mix
    x_sgd = g / np.abs(np.linalg.eigvalsh(A)).max()     # best-case SGD
    x_kfac = M @ g                                       # preconditioned
    resid_sgd = np.linalg.norm(g - A @ x_sgd) / np.linalg.norm(g)
    resid_kfac = np.linalg.norm(g - A @ x_kfac) / np.linalg.norm(g)
    print(f"\none-step residual, SGD-scaled:    {resid_sgd:.3f}")
    print(f"one-step residual, preconditioned: {resid_kfac:.2e}")
    return {"bits_low": bits_low, "bits_circuit": bits_circuit,
            "bits_device": bits_dev, "resid_sgd": resid_sgd,
            "resid_kfac": resid_kfac}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    out = run(ap.parse_args(argv).device)
    assert out["bits_circuit"] >= 16.0, \
        "circuit model must hit the paper's 16-bit bar"
    assert out["bits_device"] > out["bits_low"] + 4, \
        "composition must beat the bare primitive"
    print("\nquickstart OK")
    return out


if __name__ == "__main__":
    main()
