"""Walkthrough of the paper's Fig. 5 example, small enough to read
(counterpart of ``examples/precision_inv_demo.py``): an 8-bit matrix,
4-bit input and result, 2-bit DAC/ADC, 4-bit cells — the exact toy
configuration the paper uses to illustrate Loop b / Loop x / Loop A —
then the production-scale 16-bit configuration (both the NumPy circuit
model), then the same algorithm through ``kernels.ops.neumann_inv``:
the CUDA kernel on the card, its plain version on the CPU.

  python -m repro_torch.examples.precision_inv_demo [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.precision_inv import (
    CircuitConfig,
    achieved_bits,
    faithful_inv_apply,
    quantize_problem,
)
from repro_torch.kernels import ops
from repro_torch.launch.train import fp32_matmuls, resolve_device


def run(device="cuda") -> dict:
    """Every step; returns the printed numbers and the kernel's inverse
    (on ``device``) with its input block and damping."""
    device = resolve_device(str(device))
    fp32_matmuls()
    rng = np.random.default_rng(1)

    print("=== Fig. 5 toy: Q_A=8, Q_b=Q_x=4, DAC/ADC=2-bit, 4-bit cells ===")
    toy = CircuitConfig(q_a=8, q_b=4, q_x=4, r_dac=2, r_adc=2, r_c=4, k=1,
                        n_taylor=4)
    n = 8
    m = rng.standard_normal((n, n))
    A = m @ m.T / n + 0.3 * np.eye(n)
    b = rng.standard_normal(n)
    Aq, bq = quantize_problem(A, b, toy)
    x = faithful_inv_apply(A, b, toy)
    x_ref = np.linalg.solve(Aq, bq)
    toy_bits = achieved_bits(x, x_ref)
    print(f"loops: b={toy.loops_b} x={toy.loops_x} A={toy.n_taylor}")
    print(f"cycles (Eqn. 10): {toy.cycles_inv()}")
    print(f"achieved bits vs quantized-problem solve: "
          f"{toy_bits:.1f} (target {toy.q_x})")

    print("\n=== production: Q=16, DAC=4, ADC=8, 2x4-bit cells ===")
    cfg = CircuitConfig()
    n = 128
    m = rng.standard_normal((n, n))
    A = m @ m.T / n
    A += 0.03 * np.trace(A) / n * np.eye(n)
    b = rng.standard_normal(n)
    Aq, bq = quantize_problem(A, b, cfg)
    x, trace = faithful_inv_apply(A, b, cfg, return_trace=True)
    x_ref = np.linalg.solve(Aq, bq)
    print(f"cycles (Eqn. 10): {cfg.cycles_inv()}  "
          f"fused (Eqn. 14): {cfg.cycles_inv_fused()}")
    print("bits after each Loop-A iteration:")
    iters = [achieved_bits(xt, x_ref) for xt in trace[:8]]
    for i, bits in enumerate(iters):
        print(f"  iter {i + 1:2d}: {bits:5.1f} bits")
    final = achieved_bits(x, x_ref)
    print(f"final: {final:.1f} bits (paper bar: 16)")

    print(f"\n=== same algorithm through neumann_inv ({device.type}) ===")
    blocks = torch.from_numpy(np.stack([A]).astype(np.float32)).to(device)
    damp = torch.zeros(1, dtype=torch.float32, device=device)  # A damped
    inv = ops.neumann_inv(blocks, damp, ns_iters=20, taylor_terms=4,
                          refine_steps=2)
    resid = float(np.max(np.abs(inv[0].cpu().numpy() @ A - np.eye(n))))
    print(f"kernel |MA - I|_inf = {resid:.2e}")
    return {"toy_bits": toy_bits, "toy_cycles": toy.cycles_inv(),
            "cycles": cfg.cycles_inv(), "cycles_fused": cfg.cycles_inv_fused(),
            "iter_bits": iters, "final_bits": final, "resid": resid,
            "inverse": inv, "blocks": blocks, "damping": damp}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    out = run(ap.parse_args(argv).device)
    assert out["final_bits"] >= 16.0
    assert out["resid"] < 1e-3
    print("\nprecision_inv_demo OK")
    return out


if __name__ == "__main__":
    main()
