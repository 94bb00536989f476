"""Paper Fig. 3: precision requirements of the second-order path.

(a) SOI matrix quantized to 8/12/16-bit: how accurate is the resulting
    preconditioned direction vs the full-precision one? The paper shows
    8/12-bit SOI diverges in training; the mechanism is the relative
    error of ``A^{-1} g`` exploding as quantization approaches the
    damping floor. We measure that mechanism directly.
(b) Inversion-result quantization 8..16-bit: test-accuracy proxy =
    direction cosine / relative error of the update step.
"""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import print_csv


def _damped_spd(rng, n, damp_rel=0.03):
    m = rng.standard_normal((n, n))
    a = m @ m.T / n
    return a + damp_rel * np.trace(a) / n * np.eye(n)


def _quant(x, bits):
    s = np.abs(x).max()
    step = s * 2.0 ** (-bits)
    return np.round(x / step) * step


def rows(n: int = 256, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = _damped_spd(rng, n)
    g = rng.standard_normal((n, 8))
    x_ref = np.linalg.solve(a, g)
    out = []
    for bits in (8, 12, 16, 20):
        aq = _quant(a, bits)
        try:
            xq = np.linalg.solve(aq, g)
        except np.linalg.LinAlgError:
            out.append({"quant": "SOI_matrix", "bits": bits,
                        "rel_err": float("inf"), "cos": 0.0})
            continue
        rel = np.linalg.norm(xq - x_ref) / np.linalg.norm(x_ref)
        cos = float(np.sum(xq * x_ref)
                    / (np.linalg.norm(xq) * np.linalg.norm(x_ref)))
        out.append({"quant": "SOI_matrix", "bits": bits,
                    "rel_err": float(rel), "cos": cos})
    for bits in (8, 12, 16, 20):
        xq = _quant(x_ref, bits)
        rel = np.linalg.norm(xq - x_ref) / np.linalg.norm(x_ref)
        cos = float(np.sum(xq * x_ref)
                    / (np.linalg.norm(xq) * np.linalg.norm(x_ref)))
        out.append({"quant": "INV_result", "bits": bits,
                    "rel_err": float(rel), "cos": cos})
    return out


def headline(rs=None):
    rs = rs or rows()
    r8 = next(r for r in rs if r["quant"] == "SOI_matrix"
              and r["bits"] == 8)
    r16 = next(r for r in rs if r["quant"] == "SOI_matrix"
               and r["bits"] == 16)
    return {"name": "fig3_rel_err_8bit_over_16bit",
            "value": (r8["rel_err"] / max(r16["rel_err"], 1e-30)),
            "paper": "8-bit SOI diverges; 16-bit converges"}


def main():
    rs = rows()
    print_csv("fig3_soi_precision", rs)
    print_csv("fig3_headline", [headline(rs)])


if __name__ == "__main__":
    main()
