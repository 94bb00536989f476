"""The precision ladder: Fig. 4(b) extended to full training runs
(counterpart of ``benchmarks/precision_ladder.py``).

The paper's Fig. 4(b) argument is compositional: more slices composed
(Loop b over R_DAC-bit DAC inputs, Loop x over R_ADC-bit ADC reads)
buys more effective bits, so 8-bit circuitry reaches 16-bit-accurate
inversion. This module climbs that ladder at four scopes:

* **block** — error-vs-Loop-A-iteration curves of the faithful
  fixed-point INV circuit at 4/8/16-bit DAC slicing (NumPy, the
  reference's arithmetic), mean achieved bits per iteration;
* **update** — achieved bits of one preconditioned K-FAC update when
  every WU product runs at each rung of the training ladder
  (``int4b4`` .. ``int16b4``, ``int8`` = 24-bit codes of 8-bit slices,
  and ``hilo`` bf16 limbs) against the fp32 path
  (``lowp.update_parity``);
* **trajectory** — the same rungs over full training trajectories
  (stats, inverse refresh and train each step): per-step worst-leaf
  achieved bits between the low-precision and fp32 parameters
  (``lowp.trajectory_parity``);
* **serve** — the int8 deployment tier: greedy-token parity on a
  briefly trained checkpoint and the resident-memory reduction
  (``lowp.serve_greedy_parity``).

The update and trajectory harnesses refresh their inverses through
``neumann_inv`` (the CUDA kernel on the card) and run the pooled einsum
WU at every rung. Writes ``--out`` (default
``bench_out/BENCH_precision.json``); its ``*_wall_s`` keys feed the
runner's summary.

  python -m repro_torch.benchmarks.precision_ladder [--fast] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.benchmarks.common import out_path, print_csv, write_json
from repro_torch.core.precision_inv import (
    CircuitConfig,
    achieved_bits,
    faithful_inv_apply,
    quantize_problem,
)
from repro_torch.launch.train import resolve_device

# training ladder rungs: (label, KFACConfig.precision spec)
LADDER = ("int4b4", "int8b4", "int16b4", "hilo", "int8")


def _damped_spd(rng, n: int, damp_rel: float = 0.1):
    m = rng.standard_normal((n, n))
    a = m @ m.T / n
    return a + damp_rel * np.trace(a) / n * np.eye(n)


def block_rows(n: int = 128, n_samples: int = 4, seed: int = 0):
    """Mean achieved bits vs Loop-A iteration at 4/8/16-bit DAC
    slicing. The DAC width divides the rhs into q_b/r_dac slices; the
    ladder claim is monotone: wider DAC -> fewer, coarser slices ->
    the same iteration count lands on the same accuracy only because
    slice composition is exact — the curves overlap near convergence
    but the coarse rung needs fewer cycles (cycles_inv column)."""
    out = []
    for r_dac in (4, 8, 16):
        cfg = CircuitConfig(r_dac=r_dac, n_taylor=12)
        rng = np.random.default_rng(seed)
        traces = []
        for _ in range(n_samples):
            a = _damped_spd(rng, n)
            b = rng.standard_normal(n)
            aq, bq = quantize_problem(a, b, cfg)
            x_ref = np.linalg.solve(aq, bq)
            _, trace = faithful_inv_apply(a, b, cfg, return_trace=True)
            traces.append([achieved_bits(x, x_ref) for x in trace])
        mean = np.mean(np.asarray(traces), axis=0)
        for it, bits in enumerate(mean):
            out.append({"r_dac": r_dac, "loop_a_iter": it + 1,
                        "bits": round(float(bits), 2),
                        "cycles_inv": cfg.cycles_inv()})
    return out


def update_rows(fast: bool = False, device="cuda"):
    from repro_torch.lowp import update_parity

    rungs = ("int8b4", "hilo", "int8") if fast else LADDER
    out = []
    for p in rungs:
        r = update_parity(p, device=device)
        out.append({"precision": p,
                    "min_bits": round(r["min_bits"], 2),
                    "mean_bits": round(r["mean_bits"], 2)})
    return out


def trajectory_rows(fast: bool = False, device="cuda"):
    from repro_torch.lowp import trajectory_parity

    rungs = ("int8b4", "int8") if fast else LADDER
    steps = 3 if fast else 4
    out = []
    for p in rungs:
        r = trajectory_parity(p, steps=steps, device=device)
        for i, bits in enumerate(r["bits"]):
            out.append({"precision": p, "step": i + 1,
                        "bits": round(bits, 2),
                        "loss_fp32": round(r["loss_fp32"][i], 4),
                        "loss_lowp": round(r["loss_lowp"][i], 4)})
    return out


def serve_rows(fast: bool = False, device="cuda"):
    from repro_torch.lowp import serve_greedy_parity

    r = serve_greedy_parity(train_steps=25 if fast else 40, device=device)
    return [{
        "arch": r["arch"],
        "decided_matched": r["decided_matched"],
        "decided_total": r["decided_total"],
        "matched": r["matched"],
        "total": r["total"],
        "margin_floor": r["margin_floor"],
        "param_reduction": round(r["param_reduction"], 2),
        "pool_reduction": round(r["pool_reduction"], 2),
    }]


def headline(data):
    upd = {r["precision"]: r["min_bits"] for r in data["update"]}
    sv = data["serve"][0]
    rows = [{"name": "lowp_update_min_bits_int8",
             "value": upd.get("int8"), "paper": ">= 16 (Sec. III)"}]
    if "hilo" in upd:
        rows.append({"name": "lowp_update_min_bits_hilo",
                     "value": upd["hilo"], "paper": ">= 16"})
    rows.append({"name": "int8_serve_decided_greedy_match",
                 "value": f"{sv['decided_matched']}/"
                          f"{sv['decided_total']}",
                 "paper": "exact (weights+KV int8)"})
    rows.append({"name": "int8_serve_param_reduction",
                 "value": sv["param_reduction"],
                 "paper": "~4x dense-linear bytes"})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="fewer rungs/steps (CI tier-1 budget)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out", default=out_path("precision"))
    args = ap.parse_args(argv)
    resolve_device(args.device)

    data, walls = {}, {}
    for part, fn in (
            ("block", lambda: block_rows()),
            ("update", lambda: update_rows(args.fast, args.device)),
            ("trajectory", lambda: trajectory_rows(args.fast, args.device)),
            ("serve", lambda: serve_rows(args.fast, args.device))):
        t0 = time.monotonic()
        data[part] = fn()
        walls[f"{part}_wall_s"] = round(time.monotonic() - t0, 2)
        print_csv(f"precision_{part}", data[part])

    hl = headline(data)
    print_csv("precision_headline", hl)
    write_json(args.out, {"fast": args.fast, "device": args.device,
                          **walls, **data, "headline": hl})
    return data


if __name__ == "__main__":
    main()
