"""Benchmark runner: one module per paper table or figure (counterpart of
``benchmarks/run.py``).

  python -m repro_torch.benchmarks.run                # on the card
  python -m repro_torch.benchmarks.run --fast         # no LM probe,
                                                      # shorter sweeps
  python -m repro_torch.benchmarks.run --device cpu   # plain versions

``--device`` defaults to ``cuda`` and raises when CUDA is not available;
it never falls back to the CPU. Prints each table as CSV, then the
reproduction scorecard under the reference's contract:

* every module of the reference's runner has exactly ONE status row,
  ``{"metric": <module>, "status": ok|failed|skipped, "note": ...}``,
  under the reference's name, in both modes; a module not yet ported is
  ``skipped`` and its note names the ROADMAP item that ports it;
* headline value rows (``paper`` against ``ours``) follow for the
  modules that ran and have a ``headline()``.

A module that raises is ``failed``, its note the exception (the
time guards of ``wu_fusion``, ``serve_engine`` and ``obs_overhead`` are
asserts in their ``main()``, as in the reference).

Every file the runner writes goes under ``--out-dir`` (default
``bench_out/``): the device-measured modules' rows as
``BENCH_<module>.json``, and ``BENCH_summary.json``, one row per
``BENCH_*.json`` there with the median of its wall-time metrics (keys
containing ``wall`` or spelled ``ms_*``/``*_ms``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
import time
import traceback

from repro_torch.benchmarks.common import print_csv

SUMMARY_SCHEMA = 1

#: the reference's modules not yet ported -> the ROADMAP item porting them
UNPORTED = {
    "dist_inverse": "8", "pipeline_bench": "8",
    "grad_compression_dcn": "8",
    "roofline": "9b",
}


def _wall_values(obj, key=""):
    """Every numeric leaf whose key names a wall time, recursively."""
    vals = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            vals.extend(_wall_values(v, k))
    elif isinstance(obj, list):
        for v in obj:
            vals.extend(_wall_values(v, key))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        k = key.lower()
        if "wall" in k or k.startswith("ms_") or k.endswith("_ms"):
            vals.append(float(obj))
    return vals


def summary_rows(directory):
    """One row per BENCH_*.json artifact in ``directory`` (stable schema:
    benchmark, file, status, n_wall_metrics, wall_ms_median)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(directory,
                                              "BENCH_*.json"))):
        fname = os.path.basename(path)
        name = fname[len("BENCH_"):-len(".json")]
        if name == "summary":
            continue
        row = {"benchmark": name, "file": fname,
               "n_wall_metrics": 0, "wall_ms_median": None}
        try:
            with open(path) as f:
                walls = _wall_values(json.load(f))
        except (OSError, ValueError):
            row["status"] = "unreadable"
        else:
            row["status"] = "ok"
            row["n_wall_metrics"] = len(walls)
            if walls:
                row["wall_ms_median"] = round(
                    statistics.median(walls), 3)
        rows.append(row)
    return rows


def write_summary(directory):
    rows = summary_rows(directory)
    out = {"schema": SUMMARY_SCHEMA,
           "generated_by": "repro_torch.benchmarks.run", "rows": rows}
    with open(os.path.join(directory, "BENCH_summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="skip the LM probe of sec6c_kfac_convergence; "
                         "the --fast sweeps of obs_overhead, serve_scale "
                         "and precision_ladder")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out-dir", default="bench_out")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    from repro_torch.benchmarks import (
        area,
        dse,
        energy,
        inv_convergence,
        kernel_bench,
        kfac_convergence,
        mapping_impact,
        obs_overhead,
        precision_ladder,
        serve_engine,
        serve_scale,
        soi_precision,
        soi_sizes,
        speedup,
        wu_fusion,
    )

    scorecard = []
    failures = 0

    def run(name, fn, *, skip=None, note=""):
        nonlocal failures
        if skip:
            print(f"# [{name}] SKIPPED: {skip}\n")
            scorecard.append({"metric": name, "status": "skipped",
                              "note": skip})
            return
        t0 = time.monotonic()
        try:
            fn()
            print(f"# [{name}] done in {time.monotonic() - t0:.1f}s\n")
            scorecard.append({"metric": name, "status": "ok",
                              "note": note})
        except Exception as e:
            failures += 1
            print(f"# [{name}] FAILED:\n{traceback.format_exc()}\n")
            scorecard.append({"metric": name, "status": "failed",
                              "note": f"{type(e).__name__}: {e}"})

    def score(entries):
        if isinstance(entries, dict):
            entries = [entries]
        for e in entries:
            e.setdefault("status", "ok")
        scorecard.extend(entries)

    def measured(name, rows):
        print_csv(name, rows)
        with open(os.path.join(args.out_dir, f"BENCH_{name}.json"),
                  "w") as f:
            json.dump({"device": str(device), "rows": rows}, f, indent=1)

    def unported(name):
        run(name, None, skip=f"not ported yet: ROADMAP Queue 1 item "
                             f"{UNPORTED[name]}")

    run("table1_soi_sizes", soi_sizes.main)
    run("table2_area", area.main)
    score(area.headline())
    run("fig3_soi_precision", soi_precision.main)
    run("fig4b_inv_convergence", inv_convergence.main)
    score(inv_convergence.headline())
    run("fig10_dse", dse.main)
    score(dse.headline())
    run("fig11_speedup", speedup.main)
    score(speedup.headline())
    run("fig12_energy", energy.main)
    score(energy.headline())
    run("fig13_mapping", mapping_impact.main)
    score(mapping_impact.headline())
    run("kernel_bench", lambda: measured(
        "kernel_bench", kernel_bench.rows(device=device)))
    dev = ["--device", str(device)]
    fast = ["--fast"] if args.fast else []

    def out(name):
        return ["--out", os.path.join(args.out_dir, f"BENCH_{name}.json")]

    # fused vs per-leaf WU; BENCH_wu_fusion.json
    run("wu_fusion", lambda: wu_fusion.main(dev + out("wu_fusion")))
    # continuous-batching engine vs static decode
    run("serve_engine", lambda: serve_engine.main(
        dev + out("serve_engine")))
    # the telemetry spine's overhead on the train-step and decode-chunk
    # hot paths (interleaved paired medians, <= 2% budget); BENCH_obs.json
    run("obs_overhead", lambda: obs_overhead.main(fast + dev + out("obs")))
    # the paged pool and the prefix cache against the slot pool at equal
    # cache bytes
    run("serve_scale", lambda: score(serve_scale.headline(
        serve_scale.main(fast + dev + out("serve_scale")))))
    # the precision ladder (Fig. 4(b) -> full trajectories and int8
    # serving); --fast drops the int4b4/int16b4 rungs and shortens the
    # trajectories
    run("precision_ladder", lambda: score(precision_ladder.headline(
        precision_ladder.main(fast + dev + out("precision")))))
    for name in ("dist_inverse", "pipeline_bench", "grad_compression_dcn"):
        unported(name)
    run("sec6c_kfac_convergence", lambda: measured(
        "kfac_convergence", kfac_convergence.rows(fast=args.fast,
                                                  device=device)),
        note="quadratic probe only (--fast)" if args.fast else "")
    unported("roofline")

    print_csv("reproduction_scorecard", [
        {k: str(v) for k, v in e.items()} for e in scorecard])
    print_csv("bench_summary", [
        {k: str(v) for k, v in r.items()}
        for r in write_summary(args.out_dir)])
    return failures


if __name__ == "__main__":
    sys.exit(main())
