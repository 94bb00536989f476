"""Telemetry overhead: instrumented vs bare hot paths (<= 2% budget)
(counterpart of ``benchmarks/obs_overhead.py``).

The obs spine promises its hooks are cheap enough to leave on in
production: per step or chunk the instrumented path adds one host-side
span (two ``perf_counter`` calls and a list append), a couple of counter
increments, and a ``TapBuffer.push`` (a list append of device tensors,
no synchronise); the batched transfer and the JSONL writes happen once
per ``LOG_EVERY`` window. This module measures both hot paths:

* **train-step**: the first-order step (``steps.make_sgd_step``) in a
  loop body shaped like ``TrainLoop.run``: the obs variant wraps each
  step in ``obs.span``, counts it, pushes the metrics, and drains (one
  batched transfer, per-row JSONL and gauge writes) every LOG_EVERY;
  both variants synchronise the device before the clock stops;
* **decode-chunk**: two ``ServeEngine``s on shared weights and an
  identical request load at full occupancy, one carrying a live
  ``Observability`` (latency histograms, token counters, queue and
  occupancy gauges per chunk), one on the NULL sink; a chunk's host
  read synchronises.

Both are timed as interleaved paired rounds in ABBA order, and
:func:`main` asserts on the paired-difference median, with a small
absolute floor (ABS_FLOOR_US) for sub-millisecond steps. The bare
variant discards its metrics unread, a stricter baseline than a loop
that reads them, so the delta overstates the cost of ``--obs``. Writes
``--out`` (default ``bench_out/BENCH_obs.json``).

  python -m repro_torch.benchmarks.obs_overhead [--fast] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import (finish, model_setup, out_path,
                                           print_csv, write_json)

TRAIN_ARCH = "qwen1.5-0.5b"
SERVE_ARCH = "qwen2-0.5b"
BATCH, SEQ = 4, 32
LOG_EVERY = 10
MAX_SLOTS = 4
MAX_LEN = 256
PROMPT_LEN = 32
DECODE_CHUNK = 8

OVERHEAD_BUDGET = 0.02               # the acceptance criterion's 2%
ABS_FLOOR_US = 100.0                 # scheduler-jitter floor per round
REPS = (60, 20)                      # paired rounds: train step, chunk
FAST_REPS = (20, 8)                  # the same under --fast


def _paired(off_us: List[float], obs_us: List[float]) -> Dict:
    off = float(np.median(off_us))
    obs = float(np.median(obs_us))
    diffs = np.asarray(obs_us) - np.asarray(off_us)
    return {
        "off_us_med": round(off, 1),
        "obs_us_med": round(obs, 1),
        "overhead_frac": round((obs - off) / max(off, 1e-9), 4),
        "paired_diff_med_us": round(float(np.median(diffs)), 1),
        "obs_loses_frac": round(float(np.mean(diffs > 0)), 2),
    }


# ---------------------------------------------------------------------------
# train-step path
# ---------------------------------------------------------------------------

def train_row(reps: int, out_dir: str, *, smoke: bool = True,
              device="cuda") -> Dict:
    from repro_torch.launch import steps as steps_mod
    from repro_torch.obs import Observability, TapBuffer

    cfg, params = model_setup(TRAIN_ARCH, smoke=smoke, device=device)
    dev = next(iter(params.values())).device
    state = (params, {k: torch.zeros_like(v) for k, v in params.items()})
    step = steps_mod.make_sgd_step(cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(BATCH, SEQ)).astype(np.int32)).to(dev)}

    obs = Observability(out_dir=out_dir)
    taps = TapBuffer()
    c_steps = obs.counter("train_steps_total")

    # both variants share one step function and one evolving state: the
    # comparison isolates the host-side instrumentation
    state = step(state, batch)[0]
    finish()

    def bare(i, st):
        st, m = step(st, batch)
        finish()
        return st

    def instrumented(i, st):
        with obs.span("train_step", args={"step": i}):
            st, m = step(st, batch)
            finish()
        c_steps.inc()
        taps.push(i, m)
        if i % LOG_EVERY == 0:
            for tag, row in taps.drain():
                obs.write({"kind": "train_step", "step": tag, **row})
                for k, v in row.items():
                    obs.gauge(f"train_{k}").set(v)
        return st

    # ABBA alternation: whichever variant runs second in a round sees
    # a warmer allocator/cache — fixed order folds that into the diff
    off_us, obs_us = [], []
    for i in range(reps):
        order = ((bare, off_us), (instrumented, obs_us))
        if i % 2:
            order = order[::-1]
        for fn, sink in order:
            t0 = time.perf_counter()
            state = fn(i, state)
            sink.append((time.perf_counter() - t0) * 1e6)
    taps.drain()
    obs.close()
    return {"case": "train_step", "reps": reps,
            **_paired(off_us, obs_us)}


# ---------------------------------------------------------------------------
# decode-chunk path
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_row(reps: int, out_dir: str, *, smoke: bool = True,
               device="cuda") -> Dict:
    from repro_torch.obs import Observability
    from repro_torch.serve import EngineConfig, Request, ServeEngine

    cfg, params = model_setup(SERVE_ARCH, smoke=smoke, device=device)
    ecfg = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN,
                        decode_chunk=DECODE_CHUNK)
    obs = Observability(out_dir=out_dir)
    engines = {"off": ServeEngine(cfg, params, ecfg),
               "obs": ServeEngine(cfg, params, ecfg, obs=obs)}

    rng = np.random.default_rng(1)
    gen = MAX_LEN - PROMPT_LEN       # enough chunks to never refill
    assert reps + 2 <= gen // DECODE_CHUNK, "raise MAX_LEN for reps"
    for eng in engines.values():
        for i in range(MAX_SLOTS):
            eng.submit(Request(
                100 + i,
                rng.integers(0, cfg.vocab,
                             size=PROMPT_LEN).astype(np.int32),
                max_new_tokens=gen))
        eng._do_admissions()
        eng.step()                   # warm the chunk

    walls = {"off": [], "obs": []}
    for i in range(reps):
        tags = ("off", "obs") if i % 2 == 0 else ("obs", "off")
        for tag in tags:
            t0 = time.perf_counter()
            engines[tag].step()      # synchronises: the chunk's host read
            walls[tag].append((time.perf_counter() - t0) * 1e6)
    obs.close()
    return {"case": "decode_chunk", "reps": reps,
            **_paired(walls["off"], walls["obs"])}


def rows(reps_train: int, reps_decode: int, *, smoke: bool = True,
         device="cuda", out_dir: Optional[str] = None) -> List[Dict]:
    """Both rows; the obs variants write their JSONL under ``out_dir``
    (``train/`` and ``serve/``), by default a temporary directory."""
    with tempfile.TemporaryDirectory() as td:
        root = out_dir or td
        return [train_row(reps_train, os.path.join(root, "train"),
                          smoke=smoke, device=device),
                decode_row(reps_decode, os.path.join(root, "serve"),
                           smoke=smoke, device=device)]


def budget_us(row: Dict) -> float:
    """The overhead a row may show: 2% of the bare median, or the
    absolute floor."""
    return max(OVERHEAD_BUDGET * row["off_us_med"], ABS_FLOOR_US)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out", default=out_path("obs"))
    args = ap.parse_args(argv)
    reps_train, reps_decode = FAST_REPS if args.fast else REPS
    r = rows(reps_train, reps_decode, device=args.device)
    print_csv("obs_overhead", r)
    write_json(args.out, {"schema": 1, "device": args.device,
                          "budget_frac": OVERHEAD_BUDGET, "rows": r})
    for row in r:
        assert row["paired_diff_med_us"] <= budget_us(row), (
            f"{row['case']}: instrumentation overhead "
            f"{row['paired_diff_med_us']:.0f}us (paired median) exceeds "
            f"{budget_us(row):.0f}us budget (off={row['off_us_med']:.0f}us)")
    return r


if __name__ == "__main__":
    main()
