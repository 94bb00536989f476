"""Continuous-batching engine vs static-batch serving throughput
(counterpart of ``benchmarks/serve_engine.py``).

Drives a synthetic mixed-length request trace (prompts and generation
budgets spread over a range, arrivals staggered so requests join and
finish mid-flight) through ``serve.ServeEngine``, then measures the
steady-state comparison at equal batch occupancy (all slots busy
against a static batch of the same size), decode tok/s of

* the engine's decode chunk (``decode_chunk`` tokens issued back to
  back with on-device sampling, one host read a chunk), against
* the warmed-up static path (``steps.make_decode_step`` called from
  Python once a token, greedy argmax on the device).

The chunk amortizes the per-token host round trip, so
``engine_tok_per_s >= static_tok_per_s`` is the expected outcome, which
:func:`main` asserts. Each timed window ends with a device synchronise
before its clock stops. Writes ``--out`` (default
``bench_out/BENCH_serve_engine.json``).

  python -m repro_torch.benchmarks.serve_engine [--arch qwen2-0.5b] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.benchmarks.common import (finish, model_setup, out_path,
                                           print_csv, write_json)

ARCH = "qwen2-0.5b"
MAX_SLOTS = 4
MAX_LEN = 96
PROMPT_LEN = 32
GEN = 16
DECODE_CHUNK = 8
STEADY_CHUNKS = 6


def _trace(cfg, n: int, seed: int = 0):
    from repro_torch.serve import synthetic_trace

    return synthetic_trace(cfg.vocab, n, PROMPT_LEN, GEN, MAX_SLOTS,
                           seed=seed)


@torch.no_grad()
def engine_rows(arch: str = ARCH, *, smoke: bool = True,
                device="cuda") -> List[Dict]:
    """Trace end-to-end + steady-state decode measurement."""
    from repro_torch.serve import EngineConfig, Request, ServeEngine

    cfg, params = model_setup(arch, smoke=smoke, device=device)
    ecfg = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN,
                        decode_chunk=DECODE_CHUNK)
    eng = ServeEngine(cfg, params, ecfg)

    # -- mixed-length trace end-to-end (correctness + occupancy churn) --
    reqs, arrivals = _trace(cfg, 3 * MAX_SLOTS)
    done = eng.run(reqs, arrivals=arrivals)
    assert len(done) == len(reqs)
    assert all(len(f.tokens) == r.max_new_tokens
               for r, f in ((r, done[r.rid]) for r in reqs))
    trace_row = {
        "case": "engine_trace",
        "requests": len(reqs),
        "tokens": sum(len(f.tokens) for f in done.values()),
        "decode_tok_per_s": eng.stats["decode_tokens"] /
        max(eng.stats["decode_s"], 1e-9),
    }

    # -- steady state: all slots occupied, timed chunks only -----------
    rng = np.random.default_rng(1)
    eng.reset_stats()
    for i in range(MAX_SLOTS):
        eng.submit(Request(
            100 + i, rng.integers(0, cfg.vocab,
                                  size=PROMPT_LEN).astype(np.int32),
            max_new_tokens=MAX_LEN - PROMPT_LEN))
    eng._do_admissions()
    eng.step()                       # warm the decode chunk
    finish()
    t0 = time.monotonic()
    for _ in range(STEADY_CHUNKS):
        eng.step()
    finish()
    dt = time.monotonic() - t0
    tokens = MAX_SLOTS * DECODE_CHUNK * STEADY_CHUNKS
    return [trace_row, {
        "case": "engine_steady",
        "batch": MAX_SLOTS,
        "tokens": tokens,
        "decode_tok_per_s": tokens / dt,
    }]


@torch.no_grad()
def static_row(arch: str = ARCH, *, smoke: bool = True,
               device="cuda") -> Dict:
    """Warmed-up per-token dispatch at the same batch occupancy."""
    from repro_torch.launch import steps as steps_mod

    cfg, params = model_setup(arch, smoke=smoke, device=device)
    dev = next(iter(params.values())).device
    mod = steps_mod.model_module(cfg)
    b = MAX_SLOTS
    rng = np.random.default_rng(2)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(b, PROMPT_LEN)).astype(np.int32)).to(dev)
    cache = mod.init_cache(cfg, b, MAX_LEN, device=dev)
    decode = steps_mod.make_decode_step(cfg)
    logits, cache = steps_mod.make_prefill_step(cfg)(
        params, {"tokens": prompts}, cache)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    for _ in range(3):               # warm the decode step
        logits, cache = decode(params, tok, cache)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    steps = DECODE_CHUNK * STEADY_CHUNKS
    finish()
    t0 = time.monotonic()
    for _ in range(steps):
        logits, cache = decode(params, tok, cache)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    finish()
    dt = time.monotonic() - t0
    return {"case": "static_steady", "batch": b, "tokens": b * steps,
            "decode_tok_per_s": b * steps / dt}


def rows(arch: str = ARCH, *, smoke: bool = True,
         device="cuda") -> List[Dict]:
    out = engine_rows(arch, smoke=smoke, device=device)
    out.append(static_row(arch, smoke=smoke, device=device))
    eng = next(r for r in out if r["case"] == "engine_steady")
    st = next(r for r in out if r["case"] == "static_steady")
    out.append({
        "case": "speedup_engine_vs_static",
        "decode_tok_per_s": eng["decode_tok_per_s"] /
        max(st["decode_tok_per_s"], 1e-9),
    })
    return out


def speedup(r: List[Dict]) -> float:
    """The engine's steady decode tok/s over the static path's."""
    return next(x for x in r if x["case"] ==
                "speedup_engine_vs_static")["decode_tok_per_s"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out", default=out_path("serve_engine"))
    args = ap.parse_args(argv)
    r = rows(args.arch, device=args.device)
    print_csv("serve_engine", r)
    write_json(args.out, {"device": args.device, "rows": r})
    assert speedup(r) >= 1.0, (
        "continuous-batching engine slower than the static baseline at "
        f"equal occupancy: {speedup(r):.2f}x")
    return r


if __name__ == "__main__":
    main()
