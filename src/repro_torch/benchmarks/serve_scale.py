"""Serving scale: slot pool vs block-paged pool vs paged + prefix cache
(counterpart of ``benchmarks/serve_scale.py``).

The slot engine sizes its KV pool for the worst case: every slot owns
``max_len`` columns whether the resident request uses them or not. The
block-paged pool (``serve.paged``) allocates the *same column budget*
as physical blocks shared by all slots, so short requests stop paying
for long-request headroom and far more sessions fit the same bytes.
The shared-prefix cache then removes repeated prompt-prefix compute on
top.

Three engines at one fixed KV byte budget (``POOL_COLUMNS`` cache
columns):

* ``slot``  — ServeEngine, ``max_slots = POOL_COLUMNS / max_len``;
* ``paged`` — PagedServeEngine, ``n_blocks = POOL_COLUMNS /
  block_len``, slot count raised until blocks (not slots) are the
  binding resource;
* ``paged+prefix`` — same, with the content-addressed prefix store on
  a repeated-system-prompt trace.

Measured per engine: generated tok/s (the trace's wall, ended by a
device synchronise), p99 TTFT, peak concurrent sessions, prefill
tokens, KV pool bytes. Asserted (counts, not times):

* the paged pool holds no more cache bytes than the slot pool (int32
  block tables aside);
* the paged pool sustains >= 4x the slot engine's concurrent sessions
  at equal cache bytes;
* the prefix cache cuts repeated-system-prompt prefill tokens >= 2x.

Writes ``--out`` (default ``bench_out/BENCH_serve_scale.json``).
``--fast`` trims the trace.

  python -m repro_torch.benchmarks.serve_scale [--fast] [--device cuda|cpu]
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
MAX_LEN = 64            # columns a single session may need
BLOCK_LEN = 16
POOL_COLUMNS = 128      # the shared KV byte budget: 2 slot-rows
PROMPT_LEN = 4          # typical request footprint: 1 block...
GEN = 12                # ...held across several decode chunks
SYS_LEN = 32            # repeated system prompt (prefix trace)
SFX_LEN = 6
PFX_GEN = 4


def _short_trace(cfg, n: int, seed: int = 0):
    """n short requests, all offered at step 0 — the concurrency
    probe: every request fits one block."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab,
                                    PROMPT_LEN).astype(np.int32),
                    max_new_tokens=GEN) for i in range(n)]
    return reqs, [0] * n


def _prefix_trace(cfg, n: int, seed: int = 3):
    """n requests sharing one SYS_LEN-token system prompt, staggered
    two per step."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, cfg.vocab, SYS_LEN).astype(np.int32)
    reqs = [Request(i, np.concatenate(
        [sys_p, rng.integers(0, cfg.vocab, SFX_LEN).astype(np.int32)]),
        max_new_tokens=PFX_GEN) for i in range(n)]
    return reqs, [i // 2 for i in range(n)]


def _drive(eng, reqs, arrivals) -> Dict:
    """Run a trace step-by-step, tracking peak concurrency and wall
    time; p99 TTFT comes from the engine's own per-request clock."""
    pending = sorted(zip(arrivals, range(len(reqs))))
    done, peak, step_i = {}, 0, 0
    finish()
    t0 = time.monotonic()
    while pending or eng.scheduler.n_queued or eng._slots:
        while pending and pending[0][0] <= step_i:
            _, i = pending.pop(0)
            eng.submit(reqs[i])
        for fin in eng.step():
            done[fin.rid] = fin
        peak = max(peak, eng.n_active)
        step_i += 1
        if step_i > 10_000:
            raise RuntimeError("trace did not drain")
    finish()
    wall = time.monotonic() - t0
    assert len(done) == len(reqs)
    ttft = np.asarray([done[r.rid].ttft_s for r in reqs])
    n_tok = sum(len(f.tokens) for f in done.values())
    return {
        "requests": len(reqs),
        "peak_sessions": peak,
        "tok_per_s": round(n_tok / max(wall, 1e-9), 1),
        "p99_ttft_s": round(float(np.percentile(ttft, 99)), 4),
        "prefill_tokens": eng.stats["prefill_tokens"],
        "kv_bytes": eng.resident_bytes()["pool"],
    }


def _slot_engine(cfg, params):
    from repro_torch.serve import EngineConfig, ServeEngine

    return ServeEngine(cfg, params, EngineConfig(
        max_slots=POOL_COLUMNS // MAX_LEN, max_len=MAX_LEN,
        decode_chunk=4))


def _paged_engine(cfg, params, max_slots: int, prefix: bool = False):
    from repro_torch.serve import PagedConfig, PagedServeEngine

    return PagedServeEngine(cfg, params, PagedConfig(
        max_slots=max_slots, max_len=MAX_LEN, decode_chunk=4,
        block_len=BLOCK_LEN, n_blocks=POOL_COLUMNS // BLOCK_LEN,
        prefix_cache=prefix))


@torch.no_grad()
def rows(fast: bool = False, *, smoke: bool = True,
         device="cuda") -> List[Dict]:
    cfg, params = model_setup(ARCH, smoke=smoke, device=device)
    out: List[Dict] = []
    n = POOL_COLUMNS // BLOCK_LEN          # one wave fills the pool
    waves = 1 if fast else 3

    # -- concurrency at equal cache bytes: slot vs paged ---------------
    reqs, arr = _short_trace(cfg, waves * n)
    slot = _slot_engine(cfg, params)
    r = _drive(slot, reqs, arr)
    out.append({"case": "slot", **r})
    paged = _paged_engine(cfg, params, max_slots=n)
    r = _drive(paged, reqs, arr)
    out.append({"case": "paged", **r})
    # same cache columns; the paged pool adds only int32 block-table
    # bookkeeping (a few hundred bytes)
    assert out[-1]["kv_bytes"] <= out[-2]["kv_bytes"] + 4096, (
        "paged pool must not exceed the slot engine's cache bytes")
    gain = out[-1]["peak_sessions"] / max(out[-2]["peak_sessions"], 1)
    out.append({"case": "sessions_paged_vs_slot",
                "peak_sessions": round(gain, 2)})
    assert gain >= 4, (
        f"paged pool served only {gain:.1f}x the slot engine's "
        "concurrent sessions at equal cache bytes (floor: 4x)")

    # -- repeated-system-prompt prefill: prefix cache on top -----------
    n_pfx = 6 if fast else 12
    reqs, arr = _prefix_trace(cfg, n_pfx)
    base = _paged_engine(cfg, params, max_slots=2)
    r = _drive(base, reqs, arr)
    out.append({"case": "paged_noprefix", **r})
    pfx = _paged_engine(cfg, params, max_slots=2, prefix=True)
    r = _drive(pfx, reqs, arr)
    out.append({"case": "paged_prefix", **r,
                "prefix_hits": pfx.stats["prefix_hits"]})
    cut = out[-2]["prefill_tokens"] / max(out[-1]["prefill_tokens"], 1)
    out.append({"case": "prefill_cut_prefix",
                "prefill_tokens": round(cut, 2)})
    assert cut >= 2, (
        f"prefix cache cut repeated-prompt prefill only {cut:.1f}x "
        "(floor: 2x)")
    return out


def headline(r: List[Dict]) -> List[Dict]:
    gain = next(x for x in r if x["case"] == "sessions_paged_vs_slot")
    cut = next(x for x in r if x["case"] == "prefill_cut_prefix")
    return [
        {"metric": "serve_sessions_paged_vs_slot", "paper": ">=4x",
         "ours": f"{gain['peak_sessions']:.1f}x"},
        {"metric": "serve_prefill_cut_prefix", "paper": ">=2x",
         "ours": f"{cut['prefill_tokens']:.1f}x"},
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="single-wave trace (CI)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out", default=out_path("serve_scale"))
    args = ap.parse_args(argv)
    r = rows(fast=args.fast, device=args.device)
    print_csv("serve_scale", r)
    write_json(args.out, {"device": args.device, "cases": r})
    print(f"# wrote {args.out}")
    return r


if __name__ == "__main__":
    main()
