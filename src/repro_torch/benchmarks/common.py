"""Shared helpers for the benchmark modules (counterpart of
``benchmarks/common.py``, without jax)."""

from __future__ import annotations

import csv
import io
import time
from typing import Callable, Dict, List

import torch


def print_csv(name: str, rows: List[Dict]) -> str:
    if not rows:
        print(f"# {name}: no rows")
        return ""
    fields: List[str] = []
    for r in rows:
        for k in r:
            if k not in fields:
                fields.append(k)
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=fields, restval="")
    w.writeheader()
    for r in rows:
        w.writerow(r)
    out = buf.getvalue()
    print(f"# --- {name} ---")
    print(out, end="")
    return out


def _finish() -> None:
    """Wait for the card's queued work (a CUDA launch returns before its
    kernel has run); nothing to wait for on the CPU."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, n: int = 3, **kw):
    """(result, best_us_per_call), measured to completion: the device is
    synchronised before the clock stops. One untimed warm-up call keeps
    first-use costs (a kernel's build and load) off the clock; best of
    ``n`` follows."""
    res = fn(*args, **kw)
    _finish()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        _finish()
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return res, best
