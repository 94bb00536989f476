"""Shared helpers for the benchmark modules (counterpart of
``benchmarks/common.py``, without jax)."""

from __future__ import annotations

import csv
import io
import json
import os
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


def finish() -> None:
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
    finish()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        finish()
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return res, best


def out_path(name: str) -> str:
    """A standalone module's default artifact: ``bench_out/BENCH_<name>.json``
    (the runner passes its own ``--out-dir``)."""
    return os.path.join("bench_out", f"BENCH_{name}.json")


def write_json(path: str, payload) -> None:
    """``payload`` as indented JSON at ``path``, its directory created."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def model_setup(arch: str, *, smoke: bool = True, device="cuda",
                seed: int = 0):
    """``(cfg, params)``: the smoke or published config of ``arch`` and its
    weights from ``seed`` on ``device`` (TF32 off, as every fp32 path of
    the port)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import fp32_matmuls, resolve_device

    device = resolve_device(str(device))
    fp32_matmuls()
    cfg = (get_smoke_config if smoke else get_config)(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, steps_mod.init_params(cfg, generator=gen, device=device)
