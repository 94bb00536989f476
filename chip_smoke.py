#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as a JSON line:
  1. card        nvidia-smi name and power limit, torch/CUDA versions;
                 TF32 off (the reference's fp32 products are full fp32)
  2. build       every CUDA kernel built from ``src/repro_torch/kernels/
                 csrc`` (one nvcc per source, all started together)
  3. kernels     each kernel against its plain PyTorch version on the
                 card at the main path's shapes, with its time (CUDA
                 events, warm, median of 5), the plain version's time,
                 one PyTorch call computing the same function, and the
                 least time the card could take (bound)
  4. main path   full-width qwen1.5-0.5b (24 layers, d 1024, d_ff 2816,
                 vocab 151936), K-FAC block 128, batch 8 x seq 256, four
                 steps with stats and inverse refresh every 2 steps,
                 through ``repro_torch.launch.train``; launch counters
                 zeroed just before and read just after
  5. checks      finite losses, every kernel launched on the main path,
                 the run's own inverses against the plain version on the
                 same factor blocks and against float64 torch.linalg.inv
                 (achieved bits); then the same four steps with
                 torch.linalg.inv as the INV method, for comparison

Then a JSON line of per-kernel results, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero
without the ``ok`` line; so does a machine without CUDA, or a directory
without the repository's ``src/repro_torch``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12

MAIN = dict(arch="qwen1.5-0.5b", batch=8, seq=256, steps=4, stats_every=2,
            inv_every=2, block_size=128, seed=0)
KFAC_COUNTS = dict(ns_iters=20, taylor_terms=4, refine_steps=2)
# a kernel agrees with its plain version when max|kernel - plain| is at
# most this share of max|plain| (rounding-level: the tensor cores sum the
# exact bf16 partial products in another order than the plain matmuls)
REL_TOL = 1e-4
# the same check on the main path's own factor blocks: these are far
# worse conditioned (condition numbers up to ~1e4 after damping, where
# 20 Newton-Schulz steps leave the iteration unconverged), and the
# iteration carries the rounding-level difference up with the
# conditioning; the achieved bits of kernel and plain version must
# still agree (checked separately)
REL_TOL_RUN = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, reps=5) -> float:
    """Median of ``reps`` warm runs, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the "
              f"repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    from repro_torch.configs import get_config
    from repro_torch.core import kfac, soi
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm
    from repro_torch.solve.partition import make_wu_plan

    failures = []

    def check(ok: bool, what: str):
        if not ok:
            failures.append(what)

    # 1. card -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    train_mod.fp32_matmuls()
    dev = torch.device("cuda", 0)
    emit({"phase": "card", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build ------------------------------------------------------------
    build_s = ops.build_all()
    emit({"phase": "build", "seconds": build_s,
          "ptxas": {name: [l.strip() for l in lib.build_log.splitlines()
                           if "registers" in l or "spill" in l]
                    for name, lib in ops.LIBRARIES.items()}})

    # the main path's shapes, from its own plan (shapes only)
    cfg = get_config(MAIN["arch"])
    bs = min(MAIN["block_size"], cfg.soi_block)
    specs = lm.kfac_specs(cfg)
    meta = {n: {s: torch.empty(shp, device="meta")
                for s, shp in soi.factor_shapes(sp, bs).items()}
            for n, sp in specs.items()}
    wu = make_wu_plan(specs, meta)
    nb_max = max(math.prod(t.shape[:-2]) for d in meta.values()
                 for t in d.values())
    (grp,) = wu.groups
    gen = torch.Generator(device=dev).manual_seed(MAIN["seed"])

    # 3. kernel checks ----------------------------------------------------
    results = {}
    n = bs
    m = torch.randn(nb_max, n, 2 * n, device=dev, generator=gen)
    a = m @ m.transpose(-1, -2) / (2 * n)
    lam = soi.tikhonov_damping(a, 0.03)
    eye = torch.eye(n, device=dev)
    got = ops.neumann_inv(a, lam, **KFAC_COUNTS)
    want = ref.neumann_inv_ref(a, lam, **KFAC_COUNTS)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    products = (5 * KFAC_COUNTS["ns_iters"]
                + 5 * (KFAC_COUNTS["taylor_terms"] - 1)
                + 6 * KFAC_COUNTS["refine_steps"])
    b_ms, b_by = bound(4.0 * (2 * nb_max * n * n + nb_max),
                       2.0 * n ** 3 * products * nb_max)
    results["neumann_inv"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/neumann_inv.cu",
        replaces="src/repro/kernels/neumann_inv.py:73",
        shape=[nb_max, n, n], max_abs_err=err, max_abs_plain=scale,
        tol=REL_TOL * scale,
        ms=time_ms(torch, lambda: ops.neumann_inv(a, lam, **KFAC_COUNTS)),
        plain_ms=time_ms(torch, lambda: ref.neumann_inv_ref(
            a, lam, **KFAC_COUNTS)),
        library_ms=time_ms(torch, lambda: torch.linalg.inv(
            a + lam[:, None, None] * eye)),
        bound_ms=b_ms, bound_by=b_by)
    check(err <= REL_TOL * scale, "neumann_inv kernel vs plain")
    del m, a, lam, got, want

    nt, bi, bo = grp.n_tiles, grp.bi, grp.bo
    a_inv = torch.randn(nt, bi, bi, device=dev, generator=gen)
    g = torch.randn(nt, bi, bo, device=dev, generator=gen)
    g_inv = torch.randn(nt, bo, bo, device=dev, generator=gen)
    out, dots = ops.fused_precond(a_inv, g, g_inv)
    p_out, p_dots = ref.fused_precond_ref(a_inv, g, g_inv)
    err = float((out - p_out).abs().max())
    scale = float(p_out.abs().max())
    d_err = float((dots - p_dots).abs().max())
    d_scale = float(p_dots.abs().max())
    del p_out, p_dots
    b_ms, b_by = bound(4.0 * nt * (bi * bi + 2 * bi * bo + bo * bo + 1),
                       2.0 * nt * 3 * (bi * bi * bo + bi * bo * bo))
    results["fused_precond"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/fused_precond.cu",
        replaces="src/repro/kernels/fused_precond.py:53",
        shape=[nt, bi, bo], max_abs_err=err, max_abs_plain=scale,
        tol=REL_TOL * scale, dots_max_abs_err=d_err,
        dots_max_abs_plain=d_scale,
        ms=time_ms(torch, lambda: ops.fused_precond(a_inv, g, g_inv)),
        plain_ms=time_ms(torch, lambda: ref.fused_precond_ref(
            a_inv, g, g_inv)),
        library_ms=time_ms(torch, lambda: torch.matmul(
            torch.matmul(a_inv, g), g_inv)),
        bound_ms=b_ms, bound_by=b_by)
    check(err <= REL_TOL * scale, "fused_precond kernel vs plain (out)")
    check(d_err <= REL_TOL * d_scale, "fused_precond kernel vs plain (dots)")
    del a_inv, g, g_inv, out, dots
    for name, r in results.items():
        emit({"phase": "kernel", "name": name, **r})
    torch.cuda.empty_cache()

    # 4. main path --------------------------------------------------------
    kcfg = kfac.KFACConfig(
        stats_every=MAIN["stats_every"], inv_every=MAIN["inv_every"],
        block_size=bs, stats_batch=MAIN["batch"], stats_seq=MAIN["seq"])
    program = train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                    device="cuda")
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=MAIN["seq"],
                         global_batch=MAIN["batch"], seed=MAIN["seed"])
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = train_mod.run(program, ds, MAIN["steps"])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    losses = [h["loss"] for h in history]
    emit({"phase": "main_path", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "block_size": bs, **{k: MAIN[k] for k in ("batch", "seq",
                                                    "steps")},
          "losses": losses, "phase_s": [h["phase_s"] for h in history],
          "wall_s": wall, "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "inv_blocks": wu.inv_plan.total_blocks,
          "wu_tiles": wu.total_tiles})
    check(all(math.isfinite(x) for x in losses), "finite losses")
    for name in ops.LIBRARIES:
        check(launches[name] > 0, f"{name} launched on the main path")

    # 5. the run's own inverses: kernel vs plain, and achieved bits -------
    def bits(x, ref64):
        e = float((x.double() - ref64).abs().max())
        return 64.0 if e == 0 else -math.log2(e / float(ref64.abs().max()))

    inv_report = []
    for name, d in state.kfac.factors.items():
        for side, f in d.items():
            flat = f.reshape(-1, f.shape[-1], f.shape[-1])
            lam = soi.tikhonov_damping(flat, kcfg.damping)
            mine = state.kfac.inverses[name][side + "_inv"].reshape(flat.shape)
            plain = ref.neumann_inv_ref(flat, lam, **KFAC_COUNTS)
            damped = flat.double() + lam.double()[:, None, None] \
                * torch.eye(flat.shape[-1], device=dev, dtype=torch.float64)
            exact = torch.linalg.inv(damped)
            ev = torch.linalg.eigvalsh(damped)
            err = float((mine - plain).abs().max())
            scale = float(plain.abs().max())
            row = dict(leaf=f"{name}/{side}", blocks=flat.shape[0],
                       max_cond=float((ev[:, -1] / ev[:, 0]).max()),
                       rel_err_vs_plain=err / scale,
                       bits_kernel=bits(mine, exact),
                       bits_plain=bits(plain, exact))
            inv_report.append(row)
            check(err <= REL_TOL_RUN * scale,
                  f"{row['leaf']} kernel vs plain")
            check(row["bits_kernel"] >= row["bits_plain"] - 1.0,
                  f"{row['leaf']} kernel as accurate as its plain version")
    emit({"phase": "inverse_checks", "leaves": inv_report,
          "min_bits_kernel": min(r["bits_kernel"] for r in inv_report),
          "min_bits_plain": min(r["bits_plain"] for r in inv_report)})

    # the same run with float64-accurate inverses (torch.linalg.inv),
    # to tell the composed inverse's share of the loss curve apart
    del state
    torch.cuda.empty_cache()
    exact_cfg = dataclasses.replace(kcfg, inv_method="exact")
    _, ex_hist = train_mod.run(
        train_mod.KFACProgram(cfg, exact_cfg, seed=MAIN["seed"],
                              device="cuda"), ds, MAIN["steps"])
    ex_losses = [h["loss"] for h in ex_hist]
    emit({"phase": "exact_inverse_run", "losses": ex_losses,
          "phase_s": [h["phase_s"] for h in ex_hist]})
    check(all(math.isfinite(x) for x in ex_losses),
          "finite losses with exact inverses")

    if failures:
        emit({"phase": "failed", "failures": failures})
        return 1
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [dict(name=name, launches=launches[name],
                           **{k: r[k] for k in keys})
                      for name, r in results.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
