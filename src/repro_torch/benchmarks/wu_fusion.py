"""WU-graph fusion: pooled fused vs per-leaf precondition + update
(counterpart of ``benchmarks/wu_fusion.py``, its local sweep).

The paper's mapping scheme fuses the VMM and INV crossbars so SOI
inverses feed the weight-update VMMs directly (Sec. V). The port's
analogue (``kfac.apply_updates(wu_plan=...)``) pools same-geometry
factored gradient tiles into batched two-sided block products, in
place of the per-leaf loop. Per arch this measures:

  * WU-step wall time, median of ``REPS`` *interleaved paired* rounds
    (per_leaf, fused, ... per round, so load drift biases no variant),
    the device synchronised before each clock stops (a CUDA launch
    returns before its kernel has run), with the signed per-round
    ``per_leaf - fused`` median and the fused win fraction;
  * counts from ``torch.profiler`` runs of each variant, outside the
    timed rounds, all from the host's records. They replace the
    reference's XLA columns (``jaxpr_eqns``, and ``hlo_ops``/``hlo_dots``
    of the optimized HLO), which have no meaning in eager PyTorch:
    ``aten_ops``, the ATen calls; ``kernels``, the kernel launch API
    calls (``*LaunchKernel*``; on the card only, None on the CPU), one a
    kernel the executed program launches, which is what ``hlo_ops``
    counted; ``gemms``, the ATen product calls (``aten::mm``/``bmm``/
    ``addmm``/``baddbmm``) plus, on the card, the port's
    ``fused_precond`` launches: calls, not the GEMM kernels a call
    launches;
  * optimizer-state bytes: per-path moments (momentum on factored
    leaves, Adam mu/nu on the others) against the legacy 3x layout.

:func:`main` asserts, as the reference: ``fused`` and ``fused+ew_pool``
bitwise ``per_leaf``; strictly fewer ``gemms`` fused than per leaf on
the asserted archs (the reference's ``hlo_dots`` assert, the
paper-level VMM⊕INV fusion claim); and the paired wall guard
(``diff >= -0.15 * per_leaf``). ``kernels`` is recorded, not asserted:
eager PyTorch has no XLA fusion, and the pool's gathers and scatters
launch copies. ``fused+ew_pool`` (concatenated elementwise chains) is
recorded unasserted, as in the reference, and so is ``fused+kernel``,
the trainer's route on the card (``use_kernel=True``: the
``fused_precond`` kernel, its plain hi/lo version on the CPU), whose
largest per-leaf deviation of the new momentum (the clipped
preconditioned direction) from ``per_leaf``'s, relative to that
leaf's largest entry, is reported beside ``KERNEL_TOL``.

``--dist`` (the reference's forced-4-device INV→VMM dataflow
comparison, ``solve/fused_wu.py`` on a mesh) waits for the multi-GPU
port and raises.

  python -m repro_torch.benchmarks.wu_fusion [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import (finish, model_setup, out_path,
                                           print_csv, write_json)

ARCHS = ("qwen1.5-0.5b", "qwen2-0.5b")
EXTRA_ARCHS = ("moonshot-v1-16b-a3b",)    # recorded, not asserted
BLOCK_SIZE = 16
REPS = 51
#: ``fused+kernel``'s momentum against ``per_leaf``'s, relative to each
#: factored leaf's largest entry: the bound tests/test_torch_kernels.py
#: puts on fused_precond against the exact two-sided product
KERNEL_TOL = 1e-4
PRODUCTS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"}


def _median_us_interleaved(fns: dict, *args, n: int):
    """Median wall per variant with the variants' reps interleaved
    (A B C A B C ...), each call synchronised to completion before the
    clock stops; also the signed per-round ``per_leaf - fused``
    paired differences."""
    for fn in fns.values():
        fn(*args)                      # first-use costs off the clock
    finish()
    ts = {tag: [] for tag in fns}
    for _ in range(n):
        for tag, fn in fns.items():
            t0 = time.perf_counter()
            fn(*args)
            finish()
            ts[tag].append((time.perf_counter() - t0) * 1e6)
    diffs = np.asarray(ts["per_leaf"]) - np.asarray(ts["fused"])
    return ({tag: float(np.median(v)) for tag, v in ts.items()},
            {"paired_diff_med_us": round(float(np.median(diffs)), 1),
             "fused_win_frac": round(float(np.mean(diffs > 0)), 2)})


def _op_counts(fn, *args, device) -> dict:
    """``aten_ops``, ``kernels`` and ``gemms`` of profiled calls, from the
    host's records only: the ATen calls of a host-only profile; the
    kernel launches (the ``*LaunchKernel*`` API calls) of a device
    profile; the product calls as ATen ``mm``/``bmm``/``addmm``/
    ``baddbmm`` plus the port's ``fused_precond`` launches. (The
    device-side kernel records are not counted: once the process is
    minutes old the profiler loses some of them; on an H100, 420 s in,
    the kernels of the first 17 of 50 products of a call.)"""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    def events(activity):
        finish()
        with profile(activities=[activity]) as prof:
            fn(*args)
            finish()
        return prof.events()

    host = events(ProfilerActivity.CPU)
    aten = sum(1 for e in host if e.name.startswith("aten::"))
    gemms = sum(1 for e in host if e.name in PRODUCTS)
    if device.type != "cuda":
        return {"aten_ops": aten, "kernels": None, "gemms": gemms}
    before = ops.launch_counts()["fused_precond"]
    launches = sum(1 for e in events(ProfilerActivity.CUDA)
                   if "LaunchKernel" in e.name)
    return {"aten_ops": aten, "kernels": launches,
            "gemms": gemms + ops.launch_counts()["fused_precond"] - before}


def _wu_case(arch: str, *, smoke: bool = True,
             block_size: int = BLOCK_SIZE, device="cuda", reps=None):
    """One arch: the four variants from one state, their walls (``reps``
    paired rounds, default :data:`REPS`), counts, bitwise flags and the
    kernel route's deviation. ``smoke=False`` takes the published config
    (the card's full width)."""
    from repro_torch.core import kfac
    from repro_torch.core.kfac import KFACConfig
    from repro_torch.launch import steps as steps_mod

    cfg, params = model_setup(arch, smoke=smoke, device=device)
    device = next(iter(params.values())).device
    kcfg = KFACConfig(block_size=block_size, ns_iters=6,
                      taylor_terms=2, refine_steps=1)
    specs = steps_mod.kfac_specs(cfg)
    state = kfac.init(params, specs, kcfg)
    r = np.random.default_rng(0)

    def spd(x):
        bs = x.shape[-1]
        a = torch.from_numpy(r.standard_normal(
            tuple(x.shape[:-1]) + (2 * bs,), dtype=np.float32)).to(device)
        return a @ a.mT / (2 * bs)

    state = dataclasses.replace(state, factors={
        n: {s: spd(f) for s, f in d.items()}
        for n, d in state.factors.items()})
    state = kfac.refresh_inverses(state, kcfg)
    grads = {k: torch.from_numpy(r.standard_normal(
        tuple(p.shape), dtype=np.float32)).to(device)
        for k, p in params.items()}
    wu_plan = steps_mod.make_wu_plan_for(
        cfg, steps_mod.TrainState(params, state))

    def variant(**kw):
        return lambda p, g, s: kfac.apply_updates(p, g, s, specs, kcfg,
                                                  **kw)

    variants = {
        "per_leaf": variant(),
        "fused": variant(wu_plan=wu_plan),
        "fused+ew_pool": variant(wu_plan=wu_plan, pool_elementwise=True),
        "fused+kernel": variant(wu_plan=wu_plan, use_kernel=True),
    }
    with torch.no_grad():
        walls, paired = _median_us_interleaved(variants, params, grads,
                                               state, n=reps or REPS)
        out, params_out, moms = {}, {}, {}
        for tag, fn in variants.items():
            params_out[tag], st = fn(params, grads, state)
            moms[tag] = st.momentum
            out[tag] = {"wall_ms": round(walls[tag] / 1e3, 3),
                        **_op_counts(fn, params, grads, state,
                                     device=device)}
    ref = params_out["per_leaf"]
    bitwise = {tag: all(torch.equal(ref[k], params_out[tag][k])
                        for k in ref)
               for tag in ("fused", "fused+ew_pool")}
    # the kernel's direction, read from the fresh momentum (d * nu):
    # the parameters themselves round the small clipped update away
    kern, want = moms["fused+kernel"], moms["per_leaf"]
    kernel_err = max(float((kern[k] - want[k]).abs().max()
                           / want[k].abs().max()) for k in want)

    p_bytes = sum(x.numel() * x.element_size() for x in params.values())
    moment_bytes = sum(
        x.numel() * x.element_size()
        for t in (state.momentum, state.adam_mu, state.adam_nu)
        for x in t.values())
    return {
        "arch": arch,
        "smoke": smoke,
        "device": str(device),
        "block_size": block_size,
        "n_tiles": wu_plan.total_tiles,
        "stacked_groups": wu_plan.summary()["stacked"],
        "bitwise_equal": bitwise,
        "kernel_max_rel_err": kernel_err,
        "kernel_tol": KERNEL_TOL,
        "paired": paired,
        "variants": out,
        "moment_bytes": moment_bytes,
        "moment_bytes_legacy_3x": 3 * p_bytes,
        "moment_savings_x": round(3 * p_bytes / max(moment_bytes, 1),
                                  2),
    }


def rows(archs=ARCHS + EXTRA_ARCHS, *, smoke: bool = True,
         block_size: int = BLOCK_SIZE, device="cuda"):
    out = []
    for arch in archs:
        c = _wu_case(arch, smoke=smoke, block_size=block_size,
                     device=device)
        for tag, v in c["variants"].items():
            out.append({
                "arch": arch, "variant": tag, **v,
                "bitwise_equal": c["bitwise_equal"].get(tag, True),
                "moment_bytes": c["moment_bytes"],
            })
    return out


def wall_guard(case) -> bool:
    """The reference's paired wall guard: the fused WU is at most 15% of
    the per-leaf wall slower, on the paired median."""
    leg = case["variants"]["per_leaf"]
    return case["paired"]["paired_diff_med_us"] >= \
        -0.15 * leg["wall_ms"] * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dist", action="store_true",
                    help="the forced-4-device INV→VMM dataflow comparison "
                         "(multi-GPU; not ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out", default=out_path("wu_fusion"))
    args = ap.parse_args(argv)

    if args.dist:
        raise NotImplementedError(
            "wu_fusion --dist compares solve/fused_wu.py's INV→VMM "
            "dataflows on a 4-device mesh; the port runs on one device "
            "(multi-GPU is ROADMAP Queue 1 item 8)")

    cases = [_wu_case(a, device=args.device) for a in ARCHS + EXTRA_ARCHS]
    table = []
    for c in cases:
        leg, fus = c["variants"]["per_leaf"], c["variants"]["fused"]
        assert c["bitwise_equal"]["fused"], \
            f"{c['arch']}: fused != per-leaf"
        assert c["bitwise_equal"]["fused+ew_pool"], \
            f"{c['arch']}: ew-pooled != per-leaf"
        if c["arch"] in ARCHS:      # the asserted acceptance archs
            # the executed program's product calls: strictly fewer with
            # the pooled WU (the reference's hlo_dots assert); kernels
            # and aten_ops are recorded, not asserted
            assert fus["gemms"] < leg["gemms"], c
            # wall: judged on the paired per-round difference, with the
            # reference's 15% allowance for load noise
            assert wall_guard(c), (
                f"{c['arch']}: fused WU slower than per-leaf (paired "
                f"median {c['paired']['paired_diff_med_us']}us on "
                f"{leg['wall_ms']}ms)")
        for tag, v in c["variants"].items():
            table.append({"arch": c["arch"], "variant": tag, **v,
                          "moment_bytes": c["moment_bytes"],
                          "moment_bytes_3x_baseline":
                              c["moment_bytes_legacy_3x"]})
    print_csv("wu_fusion", table)
    write_json(args.out, {"cases": cases})
    print(f"# wrote {args.out}")
    return cases


if __name__ == "__main__":
    main()
