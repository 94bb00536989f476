"""Distributed SOI inversion: per-rank inverse work against the rank
count (counterpart of ``benchmarks/dist_inverse.py``).

The paper's scaling claim for the INV engine (Sec. IV-B): inversion
latency shrinks with the number of INV crossbar groups, because factor
blocks are spread over them. The port's image is ``repro_torch.solve``
on a mesh: each rank inverts only its plan-owned blocks, so the blocks a
rank inverts drop from ``total`` (the replicated refresh) to at most
``ceil(total / ndev)``.

  python -m repro_torch.benchmarks.dist_inverse [--device cuda|cpu]

spawns the ranks (``dist.spawn``; the reference forces a 4-device host
platform): 4 gloo ranks on the CPU, on a (2, 2) ``(data,
model)`` mesh as the reference's; on CUDA one rank a card, or two ranks
sharing the one card over gloo. Every rank checks that the distributed
refresh is bitwise the replicated one and that the plan's per-rank block
count is within its bound; on the card each rank's ``neumann_inv``
launches are counted. The factors inverted have the shapes of
``ARCH``'s smoke config (random SPD factors from seed 0, block 64).

``--smw`` adds the reference's incremental-SOI probe on the same ranks
(:func:`smw_probe`): the SMW refresh of four 256-blocks against a full
re-inversion (asserted at least 3x apart, as the reference does), the
drift over a simulated EMA trajectory with the fallback gate, each
step's columns split over the ranks and gathered (``solve.smw.
gather_cols``, every rank's update bitwise the one-rank update) and its
drift reduced over the mesh; then ``solve.pdiv_invert`` of a block twice
one rank's share across the mesh, bitwise the local call.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import (out_path, print_csv, timed,
                                           write_json)
from repro_torch.dist.spawn import default_world, rank_device, run_ranks

ARCH = "qwen1.5-0.5b"
BLOCK_SIZE = 64
#: the reference probe's composed-inverse counts
COUNTS = dict(ns_iters=8, taylor_terms=3, refine_steps=1)


def spd_factors(specs, block_size: int, device, seed: int = 0) -> dict:
    """Random SPD factors ``a a^T / 2bs`` of every factor shape, drawn
    from one numpy generator in the reference's tree order (sorted paths,
    A before G)."""
    from repro_torch.core import soi
    from repro_torch.core.kfac import tree_order

    shapes = soi.init_factors(specs, block_size, device="meta")
    r = np.random.default_rng(seed)
    out = {}
    for name in tree_order(shapes):
        out[name] = {}
        for side in sorted(shapes[name]):
            s = tuple(shapes[name][side].shape)
            a = r.standard_normal(s[:-1] + (2 * s[-1],)).astype(np.float32)
            g = np.einsum("...ij,...kj->...ik", a, a) / (2 * s[-1])
            out[name][side] = torch.from_numpy(g).to(device)
    return out


def probe_mesh(world: int):
    """The reference's probe mesh: (2, world / 2) ``(data, model)`` for
    an even count, else ``(world, 1)``."""
    from repro_torch.launch.mesh import make_dev_mesh

    return make_dev_mesh(model=world // 2 if world > 1 and world % 2 == 0
                         else 1)


#: the SMW probe's block, columns a step and steps (the reference's)
SMW_BS, SMW_K, SMW_STEPS = 256, 32, 15


def smw_probe(rank: int, world: int, device: str) -> dict:
    """The reference's ``_SMW_CHILD`` on this rank of a spawn: see the
    module's docstring. On the card the update goes through the
    ``smw_update`` kernel, whose launches are counted."""
    from repro_torch.core.kfac import KFACConfig
    from repro_torch.kernels import ops
    from repro_torch.solve import pdiv_invert
    from repro_torch.solve.block_solver import invert_factor_tree
    from repro_torch.solve.smw import (SMWConfig, gather_cols, probe_drift,
                                       reduce_drift, smw_refresh)

    dev = rank_device(device, rank)
    bs, k, steps = SMW_BS, SMW_K, SMW_STEPS
    kcfg = KFACConfig(block_size=bs, ns_iters=12, taylor_terms=4,
                      refine_steps=2)
    scfg = SMWConfig(drift_budget=0.05, rank=k,
                     use_kernel=dev.type == "cuda")
    mesh = probe_mesh(world)
    r = np.random.default_rng(0)

    def spd(shape):
        a = r.standard_normal(shape[:-1] + (2 * shape[-1],)).astype(
            np.float32)
        return torch.from_numpy(np.einsum("...ij,...kj->...ik", a, a)
                                / (2 * shape[-1])).to(dev)

    # four bs-blocks over two leaves, one layer's output factor's
    # geometry at soi_block 256
    factors = {"lin0": {"G": spd((2, bs, bs))},
               "lin1": {"G": spd((2, bs, bs))}}

    def cols_like(seed):
        rr = np.random.default_rng(seed)
        return {n: {"G": torch.from_numpy(
            rr.standard_normal((2, k, bs)).astype(np.float32)
            / np.sqrt(k, dtype=np.float32)).to(dev)} for n in factors}

    def share(cols):
        # this rank's columns of the step's k (its tokens)
        lo, hi = rank * k // world, (rank + 1) * k // world
        return {n: {"G": c["G"][:, lo:hi]} for n, c in cols.items()}

    def ema(f, c):
        d = kcfg.ema_decay
        return {n: {"G": d * f[n]["G"] + (1.0 - d) * torch.einsum(
            "nkb,nkc->nbc", c[n]["G"], c[n]["G"])} for n in f}

    def smw_step(inv, f, c):
        # the columns gathered over the ranks in their order (weight 1:
        # the split columns are the global ones)
        got, ks = gather_cols(share(c), mesh, 1.0, scfg.rank)
        new, drift = smw_refresh(inv, f, got, kcfg, scfg, ks=ks)
        return new, reduce_drift(drift, mesh)

    def full(f):
        return invert_factor_tree(f, kcfg)

    inv = full(factors)
    drift_base = float(probe_drift(factors, inv, kcfg))
    assert drift_base <= scfg.drift_budget, drift_base
    _, us_full = timed(full, factors)
    c0 = cols_like(1)
    f1 = ema(factors, c0)
    (one, _), us_smw = timed(smw_step, inv, f1, c0)
    local, _ = smw_refresh(inv, f1, c0, kcfg, scfg)
    bitwise = all(torch.equal(one[n]["G_inv"], local[n]["G_inv"])
                  for n in one)
    assert bitwise, f"rank {rank}: the gathered update != the local one"
    assert us_smw * 3 <= us_full, (
        f"SMW refresh {us_smw:.0f}us not >=3x below full re-inversion "
        f"{us_full:.0f}us")
    ops.reset_launch_counts()
    n_fallbacks, drift_max = 0, 0.0
    for t in range(steps):
        c = cols_like(100 + t)
        factors = ema(factors, c)
        inv, drift = smw_step(inv, factors, c)
        d = float(drift)
        drift_max = max(drift_max, d)
        if not d <= scfg.drift_budget:
            inv = full(factors)
            n_fallbacks += 1
    launches = ops.launch_counts()
    drift_final = float(probe_drift(factors, inv, kcfg))
    assert drift_final <= scfg.drift_budget, drift_final
    # pdiv: one block twice a rank's pool share, across the mesh
    blk = spd((2 * bs, 2 * bs))
    out_loc, us_ploc = timed(lambda: pdiv_invert(blk, 0.03, kcfg, depth=1))
    out_dst, us_pdst = timed(lambda: pdiv_invert(blk, 0.03, kcfg, depth=1,
                                                 mesh=mesh))
    pdiv_bitwise = bool(torch.equal(out_loc, out_dst))
    assert pdiv_bitwise, f"rank {rank}: pdiv distributed != local"
    return {"bs": bs, "k": k, "ndev": world, "rank": rank, "steps": steps,
            "ms_full_reinversion": us_full / 1e3, "ms_smw_step": us_smw / 1e3,
            "smw_speedup": us_full / us_smw,
            "drift_budget": scfg.drift_budget, "drift_base": drift_base,
            "drift_max": drift_max, "drift_final": drift_final,
            "n_fallbacks": n_fallbacks, "smw_bitwise_local": bitwise,
            "smw_update_launches": launches["smw_update"],
            "neumann_inv_launches": launches["neumann_inv"],
            "ms_pdiv_local": us_ploc / 1e3, "ms_pdiv_dist": us_pdst / 1e3,
            "pdiv_block": 2 * bs, "pdiv_bitwise": pdiv_bitwise}


def _rank(rank: int, world: int, arch: str, device: str,
          smw: bool = False) -> dict:
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.kfac import KFACConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.solve import invert_factor_tree, make_plan

    dev = rank_device(device, rank)
    kcfg = KFACConfig(block_size=BLOCK_SIZE, **COUNTS)
    factors = spd_factors(steps_mod.kfac_specs(get_smoke_config(arch)),
                          BLOCK_SIZE, dev)
    mesh = probe_mesh(world)
    plan = make_plan(factors, world, kcfg)
    inv_rep, us_rep = timed(lambda: invert_factor_tree(factors, kcfg))
    ops.reset_launch_counts()
    inv_dist = invert_factor_tree(factors, kcfg, mesh=mesh, plan=plan)
    launches = ops.launch_counts()["neumann_inv"]
    _, us_dist = timed(lambda: invert_factor_tree(factors, kcfg, mesh=mesh,
                                                  plan=plan))
    bitwise = all(torch.equal(inv_rep[n][k], inv_dist[n][k])
                  for n in inv_rep for k in inv_rep[n])
    s = plan.summary()
    # ceil(total / ndev) holds when every block costs the same (one
    # block size); with mixed sizes the greedy balances operations and
    # only the sum of the groups' ceilings is guaranteed
    uniform = len({g.bs for g in plan.groups}) == 1
    bound = (-(-plan.total_blocks // world) if uniform
             else sum(-(-g.n_blocks // world) for g in plan.groups))
    assert bitwise, f"rank {rank}: distributed != replicated"
    assert plan.max_device_blocks <= bound, s
    return {"arch": arch, "ndev": world, "rank": rank,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "device": str(dev), "total_blocks": s["total_blocks"],
            "device_blocks": s["device_blocks"],
            "device_gflops": s["device_gflops"], "count_bound": bound,
            "uniform_bs": uniform, "ms_replicated": us_rep / 1e3,
            "ms_distributed": us_dist / 1e3, "bitwise_equal": bitwise,
            "neumann_inv_launches": launches,
            **({"smw": smw_probe(rank, world, device)} if smw else {})}


def probe(device: str = "cpu", smw: bool = False) -> list:
    """Every rank's record (see :func:`_rank`), in rank order."""
    return run_ranks(_rank, default_world(device, 4), device=device,
                     args=(ARCH, device, smw))


def rows(payload=None, *, device: str = "cpu", ranks=None,
         smw: bool = False):
    """The table from every rank's record: ``ranks``, or a :func:`probe`
    of its own."""
    ranks = ranks or probe(device, smw)
    d = ranks[0]
    if payload is not None:
        payload["dist"] = d
        payload["ranks"] = ranks
    total, bound, ndev = d["total_blocks"], d["count_bound"], d["ndev"]
    assert all(r["bitwise_equal"] for r in ranks)
    assert max(d["device_blocks"]) <= bound, d
    return [{
        "variant": "replicated",
        "blocks_per_dev": total,
        "gflops_per_dev": round(sum(d["device_gflops"]), 3),
        "wall_ms": max(r["ms_replicated"] for r in ranks),
    }, {
        "variant": "distributed",
        "blocks_per_dev": max(d["device_blocks"]),
        "gflops_per_dev": max(d["device_gflops"]),
        "wall_ms": max(r["ms_distributed"] for r in ranks),
    }, {
        "variant": (f"bound_ceil(total/{ndev})" if d["uniform_bs"]
                    else "bound_sum_group_ceils"),
        "blocks_per_dev": bound,
        "gflops_per_dev": "",
        "wall_ms": "",
    }]


def smw_rows(ranks, payload=None):
    """The incremental-SOI table from every rank's ``smw`` record: the
    reference's rows (each wall the slowest rank's)."""
    d = ranks[0]["smw"]
    if payload is not None:
        payload["smw"] = d
        payload["smw_ranks"] = [r["smw"] for r in ranks]
    assert all(r["smw"]["smw_bitwise_local"] and r["smw"]["pdiv_bitwise"]
               for r in ranks)
    slowest = {key: max(r["smw"][key] for r in ranks)
               for key in ("ms_full_reinversion", "ms_smw_step",
                           "ms_pdiv_local", "ms_pdiv_dist")}
    return [{
        "variant": "full_reinversion (dispatched per inv cadence)",
        "wall_ms": slowest["ms_full_reinversion"],
        "drift": d["drift_base"],
        "note": f"bs={d['bs']} composed",
    }, {
        "variant": "smw_step (every step)",
        "wall_ms": slowest["ms_smw_step"],
        "drift": d["drift_max"],
        "note": f"k={d['k']} over {d['ndev']} ranks "
                f"{d['smw_speedup']:.1f}x faster, "
                f"{d['n_fallbacks']}/{d['steps']} fallbacks, "
                f"final drift {d['drift_final']:.4f} <= "
                f"{d['drift_budget']}",
    }, {
        "variant": f"pdiv_local (block {d['pdiv_block']})",
        "wall_ms": slowest["ms_pdiv_local"],
        "drift": "",
        "note": "2x one rank's pool share",
    }, {
        "variant": f"pdiv_distributed (block {d['pdiv_block']})",
        "wall_ms": slowest["ms_pdiv_dist"],
        "drift": "",
        "note": f"ndev={d['ndev']} bitwise == local",
    }]


def main(argv=None, ranks=None):
    """The CLI; ``ranks``: the ranks' records of a spawn shared with
    another benchmark (``benchmarks.run``), else a probe of its own."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--smw", action="store_true",
                    help="also the incremental-SOI (SMW + pdiv) probe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out", default=out_path("dist_inverse"))
    args = ap.parse_args(argv)
    from repro_torch.launch.train import resolve_device

    device = str(resolve_device(args.device))
    payload = {"device": device}
    ranks = ranks or probe(device, args.smw)
    r = rows(payload, device=device, ranks=ranks)
    print_csv("dist_inverse", r)
    if args.smw:
        print_csv("dist_inverse_smw", smw_rows(ranks, payload))
    write_json(args.out, payload)
    print(f"# wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
