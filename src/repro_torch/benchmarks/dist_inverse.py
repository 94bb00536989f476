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
``ARCH``'s smoke config (random SPD factors from seed 0, block 64). The
reference's ``--smw`` probe (SMW refresh against a full re-inversion,
pdiv across the mesh) is not ported; it raises (ROADMAP Queue 1 item 8).
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


def _rank(rank: int, world: int, arch: str, device: str) -> dict:
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
            "neumann_inv_launches": launches}


def probe(device: str = "cpu") -> list:
    """Every rank's record (see :func:`_rank`), in rank order."""
    return run_ranks(_rank, default_world(device, 4), device=device,
                     args=(ARCH, device))


def rows(payload=None, *, device: str = "cpu", ranks=None):
    """The table from every rank's record: ``ranks``, or a :func:`probe`
    of its own."""
    ranks = ranks or probe(device)
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


def main(argv=None, ranks=None):
    """The CLI; ``ranks``: the ranks' records of a spawn shared with
    another benchmark (``benchmarks.run``), else a probe of its own."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--smw", action="store_true",
                    help="the incremental-SOI probe (not ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out", default=out_path("dist_inverse"))
    args = ap.parse_args(argv)
    if args.smw:
        raise NotImplementedError(
            "dist_inverse --smw (the SMW refresh and pdiv across ranks) is "
            "not ported yet (ROADMAP Queue 1 item 8)")
    from repro_torch.launch.train import resolve_device

    device = str(resolve_device(args.device))
    payload = {"device": device}
    r = rows(payload, device=device, ranks=ranks)
    print_csv("dist_inverse", r)
    write_json(args.out, payload)
    print(f"# wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
