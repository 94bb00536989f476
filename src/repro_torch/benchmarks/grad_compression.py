"""Data-parallel gradient all-reduce: fp32 against int8 error-feedback
compression (counterpart of ``benchmarks/grad_compression.py``).

The reference lowers both variants for a gradient tree of ``--arch``'s
published config on its multi-pod mesh and counts the collective bytes
in the HLO. The port runs them, so it takes the smoke config's shapes:
the reduction is computed, on every rank (``dist.spawn``: 2 gloo ranks
on the CPU; on CUDA one rank a card, or two sharing the one card over
gloo), and the bytes a rank hands its collectives scale with the
element count alone. Each rank holds its own random gradient tree of
those shapes and reduces it

  * ``fp32``: one ``all_reduce`` of the fp32 tree (what data parallelism
    inserts), divided by the rank count;
  * ``int8_ef``: ``dist.compression.compressed_allreduce_tree`` (a MAX
    ``all_reduce`` of one scalar a leaf, an int8 ``all_gather``, the mean
    in fp32 locally), with error-feedback buffers.

Per variant: the bytes a rank hands to its collectives (its operands:
4 bytes an element for fp32, 1 for int8 plus a 4-byte scale a leaf) and
the wall ms (best of 3, device synchronised). Asserted, as the
reference's property tests do: every element of the compressed mean
within ``s / 127`` of the fp32 mean (``s`` the leaf's shared scale), the
int8 operand bytes at most a quarter of fp32's plus the scales, and over
8 steps of error feedback on fixed gradients the summed compressed means
within one quantization step of the summed true means.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.common import (out_path, print_csv, timed,
                                           write_json)
from repro_torch.dist.spawn import default_world, rank_device, run_ranks

ARCH = "llama3.2-1b"
EF_STEPS = 8


def _rank(rank: int, world: int, arch: str, device: str):
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import compression
    from repro_torch.dist.api import all_reduce
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_dev_mesh

    dev = rank_device(device, rank)
    cfg = get_smoke_config(arch)
    shapes = steps_mod.init_params(
        cfg, generator=None, device="meta")
    gen = torch.Generator(device=dev).manual_seed(1000 + rank)
    grads = {k: torch.randn(v.shape, generator=gen, device=dev)
             for k, v in shapes.items()}
    mesh = make_dev_mesh()

    def fp32_mean():
        return {k: all_reduce(g.clone(), mesh) / world
                for k, g in grads.items()}

    errs0 = compression.init_error_buffers(grads)
    want, us_fp32 = timed(fp32_mean)
    (got, _), us_int8 = timed(lambda: compression.compressed_allreduce_tree(
        grads, errs0, mesh, ("pod", "data")))
    worst = 0.0
    for k, g in grads.items():
        s = all_reduce(g.abs().max().reshape(1).clone(), mesh, "max")[0]
        worst = max(worst, float((got[k] - want[k]).abs().max() / (s / 127)))
    assert worst <= 1.0 + 1e-6, f"rank {rank}: error {worst} x s/127"
    # error feedback: fixed gradients, 8 steps; the sums of the compressed
    # and the true means differ by at most one quantization step
    errs, acc = errs0, {k: torch.zeros_like(g) for k, g in grads.items()}
    for _ in range(EF_STEPS):
        got, errs = compression.compressed_allreduce_tree(
            grads, errs, mesh, ("pod", "data"))
        acc = {k: acc[k] + got[k] for k in acc}
    ef_worst = 0.0
    for k, g in grads.items():
        step = all_reduce((g.abs() + errs[k].abs()).max().reshape(1),
                          mesh, "max")[0] / 127
        ef_worst = max(ef_worst, float(
            (acc[k] - EF_STEPS * want[k]).abs().max() / step))
    n = sum(g.numel() for g in grads.values())
    return {"arch": arch, "ndev": world, "device": str(dev),
            "elements": n, "leaves": len(grads),
            "fp32_bytes": 4 * n, "int8_bytes": n + 4 * len(grads),
            "fp32_ms": us_fp32 / 1e3, "int8_ef_ms": us_int8 / 1e3,
            "max_err_over_s127": worst, "ef_sum_err_over_step": ef_worst}


def rows(payload=None, *, arch: str = ARCH, device: str = "cpu",
         ranks=None):
    """The table from every rank's record: ``ranks``, or a spawn of its
    own."""
    ranks = ranks or run_ranks(_rank, default_world(device, 2),
                               device=device, args=(arch, device))
    d = ranks[0]
    if payload is not None:
        payload["ranks"] = ranks
    assert d["int8_bytes"] <= d["fp32_bytes"] / 4 + 4 * d["leaves"], d
    # the error-feedback invariant, with room for the fp32 sums' rounding
    assert all(r["ef_sum_err_over_step"] <= 1.0 + 1e-3 for r in ranks), ranks
    return [{"variant": "fp32", "coll_bytes_per_dev": d["fp32_bytes"],
             "wall_ms": max(r["fp32_ms"] for r in ranks)},
            {"variant": "int8_ef", "coll_bytes_per_dev": d["int8_bytes"],
             "wall_ms": max(r["int8_ef_ms"] for r in ranks)},
            {"variant": "reduction_x",
             "coll_bytes_per_dev": round(d["fp32_bytes"] / d["int8_bytes"],
                                         2), "wall_ms": ""}]


def main(argv=None, ranks=None):
    """The CLI; ``ranks``: the ranks' records of a spawn shared with
    another benchmark (``benchmarks.run``), else a spawn of its own."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out", default=out_path("grad_compression"))
    args = ap.parse_args(argv)
    from repro_torch.launch.train import resolve_device

    device = str(resolve_device(args.device))
    payload = {"device": device}
    r = rows(payload, arch=args.arch, device=device, ranks=ranks)
    print_csv("grad_compression_dcn", r)
    write_json(args.out, payload)
    print(f"# wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
