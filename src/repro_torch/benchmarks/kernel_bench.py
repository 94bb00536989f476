"""Kernel-level benchmark: the composed-precision inversion datapath
(counterpart of ``benchmarks/kernel_bench.py``).

  * accuracy ladder: bits recovered by each stage (Newton-Schulz only,
    + Neumann, + refinement), the paper's Fig. 4 analogue in the bf16
    tensor-core regime, through ``kernels.ops.neumann_inv`` on the
    device given (the CUDA kernel on the card, its plain version on the
    CPU), with each stage's wall time measured to completion
    (``common.timed``);
  * traffic model: the device-memory bytes a block inverse moves when
    every matmul streams its operands, against one that keeps the block
    resident in on-chip memory (one read and one write), per SOI block
    size. The arithmetic is the reference's. On an H100 a block of up to
    128 fits one CTA's shared memory (``neumann_inv``'s one-CTA route);
    the rows above 128 are not realisable in one CTA there (a 256 block
    in fp32 is 256 KB, against 228 KB of shared memory per SM), and
    ``neumann_inv`` takes them on its large route, whose batched
    products stream every operand through device memory and L2.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import print_csv, timed
from repro_torch.kernels import ops

#: (stage, neumann_inv counts) of the ladder, the reference's settings
STAGES = (
    ("ns_only", dict(ns_iters=20, taylor_terms=1, refine_steps=0)),
    ("ns+neumann", dict(ns_iters=20, taylor_terms=4, refine_steps=0)),
    ("ns+neumann+refine", dict(ns_iters=20, taylor_terms=4,
                               refine_steps=2)),
)


def ladder_problem(n: int = 128, seed: int = 0):
    """The ladder's damped SPD block (1, n, n) fp32, its damping (1,)
    and the float64 inverse of the damped block."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((1, n, n)).astype(np.float32)
    a = np.einsum("bij,bkj->bik", m, m) / n
    damp = 0.03 * np.trace(a, axis1=1, axis2=2) / n
    ad = a + damp[:, None, None] * np.eye(n, dtype=np.float32)
    return a, damp, np.linalg.inv(ad.astype(np.float64))


def accuracy_ladder(n: int = 128, seed: int = 0, device="cuda",
                    out: dict | None = None):
    """One row a stage: relative error and bits against the float64
    inverse, and the wall ms of one call. ``out``, if given, receives
    each stage's inverse (on ``device``) under its stage name."""
    a, damp, exact = ladder_problem(n, seed)
    a_t = torch.from_numpy(a).to(device)
    d_t = torch.from_numpy(damp).to(device)
    rows = []
    for tag, kw in STAGES:
        got, us = timed(ops.neumann_inv, a_t, d_t, n=1, **kw)
        if out is not None:
            out[tag] = got
        inv = got.cpu().numpy()
        rel = np.max(np.abs(inv - exact)) / np.max(np.abs(exact))
        rows.append({"stage": tag,
                     "rel_err": float(rel),
                     "bits": round(float(-np.log2(max(rel, 1e-30))), 1),
                     "wall_ms": round(us / 1e3, 2)})
    return rows


def traffic_model():
    """Device-memory bytes per block inverse: streaming against
    resident in on-chip memory.

    Streaming: every matmul reads 2 and writes 1 (n, n) fp32 buffer;
    the composed inverse runs ~(2*ns + 2*(taylor-1) + 2*refine) matmuls.
    Resident: one read and one write of the block. (The reference names
    the resident column after the TPU's VMEM; on the card it is shared
    memory, hence ``smem_resident_mb``.)"""
    ns, taylor, refine = 14, 4, 1
    matmuls = 2 * ns + 2 * (taylor - 1) + 2 * refine
    out = []
    for n in (128, 256, 512, 1024):
        blk = n * n * 4
        stream = matmuls * 3 * blk
        fused = 2 * blk
        out.append({"block": n,
                    "streaming_mb": round(stream / 1e6, 1),
                    "smem_resident_mb": round(fused / 1e6, 2),
                    "traffic_reduction_x": round(stream / fused, 1)})
    return out


def rows(device="cuda"):
    return accuracy_ladder(device=device) + traffic_model()


def main(device="cuda"):
    print_csv("kernel_accuracy_ladder", accuracy_ladder(device=device))
    print_csv("kernel_traffic_model", traffic_model())


if __name__ == "__main__":
    main()
