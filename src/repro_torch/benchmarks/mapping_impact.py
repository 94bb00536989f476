"""Paper Fig. 13: (a) ResNet-50 epoch time vs SOI block size, with and
without the Sec.-V mapping scheme (mapping keeps the slope flat; the
paper proves crossbar occupation becomes block-size-independent);
(b) write-count reduction vs PipeLayer (paper: 55.7% average)."""

from __future__ import annotations

import numpy as np

from repro_torch.pimsim import perf
from repro_torch.benchmarks.common import print_csv


def rows_blocksize():
    out = []
    base = None
    for block in (64, 128, 256, 512, 1024):
        w = perf.evaluate("resnet50", block=block, use_mapping=True)
        wo = perf.evaluate("resnet50", block=block, use_mapping=False)
        if base is None:
            base = w["epoch_repast"]
        out.append({
            "block": block,
            "epoch_with_mapping": round(w["epoch_repast"] / base, 3),
            "epoch_no_mapping": round(wo["epoch_repast"] / base, 3),
        })
    return out


def rows_writes():
    out = []
    for name in perf.EPOCHS:
        r = perf.evaluate(name)
        out.append({"net": name,
                    "write_reduction_pct":
                        round(100 * r["write_reduction"], 1)})
    return out


def headline(rw=None):
    rw = rw or rows_writes()
    return {"name": "fig13b_write_reduction_mean_pct",
            "value": round(float(np.mean(
                [r["write_reduction_pct"] for r in rw])), 1),
            "paper": 55.7}


def main():
    rb = rows_blocksize()
    print_csv("fig13a_blocksize", rb)
    rw = rows_writes()
    print_csv("fig13b_writes", rw)
    print_csv("fig13b_headline", [headline(rw)])


if __name__ == "__main__":
    main()
