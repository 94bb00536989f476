#!/usr/bin/env python3
"""Times the composed-inverse kernels and bitslice_mm of one tree's
``repro_torch`` on one GPU, so that two trees can be compared inside one
call.

    python3 kernel_times.py [--src DIR] [--ablate]

Imports ``repro_torch`` from DIR (default: this tree's ``src``) and times,
with CUDA events (warm, median of 5), at the shapes of ``chip_smoke.py``'s
main path (qwen1.5-0.5b, K-FAC block 128, 2048 tokens):
  neumann_inv     528 and 192 blocks of 128 at the K-FAC counts 20/4/2,
                  and the main path's 11 factor leaves (3120 blocks) one
                  launch a leaf, and in one grouped call where the tree
                  has ``ops.neumann_inv_grouped``;
  fused_gram_inv  (2048, 528, 128) activations, fp32 and bf16, at the
                  K-FAC counts and at 0/1/0 (the Gram and X0 only);
  bitslice_mm     fp32 (2048, 1024) @ (1024, 2816) (the MLP product) and
                  (128, 128) @ (128, 64) (mxu_inv_apply's), through
                  ``ops.bitslice_mm``, one call and 20 back to back,
                  beside fp32 torch.matmul (TF32 off).
With ``--ablate`` (this tree's kernel only) it also builds copies of
``csrc/bitslice_mm.cu`` with parts of the work cut out and times them at
the MLP product (20 calls back to back, wrong results): the TMA copies
and hand-overs alone, copies and splits (no products), copies and
products (no splits).
Inputs are random, from seed 0. Prints one JSON line with the card's
name and power limit. Compare two trees in turns (parent, change,
change, parent); a directory without ``repro_torch`` or a machine
without CUDA exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

KFAC_COUNTS = dict(ns_iters=20, taylor_terms=4, refine_steps=2)
GRAM_ONLY = dict(ns_iters=0, taylor_terms=1, refine_steps=0)


# bitslice_mm.cu cut down, for --ablate: (anchor, replacement) pairs
NO_PRODUCTS = ("        for (int ks = 0; ks < BK / 16; ++ks) {",
               "        for (int ks = 0; ks < BK / 16 && g < 0; ++ks) {")
NO_SPLITS = ("      store_stage<T>(l, g % C::S, slice, v);\n"
             "      wgmma::fence_smem();\n      __syncwarp();\n"
             "      if (lane0) mbar_arrive(l.full + 8 * (g % C::S));\n    }\n"
             "  } else {",
             "      if (g < 0) store_stage<T>(l, g % C::S, slice, v);\n"
             "      wgmma::fence_smem();\n      __syncwarp();\n"
             "      if (lane0) mbar_arrive(l.full + 8 * (g % C::S));\n    }\n"
             "  } else {")
ABLATIONS = {"copies": (NO_PRODUCTS, NO_SPLITS),
             "copies_splits": (NO_PRODUCTS,),
             "copies_products": (NO_SPLITS,)}


def time_ms(torch, fn, reps=5, launches=1) -> float:
    """Median of ``reps`` warm runs of ``launches`` calls back to back;
    ms a call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def ablate(torch, build, x, w) -> dict:
    """ms a call of each cut-down copy of bitslice_mm.cu on fp32 x @ w."""
    src = (build.CSRC / "bitslice_mm.cu").read_text()
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in ABLATIONS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise SystemExit(f"kernel_times: --ablate anchor not found "
                                 f"in bitslice_mm.cu: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"bitslice_mm_{name}.cu"
        cu.write_text(text)
        so = out_dir / f"libbitslice_mm_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    (m, k), n = x.shape, w.shape[1]
    c = torch.empty(m, n, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} cut:\n{log}")
        fn = ctypes.CDLL(str(so)).bitslice_mm_f32_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]

        def call(fn=fn):
            if fn(x.data_ptr(), w.data_ptr(), c.data_ptr(), m, n, k,
                  stream) != 0:
                raise RuntimeError(f"{name} cut failed to launch")
        times[name] = time_ms(torch, call, launches=20)
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(args.src, "repro_torch")):
        print(f"kernel_times: {args.src}/repro_torch not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.core import soi
    from repro_torch.kernels import build, ops
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    build_s = ops.build_all()
    bs = 128
    cfg = get_config("qwen1.5-0.5b")
    leaves = [shp for sp in lm.kfac_specs(cfg).values()
              for shp in soi.factor_shapes(sp, bs).values()]

    def damped(nb):
        m = torch.randn(nb, bs, 2 * bs, device=dev, generator=gen)
        a = m @ m.transpose(-1, -2) / (2 * bs)
        return a, soi.tikhonov_damping(a, 0.03)

    out = {"src": args.src, "build_s": build_s}
    for nb in (528, 192):
        a, lam = damped(nb)
        out[f"neumann_inv_{nb}_ms"] = time_ms(
            torch, lambda: ops.neumann_inv(a, lam, **KFAC_COUNTS))
    flats = [damped(math.prod(s[:-2])) for s in leaves]
    out["leaves"] = [f[0].shape[0] for f in flats]
    out["neumann_inv_per_leaf_ms"] = time_ms(torch, lambda: [
        ops.neumann_inv(a, lam, **KFAC_COUNTS) for a, lam in flats])
    if hasattr(ops, "neumann_inv_grouped"):
        out["neumann_inv_grouped_ms"] = time_ms(
            torch, lambda: ops.neumann_inv_grouped(
                [a for a, _ in flats], [lam for _, lam in flats],
                **KFAC_COUNTS))
    del flats
    acts = torch.randn(2048, 528, bs, device=dev, generator=gen)
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        x = acts.to(dtype)
        for counts, tag in ((KFAC_COUNTS, "20_4_2"), (GRAM_ONLY, "0_1_0")):
            out[f"fused_gram_inv_{name}_{tag}_ms"] = time_ms(
                torch, lambda: ops.fused_gram_inv(x, rel_damp=0.03,
                                                  **counts))
    del acts, x
    for m, k, n in ((2048, 1024, 2816), (128, 128, 64)):
        x = torch.randn(m, k, device=dev, generator=gen)
        w = torch.randn(k, n, device=dev, generator=gen)
        tag = f"bitslice_mm_{m}_{k}_{n}"
        out[f"{tag}_ms"] = time_ms(torch, lambda: ops.bitslice_mm(x, w))
        out[f"{tag}_loop20_ms"] = time_ms(
            torch, lambda: ops.bitslice_mm(x, w), launches=20)
        out[f"matmul_{m}_{k}_{n}_ms"] = time_ms(
            torch, lambda: torch.matmul(x, w))
        out[f"matmul_{m}_{k}_{n}_loop20_ms"] = time_ms(
            torch, lambda: torch.matmul(x, w), launches=20)
    if args.ablate:   # last: it loads three more libraries
        x = torch.randn(2048, 1024, device=dev, generator=gen)
        w = torch.randn(1024, 2816, device=dev, generator=gen)
        out["bitslice_mm_ablate_loop20_ms"] = ablate(torch, build, x, w)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
