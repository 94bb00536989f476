#!/usr/bin/env python3
"""Times the kernels of one tree's ``repro_torch`` on one GPU, so that
two trees can be compared inside one call.

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
                  beside fp32 torch.matmul (TF32 off);
and the large routes (sides and ranks of 129..1024) at the shapes of
``chip_smoke.py``'s phase ``large_blocks`` (its ``LARGE``), for each
kernel whose module in the tree takes them (``MAX_N``/``MAX_B`` above
128; a tree without a kernel's large route gets no key for it):
  neumann_inv     (a)'s blocks of 129..1024; the main path's sides at
                  block 256 and 1024 ((b), (c): 768 x 256, 1152 x 176,
                  192 x 1024), each beside torch.linalg.inv of the same
                  damped blocks, and the block-256 refresh (768 x 256 and
                  1152 x 176) in one grouped call;
  fused_precond   (a)'s tile shapes, pools indexed as a WU plan makes
                  them, in turns with the gather + fp32 torch.matmul
                  chain on the same pools and indices (``chain_*``), and
                  the large route's bytes floor where the tree has
                  ``wu_schedule`` (``*_floor_ms``, at 3.35 TB/s);
  smw_update      (d)'s (blocks, k, bs), at the G side's scale, and the
                  --smw path's update at block 256 (768 x 256 and 1152 x
                  176 blocks, at rank 64 and 256) beside
                  ref.exact_smw_update; the host's enqueue time of one
                  call at the path's shapes and at (2, 1024, 1024);
  fused_gram_inv  (d)'s (T, nb, n) and (f)'s (the main path's first
                  batch at block 256: 2048 tokens of 96 blocks of 256 and
                  384 of 176), fp32 and bf16.
Where a tree's module takes the large routes, ``smw_update``'s and
``fused_gram_inv``'s are also timed launch by launch (CUDA events around
each launch, median of 5 calls after one to warm up; any tree, keyed by
stage): ``smw_*`` the prep, the products (``y`` = hilo(V, M), ``s`` =
hilo(Y, V^T), ``out`` = M - hilo(Y^T, Z)) and the solve's launches
together, at (d)'s shapes and the path's; ``gram_*`` the
activations' split, the Gram product, the finish and neumann_inv's
launches, at (d)'s and (f)'s shapes, fp32 and bf16.
Where the tree's ``fused_precond`` has ``wu_schedule``, its large route's
launches are also timed by kind (the pool splits, g's split, the two
products, the dots; CUDA events around each launch, median of 5 calls),
with the host's time to enqueue a call, at (1536, 256, 256) and (512,
130, 200) of (a).
Where the tree's ``smw_update`` has the blocked LU (``lu_schedule``), its
launches are also timed by kind (panel, update, back substitution; CUDA
events around each launch, median of 5 solves) at (2, 1024, 1024) and
the path's rank-256 shapes, on S = N(0, 1) + 30 I and Y = N(0, 1).
For ``neumann_inv``'s (a) shapes it also gives the host's time to enqueue
one call (no synchronisation; median of 5). With ``--ablate`` (this
tree's kernels only) it also builds copies of ``csrc/bitslice_mm.cu``
with parts of the work cut out and times them at the MLP product (20
calls back to back, wrong results): the TMA copies and hand-overs alone,
copies and splits (no products), copies and products (no splits); and a
copy of ``csrc/hilo_tma.cuh`` with the products' epilogue cut out, timing
single products of ``neumann_inv``'s large route (10 back to back) as
built and without their epilogue, at a chunk of the block-256 path's 256
side (384 blocks) and of the 1024 side (32 blocks); and ``fused_precond``'s
launches by kind again, built from a copy of ``csrc/fused_precond.cu``
with that cut header, so its products run without their epilogue.
Each large-route call's result also gets a digest (``*_digest``, a hash
of its bytes): two trees' digests agree where their results on the same
inputs are bitwise equal.
Inputs are random, from seed 0. Prints one JSON line with the card's
name and power limit. Compare two trees in turns (parent, change,
change, parent); a directory without ``repro_torch`` or a machine
without CUDA exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

KFAC_COUNTS = dict(ns_iters=20, taylor_terms=4, refine_steps=2)
# the main path's large sides: (blocks, side) of a refresh at block 256
# (chip_smoke.py phase large_blocks (b)) and the 1024 side at block 1024 (c)
PATH_SIDES = ((768, 256), (1152, 176), (192, 1024))
GRAM_ONLY = dict(ns_iters=0, taylor_terms=1, refine_steps=0)
# smw_update on the --smw path at block 256 (phase large_blocks (e)):
# (blocks, k, bs) of a step's update at rank 64 and 256
SMW_PATH = ((768, 64, 256), (1152, 64, 176), (768, 256, 256),
            (1152, 256, 176))
# fused_gram_inv on the main path's first batch at block 256 (phase
# large_blocks (f)): (T, nb, n) of its A leaves' two sides
GRAM_PATH = ((2048, 96, 256), (2048, 384, 176))


def row_stride(cols: int) -> int:
    """An fp32 workspace row's stride (any tree's ``row_stride``)."""
    return -(-cols // 4) * 4


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
# hilo_tma.cuh cut down, for --ablate: no tile's epilogue runs
NO_EPILOGUE = ("    epilogue<BN, VEC>(acc, p,",
               "    if (p.n < 0) epilogue<BN, VEC>(acc, p,")
# neumann_inv's large-route products timed alone, by their place in the
# schedule at 20/4/2: a Newton-Schulz pair (2I - A_H X, then X W), a
# Neumann term's -X U with M += T, a refinement's M + M R
PRODUCTS = {"ns_w": 0, "ns_xw": 1, "neg_acc": 41, "add": 47}


def digest(*tensors) -> str:
    """A short hash of the tensors' bytes: equal digests of two trees'
    results on the same inputs mean bitwise equal results."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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


def in_turns(torch, fns: dict, reps=5) -> dict:
    """ms a call of each of ``fns``, timed in turns (each rep times every
    function once, in order, warm); the median of ``reps`` for each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(ts) for name, ts in times.items()}


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


def ablate_products(torch, ops, build, dev, gen) -> dict:
    """ms a launch of single large-route products of ``neumann_inv`` (10
    back to back), as built and with the epilogue cut out of
    ``csrc/hilo_tma.cuh``, at (384, 256) and (32, 1024)."""
    from repro_torch.core import soi
    from repro_torch.kernels import hilo_tma
    from repro_torch.kernels import neumann_inv as kn

    old, new = NO_EPILOGUE
    text = (build.CSRC / "hilo_tma.cuh").read_text()
    if old not in text:
        raise SystemExit(f"kernel_times: --ablate anchor not found in "
                         f"hilo_tma.cuh: {old!r}")
    cut_dir = build.BUILD_DIR / "ablate" / "no_epilogue"
    cut_dir.mkdir(parents=True, exist_ok=True)
    (cut_dir / "hilo_tma.cuh").write_text(text.replace(old, new))
    # a copy beside it, so that its #include finds the cut header first
    (cut_dir / "neumann_inv.cu").write_text(
        (build.CSRC / "neumann_inv.cu").read_text())
    so = cut_dir / "libneumann_inv.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(so), str(cut_dir / "neumann_inv.cu")], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the no_epilogue cut:\n"
                           f"{proc.stdout}{proc.stderr}")
    fns = {"built": kn.LIB._load()["neumann_inv_product"],
           "no_epilogue": ctypes.CDLL(str(so)).neumann_inv_product}
    fns["no_epilogue"].argtypes = kn.LIB.entries["neumann_inv_product"]
    stream = torch.cuda.current_stream().cuda_stream
    sched = kn.inv_schedule(**KFAC_COUNTS)
    out = {}
    for nb, n in ((384, 256), (32, 1024)):
        m = torch.randn(nb, n, 2 * n, device=dev, generator=gen)
        a = m @ m.transpose(-1, -2) / (2 * n)
        lam = soi.tikhonov_damping(a, 0.03)
        inv = torch.empty_like(a)
        ld32, ld16 = row_stride(n), hilo_tma.slice_stride(n)
        ws = torch.empty(nb * kn.block_bytes(n), dtype=torch.uint8,
                         device=dev)
        addr = kn.workspace(ws.data_ptr(), nb, n)

        def form(buf, forms):
            return hilo_tma.Out(*(addr[(buf, f)] if f in forms else None
                                  for f in hilo_tma.FORMS))

        table = kn._table([a], [lam], [inv], [0])
        kn.LIB.launch("neumann_inv_prep", ctypes.byref(table), 0, nb, n,
                      ld32, ld16, ctypes.byref(form("ad", sched.prep["ad"])),
                      ctypes.byref(form("x0", sched.prep["x0"])), stream)
        params = []
        for p in sched.products:
            left = [addr[(p.left, f)] for f in hilo_tma.LEFT_FORMS[p.mode]]
            params.append(hilo_tma.Params(
                left[0], left[1] if len(left) > 1 else None,
                addr[(p.right, hilo_tma.HI)], addr[(p.right, hilo_tma.LO)],
                addr[(p.e, hilo_tma.F32)] if p.e else None,
                form(p.c, p.c_forms),
                form(p.f, p.f_forms) if p.f else hilo_tma.Out(),
                n, ld32, ld16, nb, p.epi))
            if fns["built"](ctypes.byref(params[-1]), stream) != 0:
                raise RuntimeError("neumann_inv_product refused a launch")
        for tag, i in PRODUCTS.items():
            for name, fn in fns.items():
                def call(fn=fn, prm=params[i], name=name):
                    err = fn(ctypes.byref(prm), stream)
                    if err != 0:
                        raise RuntimeError(f"{name} product refused: "
                                           f"cudaError {err}")
                out[f"product_{nb}x{n}_{tag}_{name}_ms"] = time_ms(
                    torch, call, launches=10)
        del m, a, lam, inv, ws
    return out


def large_routes(torch, ops, dev, gen) -> dict:
    """ms a call of each kernel's large route at ``chip_smoke.LARGE``'s
    shapes, for the kernels whose module takes sides above 128."""
    from chip_smoke import LARGE
    from repro_torch.core import soi
    from repro_torch.kernels import fused_gram_solve as kg
    from repro_torch.kernels import fused_precond as kf
    from repro_torch.kernels import neumann_inv as kn
    from repro_torch.kernels import smw_update as ks

    def damped(nb, n):
        m = torch.randn(nb, n, 2 * n, device=dev, generator=gen)
        a = m @ m.transpose(-1, -2) / (2 * n)
        return a, soi.tikhonov_damping(a, 0.03)

    out = {}
    if getattr(kn, "MAX_N", 128) > 128:
        for nb, n in LARGE["sides"]:
            a, lam = damped(nb, n)
            out[f"neumann_inv_{nb}x{n}_ms"] = time_ms(
                torch, lambda: ops.neumann_inv(a, lam, **KFAC_COUNTS))
            out[f"neumann_inv_{nb}x{n}_digest"] = digest(
                ops.neumann_inv(a, lam, **KFAC_COUNTS))
            enqueue = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ops.neumann_inv(a, lam, **KFAC_COUNTS)
                enqueue.append((time.perf_counter() - t0) * 1e3)
            out[f"neumann_inv_{nb}x{n}_enqueue_ms"] = statistics.median(
                enqueue)
        refresh = []
        for nb, n in PATH_SIDES:
            a, lam = damped(nb, n)
            eye = torch.eye(n, device=dev)
            out[f"neumann_inv_{nb}x{n}_ms"] = time_ms(
                torch, lambda: ops.neumann_inv(a, lam, **KFAC_COUNTS), 3)
            out[f"linalg_inv_{nb}x{n}_ms"] = time_ms(
                torch, lambda: torch.linalg.inv(a + lam[:, None, None] * eye),
                3)
            if n < 1024:
                refresh.append((a, lam))
            del a, lam
        out["neumann_inv_refresh_256_ms"] = time_ms(
            torch, lambda: ops.neumann_inv_grouped(
                [a for a, _ in refresh], [lam for _, lam in refresh],
                **KFAC_COUNTS), 3)
        del refresh
    if getattr(kf, "MAX_B", 128) > 128:
        run = LARGE["pool_run"]
        for nt, bi, bo in LARGE["tiles"]:
            na, ng = -(-nt // run), max(1, min(run, nt))
            pa = torch.randn(na, bi, bi, device=dev, generator=gen)
            pg = torch.randn(ng, bo, bo, device=dev, generator=gen)
            g = torch.randn(nt, bi, bo, device=dev, generator=gen)
            t = torch.arange(nt, device=dev)
            a_src, g_src = (t // run).to(torch.int32), (t % ng).to(
                torch.int32)
            a_idx, g_idx = a_src.long(), g_src.long()
            tag = f"{nt}x{bi}x{bo}"
            got = in_turns(torch, {
                "kernel": lambda: ops.fused_precond(pa, g, pg, a_src, g_src),
                "chain": lambda: torch.matmul(torch.matmul(pa[a_idx], g),
                                              pg[g_idx])})
            out[f"fused_precond_{tag}_ms"] = got["kernel"]
            out[f"fused_precond_{tag}_digest"] = digest(
                *ops.fused_precond(pa, g, pg, a_src, g_src))
            out[f"chain_{tag}_ms"] = got["chain"]
            if hasattr(kf, "wu_schedule"):
                out[f"fused_precond_{tag}_floor_ms"] = kf.wu_schedule(
                    nt, bi, bo, (na, ng)).floor_bytes / 3.35e12 * 1e3
            del pa, pg, g, a_idx, g_idx
    if getattr(ks, "MAX_N", 128) > 128:
        from repro_torch.kernels import ref

        for nb, k, bs in tuple(LARGE["smw"]) + SMW_PATH:
            a, lam = damped(nb, bs)
            inv = (torch.linalg.inv(a + lam[:, None, None] * torch.eye(
                bs, device=dev)) / 3e-4 ** 2).contiguous()
            v = torch.randn(nb, k, bs, device=dev, generator=gen) * 3e-4
            tag = f"smw_update_{nb}x{k}x{bs}"
            kw = dict(decay=0.95, cscale=0.05)
            out[f"{tag}_ms"] = time_ms(
                torch, lambda: ops.smw_update(inv, v, **kw))
            out[f"{tag}_digest"] = digest(ops.smw_update(inv, v, **kw))
            if (nb, k, bs) in SMW_PATH or k == 1024:
                enqueue = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ops.smw_update(inv, v, **kw)
                    enqueue.append((time.perf_counter() - t0) * 1e3)
                out[f"{tag}_enqueue_ms"] = statistics.median(enqueue)
                out[f"exact_{tag}_ms"] = time_ms(
                    torch, lambda: ref.exact_smw_update(inv, v, **kw))
            del a, lam, inv, v
    if getattr(kg, "MAX_N", 128) > 128:
        for t, nb, n in tuple(LARGE["gram"]) + GRAM_PATH:
            acts = torch.randn(t, nb, n, device=dev, generator=gen)
            for dtype, name in ((torch.float32, "fp32"),
                                (torch.bfloat16, "bf16")):
                x = acts.to(dtype)
                out[f"fused_gram_inv_{t}x{nb}x{n}_{name}_ms"] = time_ms(
                    torch, lambda: ops.fused_gram_inv(x, rel_damp=0.03,
                                                      **KFAC_COUNTS))
                out[f"fused_gram_inv_{t}x{nb}x{n}_{name}_digest"] = digest(
                    ops.fused_gram_inv(x, rel_damp=0.03, **KFAC_COUNTS))
    return out


def by_launch(torch, build, call, name) -> dict:
    """ms of each kernel launch of ``call()`` (CUDA events around every
    ``CudaLibrary.launch``), summed by ``name(library, entry, i)`` (i: the
    launch's count among the call's launches of that entry), median of 5
    calls after one to warm up."""
    launch = build.CudaLibrary.launch
    evs, times = [], {}

    def timed(lib, entry, *args, key=None):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        launch(lib, entry, *args, key=key)
        e1.record()
        evs.append((lib.name, entry, e0, e1))

    build.CudaLibrary.launch = timed
    try:
        for rep in range(6):
            evs.clear()
            call()
            torch.cuda.synchronize()
            if not rep:
                continue
            by, seen = {}, {}
            for lib, entry, e0, e1 in evs:
                i = seen[entry] = seen.get(entry, -1) + 1
                stage = name(lib, entry, i)
                by[stage] = by.get(stage, 0.0) + e0.elapsed_time(e1)
            for stage, ms in by.items():
                times.setdefault(stage, []).append(ms)
    finally:
        build.CudaLibrary.launch = launch
    return {stage: statistics.median(ts) for stage, ts in times.items()}


def smw_stage(lib, entry, i) -> str:
    """smw_update's stages, summed over a call's chunks: the products in
    the schedule's order (y, s, out), the prep, the solve's launches."""
    if entry == "smw_update_product":
        return ("y", "s", "out")[i % 3]
    if entry == "smw_update_prep":
        return "prep"
    return "solve"


def gram_stage(lib, entry, i) -> str:
    """fused_gram_inv's stages: the split, the Gram, the finish; the
    inverse (neumann_inv's launches)."""
    if lib == "neumann_inv":
        return "inverse"
    return entry.replace("fused_gram_inv_", "")


def stage_breakdown(torch, ops, build, dev, gen) -> dict:
    """``smw_update``'s and ``fused_gram_inv``'s large routes launch by
    launch (:func:`by_launch`) at ``chip_smoke.LARGE``'s shapes and the
    paths' (``SMW_PATH``, ``GRAM_PATH``), beside the bounds of the stages
    the products do (H100 SXM peaks, 989 TFLOP/s bf16, 3.35 TB/s): the
    three products' operations (``smw_*_products_bound_ms``: 3 partials of
    V M, Y V^T and Y^T Z); the Gram's (``gram_*_gram_bound_ms``: 3
    partials, one for bf16, of a^T a, against the activations read once
    and the Grams written once, the larger of the two)."""
    from chip_smoke import LARGE
    from repro_torch.core import soi

    out = {}
    kw = dict(decay=0.95, cscale=0.05)
    for nb, k, bs in tuple(LARGE["smw"]) + SMW_PATH:
        m = torch.randn(nb, bs, 2 * bs, device=dev, generator=gen)
        a = m @ m.transpose(-1, -2) / (2 * bs)
        lam = soi.tikhonov_damping(a, 0.03)
        inv = (torch.linalg.inv(a + lam[:, None, None] * torch.eye(
            bs, device=dev)) / 3e-4 ** 2).contiguous()
        v = torch.randn(nb, k, bs, device=dev, generator=gen) * 3e-4
        del m, a, lam
        for stage, ms in by_launch(
                torch, build, lambda: ops.smw_update(inv, v, **kw),
                smw_stage).items():
            out[f"smw_{nb}x{k}x{bs}_{stage}_ms"] = ms
        flops = 2.0 * 3 * nb * (k * bs * bs + k * k * bs + bs * bs * k)
        out[f"smw_{nb}x{k}x{bs}_products_bound_ms"] = flops / 989e12 * 1e3
        del inv, v
    for t, nb, n in tuple(LARGE["gram"]) + GRAM_PATH:
        acts = torch.randn(t, nb, n, device=dev, generator=gen)
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16,
                                                     "bf16")):
            x = acts.to(dtype)
            for stage, ms in by_launch(
                    torch, build, lambda: ops.fused_gram_inv(
                        x, rel_damp=0.03, **KFAC_COUNTS),
                    gram_stage).items():
                out[f"gram_{t}x{nb}x{n}_{tag}_{stage}_ms"] = ms
            partials = 3 if dtype == torch.float32 else 1
            out[f"gram_{t}x{nb}x{n}_{tag}_gram_bound_ms"] = 1e3 * max(
                2.0 * partials * nb * n * n * t / 989e12,
                (x.element_size() * t * nb * n + 4 * nb * n * n) / 3.35e12)
            del x
        del acts
    return out


# fused_precond's large route timed launch by launch (wu_breakdown)
WU_SHAPES = ((1536, 256, 256), (512, 130, 200))


def wu_stage(lib, entry, i) -> str:
    """fused_precond's stages: the two pool splits, then g's; the two
    products in order; the dots."""
    name = entry.replace("fused_precond_", "")
    if name == "split":
        return "split_pools" if i < 2 else "split_g"
    if name == "product":
        return "product_%d" % (1 + i % 2)
    return name


def wu_breakdown(torch, ops, dev, gen, tag="") -> dict:
    """ms of ``fused_precond``'s large-route launches by kind
    (:func:`by_launch`), the whole call, and the host's time to enqueue
    one, at :data:`WU_SHAPES` with pools as ``chip_smoke.LARGE`` makes
    them."""
    from chip_smoke import LARGE
    from repro_torch.kernels import build

    run, out = LARGE["pool_run"], {}
    for nt, bi, bo in WU_SHAPES:
        na, ng = -(-nt // run), max(1, min(run, nt))
        pa = torch.randn(na, bi, bi, device=dev, generator=gen)
        pg = torch.randn(ng, bo, bo, device=dev, generator=gen)
        g = torch.randn(nt, bi, bo, device=dev, generator=gen)
        t = torch.arange(nt, device=dev)
        a_src, g_src = (t // run).to(torch.int32), (t % ng).to(torch.int32)
        shape = f"{nt}x{bi}x{bo}"
        for name, ms in by_launch(
                torch, build,
                lambda: ops.fused_precond(pa, g, pg, a_src, g_src),
                wu_stage).items():
            out[f"wu{tag}_{shape}_{name}_ms"] = ms
        out[f"wu{tag}_{shape}_call_ms"] = time_ms(
            torch, lambda: ops.fused_precond(pa, g, pg, a_src, g_src))
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.fused_precond(pa, g, pg, a_src, g_src)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        out[f"wu{tag}_{shape}_enqueue_ms"] = statistics.median(enqueue)
        del pa, pg, g
    return out


def ablate_wu(torch, ops, build, dev, gen) -> dict:
    """:func:`wu_breakdown` with ``fused_precond``'s library built from
    copies of its source and of ``csrc/hilo_tma.cuh`` with the products'
    epilogue cut out (wrong results, times only)."""
    from repro_torch.kernels import fused_precond as kf

    old, new = NO_EPILOGUE
    cut_dir = build.BUILD_DIR / "ablate" / "wu_no_epilogue"
    cut_dir.mkdir(parents=True, exist_ok=True)
    (cut_dir / "hilo_tma.cuh").write_text(
        (build.CSRC / "hilo_tma.cuh").read_text().replace(old, new))
    (cut_dir / "fused_precond.cu").write_text(
        (build.CSRC / "fused_precond.cu").read_text())
    so = cut_dir / "libfused_precond.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(so), str(cut_dir / "fused_precond.cu")], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the wu_no_epilogue cut:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    fns = {}
    for sym, argtypes in kf.LIB.entries.items():
        fns[sym] = getattr(lib, sym)
        fns[sym].argtypes = argtypes
        fns[sym].restype = ctypes.c_int
    built = kf.LIB._load()
    kf.LIB._fns = fns
    try:
        return wu_breakdown(torch, ops, dev, gen, tag="_no_epilogue")
    finally:
        kf.LIB._fns = built


def lu_breakdown(torch, dev, gen) -> dict:
    """ms of the blocked LU's launches by kind, a solve at a time."""
    from repro_torch.kernels import smw_update as ks

    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for nb, k, bs in ((2, 1024, 1024), (768, 256, 256), (1152, 256, 176)):
        lds, ldy = row_stride(k), row_stride(bs)
        s0 = torch.randn(nb, k, lds, device=dev, generator=gen) \
            + 30 * torch.eye(k, lds, device=dev)
        s = s0.clone()
        y = torch.randn(nb, k, ldy, device=dev, generator=gen)
        z = torch.empty_like(y)
        piv = torch.empty(nb, lds, dtype=torch.int32, device=dev)
        op = {"s": (s.data_ptr(), k * lds, lds),
              "y": (y.data_ptr(), k * ldy, ldy),
              "z": (z.data_ptr(), k * ldy, ldy),
              "piv": (piv.data_ptr(), lds, lds)}
        times = {"panel": [], "update": [], "back": []}
        for rep in range(6):
            s.copy_(s0)
            evs = []
            for kind, j0, _ in ks.lu_schedule(k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                ks._solve_step(kind, j0, op, nb, k, bs, 1.0, stream, None)
                e1.record()
                evs.append((kind, e0, e1))
            torch.cuda.synchronize()
            if rep:   # the first warms up
                for kind in times:
                    times[kind].append(sum(e0.elapsed_time(e1)
                                           for kd, e0, e1 in evs
                                           if kd == kind))
        for kind, ts in times.items():
            out[f"lu_{nb}x{k}x{bs}_{kind}_ms"] = statistics.median(ts)
        del s0, s, y, z, piv
    return out


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
    out.update(large_routes(torch, ops, dev, gen))
    from repro_torch.kernels import fused_gram_solve as kg
    from repro_torch.kernels import fused_precond as kf
    from repro_torch.kernels import smw_update as ks
    if hasattr(kf, "wu_schedule"):
        out.update(wu_breakdown(torch, ops, dev, gen))
    if hasattr(ks, "lu_schedule"):
        out.update(lu_breakdown(torch, dev, gen))
    if getattr(ks, "MAX_N", 128) > 128 and getattr(kg, "MAX_N", 128) > 128:
        out.update(stage_breakdown(torch, ops, build, dev, gen))
    if args.ablate:   # last: it loads three more libraries
        x = torch.randn(2048, 1024, device=dev, generator=gen)
        w = torch.randn(1024, 2816, device=dev, generator=gen)
        out["bitslice_mm_ablate_loop20_ms"] = ablate(torch, build, x, w)
        out["neumann_inv_products_ablate"] = ablate_products(
            torch, ops, build, dev, gen)
        out["fused_precond_ablate"] = ablate_wu(torch, ops, build, dev, gen)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
