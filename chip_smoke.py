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
                 least time the card could take (bound); neumann_inv at
                 both leaf sizes (528 and 192 blocks) and over a refresh
                 of the main path's 11 leaves, one grouped launch against
                 11 launches (bitwise equal); fused_gram_inv on fp32 and
                 bf16 activations, at the K-FAC counts and at 0/1/0 (the
                 Gram and X0 only); fused_precond
                 in both forms on the main path's own WU plan (pool
                 indexed by a_src/g_src, as the main path calls it, and
                 gathered), beside the route the indexed form replaces
                 (gather, then a gathered call); smw_update on both
                 sides against float64 Woodbury too; bitslice_mm at the
                 MLP product and at the precision_inv path's (128, 128) @
                 (128, 64), one call and 20 back to back, beside fp32
                 torch.matmul, with the L2 read rate of its tiles
  4. main path   full-width qwen1.5-0.5b (24 layers, d 1024, d_ff 2816,
                 vocab 151936), K-FAC block 128, batch 8 x seq 256, four
                 steps with stats and inverse refresh every 2 steps,
                 through ``repro_torch.launch.train``; launch counters
                 zeroed just before and read just after
  5. checks      finite losses, both its kernels launched on the main
                 path (fused_precond once a step, neumann_inv once a
                 block side a refresh), the run's own
                 inverses against the plain version on the same factor
                 blocks and against float64 torch.linalg.inv (achieved
                 bits); then the same four steps with torch.linalg.inv
                 as the INV method, for comparison
  6. smw path    the incremental-SOI path (``--smw``): the same model and
                 batch, four steps of one rank-64 SMW program each
                 (drift budget 0.05) with the drift-gated full
                 re-inversion; per step the phase seconds, drift,
                 fallback flag and loss; launch counters zeroed just
                 before and read just after (its three kernels must have
                 run, smw_update once a leaf a step, neumann_inv once a
                 block side a fallback); then the first
                 step without a fallback is updated again from its own
                 inverses and batch: kernel against plain version, and
                 the achieved bits of the run's, the kernel's, the plain
                 version's, the fp32 route's and float64 Woodbury's
                 inverses, beside those of a full re-inversion of the
                 same factors
  7. loop       the K-FAC CLI (``repro_torch.launch.train.main``) on the
                 main path's configuration through ``runtime.TrainLoop``:
                 6 steps, a checkpoint every 3 (about 4.75 GB each, the
                 free disk reckoned first), a device loss injected at
                 step 4, the telemetry spine on; recovery once, the
                 losses of the steps the main path also ran bitwise its
                 own, both kernels launched as the cadence from the
                 restored step gives, the three obs artifacts; the
                 checkpoint bytes, save dispatch, write and restore
                 seconds, and peak memory
  8. sgd        the same CLI with ``--optimizer sgd``, 4 steps on the same
                 batches: finite losses, no kernel launched
  9. precision  the same CLI at ``--precision int8``, 2 steps: the pooled
                 einsum WU route (no fused_precond), neumann_inv on the
                 refresh, the WU seconds and peak memory; then
                 ``lowp.parity.update_parity`` at hilo and int8 on the
                 card, >= 16 bits
  10. precision_inv  the composed-precision inversion library: the circuit
                 model at the Fig. 5 toy and the production config
                 (achieved bits, >= 16 asserted; cycle counts), the
                 quickstart block (bf16 alone, circuit model, the port's
                 composed inverse), then with launch counters zeroed just
                 before and read just after: ``mxu_inv_apply`` (through
                 bitslice_mm) on a damped 128-block with a 128 x 64
                 right-hand side, and ``fused_gram_inv`` on the
                 activations of the main path's first batch for every A
                 leaf, each held to its plain version, the fused
                 inverses also to the two-step route (Gram, then
                 neumann_inv) and to float64 torch.linalg.inv
  11. async_inv  the K-FAC CLI with ``--async-inv``, 6 steps (triggers at
                 0, 2, 4; swaps at 2 and 4): finite losses, 3 dispatched
                 and 2 swapped, neumann_inv once a trigger and every
                 launch on a stream other than the main one, fused_precond
                 once a step; ``launch.train.run`` of the same program,
                 each step's inverses bitwise a synchronous refresh of the
                 factors of the trigger before the last (identities before
                 the first swap), and how long each trigger's refresh ran
                 on past the main stream; steps 2-3 of a third run under
                 torch.profiler: the side stream's neumann_inv interval
                 and the main-stream kernel time inside it, the stream
                 priority used; the CLI with a checkpoint every 3 steps
                 and a device loss at step 4: the step-3 checkpoint holds
                 the pending inverses bitwise, the restore completes;
                 ``--dist-inv``, 4 steps, losses bitwise the main path's;
                 on the main path's factors, ``invert_factor_tree``
                 through plans of 1 and 4 devices bitwise the replicated
                 path, pdiv at a cap of 64 against the direct kernel route
                 (achieved bits, ms), Gauss-Newton's G refresh through the
                 solver bitwise; the factors of one stats step at block
                 256 through pdiv at a cap of 128 (bits, ms)
  12. families   the other decoder families on the main path's batch,
                 block and cadence: moonshot-v1-16b-a3b (moe, 2 of 48
                 layers), falcon-mamba-7b (ssm, 8 of 64) and qwen2-vl-7b
                 (vlm, 3 of 28, with (8, 256, 1280) image embeddings and
                 (3, 8, 256) M-RoPE positions) at their published widths,
                 and recurrentgemma-9b at its smoke config (hybrid: one
                 unit and an unstacked tail); each 4 K-FAC steps of
                 ``launch.train.run`` with the launch counters zeroed
                 just before and read just after (fused_precond once a WU
                 group a step, neumann_inv once a block side and 32
                 leaves a refresh), finite losses, the run's inverses
                 against the plain version, one fused_precond call on the
                 family's own WU plan and the refresh of its largest
                 block side against their plain versions and timed
                 (beside the library call and the bound), phase seconds
                 and peak memory; then one ``--optimizer sgd`` step of the
                 same config through the CLI, no kernel launched
  13. whisper    whisper-tiny (audio encoder-decoder, 4 + 4 layers, d
                 384, vocab 51865) at its published widths: 4 K-FAC steps
                 of ``launch.train.run`` on 8 x 448 decoder tokens with
                 448 seeded frames, block 128, the same cadence; launch
                 counters zeroed just before and read just after
                 (neumann_inv 2, fused_precond 4), finite losses, the
                 run's inverses and one fused_precond call on its WU
                 plan against their plain versions (timed, beside the
                 library call and the bound); one SGD step; one static
                 serve (batch 8, a 4-token prompt, 32 tokens, greedy)
  14. serve      the serving path on qwen1.5-0.5b at full width: the
                 static path (batch 8, prompt 256, 32 tokens, greedy);
                 the engine on ``synthetic_trace`` (16 requests, prompts
                 of 256-512, up to 64 tokens, 8 slots of 1024 columns,
                 decode chunks of 8); each request held to the static
                 path's greedy decode of its prompt (first tokens agree;
                 a later divergence only where the static run's top two
                 logits lie within SERVE_GAP_TOL, counted); one decode
                 chunk of 8 live slots under
                 ``torch.cuda.set_sync_debug_mode("error")``; then
                 falcon-mamba-7b (8 of 64 layers) and recurrentgemma's
                 smoke config through the engine, each held to its
                 static path; prefill and decode seconds, decode tokens
                 a second, each request's time to first token, resident
                 bytes, peak memory; no kernel launched (checked)
  15. trace      the main path's four steps again, the fourth under
                 torch.profiler (kernels only): the device's busy time
                 against the step's wall time, and the top kernels; last,
                 so that the profiler session cannot perturb the phases
                 timed before it

Then a JSON line of per-kernel results (with whisper's launches and the
serve phase's, none), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero
without the ``ok`` line; so does a machine without CUDA, or a directory
without the repository's ``src/repro_torch``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_FP32_FLOP_PER_S = 67e12
# the output tile of csrc/bitslice_mm.cu (rows, columns): what its L2 reads
# are counted from
BITSLICE_TILE = (128, 192)

MAIN = dict(arch="qwen1.5-0.5b", batch=8, seq=256, steps=4, stats_every=2,
            inv_every=2, block_size=128, seed=0)
SMW = dict(steps=4, rank=64, drift_budget=0.05)
# the other decoder families on the main path's batch and cadence: the
# published widths and vocabularies, depth cut to fit one card (layers;
# None keeps the config's own), recurrentgemma at its smoke config (its
# untied 256000 x 4096 embedding and head alone fill the card)
FAMILIES = (
    dict(family="moe", arch="moonshot-v1-16b-a3b", layers=2),
    dict(family="ssm", arch="falcon-mamba-7b", layers=8),
    dict(family="vlm", arch="qwen2-vl-7b", layers=3),
    dict(family="hybrid", arch="recurrentgemma-9b", layers=None,
         smoke=True),
)
# whisper-tiny at its published widths: 8 sequences of its 448 decoder
# tokens (max_target_positions) with 448 seeded frames, the main path's
# block and cadence
WHISPER = dict(batch=8, seq=448, steps=4, stats_every=2, inv_every=2,
               block_size=128, seed=0)
# the serving path on the main path's model: the static batch, the
# engine's synthetic trace, and the recurrent families (falcon-mamba-7b
# at its published widths with depth cut as in FAMILIES, recurrentgemma
# at its smoke config)
SERVE = dict(arch="qwen1.5-0.5b", seed=0, static_batch=8, static_prompt=256,
             static_gen=32, requests=16, prompt_len=512, gen=64,
             max_slots=8, max_len=1024, decode_chunk=8,
             recurrent=(
                 dict(arch="falcon-mamba-7b", layers=8, requests=4,
                      prompt_len=64, gen=16, max_slots=2),
                 dict(arch="recurrentgemma-9b", smoke=True, requests=4,
                      prompt_len=24, gen=8, max_slots=2)))
# a greedy divergence between the engine and the static path must start
# where the static run's top two logits lie within this: both compute in
# bf16 but round differently (the engine prefills a padded bucket and
# attends over its 1024 columns), and random weights give near-flat
# logits (15 of 16 requests diverged, at gaps of 0.0035-0.0167, on an
# H100 80GB HBM3 at 700 W)
SERVE_GAP_TOL = 0.05
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


def time_ms(torch, fn, reps=5, launches=1) -> float:
    """Median of ``reps`` warm runs of ``launches`` calls back to back,
    timed with CUDA events; ms a call."""
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


def bound(n_bytes: float, flops: float, fp32_flops: float = 0.0):
    """Least ms for ``n_bytes`` of device memory traffic and ``flops``
    bf16 tensor-core plus ``fp32_flops`` fp32 operations."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_BF16_FLOP_PER_S
             + fp32_flops / PEAK_FP32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a tree of dicts, lists, tuples and
    dataclasses."""
    if hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(tensor_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


class WithImages:
    """The VLM's batch: the token dataset's rows plus ``img_embeds``
    (B, n_img, vision_dim) and M-RoPE positions (3, B, T), made once
    from the seed on the card (the image tokens on a 16 x 16 grid, any
    text after them counting on in all three streams)."""

    def __init__(self, torch, ds, cfg, seed, device):
        g = torch.Generator(device=device).manual_seed(seed)
        b, t, n = ds.global_batch, ds.seq_len, cfg.n_img_tokens
        self.ds = ds
        self.img = torch.randn((b, n, cfg.vision_dim), generator=g,
                               device=device)
        side = math.isqrt(n - 1) + 1
        i = torch.arange(n, device=device)
        grid = torch.stack([torch.zeros_like(i), i // side, i % side])
        text = side + torch.arange(t - n, device=device)
        pos = torch.cat([grid, text.expand(3, t - n)], dim=1)
        self.pos = pos[:, None, :].expand(3, b, t).to(torch.int32) \
            .contiguous()

    def batch(self, cursor, *, device):
        out = self.ds.batch(cursor, device=device)
        out.update(img_embeds=self.img, positions=self.pos)
        return out


def kfac_launch_checks(check, name, state, hist, launches, wu) -> int:
    """A K-FAC run's launches: ``fused_precond`` once a WU group a step,
    ``neumann_inv`` once a block side (and 32 leaves) a refresh. Returns
    the launches a refresh makes."""
    from repro_torch.kernels.neumann_inv import MAX_LEAVES

    check(launches["fused_precond"] == len(hist) * len(wu.groups),
          f"{name}: fused_precond once a WU group a step")
    by_side = {}
    for d in state.kfac.factors.values():
        for t in d.values():
            by_side[t.shape[-1]] = by_side.get(t.shape[-1], 0) + 1
    per_refresh = sum(-(-c // MAX_LEAVES) for c in by_side.values())
    refreshes = sum("inv" in h["phase_s"] for h in hist)
    check(launches["neumann_inv"] == refreshes * per_refresh,
          f"{name}: neumann_inv once a block side a refresh")
    return per_refresh


def kfac_kernel_checks(torch, dev, check, name, box, kcfg, wu):
    """The kernels of a K-FAC run held to their plain versions and
    timed: the run's inverses (``box["state"]``, popped so that its
    memory can go before the WU's tiles are made) against the plain
    ``neumann_inv`` on the same factor blocks; the refresh of the
    largest block side, one grouped call; and one ``fused_precond``
    call on the WU plan ``wu``'s largest group (the run's inverse pools,
    random tiles), each beside its library call and its bound. Returns
    ``(worst inverse, refresh row, fused_precond row)``."""
    from repro_torch.core import kfac, soi
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.neumann_inv import MAX_LEAVES

    import gc

    import numpy as np

    state = box.pop("state")
    by_side = {}
    for d in state.kfac.factors.values():
        for t in d.values():
            by_side[t.shape[-1]] = by_side.get(t.shape[-1], 0) + 1
    # the run's inverses against the plain version on its factors
    worst = dict(rel_err=0.0, leaf=None)
    leaves = []
    for lname, d in state.kfac.factors.items():
        for side, f in d.items():
            flat = f.reshape(-1, f.shape[-1], f.shape[-1])
            lam = soi.tikhonov_damping(flat, kcfg.damping)
            leaves.append((flat, lam))
            mine = state.kfac.inverses[lname][side + "_inv"].reshape(
                flat.shape)
            plain = ref.neumann_inv_ref(flat, lam, **KFAC_COUNTS)
            rel = float((mine - plain).abs().max()
                        / plain.abs().max())
            if rel > worst["rel_err"]:
                worst = dict(rel_err=rel, leaf=f"{lname}/{side}")
            check(rel <= REL_TOL_RUN, f"{name}: {lname}/{side} "
                  f"neumann_inv kernel vs plain (run)")
            del mine, plain

    # the refresh of the largest block side, timed: one grouped call
    n_big = max(by_side)
    big = [(x, y) for x, y in leaves if x.shape[-1] == n_big]
    blocks, lams = [x for x, _ in big], [y for _, y in big]
    nb = sum(x.shape[0] for x in blocks)
    prods = (5 * KFAC_COUNTS["ns_iters"]
             + 5 * (KFAC_COUNTS["taylor_terms"] - 1)
             + 6 * KFAC_COUNTS["refine_steps"])
    inv_b_ms, inv_b_by = bound(4.0 * (2 * nb * n_big * n_big + nb),
                               2.0 * n_big ** 3 * prods * nb)
    cat = torch.cat(blocks)
    cat_lam = torch.cat(lams)
    eye = torch.eye(n_big, device=dev)
    refresh_row = dict(
        block_side=n_big, leaves=len(blocks), blocks=nb,
        launches=-(-len(blocks) // MAX_LEAVES),
        ms=time_ms(torch, lambda: ops.neumann_inv_grouped(
            blocks, lams, **KFAC_COUNTS)),
        plain_ms=time_ms(torch, lambda: [ref.neumann_inv_ref(
            x, y, **KFAC_COUNTS) for x, y in big]),
        library_ms=time_ms(torch, lambda: torch.linalg.inv(
            cat + cat_lam[:, None, None] * eye)),
        bound_ms=inv_b_ms, bound_by=inv_b_by)
    del cat, cat_lam, leaves, big, blocks, lams

    # one fused_precond call on the family's own WU plan: its largest
    # group, the run's inverse pools, random gradient tiles; the
    # plain version in chunks of 8192 tiles (the tiles are
    # independent: the same function with a bounded footprint)
    grp = max(wu.groups, key=lambda g: g.n_tiles)
    pools = kfac.inverse_pools(state.kfac.inverses, wu.inv_plan)
    pa, pg = pools[grp.bi], pools[grp.bo]
    del state, pools
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(MAIN["seed"])
    g = torch.randn(grp.n_tiles, grp.bi, grp.bo, device=dev,
                    generator=gen)
    a_src, g_src = grp.src_on(dev)

    def plain():
        parts = [ref.fused_precond_ref(pa, g[lo:lo + 8192], pg,
                                       a_src[lo:lo + 8192],
                                       g_src[lo:lo + 8192])
                 for lo in range(0, g.shape[0], 8192)]
        return (torch.cat([o for o, _ in parts]),
                torch.cat([d for _, d in parts]))

    out, dots = ops.fused_precond(pa, g, pg, a_src, g_src)
    p_out, p_dots = plain()
    err = float((out - p_out).abs().max())
    scale = float(p_out.abs().max())
    d_err = float((dots - p_dots).abs().max())
    d_scale = float(p_dots.abs().max())
    check(err <= REL_TOL * scale, f"{name}: fused_precond vs plain")
    check(d_err <= REL_TOL * d_scale,
          f"{name}: fused_precond vs plain (dots)")
    nt, bi, bo = grp.n_tiles, grp.bi, grp.bo
    # each input read once (each distinct pool block once), each
    # output written once
    n_a, n_g = np.unique(grp.a_src).size, np.unique(grp.g_src).size
    wu_b_ms, wu_b_by = bound(
        4.0 * (2 * nt * bi * bo + nt + n_a * bi * bi + n_g * bo * bo),
        2.0 * nt * 3 * (bi * bi * bo + bi * bo * bo))
    a_idx, g_idx = a_src.long(), g_src.long()
    precond_row = dict(
        shape=[nt, bi, bo], groups=len(wu.groups), rel_err=err / scale,
        dots_rel_err=d_err / d_scale,
        ms=time_ms(torch, lambda: ops.fused_precond(pa, g, pg, a_src,
                                                    g_src)),
        plain_ms=time_ms(torch, plain),
        library_ms=time_ms(torch, lambda: torch.matmul(
            torch.matmul(pa[a_idx], g), pg[g_idx])),
        bound_ms=wu_b_ms, bound_by=wu_b_by)
    del out, dots, p_out, p_dots, pa, pg, g, a_idx, g_idx
    torch.cuda.empty_cache()

    return worst, refresh_row, precond_row


def families_phase(torch, dev, check, cli):
    """Phase ``families``: each entry of :data:`FAMILIES` trains 4 K-FAC
    steps through ``launch.train.run`` with the launch counters zeroed
    just before and read just after; finite losses, ``fused_precond``
    once a WU group a step and ``neumann_inv`` once a block side (and
    32 leaves) a refresh; the run's inverses against the plain version
    on the same factor blocks; one ``fused_precond`` call on the
    family's own WU plan (the run's inverse pools, random tiles) and the
    refresh of its largest block side, each against its plain version
    and timed; then one ``--optimizer sgd`` step of the same config
    through the CLI, with no kernel launched. Returns one record a
    family."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import kfac
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod

    import gc

    rows = []
    for fam in FAMILIES:
        t_phase = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        held_gb = torch.cuda.memory_allocated(dev) / 1e9
        cfg = (get_smoke_config if fam.get("smoke") else get_config)(
            fam["arch"])
        full_layers = cfg.n_layers
        if fam["layers"]:
            cfg = dataclasses.replace(cfg, n_layers=fam["layers"])
        bs = min(MAIN["block_size"], cfg.soi_block)
        kcfg = kfac.KFACConfig(
            stats_every=MAIN["stats_every"], inv_every=MAIN["inv_every"],
            block_size=bs, stats_batch=MAIN["batch"], stats_seq=MAIN["seq"])
        ds = SyntheticTokens(vocab=cfg.vocab, seq_len=MAIN["seq"],
                             global_batch=MAIN["batch"], seed=MAIN["seed"])
        if cfg.family == "vlm":
            ds = WithImages(torch, ds, cfg, MAIN["seed"], dev)
        program = train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                        device="cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = train_mod.run(program, ds, MAIN["steps"])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        name = cfg.name
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(x) for x in losses),
              f"{name}: finite losses")
        wu = train_mod.steps_mod.make_wu_plan_for(cfg, state)
        per_refresh = kfac_launch_checks(check, name, state, hist,
                                         launches, wu)
        n_params = sum(p.numel() for p in state.params.values())
        box = {"state": state}
        del state, program
        worst, refresh_row, precond_row = kfac_kernel_checks(
            torch, dev, check, name, box, kcfg, wu)

        # one first-order step of the same config through the CLI (the
        # CLI's --arch names the published depth: the cut config is
        # handed to it for this call)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        get_cfg = train_mod.get_smoke_config if fam.get("smoke") \
            else train_mod.get_config
        attr = get_cfg.__name__
        setattr(train_mod, attr, lambda arch, _c=cfg: _c)
        try:
            sgd_sum = cli(["--arch", fam["arch"], "--optimizer", "sgd",
                           "--steps", "1", "--batch", str(MAIN["batch"]),
                           "--seq", str(MAIN["seq"]),
                           "--seed", str(MAIN["seed"])]
                          + (["--smoke"] if fam.get("smoke") else []))
        finally:
            setattr(train_mod, attr, get_cfg)
        sgd_launches = ops.launch_counts()
        sgd_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        check(len(sgd_sum["losses"]) == 1
              and math.isfinite(sgd_sum["losses"][0]),
              f"{name}: one finite sgd step")
        check(set(sgd_launches.values()) == {0},
              f"{name}: sgd launches no kernel")
        torch.cuda.empty_cache()
        rows.append(dict(
            family=fam["family"], arch=name, layers=cfg.n_layers,
            held_at_start_gb=held_gb,
            published_layers=full_layers, d_model=cfg.d_model,
            vocab=cfg.vocab, params=n_params, block_size=bs,
            batch=MAIN["batch"], seq=MAIN["seq"],
            train_accum=cfg.train_accum, steps=MAIN["steps"],
            losses=losses, phase_s=[h["phase_s"] for h in hist],
            wall_s=wall, peak_mem_gb=peak, launches=launches,
            neumann_inv_per_refresh=per_refresh,
            inv_blocks=wu.inv_plan.total_blocks, wu_tiles=wu.total_tiles,
            worst_inverse=worst, refresh=refresh_row,
            fused_precond=precond_row, sgd_losses=sgd_sum["losses"],
            sgd_peak_mem_gb=sgd_peak,
            sgd_phase_s=[h["phase_s"] for h in sgd_sum["history"]],
            phase_seconds=time.perf_counter() - t_phase))
    return rows


class WithFrames:
    """Whisper's batch: the token dataset's rows plus ``enc_embeds``
    (B, ``steps.enc_len_for(seq)``, d_model) frame embeddings, made once
    from the seed on the card (the reference's token stream makes none;
    its tests build them by hand)."""

    def __init__(self, torch, ds, cfg, seed, device):
        from repro_torch.launch.steps import enc_len_for

        g = torch.Generator(device=device).manual_seed(seed)
        self.ds = ds
        self.frames = torch.randn(
            (ds.global_batch, enc_len_for(cfg, ds.seq_len), cfg.d_model),
            generator=g, device=device)

    def batch(self, cursor, *, device):
        out = self.ds.batch(cursor, device=device)
        out["enc_embeds"] = self.frames
        return out


def whisper_phase(torch, dev, check):
    """Phase ``whisper``: whisper-tiny at its published widths (4 + 4
    layers, d 384, vocab 51865), weights from the seed, 4 K-FAC steps of
    ``launch.train.run`` on :data:`WHISPER`'s batch with seeded frames,
    the launch counters zeroed just before and read just after: finite
    losses, ``neumann_inv`` once a refresh and ``fused_precond`` once a
    step, the run's inverses and one WU call against their plain
    versions (timed, beside library call and bound); one SGD step; then
    one static serve (greedy). Returns the phase's record."""
    from argparse import Namespace

    from repro_torch.configs import get_config
    from repro_torch.core import kfac
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config("whisper-tiny")
    name = cfg.name
    kcfg = kfac.KFACConfig(
        stats_every=WHISPER["stats_every"], inv_every=WHISPER["inv_every"],
        block_size=WHISPER["block_size"], stats_batch=WHISPER["batch"],
        stats_seq=WHISPER["seq"])
    ds = WithFrames(torch, SyntheticTokens(
        vocab=cfg.vocab, seq_len=WHISPER["seq"],
        global_batch=WHISPER["batch"], seed=WHISPER["seed"]),
        cfg, WHISPER["seed"], dev)
    program = train_mod.KFACProgram(cfg, kcfg, seed=WHISPER["seed"],
                                    device="cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = train_mod.run(program, ds, WHISPER["steps"])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"{name}: finite losses")
    wu = train_mod.steps_mod.make_wu_plan_for(cfg, state)
    per_refresh = kfac_launch_checks(check, name, state, hist, launches,
                                     wu)
    check(launches["neumann_inv"] == 2 and launches["fused_precond"] == 4,
          f"{name}: 2 neumann_inv and 4 fused_precond launches")
    n_params = sum(p.numel() for p in state.params.values())
    frames = ds.frames.shape
    box = {"state": state}
    del state, program
    worst, refresh_row, precond_row = kfac_kernel_checks(
        torch, dev, check, name, box, kcfg, wu)

    # one first-order step (the CLI refuses whisper: its token stream
    # makes no frames, as the reference's does not)
    sgd = train_mod.SGDProgram(cfg, seed=WHISPER["seed"], device="cuda")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    sgd_state = sgd.init_state()
    _, sgd_m = sgd.make_step(sgd_state)(
        sgd_state, ds.batch(train_mod.DataCursor(), device=dev))
    sgd_loss = float(sgd_m["loss"])
    sgd_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    check(math.isfinite(sgd_loss), f"{name}: one finite sgd step")
    check(set(ops.launch_counts().values()) == {0},
          f"{name}: sgd launches no kernel")
    del sgd_state

    # one static serve through the serving CLI's function
    args = serve_mod.build_parser().parse_args(
        ["--arch", name, "--static", "--batch", "8", "--prompt-len", "4",
         "--gen", "32", "--seed", str(WHISPER["seed"])])
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        serve_sum, gen = serve_mod.serve_static(cfg, args, dev)
    serve_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    check(gen.shape == (8, 32) and bool(((gen >= 0) & (gen < cfg.vocab))
                                        .all()),
          f"{name}: static serve tokens in the vocabulary")
    check(set(ops.launch_counts().values()) == {0},
          f"{name}: serving launches no kernel")
    torch.cuda.empty_cache()
    return dict(
        arch=name, enc_layers=cfg.n_enc_layers, dec_layers=cfg.n_dec_layers,
        d_model=cfg.d_model, vocab=cfg.vocab, params=n_params,
        frames=list(frames), **WHISPER, losses=losses,
        phase_s=[h["phase_s"] for h in hist], wall_s=wall,
        peak_mem_gb=peak, launches=launches,
        neumann_inv_per_refresh=per_refresh,
        inv_blocks=wu.inv_plan.total_blocks, wu_tiles=wu.total_tiles,
        worst_inverse=worst, refresh=refresh_row, fused_precond=precond_row,
        sgd_loss=sgd_loss, sgd_peak_mem_gb=sgd_peak,
        sgd_phase_s=sgd_m["phase_s"], serve=serve_sum,
        serve_peak_mem_gb=serve_peak,
        phase_seconds=time.perf_counter() - t_phase)


def held_to_static(torch, cfg, params, prompt, got, dev):
    """The engine's tokens ``got`` for ``prompt`` against the static
    path's greedy decode of it (batch 1, the exact prompt), step by step
    until the first divergence: the first tokens must agree, and a later
    divergence must start where the static run's top two logits lie
    within :data:`SERVE_GAP_TOL` (past it the two runs decode different
    text). Returns ``(ok, step of the divergence or None, top-2 gap
    there)``."""
    from repro_torch.launch import steps as steps_mod

    mod = steps_mod.model_module(cfg)
    cache = mod.init_cache(cfg, 1, len(prompt) + len(got), device=dev)
    logits, cache = mod.prefill(
        cfg, params, {"tokens": torch.from_numpy(prompt[None]).to(dev)},
        cache)
    for i, t in enumerate(got):
        top = torch.topk(logits[0].float(), 2).values
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        if int(tok) != t:
            gap = float(top[0] - top[1])
            return i > 0 and gap <= SERVE_GAP_TOL, i, gap
        if i < len(got) - 1:
            logits, cache = mod.decode_step(cfg, params, tok, cache)
    return True, None, None


def hold_to_static(torch, cfg, params, done, reqs, dev):
    """Every request of a trace held to the static path
    (:func:`held_to_static`). Returns ``(all held, divergences [(rid,
    step, gap)])``."""
    ok, div = True, []
    for r in reqs:
        got = done[r.rid].tokens
        ok_r, j, gap = held_to_static(torch, cfg, params, r.prompt, got,
                                      dev)
        ok &= ok_r and len(got) == r.max_new_tokens
        if j is not None:
            div.append((r.rid, j, gap))
    return ok, div


def serve_phase(torch, dev, check):
    """Phase ``serve``: the serving path of :data:`SERVE`'s model at full
    width, weights from the seed: the static path; the engine on
    ``synthetic_trace``, held to the static path (greedy) request by
    request; one decode chunk under ``set_sync_debug_mode("error")``;
    then the recurrent families through the engine, each held to its
    static path. No kernel is launched (checked). Returns the phase's
    record."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import EngineConfig, ServeEngine, synthetic_trace

    t_phase = time.perf_counter()
    parse = serve_mod.build_parser().parse_args
    cfg = get_config(SERVE["arch"])
    name = cfg.name
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    out = dict(arch=name)
    with torch.no_grad():
        params = serve_mod.init_params(cfg, SERVE["seed"], dev)
        st_args = parse(["--arch", name, "--static",
                         "--batch", str(SERVE["static_batch"]),
                         "--prompt-len", str(SERVE["static_prompt"]),
                         "--gen", str(SERVE["static_gen"]),
                         "--seed", str(SERVE["seed"])])
        st_sum, st_gen = serve_mod.serve_static(cfg, st_args, dev,
                                                params=params)
        check(st_gen.shape == (SERVE["static_batch"], SERVE["static_gen"])
              and bool(((st_gen >= 0) & (st_gen < cfg.vocab)).all()),
              f"{name}: static tokens in the vocabulary")
        en_args = parse(["--arch", name,
                         "--requests", str(SERVE["requests"]),
                         "--prompt-len", str(SERVE["prompt_len"]),
                         "--gen", str(SERVE["gen"]),
                         "--max-slots", str(SERVE["max_slots"]),
                         "--max-len", str(SERVE["max_len"]),
                         "--decode-chunk", str(SERVE["decode_chunk"]),
                         "--seed", str(SERVE["seed"])])
        en_sum, done = serve_mod.serve_engine(cfg, en_args, dev,
                                              params=params)
        reqs, _ = synthetic_trace(cfg.vocab, SERVE["requests"],
                                  SERVE["prompt_len"], SERVE["gen"],
                                  SERVE["max_slots"], seed=SERVE["seed"])
        check(sorted(done) == [r.rid for r in reqs]
              and all(len(done[r.rid].tokens) == r.max_new_tokens
                      for r in reqs),
              f"{name}: every request served its budget")
        t0 = time.perf_counter()
        ok, div = hold_to_static(torch, cfg, params, done, reqs, dev)
        check(ok, f"{name}: engine vs static (first tokens agree, "
              f"divergences at top-2 gaps <= {SERVE_GAP_TOL})")
        static_ref_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 1e9

        # one decode chunk with every slot live, under the sync check
        eng = ServeEngine(cfg, params, EngineConfig(
            max_slots=SERVE["max_slots"], max_len=SERVE["max_len"],
            decode_chunk=SERVE["decode_chunk"]))
        for r in reqs[:SERVE["max_slots"]]:
            eng.submit(r)
        eng._do_admissions()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            toks, emitted = eng.decode_chunk()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        dispatch_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        chunk_s = time.perf_counter() - t0
        toks, emitted = toks.cpu().numpy(), emitted.cpu().numpy()
        chunk_ok = bool(emitted.all())
        for slot, st in eng._slots.items():
            chunk_ok &= held_to_static(
                torch, cfg, params, st.req.prompt,
                st.tokens + toks[:, slot].tolist(), dev)[0]
        check(chunk_ok, f"{name}: the sync-checked chunk held to the "
              f"static path")
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
        out.update(
            layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
            static=st_sum, engine=en_sum, peak_mem_gb=peak,
            divergences=[dict(rid=a, step=b, top2_gap=c) for a, b, c in div],
            n_divergences=len(div), gap_tol=SERVE_GAP_TOL,
            static_reference_s=static_ref_s,
            sync_checked_chunk=dict(tokens=int(emitted.sum()),
                                    dispatch_s=dispatch_s,
                                    wall_s=chunk_s))

        # the recurrent families through the engine, each held to its
        # static path
        rec_rows = []
        for fam in SERVE["recurrent"]:
            rcfg = (get_smoke_config if fam.get("smoke") else get_config)(
                fam["arch"])
            if fam.get("layers"):
                rcfg = dataclasses.replace(rcfg, n_layers=fam["layers"])
            torch.cuda.reset_peak_memory_stats(dev)
            rp = serve_mod.init_params(rcfg, SERVE["seed"], dev)
            args = parse(["--arch", fam["arch"],
                          "--requests", str(fam["requests"]),
                          "--prompt-len", str(fam["prompt_len"]),
                          "--gen", str(fam["gen"]),
                          "--max-slots", str(fam["max_slots"]),
                          "--decode-chunk", str(SERVE["decode_chunk"]),
                          "--seed", str(SERVE["seed"])])
            r_sum, r_done = serve_mod.serve_engine(rcfg, args, dev,
                                                   params=rp)
            r_reqs, _ = synthetic_trace(rcfg.vocab, fam["requests"],
                                        fam["prompt_len"], fam["gen"],
                                        fam["max_slots"], seed=SERVE["seed"])
            r_ok, r_div = hold_to_static(torch, rcfg, rp, r_done, r_reqs,
                                         dev)
            check(r_ok, f"{rcfg.name}: engine vs static")
            rec_rows.append(dict(
                arch=rcfg.name, family=rcfg.family, layers=rcfg.n_layers,
                d_model=rcfg.d_model, engine=r_sum,
                divergences=[dict(rid=a, step=b, top2_gap=c)
                             for a, b, c in r_div],
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9))
            del rp
            gc.collect()
            torch.cuda.empty_cache()
    launches = ops.launch_counts()
    check(set(launches.values()) == {0}, "serve: no kernel launched")
    out.update(recurrent=rec_rows, launches=launches,
               phase_seconds=time.perf_counter() - t_phase)
    return out


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
                           if "Used" in l or "spill" in l or "C7511" in l]
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
    eye = torch.eye(n, device=dev)
    products = (5 * KFAC_COUNTS["ns_iters"]
                + 5 * (KFAC_COUNTS["taylor_terms"] - 1)
                + 6 * KFAC_COUNTS["refine_steps"])

    def damped_blocks(nb):
        m = torch.randn(nb, n, 2 * n, device=dev, generator=gen)
        a = m @ m.transpose(-1, -2) / (2 * n)
        return a, soi.tikhonov_damping(a, 0.03)

    def inv_bound(nb):
        # each block read once, its inverse written once, the damping read
        return bound(4.0 * (2 * nb * n * n + nb),
                     2.0 * n ** 3 * products * nb)

    # neumann_inv at the main path's largest leaf (528 blocks) and at its
    # other leaf size (192)
    a, lam = damped_blocks(nb_max)
    got = ops.neumann_inv(a, lam, **KFAC_COUNTS)
    want = ref.neumann_inv_ref(a, lam, **KFAC_COUNTS)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    b_ms, b_by = inv_bound(nb_max)
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
    del a, lam, got, want
    leaf_nb = sorted({math.prod(t.shape[:-2]) for d in meta.values()
                      for t in d.values()})
    nb_small = leaf_nb[0]
    a, lam = damped_blocks(nb_small)
    got = ops.neumann_inv(a, lam, **KFAC_COUNTS)
    want = ref.neumann_inv_ref(a, lam, **KFAC_COUNTS)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    b_ms, b_by = inv_bound(nb_small)
    results["neumann_inv"]["small_leaf"] = dict(
        shape=[nb_small, n, n], max_abs_err=err, max_abs_plain=scale,
        ms=time_ms(torch, lambda: ops.neumann_inv(a, lam, **KFAC_COUNTS)),
        bound_ms=b_ms, bound_by=b_by)
    check(err <= REL_TOL * scale, "neumann_inv kernel vs plain (small leaf)")
    del a, lam, got, want

    # a refresh of the main path's own 11 factor leaves (3120 blocks): one
    # grouped launch, bitwise the 11 launches of one leaf each
    leaves = [damped_blocks(math.prod(t.shape[:-2]))
              for d in meta.values() for t in d.values()]
    blocks, lams = [x for x, _ in leaves], [y for _, y in leaves]
    before = ops.launch_counts()["neumann_inv"]
    grouped = ops.neumann_inv_grouped(blocks, lams, **KFAC_COUNTS)
    grouped_launches = ops.launch_counts()["neumann_inv"] - before
    per_leaf = [ops.neumann_inv(x, y, **KFAC_COUNTS) for x, y in leaves]
    bitwise = all(torch.equal(x, y) for x, y in zip(grouped, per_leaf))
    total = sum(x.shape[0] for x in blocks)
    b_ms, b_by = inv_bound(total)
    results["neumann_inv"]["refresh"] = dict(
        leaves=len(blocks), blocks=total, launches=grouped_launches,
        bitwise_equal_per_leaf=bitwise,
        ms=time_ms(torch, lambda: ops.neumann_inv_grouped(
            blocks, lams, **KFAC_COUNTS)),
        per_leaf_ms=time_ms(torch, lambda: [
            ops.neumann_inv(x, y, **KFAC_COUNTS) for x, y in leaves]),
        bound_ms=b_ms, bound_by=b_by)
    check(bitwise, "neumann_inv grouped bitwise the per-leaf launches")
    check(grouped_launches == 1, "neumann_inv: one launch for the refresh")
    del leaves, blocks, lams, grouped, per_leaf

    # fused_precond on the main path's own WU plan: its 18816 tiles read
    # their inverse blocks from one pool of 3120 random 128-blocks by the
    # plan's a_src/g_src (the indexed form the main path runs), and the
    # same tiles with the blocks gathered first (the gathered form, and
    # the route the indexed form replaces: gather, then a gathered call).
    # Bounds: each input read once, each output written once; the indexed
    # form reads each distinct pool block once.
    import numpy as np

    nt, bi, bo = grp.n_tiles, grp.bi, grp.bo
    pool = torch.randn(wu.inv_plan.total_blocks, bs, bs, device=dev,
                       generator=gen)
    g = torch.randn(nt, bi, bo, device=dev, generator=gen)
    a_src = torch.as_tensor(grp.a_src, device=dev)
    g_src = torch.as_tensor(grp.g_src, device=dev)
    a_idx, g_idx = a_src.long(), g_src.long()
    a_sel, g_sel = pool[a_idx], pool[g_idx]
    flops = 2.0 * nt * 3 * (bi * bi * bo + bi * bo * bo)

    def held(got, want):
        err = float((got - want).abs().max())
        return err, float(want.abs().max())

    out, dots = ops.fused_precond(pool, g, pool, a_src, g_src)
    p_out, p_dots = ref.fused_precond_ref(pool, g, pool, a_src, g_src)
    err, scale = held(out, p_out)
    d_err, d_scale = held(dots, p_dots)
    del out, dots, p_out, p_dots
    distinct = int(np.unique(grp.a_src).size + np.unique(grp.g_src).size)
    b_ms, b_by = bound(4.0 * (2 * nt * bi * bo + nt + distinct * bs * bs),
                       flops)
    check(err <= REL_TOL * scale, "fused_precond indexed vs plain (out)")
    check(d_err <= REL_TOL * d_scale, "fused_precond indexed vs plain (dots)")

    out, dots = ops.fused_precond(a_sel, g, g_sel)
    p_out, p_dots = ref.fused_precond_ref(a_sel, g, g_sel)
    gerr, gscale = held(out, p_out)
    gd_err, gd_scale = held(dots, p_dots)
    del out, dots, p_out, p_dots
    gb_ms, gb_by = bound(4.0 * nt * (bi * bi + 2 * bi * bo + bo * bo + 1),
                         flops)
    check(gerr <= REL_TOL * gscale, "fused_precond gathered vs plain (out)")
    check(gd_err <= REL_TOL * gd_scale,
          "fused_precond gathered vs plain (dots)")
    results["fused_precond"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/fused_precond.cu",
        replaces="src/repro/kernels/fused_precond.py:53",
        shape=[nt, bi, bo], pool_blocks=pool.shape[0],
        distinct_blocks=distinct, max_abs_err=err, max_abs_plain=scale,
        tol=REL_TOL * scale, dots_max_abs_err=d_err,
        dots_max_abs_plain=d_scale,
        ms=time_ms(torch, lambda: ops.fused_precond(pool, g, pool, a_src,
                                                    g_src)),
        replaced_route_ms=time_ms(torch, lambda: ops.fused_precond(
            pool[a_idx], g, pool[g_idx])),
        plain_ms=time_ms(torch, lambda: ref.fused_precond_ref(
            pool, g, pool, a_src, g_src)),
        library_ms=time_ms(torch, lambda: torch.matmul(
            torch.matmul(pool[a_idx], g), pool[g_idx])),
        library_gathered_ms=time_ms(torch, lambda: torch.matmul(
            torch.matmul(a_sel, g), g_sel)),
        bound_ms=b_ms, bound_by=b_by,
        gathered=dict(
            max_abs_err=gerr, max_abs_plain=gscale, dots_max_abs_err=gd_err,
            dots_max_abs_plain=gd_scale,
            ms=time_ms(torch, lambda: ops.fused_precond(a_sel, g, g_sel)),
            plain_ms=time_ms(torch, lambda: ref.fused_precond_ref(
                a_sel, g, g_sel)),
            library_ms=time_ms(torch, lambda: torch.matmul(
                torch.matmul(a_sel, g), g_sel)),
            bound_ms=gb_ms, bound_by=gb_by))
    del pool, g, a_sel, g_sel, a_src, g_src, a_idx, g_idx
    torch.cuda.empty_cache()

    # smw_update at the SMW path's largest leaf: (528, 64, 128), with
    # inverses of damped factor-like blocks at the A side's scale
    # (c = 0.05/2048, as at 2048 subsample tokens) and the G side's
    # (columns at 3e-4, inverse entries ~1e7, c = 0.05)
    ks = SMW["rank"]
    decay = kfac.KFACConfig().ema_decay

    def smw_case(scale):
        v0 = torch.randn(nb_max, 2 * n, n, device=dev, generator=gen,
                         dtype=torch.float64) * scale
        f = v0.transpose(-1, -2) @ v0 / (2 * n)
        lam = soi.tikhonov_damping(f, 0.03)
        inv64 = torch.linalg.inv(f + lam[:, None, None]
                                 * torch.eye(n, device=dev,
                                             dtype=torch.float64))
        v = torch.randn(nb_max, ks, n, device=dev, generator=gen) * scale
        return inv64.float().contiguous(), v

    def woodbury64(inv, v, *, decay, cscale):
        inv, v = inv.double(), v.double()
        m = (inv + inv.transpose(-1, -2)) * (0.5 / decay)
        y = v @ m
        s = y @ v.transpose(-1, -2) + torch.eye(
            v.shape[-2], device=dev, dtype=torch.float64) / cscale
        return m - y.transpose(-1, -2) @ torch.linalg.solve(s, y), s

    # each side: kernel and plain version against each other, and both
    # against float64 Woodbury, with the capacitance's condition number
    smw_sides = {}
    for side, scale, c in (("A", 1.0, (1 - decay) / (8 * 256)),
                           ("G", 3e-4, 1 - decay)):
        inv, v = smw_case(scale)
        got = ops.smw_update(inv, v, decay=decay, cscale=c)
        want = ref.smw_update_ref(inv, v, decay=decay, cscale=c)
        w64, s64 = woodbury64(inv, v, decay=decay, cscale=c)
        err, mx = held(got, want)
        w_scale = float(w64.abs().max())
        smw_sides[side] = dict(
            max_abs_err=err, max_abs_plain=mx, rel_err=err / mx,
            kernel_rel_to_woodbury64=float((got.double() - w64).abs().max())
            / w_scale,
            plain_rel_to_woodbury64=float((want.double() - w64).abs().max())
            / w_scale,
            max_cond_s=float(torch.linalg.cond(s64).max()))
        check(err <= REL_TOL * mx, f"smw_update kernel vs plain ({side} side)")
        del got, want, w64, s64
    # timed on the last (G-side) case. Bound: the function must read inv
    # and v and write out; 3 hi/lo partials for each of V M, Y V^T and
    # Y^T Z, and the fp32 solve (LU of k x k, two triangular solves on n
    # columns). The design's own traffic reads inv twice.
    b_ms, b_by = bound(
        4.0 * nb_max * (2 * n * n + ks * n),
        2.0 * 3 * nb_max * (ks * n * n + ks * ks * n + n * n * ks),
        nb_max * (2.0 / 3.0 * ks ** 3 + 2.0 * ks * ks * n))
    design_ms, _ = bound(4.0 * nb_max * (3 * n * n + ks * n), 0.0)
    g_side = smw_sides["G"]
    results["smw_update"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/smw_update.cu",
        replaces="src/repro/kernels/smw_update.py:56,66",
        shape=[nb_max, ks, n], max_abs_err=g_side["max_abs_err"],
        max_abs_plain=g_side["max_abs_plain"], rel_err=g_side["rel_err"],
        tol=REL_TOL * g_side["max_abs_plain"], sides=smw_sides,
        ms=time_ms(torch, lambda: ops.smw_update(inv, v, decay=decay,
                                                 cscale=c)),
        plain_ms=time_ms(torch, lambda: ref.smw_update_ref(
            inv, v, decay=decay, cscale=c)),
        library_ms=time_ms(torch, lambda: ref.exact_smw_update(
            inv, v, decay=decay, cscale=c)),
        bound_ms=b_ms, bound_by=b_by, design_bytes_ms=design_ms)
    del inv, v

    # bitslice_mm at the main path's MLP product: 8 x 256 tokens of
    # d_model 1024 into d_ff 2816, and at the precision_inv path's own shape,
    # (128, 128) @ (128, 64) (mxu_inv_apply). Bound: 3 partials of 2MKN
    # operations; bytes: each input read once, the output written once. The
    # kernel's 128 x 192 tiles read a's rows once for each column tile and
    # b's columns once for each row tile from the L2, as fp32: their rate is
    # those bytes over the kernel's time. Times of one call (ms, as for the
    # other kernels) and of 20 calls back to back (loop20_ms, a call's
    # share), which hides the wrapper's host time behind the kernel.
    def l2_read_bytes(m, k, n):
        return 4.0 * (m * k * -(-n // BITSLICE_TILE[1])
                      + k * n * -(-m // BITSLICE_TILE[0]))

    mm = {}
    for mm_m, mm_k, mm_n in ((MAIN["batch"] * MAIN["seq"], cfg.d_model,
                              cfg.d_ff), (128, 128, 64)):
        x = torch.randn(mm_m, mm_k, device=dev, generator=gen)
        w = torch.randn(mm_k, mm_n, device=dev, generator=gen)
        got = ops.bitslice_mm(x, w)
        want = ref.bitslice_mm_ref(x, w)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        b_ms, b_by = bound(4.0 * (mm_m * mm_k + mm_k * mm_n + mm_m * mm_n),
                           2.0 * 3 * mm_m * mm_k * mm_n)
        ms = time_ms(torch, lambda: ops.bitslice_mm(x, w))
        loop_ms = time_ms(torch, lambda: ops.bitslice_mm(x, w), launches=20)
        mm[(mm_m, mm_k, mm_n)] = dict(
            shape=[mm_m, mm_k, mm_n], max_abs_err=err, max_abs_plain=scale,
            tol=REL_TOL * scale, ms=ms, loop20_ms=loop_ms,
            plain_ms=time_ms(torch, lambda: ref.bitslice_mm_ref(x, w)),
            library_ms=time_ms(torch, lambda: torch.matmul(x, w)),
            library_loop20_ms=time_ms(torch, lambda: torch.matmul(x, w),
                                      launches=20),
            bound_ms=b_ms, bound_by=b_by,
            l2_read_bytes=l2_read_bytes(mm_m, mm_k, mm_n),
            l2_read_tb_per_s=l2_read_bytes(mm_m, mm_k, mm_n) / loop_ms / 1e9)
        check(err <= REL_TOL * scale,
              f"bitslice_mm kernel vs plain at {(mm_m, mm_k, mm_n)}")
        del x, w, got, want
    main_mm, path_mm = mm.values()
    results["bitslice_mm"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/bitslice_mm.cu",
        replaces="src/repro/kernels/bitslice_mm.py:39", **main_mm,
        path_shape=path_mm)

    # fused_gram_inv at the main path's largest A leaf (24 layers x 22
    # blocks of d_ff 2816: 528 blocks of 128) over its 2048 tokens, at
    # the K-FAC counts, in fp32 and in bf16, and at counts 0/1/0 (the Gram
    # and X0 only). Bound: the Gram's partials of 2Tn^2 (3, or 1 for bf16
    # input, whose lo slice is zero) and the inverse's partial GEMMs, per
    # block; bytes: the activations read once, the inverses written once.
    # At 0/1/0 the output is A_H / (|A_H|_1 |A_H|_inf): one bf16 rounding
    # of the Gram, which the kernel's summation order can move by one bf16
    # step (at most 2^-7 of the entry), so there it is held to 2^-6 of the
    # plain version's largest entry, which leaves room for the norms' own
    # rounding.
    n_tok = MAIN["batch"] * MAIN["seq"]
    damping = kfac.KFACConfig().damping
    acts32 = torch.randn(n_tok, nb_max, n, device=dev, generator=gen)
    gram_only = dict(ns_iters=0, taylor_terms=1, refine_steps=0)
    fg = {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        acts = acts32.to(dtype)
        partials = 3 if dtype == torch.float32 else 1
        for counts, ctag, prods, tol in ((KFAC_COUNTS, "20_4_2", products,
                                          REL_TOL),
                                         (gram_only, "0_1_0", 0, 2.0 ** -6)):
            kw = dict(rel_damp=damping, **counts)
            got = ops.fused_gram_inv(acts, **kw)
            want = ref.fused_gram_inv_ref(acts, **kw)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            b_ms, b_by = bound(
                acts.element_size() * nb_max * n_tok * n
                + 4.0 * nb_max * n * n,
                2.0 * nb_max * (partials * n_tok * n * n + prods * n ** 3))
            fg[f"{tag}_{ctag}"] = dict(
                max_abs_err=err, max_abs_plain=scale, tol=tol * scale,
                ms=time_ms(torch, lambda: ops.fused_gram_inv(acts, **kw)),
                bound_ms=b_ms, bound_by=b_by)
            check(err <= tol * scale,
                  f"fused_gram_inv kernel vs plain ({tag}, {ctag})")
            del got, want
    main_fg = fg.pop("fp32_20_4_2")
    fg_kw = dict(rel_damp=damping, **KFAC_COUNTS)
    results["fused_gram_inv"] = dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/fused_gram_solve.cu",
        replaces="src/repro/kernels/fused_gram_solve.py:64",
        shape=[n_tok, nb_max, n], **main_fg,
        plain_ms=time_ms(torch, lambda: ref.fused_gram_inv_ref(
            acts32, **fg_kw)),
        library_ms=time_ms(torch, lambda: ref.exact_gram_inv(acts32,
                                                             damping)),
        variants=fg)
    del acts32, acts
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
    for name in ("neumann_inv", "fused_precond"):
        check(launches[name] > 0, f"{name} launched on the main path")
    check(launches["fused_precond"] == MAIN["steps"] * len(wu.groups),
          "fused_precond: one launch per WU group a step")
    # INV: one grouped launch per block side a refresh
    sides = {t.shape[-1] for d in meta.values() for t in d.values()}
    refreshes = sum("inv" in h["phase_s"] for h in history)
    check(launches["neumann_inv"] == refreshes * len(sides),
          "neumann_inv: one launch per block side a refresh")

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
    # what one checkpoint of this state holds (the loop phase's disk)
    state_bytes = tensor_bytes(state)
    # the factors after step 2 (the last stats step), on the host until
    # the async_inv phase's solver checks, so that no phase between
    # carries them in its peak memory
    main_factors = {n: {k: t.cpu() for k, t in d.items()}
                    for n, d in state.kfac.factors.items()}

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

    # 6. the SMW path ---------------------------------------------------
    torch.cuda.empty_cache()
    smw_prog = train_mod.KFACProgram(
        cfg, kcfg, seed=MAIN["seed"], device="cuda", smw=True,
        smw_drift_budget=SMW["drift_budget"], smw_rank=SMW["rank"])
    kept = {}

    def to_host(tree):
        return {n: {k: t.cpu() for k, t in d.items()}
                for n, d in tree.items()}

    def keep_first_smw_step(st, rec):
        # on the host, so that the path's peak memory is its own: the
        # params and inverses entering the first step without a
        # fallback, and that step's factors and inverses
        if "factors" in kept:
            return
        if rec["smw_fallback"] == 0.0:
            kept.update(step=rec["step"], factors=to_host(st.kfac.factors),
                        inverses=to_host(st.kfac.inverses))
        else:
            kept.update(params={k: p.cpu() for k, p in st.params.items()},
                        inverses0=to_host(st.kfac.inverses))

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, smw_hist = train_mod.run(smw_prog, ds, SMW["steps"],
                                on_step=keep_first_smw_step)
    torch.cuda.synchronize(dev)
    smw_wall = time.perf_counter() - t0
    smw_launches = ops.launch_counts()
    smw_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    smw_losses = [h["loss"] for h in smw_hist]
    check(all(math.isfinite(x) for x in smw_losses), "finite SMW losses")
    for name in ("neumann_inv", "fused_precond", "smw_update"):
        check(smw_launches[name] > 0, f"{name} launched on the SMW path")
    check("factors" in kept, "an SMW step without a fallback")
    n_leaves = sum(len(d) for d in meta.values())
    check(smw_launches["smw_update"] == n_leaves * SMW["steps"],
          "smw_update: one launch per leaf a step")
    check(smw_launches["neumann_inv"]
          == sum(h["smw_fallback"] for h in smw_hist) * len(sides),
          "neumann_inv: one launch per block side a gate fallback")

    # that step's update again, from the inverses it started from and
    # its own batch's columns: the kernel, its plain version, the fp32
    # route and float64 Woodbury, each against float64 torch.linalg.inv
    # of the step's damped factors (the last tells the algorithm's error
    # from the rounding's), beside a full re-inversion of those factors
    from repro_torch.data.pipeline import DataCursor
    from repro_torch.solve import smw as smw_mod

    smw_bits = []
    if "factors" in kept:
        # stats_batch and stats_seq are the whole batch here
        batch = ds.batch(DataCursor(kept["step"] - 1), device=dev)
        n_tok = batch["tokens"].numel()
        _, _, cols, _ = kfac.stats_rank_k(
            lambda p, tp, bt: lm.loss_fn(cfg, p, bt, taps=tp,
                                         collect="cols", soi_block=bs),
            {k: p.to(dev) for k, p in kept["params"].items()},
            lm.build_taps(cfg, specs, n_tok, device=dev),
            batch, specs, bs)
        for name, c_d in cols.items():
            for side, v in c_d.items():
                f = kept["factors"][name][side].to(dev)
                flat = f.reshape(-1, bs, bs)
                lam = soi.tikhonov_damping(flat, kcfg.damping)
                exact = torch.linalg.inv(
                    flat.double() + lam.double()[:, None, None]
                    * torch.eye(bs, device=dev, dtype=torch.float64))
                inv0 = kept["inverses0"][name][side + "_inv"].to(dev) \
                    .reshape(-1, bs, bs).contiguous()
                w = 1.0 / v.shape[-2] if side == "A" else 1.0
                v = smw_mod._subsample_cols(v, SMW["rank"])
                v = v.reshape(-1, *v.shape[-2:]).contiguous()
                args = dict(decay=decay, cscale=(1.0 - decay) * w)
                mine = ops.smw_update(inv0, v, **args)
                plain = ref.smw_update_ref(inv0, v, **args)
                run_inv = kept["inverses"][name][side + "_inv"].to(dev) \
                    .reshape(-1, bs, bs)
                full = ops.neumann_inv(flat.contiguous(), lam,
                                       **KFAC_COUNTS)
                err = float((mine - plain).abs().max())
                scale = float(plain.abs().max())
                row = dict(
                    leaf=f"{name}/{side}", rel_err_vs_plain=err / scale,
                    rel_diff_vs_run=float((mine - run_inv).abs().max())
                    / scale,
                    bits_smw=bits(run_inv, exact),
                    bits_kernel=bits(mine, exact),
                    bits_plain=bits(plain, exact),
                    bits_fp32=bits(ref.exact_smw_update(inv0, v, **args),
                                   exact),
                    bits_woodbury64=bits(woodbury64(inv0, v, **args)[0],
                                         exact),
                    bits_full_reinversion=bits(full, exact))
                smw_bits.append(row)
                check(err <= REL_TOL_RUN * scale,
                      f"{row['leaf']} smw_update kernel vs plain (run)")
                check(row["bits_kernel"] >= row["bits_plain"] - 1.0,
                      f"{row['leaf']} smw_update as accurate as plain")
                del exact, mine, plain, full
        del cols

    def lowest(key):
        return min((r[key] for r in smw_bits), default=None)

    emit({"phase": "smw_path", "arch": cfg.name, "layers": cfg.n_layers,
          "block_size": bs, "batch": MAIN["batch"], "seq": MAIN["seq"],
          **SMW, "losses": smw_losses,
          "drift": [h["smw_drift"] for h in smw_hist],
          "fallback": [h["smw_fallback"] for h in smw_hist],
          "phase_s": [h["phase_s"] for h in smw_hist],
          "wall_s": smw_wall, "launches": smw_launches,
          "peak_mem_gb": smw_peak, "bits_step": kept.get("step"),
          "bits": smw_bits,
          **{"min_" + k: lowest(k) for k in (
              "bits_smw", "bits_kernel", "bits_plain", "bits_fp32",
              "bits_woodbury64", "bits_full_reinversion")}})
    kept.clear()
    del smw_prog

    # 7-9. the training CLI through runtime.TrainLoop ---------------------
    # main() prints its own summary; the phases emit one line each instead
    def cli(args):
        with contextlib.redirect_stdout(io.StringIO()):
            return train_mod.main(args)

    cli_main = ["--arch", MAIN["arch"], "--batch", str(MAIN["batch"]),
                "--seq", str(MAIN["seq"]), "--block-size", str(bs),
                "--stats-every", str(MAIN["stats_every"]),
                "--inv-every", str(MAIN["inv_every"]),
                "--seed", str(MAIN["seed"])]

    def trace_spans(path, name):
        with open(path) as f:
            return [e["dur"] / 1e6 for e in json.load(f)["traceEvents"]
                    if e["name"] == name]

    # 7. loop: checkpoints every 3 steps, a device loss at step 4; the
    # restore from the step-3 checkpoint replays step 3. Two checkpoints
    # stay on disk (the loop keeps 3), so twice the state's bytes must
    # be free before the run.
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        ck_dir, obs_dir = os.path.join(tmp, "ck"), os.path.join(tmp, "obs")
        free_disk = shutil.disk_usage(tmp).free
        check(free_disk > 2.2 * state_bytes,
              f"free disk for two checkpoints of {state_bytes} bytes")
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loop_sum = cli(cli_main + [
            "--steps", "6", "--ckpt-dir", ck_dir, "--ckpt-every", "3",
            "--inject-failure-at", "4", "--obs-dir", obs_dir])
        torch.cuda.synchronize(dev)
        loop_wall = time.perf_counter() - t0
        loop_launches = ops.launch_counts()
        loop_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        loop_hist = loop_sum["history"]
        ckpt_files = {name: os.path.getsize(os.path.join(ck_dir, name,
                                                         "arrays.npz"))
                      for name in sorted(os.listdir(ck_dir))}
        with open(os.path.join(obs_dir, "events.jsonl")) as f:
            events = [json.loads(line) for line in f]
        trace_json = os.path.join(obs_dir, "trace.json")
        dispatch_s = trace_spans(trace_json, "ckpt_save_dispatch")
        restore_s = trace_spans(trace_json, "ckpt_restore")
        phase_spans = [n for n in ("stats", "inv", "train", "wu")
                       if trace_spans(trace_json, f"phase:{n}")]
        artifacts = sorted(os.listdir(obs_dir))
    finally:
        shutil.rmtree(tmp)
    executed = [h["step"] for h in loop_hist]
    check(loop_sum["recoveries"] == 1 and loop_sum["steps"] == 6,
          "loop: one recovery, 6 steps")
    check(executed == [0, 1, 2, 3, 3, 4, 5],
          "loop: steps 0-3, the replay of 3 from the step-3 checkpoint, 4-5")
    same = [h["loss"] == losses[h["step"]] for h in loop_hist
            if h["step"] < MAIN["steps"]]
    check(len(same) == 5 and all(same),
          "loop: losses bitwise the main path's at the steps both ran")
    refreshes_due = sum(s % MAIN["inv_every"] == 0 for s in executed)
    check([("inv" in h["phase_s"]) for h in loop_hist]
          == [s % MAIN["inv_every"] == 0 for s in executed],
          "loop: the refresh cadence follows the restored KFACState.step")
    check(loop_launches["neumann_inv"] == refreshes_due * len(sides),
          "loop: neumann_inv once a block side a refresh")
    check(loop_launches["fused_precond"] == len(executed) * len(wu.groups),
          "loop: fused_precond once a WU group an executed step")
    check(artifacts == ["events.jsonl", "metrics.prom", "trace.json"],
          "loop: the three obs artifacts")
    check(sum(e["kind"] == "train_step" for e in events) == len(executed),
          "loop: one train_step row an executed step")
    check(sum(e["kind"] == "recovery" for e in events) == 1,
          "loop: a recovery event")
    check(phase_spans == ["stats", "inv", "train", "wu"],
          "loop: phase spans in trace.json")
    check(len(ckpt_files) == 2, "loop: two checkpoints written")
    emit({"phase": "loop", "arch": cfg.name, "steps": loop_sum["steps"],
          "executed_steps": executed, "recoveries": loop_sum["recoveries"],
          "stragglers": loop_sum["stragglers"],
          "losses": [h["loss"] for h in loop_hist],
          "main_path_losses": losses,
          "phase_s": [h["phase_s"] for h in loop_hist],
          "wall_s": loop_wall, "loop_wall_s": loop_sum["wall_s"],
          "launches": loop_launches, "peak_mem_gb": loop_peak,
          "state_bytes": state_bytes, "free_disk_bytes": free_disk,
          "checkpoint_bytes": ckpt_files,
          "save_dispatch_s": dispatch_s,
          "save_write_s": loop_sum["ckpt_write_s"],
          "restore_s": restore_s, "obs_artifacts": artifacts,
          "train_step_rows": sum(e["kind"] == "train_step" for e in events)})

    # 8. sgd: the first-order baseline on the same weights and batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sgd_sum = cli(cli_main + ["--optimizer", "sgd", "--steps", "4"])
    torch.cuda.synchronize(dev)
    sgd_wall = time.perf_counter() - t0
    sgd_launches = ops.launch_counts()
    check(all(math.isfinite(x) for x in sgd_sum["losses"])
          and len(sgd_sum["losses"]) == 4, "sgd: 4 finite losses")
    check(set(sgd_launches.values()) == {0}, "sgd: no kernel launched")
    emit({"phase": "sgd", "arch": cfg.name, "lr": 3e-2,
          "losses": sgd_sum["losses"], "kfac_losses": losses,
          "phase_s": [h["phase_s"] for h in sgd_sum["history"]],
          "wall_s": sgd_wall, "launches": sgd_launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})

    # 9. precision: --precision int8 takes the pooled einsum WU route
    # (the fused_precond kernel is the hi/lo scheme); INV stays on
    # neumann_inv. Then the update-parity budget on the card.
    from repro_torch.lowp import parity as lowp_parity

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    int8_sum = cli(cli_main + ["--precision", "int8", "--steps", "2"])
    torch.cuda.synchronize(dev)
    int8_wall = time.perf_counter() - t0
    int8_launches = ops.launch_counts()
    int8_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    check(all(math.isfinite(x) for x in int8_sum["losses"])
          and len(int8_sum["losses"]) == 2, "int8: 2 finite losses")
    check(int8_sum["wu_route"] == "einsum", "int8: the einsum WU route")
    check(int8_launches["neumann_inv"] > 0, "int8: neumann_inv launched")
    check(int8_launches["fused_precond"] == 0,
          "int8: fused_precond not launched")
    parity = {p: lowp_parity.update_parity(p, device="cuda")
              for p in ("hilo", "int8")}
    for p, r in parity.items():
        check(r["min_bits"] >= 16.0, f"update_parity({p}) >= 16 bits")
    emit({"phase": "precision", "arch": cfg.name,
          "int8": dict(losses=int8_sum["losses"], kfac_losses=losses[:2],
                       wu_route=int8_sum["wu_route"],
                       wu_s=[h["phase_s"]["wu"] for h in int8_sum["history"]],
                       fp32_kernel_wu_s=[h["phase_s"]["wu"]
                                         for h in loop_hist[:2]],
                       phase_s=[h["phase_s"] for h in int8_sum["history"]],
                       wall_s=int8_wall, launches=int8_launches,
                       peak_mem_gb=int8_peak),
          "update_parity": {p: dict(min_bits=r["min_bits"],
                                    mean_bits=r["mean_bits"])
                            for p, r in parity.items()}})

    # 10. the composed-precision inversion library ----------------------
    # What examples/precision_inv_demo.py and examples/quickstart.py check,
    # on the port; then the library's two kernels on their own paths:
    # mxu_inv_apply (the composed inverse applied through bitslice_mm) and
    # fused_gram_inv on the activations of the main path's first batch.
    from repro_torch.core import precision_inv as pinv

    rng = np.random.default_rng(1)
    toy = pinv.CircuitConfig(q_a=8, q_b=4, q_x=4, r_dac=2, r_adc=2, r_c=4,
                             k=1, n_taylor=4)
    m8 = rng.standard_normal((8, 8))
    a8 = m8 @ m8.T / 8 + 0.3 * np.eye(8)
    b8 = rng.standard_normal(8)
    q_a, q_b = pinv.quantize_problem(a8, b8, toy)
    toy_bits = pinv.achieved_bits(pinv.faithful_inv_apply(a8, b8, toy),
                                  np.linalg.solve(q_a, q_b))
    prod = pinv.CircuitConfig()
    m128 = rng.standard_normal((128, 128))
    a128 = m128 @ m128.T / 128
    a128 += 0.03 * np.trace(a128) / 128 * np.eye(128)
    b128 = rng.standard_normal(128)
    q_a, q_b = pinv.quantize_problem(a128, b128, prod)
    x_ref = np.linalg.solve(q_a, q_b)
    x_c, trace = pinv.faithful_inv_apply(a128, b128, prod, return_trace=True)
    prod_bits = pinv.achieved_bits(x_c, x_ref)
    check(prod_bits >= 16.0, "circuit model, production config: >= 16 bits")

    # quickstart's damped block (n = 256, seed 0)
    rng = np.random.default_rng(0)
    nq = 256
    mq = rng.standard_normal((nq, nq))
    a_q = mq @ mq.T / nq
    a_q += 0.03 * np.trace(a_q) / nq * np.eye(nq)
    b_q = rng.standard_normal(nq)
    xq_ref = np.linalg.solve(a_q, b_q)
    qcfg = pinv.CircuitConfig(n_taylor=26)
    q_a, q_b = pinv.quantize_problem(a_q, b_q, qcfg)
    bits_circuit = pinv.achieved_bits(pinv.faithful_inv_apply(a_q, b_q, qcfg),
                                      np.linalg.solve(q_a, q_b))
    a_bf16 = torch.from_numpy(a_q).to(torch.bfloat16).double().numpy()
    bits_bf16 = pinv.achieved_bits(np.linalg.solve(a_bf16, b_q), xq_ref)
    m_q = pinv.composed_inverse(torch.from_numpy(a_q).float().to(dev), 0.0,
                                **KFAC_COUNTS).cpu().numpy()
    bits_composed = pinv.achieved_bits(m_q @ b_q, xq_ref)
    g_q = a_q @ rng.standard_normal(nq)
    x_sgd = g_q / np.abs(np.linalg.eigvalsh(a_q)).max()
    resid_sgd = np.linalg.norm(g_q - a_q @ x_sgd) / np.linalg.norm(g_q)
    resid_pre = np.linalg.norm(g_q - a_q @ (m_q @ g_q)) / np.linalg.norm(g_q)
    check(bits_circuit >= 16.0, "quickstart: circuit model >= 16 bits")
    check(bits_composed > bits_bf16 + 4,
          "quickstart: composed inverse beats bf16 by more than 4 bits")

    # mxu_inv_apply's operands: a damped 128-block (the reference's
    # test_mxu_inv_apply) and a 128 x 64 right-hand side
    rng = np.random.default_rng(8)
    f = rng.standard_normal((128, 4 * 128)) / np.sqrt(4 * 128)
    a_m = f @ f.T
    lam_m = 0.1 * np.trace(a_m) / 128
    a_m32 = torch.from_numpy(a_m.astype(np.float32)).to(dev)
    rhs = torch.from_numpy(rng.standard_normal((128, 64)).astype(
        np.float32)).to(dev)

    # the main path's first batch, through soi.blocked_tokens, for every
    # A leaf (all of block width 128 here), as (T, nb, n)
    params0 = train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                    device="cuda").init_state().params
    batch0 = ds.batch(DataCursor(0), device=dev)
    n_tok = batch0["tokens"].numel()
    _, _, cols0, _ = kfac.stats_rank_k(
        lambda p, tp, bt: lm.loss_fn(cfg, p, bt, taps=tp, collect="cols",
                                     soi_block=bs),
        params0, lm.build_taps(cfg, specs, n_tok, device=dev), batch0,
        specs, bs)
    acts_run = {f"{name}/A": c["A"].movedim(-2, 0).reshape(
        n_tok, -1, c["A"].shape[-1]).contiguous()
        for name, c in cols0.items()
        if "A" in c and c["A"].shape[-1] <= 128}
    del params0, cols0
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    x_mxu = pinv.mxu_inv_apply(a_m32, rhs, lam_m, **KFAC_COUNTS)
    fused = {leaf: ops.fused_gram_inv(x, **fg_kw)
             for leaf, x in acts_run.items()}
    torch.cuda.synchronize(dev)
    pinv_wall = time.perf_counter() - t0
    pinv_launches = ops.launch_counts()
    for name in ("bitslice_mm", "fused_gram_inv"):
        check(pinv_launches[name] > 0,
              f"{name} launched on the precision_inv path")

    x_plain = ref.bitslice_mm_ref(
        pinv.composed_inverse(a_m32, lam_m, **KFAC_COUNTS), rhs)
    mxu_err = float((x_mxu - x_plain).abs().max())
    mxu_scale = float(x_plain.abs().max())
    x_solve = np.linalg.solve(a_m + lam_m * np.eye(128),
                              rhs.double().cpu().numpy())
    mxu_rel_solve = float(np.max(np.abs(x_mxu.double().cpu().numpy()
                                        - x_solve))
                          / np.max(np.abs(x_solve)))
    check(mxu_err <= REL_TOL * mxu_scale, "mxu_inv_apply kernel vs plain")
    check(mxu_rel_solve < 2.0 ** -10, "mxu_inv_apply vs float64 solve")

    # the fused kernel against its plain version and against the two-step
    # route (gram_from_tokens, the K-FAC path's damping, neumann_inv), and
    # each against float64 torch.linalg.inv. The two-step tolerance is the
    # reference's cross-route one, atol 5e-3 on inverses with entries of
    # order 1 (tests/test_kernels.py::test_fused_matches_composed_inverse_
    # path), held relative to the largest entry where entries exceed 1.
    # Both tolerances presume an iteration that has converged, which 20
    # Newton-Schulz steps are not on ill-conditioned blocks: there the
    # inverse moves with the rounding of its Gram. So each leaf also
    # measures that: the plain route on the float64 Gram rounded to fp32,
    # another equally valid rounding of the same Gram. A route may differ
    # from the plain version by twice what that rounding alone moves it.
    fused_report = []
    for leaf, x in acts_run.items():
        plain = ref.fused_gram_inv_ref(x, **fg_kw)
        gram = soi.gram_from_tokens(x)
        two_step = ops.neumann_inv(gram.contiguous(),
                                   soi.tikhonov_damping(gram, damping),
                                   **KFAC_COUNTS)
        gram64 = soi.gram_from_tokens(x.double())
        exact = torch.linalg.inv(
            gram64 + soi.tikhonov_damping(gram64, damping)[:, None, None]
            * torch.eye(gram.shape[-1], device=dev, dtype=torch.float64))
        g_alt = gram64.float()
        alt = ref.neumann_inv_ref(g_alt, soi.tikhonov_damping(g_alt, damping),
                                  **KFAC_COUNTS)
        mine = fused[leaf]
        err = float((mine - plain).abs().max())
        scale = float(plain.abs().max())
        sens = float((alt - plain).abs().max())
        gap = float((mine - two_step).abs().max())
        two_scale = float(two_step.abs().max())
        row = dict(leaf=leaf, shape=list(x.shape),
                   rel_err_vs_plain=err / scale, max_abs_plain=scale,
                   rel_rounding_sensitivity=sens / scale,
                   max_abs_gap_two_step=gap,
                   rel_gap_two_step=gap / two_scale,
                   bits_fused=bits(mine, exact),
                   bits_plain=bits(plain, exact),
                   bits_two_step=bits(two_step, exact),
                   bits_plain_f64_gram=bits(alt, exact))
        fused_report.append(row)
        check(err <= max(REL_TOL_RUN * scale, 2.0 * sens),
              f"{leaf} fused_gram_inv kernel vs plain (run)")
        check(row["bits_fused"] >= row["bits_plain"] - 1.0,
              f"{leaf} fused_gram_inv as accurate as plain")
        check(gap <= max(5e-3 * max(1.0, two_scale), 2.0 * sens),
              f"{leaf} fused_gram_inv vs the two-step route")
        del plain, gram, two_step, gram64, exact, g_alt, alt
    emit({"phase": "precision_inv",
          "fig5_toy": dict(bits=toy_bits, target=toy.q_x,
                           loops=[toy.loops_b, toy.loops_x, toy.n_taylor],
                           cycles_inv=toy.cycles_inv()),
          "production": dict(bits=prod_bits,
                             bits_per_loop_a=[pinv.achieved_bits(t, x_ref)
                                              for t in trace],
                             cycles_inv=prod.cycles_inv(),
                             cycles_inv_fused=prod.cycles_inv_fused()),
          "quickstart": dict(bits_bf16=bits_bf16,
                             bits_circuit=bits_circuit,
                             bits_composed=bits_composed,
                             resid_sgd=float(resid_sgd),
                             resid_preconditioned=float(resid_pre)),
          "mxu_inv_apply": dict(shape=[128, 64], max_abs_err=mxu_err,
                                max_abs_plain=mxu_scale,
                                rel_err_vs_float64_solve=mxu_rel_solve),
          "fused_gram_inv": fused_report,
          "min_bits_fused": min(r["bits_fused"] for r in fused_report),
          "min_bits_two_step": min(r["bits_two_step"]
                                   for r in fused_report),
          "wall_s": pinv_wall, "launches": pinv_launches})
    del acts_run, fused

    # 11. async_inv: the staleness-tolerant double-buffered refresh on a
    # side stream (--async-inv), --dist-inv, and the solver API on the
    # card -----------------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import gauss_newton
    from repro_torch.launch import steps as steps_mod
    from repro_torch.solve import invert_factor_tree, make_plan
    from repro_torch.solve.async_refresh import lowest_stream_priority

    main_stream = torch.cuda.current_stream(dev).cuda_stream
    async_steps = 6

    # the CLI: triggers at steps 0, 2, 4, swaps at 2 and 4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    as_sum = cli(cli_main + ["--steps", str(async_steps), "--async-inv"])
    torch.cuda.synchronize(dev)
    as_wall = time.perf_counter() - t0
    as_launches = ops.launch_counts()
    nv_streams = ops.launch_streams()["neumann_inv"]
    as_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    as_losses = as_sum["losses"]
    check(len(as_losses) == async_steps
          and all(math.isfinite(x) for x in as_losses),
          "async_inv: 6 finite losses")
    check(as_losses[0] == losses[0], "async_inv: step 0's loss is the "
          "main path's (the weights have not moved yet)")
    check((as_sum["n_dispatched"], as_sum["n_swapped"]) == (3, 2),
          "async_inv: 3 refreshes dispatched, 2 swapped in")
    triggers = sum(s % MAIN["inv_every"] == 0 for s in range(async_steps))
    check(as_launches["neumann_inv"] == triggers * len(sides),
          "async_inv: neumann_inv once a block side a trigger")
    check(main_stream not in nv_streams
          and sum(nv_streams.values()) == as_launches["neumann_inv"],
          "async_inv: every neumann_inv launch on a side stream")
    check(as_launches["fused_precond"] == async_steps * len(wu.groups),
          "async_inv: fused_precond once a WU group a step")

    # staleness, bitwise: launch.train.run of the same program, the
    # factors of each trigger and the inverses of each step kept; step N
    # must hold a synchronous refresh of the factors of the trigger
    # before the last one, steps 0 and 1 the initial identities. After
    # each step the host also waits for the side stream: how long the
    # refresh ran on past the main stream's work
    def clone(tree):
        return {n: {k: t.clone() for k, t in d.items()}
                for n, d in tree.items()}

    snaps, used, side_wait = {}, [], []

    def keep_async_step(st, rec):
        t = time.perf_counter()
        torch.cuda.synchronize(dev)
        side_wait.append(time.perf_counter() - t)
        i = rec["step"] - 1
        if i % MAIN["inv_every"] == 0:
            snaps[i] = clone(st.kfac.factors)
        used.append(clone(st.kfac.inverses))

    torch.cuda.empty_cache()
    a_prog = train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                   device="cuda", async_inv=True)
    a_hist = train_mod.run(a_prog, ds, async_steps,
                           on_step=keep_async_step)[1]
    a_stream = a_prog.refresher.stream
    prio_range = torch.cuda.Stream.priority_range()
    init_inv = soi.init_inverses(specs, bs, device=dev)
    stale_equal = []
    for n_step, inv in enumerate(used):
        want = init_inv if n_step < 2 else kfac.invert_factors(
            snaps[n_step - n_step % MAIN["inv_every"] - 2], kcfg)
        stale_equal.append(all(torch.equal(inv[a][b], t)
                               for a, d in want.items()
                               for b, t in d.items()))
        del want
    check(all(stale_equal), "async_inv: every step's inverses bitwise a "
          "synchronous refresh of the factors two steps back")
    check([h["loss"] for h in a_hist] == as_losses,
          "async_inv: run() losses bitwise the CLI's")
    swapped_at_4 = {n: {k: t.cpu() for k, t in d.items()}
                    for n, d in used[4].items()}
    del snaps, used, init_inv, a_prog
    trigger_rows = []
    for i in range(MAIN["inv_every"], async_steps, MAIN["inv_every"]):
        ph = a_hist[i]["phase_s"]
        trigger_rows.append(dict(
            step=i, stats_s=ph["stats"], inv_dispatch_s=ph["inv"],
            train_s=ph["train"], side_wait_s=side_wait[i],
            inv_train_s=ph["inv"] + ph["train"] + side_wait[i]))
    sync_ph = history[2]["phase_s"]
    sync_inv_train_s = sync_ph["inv"] + sync_ph["train"]

    # overlap, measured: steps 4 (a trigger) and 5 of another run under
    # torch.profiler, kernels only; the side stream's neumann_inv
    # interval against the other streams' kernels; and the unprofiled
    # trigger step 2's inv + train, with the host's wait for the side
    # stream after it. The side stream runs at the lowest priority, which
    # is the default stream's; a second run (not the CLI's path) puts the
    # training on a stream of the highest priority, to see what a main
    # stream that outranks the refresh gains
    def overlap_profile(main_priority):
        prof = profile(activities=[ProfilerActivity.CUDA])
        wait = {}

        def profile_trigger(st, rec):
            if rec["step"] == 3:
                t = time.perf_counter()
                torch.cuda.synchronize(dev)
                wait["s"] = time.perf_counter() - t
            elif rec["step"] == 4:
                torch.cuda.synchronize(dev)
                prof.start()
            elif rec["step"] == 6:
                torch.cuda.synchronize(dev)
                prof.stop()

        torch.cuda.empty_cache()
        prog = train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                     device="cuda", async_inv=True)
        stream = (torch.cuda.current_stream(dev) if main_priority is None
                  else torch.cuda.Stream(dev, priority=main_priority))
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            hist = train_mod.run(prog, ds, async_steps,
                                 on_step=profile_trigger)[1]
        torch.cuda.synchronize(dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as ptmp:
            ppath = os.path.join(ptmp, "trace.json")
            prof.export_chrome_trace(ppath)
            with open(ppath) as f:
                kev = [e for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
        del prof, prog
        torch.cuda.empty_cache()
        inv_ev = [e for e in kev if "neumann_inv" in e["name"]]
        side_ids = {e["args"].get("stream") for e in inv_ev}
        main_iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in kev
                         if e["args"].get("stream") not in side_ids)
        rows = []
        for e in inv_ev:
            lo, hi = e["ts"], e["ts"] + e["dur"]
            covered, end = 0.0, lo
            for a_, b_ in main_iv:
                a_, b_ = max(a_, end), min(b_, hi)
                if b_ > a_:
                    covered += b_ - a_
                    end = b_
            rows.append(dict(stream=e["args"].get("stream"),
                             ms=e["dur"] / 1e3,
                             main_kernels_overlap_ms=covered / 1e3))
        check(len(inv_ev) == len(sides) and side_ids
              and not side_ids & {e["args"].get("stream") for e in kev
                                  if "fused_precond" in e["name"]},
              "async_inv: the profiled refresh ran on a stream of its own")
        return dict(main_stream_priority=stream.priority,
                    side_stream_priority=None if main_priority is None
                    else lowest_stream_priority(),
                    neumann_inv=rows,
                    trigger_phase_s=hist[2]["phase_s"],
                    trigger_side_wait_s=wait["s"],
                    trigger_inv_train_s=hist[2]["phase_s"]["inv"]
                    + hist[2]["phase_s"]["train"] + wait["s"])

    overlap = overlap_profile(None)
    overlap["side_stream_priority"] = a_stream.priority
    overlap_high = overlap_profile(min(prio_range))

    # a checkpoint with a refresh in flight: the CLI with checkpoints
    # every 3 steps and a device loss at step 4. The step-3 checkpoint
    # (the state after step 2) must hold the refresh dispatched at step
    # 2, not yet swapped in: bitwise a refresh of its own factors, and
    # bitwise what the run above swapped in at step 4
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_async_")
    try:
        ck_dir = os.path.join(tmp, "ck")
        check(shutil.disk_usage(tmp).free > 2.2 * state_bytes,
              "async_inv: free disk for two checkpoints")
        ck_sum = cli(cli_main + [
            "--steps", str(async_steps), "--async-inv", "--ckpt-dir",
            ck_dir, "--ckpt-every", "3", "--inject-failure-at", "4"])
        arrays = np.load(os.path.join(ck_dir, f"step_{3:010d}",
                                      "arrays.npz"))
        saved = {"factors": {}, "inverses": {}}
        for key in arrays.files:
            for part in saved:
                head = f".kfac|.{part}|"
                if key.startswith(head):
                    name, side = key[len(head):].rsplit("|", 1)
                    saved[part].setdefault(name, {})[side] = arrays[key]
        del arrays
    finally:
        shutil.rmtree(tmp)
    ck_refresh = kfac.invert_factors(
        {n: {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
         for n, d in saved["factors"].items()}, kcfg)
    ck_pending = all(
        np.array_equal(saved["inverses"][n][k], t.cpu().numpy())
        and np.array_equal(saved["inverses"][n][k],
                           swapped_at_4[n][k].numpy())
        for n, d in ck_refresh.items() for k, t in d.items())
    del ck_refresh, swapped_at_4
    ck_hist = ck_sum["history"]
    check(ck_pending, "async_inv: the checkpoint holds the pending "
          "inverses bitwise")
    check(ck_sum["recoveries"] == 1
          and [h["step"] for h in ck_hist] == [0, 1, 2, 3, 3, 4, 5]
          and all(math.isfinite(h["loss"]) for h in ck_hist),
          "async_inv: the restore from the step-3 checkpoint completes "
          "with finite losses")

    # --dist-inv on one device: the replicated refresh, bitwise
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    dist_sum = cli(cli_main + ["--steps", "4", "--dist-inv"])
    dist_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    check(dist_sum["losses"] == losses,
          "dist_inv: losses bitwise the main path's")

    # the solver on the main path's factors after step 2: the pooled
    # program (plans of 1 and 4 devices) bitwise the replicated one,
    # pdiv at a cap of 64 (halves of 64 on neumann_inv) against the
    # direct route, each against float64 torch.linalg.inv
    torch.cuda.empty_cache()
    mf = {n: {k: t.to(dev) for k, t in d.items()}
          for n, d in main_factors.items()}
    repl = invert_factor_tree(mf, kcfg)
    pooled_equal = {}
    for nd in (1, 4):
        got = invert_factor_tree(mf, kcfg, plan=make_plan(mf, nd, kcfg))
        pooled_equal[nd] = all(torch.equal(got[n][k], t)
                               for n, d in repl.items()
                               for k, t in d.items())
    check(all(pooled_equal.values()),
          "solver: pooled (1 and 4 devices) bitwise the replicated path")
    plan4 = make_plan(mf, 4, kcfg)
    plan64 = make_plan(mf, 1, kcfg, pdiv_cap_bs=64)
    pd64 = invert_factor_tree(mf, kcfg, plan=plan64)

    def damped64(f, damp):
        flat = f.reshape(-1, f.shape[-1], f.shape[-1]).double()
        lam = soi.tikhonov_damping(flat, damp)
        return flat + lam[:, None, None] * torch.eye(
            flat.shape[-1], device=dev, dtype=torch.float64)

    def route_bits(routes, factors, damp):
        rows = []
        for n, d in factors.items():
            for side, f in d.items():
                exact = torch.linalg.inv(damped64(f, damp))
                rows.append(dict(leaf=f"{n}/{side}", **{
                    k: bits(r[n][side + "_inv"].reshape(exact.shape),
                            exact) for k, r in routes.items()}))
                del exact
        return rows

    rows64 = route_bits({"bits_direct": repl, "bits_pdiv64": pd64}, mf,
                        kcfg.damping)
    solver = dict(
        pooled_bitwise=pooled_equal,
        plan4_device_blocks=list(plan4.device_blocks),
        direct_ms=time_ms(torch, lambda: invert_factor_tree(mf, kcfg)),
        pooled4_ms=time_ms(torch, lambda: invert_factor_tree(
            mf, kcfg, plan=plan4)),
        pdiv64_ms=time_ms(torch, lambda: invert_factor_tree(
            mf, kcfg, plan=plan64)),
        pdiv64_depth=sorted({e.depth for e in plan64.pdiv}),
        min_bits_direct=min(r["bits_direct"] for r in rows64),
        min_bits_pdiv64=min(r["bits_pdiv64"] for r in rows64),
        bits=rows64)
    check(all(math.isfinite(r["bits_pdiv64"]) for r in rows64),
          "solver: pdiv at 64 finite")

    # Gauss-Newton: the G-only tree through the solver (a 4-device plan),
    # bitwise the replicated G inverses
    g_tree = {n: {"G": d["G"]} for n, d in mf.items()}
    gn_inv = gauss_newton.refresh_inverses(
        kfac.KFACState(0, g_tree, {}, {}, {}, {}), kcfg,
        plan=make_plan(g_tree, 4, kcfg)).inverses
    gn_equal = all(torch.equal(gn_inv[n]["G_inv"], repl[n]["G_inv"])
                   for n in g_tree)
    check(gn_equal, "gauss_newton: G refresh through the solver bitwise "
          "the replicated G inverses")
    del mf, repl, pd64, gn_inv, g_tree

    # blocks of 256 (--block-size 256): the factors of one stats step,
    # through pdiv at a cap of 128 (the reference's route for blocks the
    # card's neumann_inv cannot take), against float64 torch.linalg.inv,
    # beside fp32 torch.linalg.inv
    torch.cuda.empty_cache()
    kcfg256 = dataclasses.replace(kcfg, block_size=256)
    prog256 = train_mod.KFACProgram(cfg, kcfg256, seed=MAIN["seed"],
                                    device="cuda")
    st256 = prog256.init_state()
    st256, _ = steps_mod.make_stats_step(cfg, kcfg256)(
        st256, ds.batch(DataCursor(0), device=dev))
    f256 = st256.kfac.factors
    del st256, prog256
    torch.cuda.empty_cache()
    plan128 = make_plan(f256, 1, kcfg256, pdiv_cap_bs=128)
    pd128 = invert_factor_tree(f256, kcfg256, plan=plan128)
    fp32_inv = {n: {k + "_inv": torch.linalg.inv(
        damped64(t, kcfg.damping).float()).reshape(t.shape)
        for k, t in d.items()} for n, d in f256.items()}
    rows256 = route_bits({"bits_pdiv128": pd128, "bits_fp32_inv": fp32_inv},
                         f256, kcfg.damping)
    solver["block_256"] = dict(
        leaf_bs=sorted({t.shape[-1] for d in f256.values()
                        for t in d.values()}),
        pdiv=[dict(leaf=f"{e.name}/{e.side}", bs=e.bs, depth=e.depth)
              for e in plan128.pdiv][:3],
        n_pdiv_leaves=len(plan128.pdiv),
        pdiv128_ms=time_ms(torch, lambda: invert_factor_tree(
            f256, kcfg256, plan=plan128)),
        min_bits_pdiv128=min(r["bits_pdiv128"] for r in rows256),
        min_bits_fp32_inv=min(r["bits_fp32_inv"] for r in rows256),
        bits=rows256)
    check(len(plan128.pdiv) == sum(len(d) for d in f256.values())
          and all(math.isfinite(r["bits_pdiv128"]) for r in rows256),
          "solver: every 256-block leaf inverted through pdiv, finite")
    del f256, pd128, fp32_inv

    emit({"phase": "async_inv", "arch": cfg.name, "block_size": bs,
          "steps": async_steps, "losses": as_losses,
          "main_path_losses": losses,
          "n_dispatched": as_sum["n_dispatched"],
          "n_swapped": as_sum["n_swapped"],
          "phase_s": [h["phase_s"] for h in a_hist],
          "wall_s": as_wall, "launches": as_launches,
          "neumann_inv_streams": {str(k): v for k, v in nv_streams.items()},
          "main_stream": main_stream, "peak_mem_gb": as_peak,
          "stream_priority": a_stream.priority,
          "priority_range": list(prio_range),
          "staleness_bitwise": stale_equal,
          "trigger_steps": trigger_rows,
          "sync_inv_train_s": sync_inv_train_s,
          "overlap": overlap,
          "overlap_main_high_priority": overlap_high,
          "checkpoint": dict(pending_bitwise=ck_pending,
                             recoveries=ck_sum["recoveries"],
                             executed=[h["step"] for h in ck_hist],
                             losses=[h["loss"] for h in ck_hist]),
          "dist_inv_losses": dist_sum["losses"],
          "dist_inv_peak_mem_gb": dist_peak,
          "gauss_newton_bitwise": gn_equal,
          "solver": solver})
    torch.cuda.empty_cache()

    # 12. families: moe, ssm, vlm at full width (depth cut) and the
    # hybrid at its smoke config, each through launch.train.run and the
    # CLI's sgd path
    t0 = time.perf_counter()
    fam_rows = families_phase(torch, dev, check, cli)
    emit({"phase": "families", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi, "runs": fam_rows})

    # 13. whisper: the audio encoder-decoder's K-FAC run at published
    # widths, one SGD step and a static serve
    whisper_row = whisper_phase(torch, dev, check)
    emit({"phase": "whisper", "nvidia_smi": smi, **whisper_row})

    # 14. serve: the serving path (static, engine, a sync-checked chunk,
    # the recurrent families); no kernel
    serve_row = serve_phase(torch, dev, check)
    emit({"phase": "serve", "nvidia_smi": smi, **serve_row})

    # 15. trace: the main path's fourth step (FP, BP and WU only) under
    # torch.profiler, kernels only, last, so that the profiler session
    # cannot perturb the phases timed before it: the device's busy time
    # (the union of the kernels' intervals) against the step's host wall
    # time, and the kernels that fill it
    from torch.autograd import DeviceType

    prof = profile(activities=[ProfilerActivity.CUDA])

    def profile_last_step(st, rec):
        if rec["step"] == MAIN["steps"] - 1:
            prof.start()
        elif rec["step"] == MAIN["steps"]:
            torch.cuda.synchronize(dev)
            prof.stop()

    torch.cuda.empty_cache()
    _, tr_hist = train_mod.run(
        train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"], device="cuda"),
        ds, MAIN["steps"], on_step=profile_last_step)
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0_us, t1_us = e.time_range.start, e.time_range.end
        spans.append((t0_us, t1_us))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t1_us - t0_us)
    busy_us, end_us = 0.0, -math.inf
    for t0_us, t1_us in sorted(spans):
        busy_us += max(0.0, t1_us - max(t0_us, end_us))
        end_us = max(end_us, t1_us)
    span_ms = (end_us - min(t for t, _ in spans)) / 1e3 if spans else 0.0
    step_ms = tr_hist[-1]["phase_s"]["train"] * 1e3
    emit({"phase": "trace", "step": MAIN["steps"],
          "train_ms_profiled": step_ms,
          "train_ms_unprofiled": history[-1]["phase_s"]["train"] * 1e3,
          "kernel_launches": len(spans), "device_busy_ms": busy_us / 1e3,
          "device_span_ms": span_ms,
          "idle_share_of_span": 1.0 - busy_us / 1e3 / span_ms
          if span_ms else None,
          "fused_precond_ms": sum(us for k, us in by_name.items()
                                  if "fused_precond" in k) / 1e3,
          "top": [dict(name=k[:80], ms=us / 1e3) for k, us in sorted(
              by_name.items(), key=lambda x: -x[1])[:10]]})
    check(bool(spans), "the profiled step ran kernels on the device")
    del prof

    if failures:
        emit({"phase": "failed", "failures": failures})
        return 1
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # each kernel's count from the path it belongs to: the K-FAC main
    # path for neumann_inv and fused_precond, the SMW path for smw_update,
    # the precision_inv path for bitslice_mm and fused_gram_inv
    path_launches = dict(launches, smw_update=smw_launches["smw_update"],
                         bitslice_mm=pinv_launches["bitslice_mm"],
                         fused_gram_inv=pinv_launches["fused_gram_inv"])
    # whisper's launches beside them, and the serving phase's (none:
    # the serving path runs no TPU kernel's counterpart)
    emit({"kernels": [dict(name=name, launches=path_launches[name],
                           **{k: r[k] for k in keys},
                           whisper_launches=whisper_row["launches"][name],
                           serve_launches=serve_row["launches"][name])
                      for name, r in results.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
