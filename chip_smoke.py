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
  15. paged      the block-paged pool, the prefix cache and int8 serving
                 on the same model, weights from the same seed: P1 the
                 paged engine (8 slots, 512 blocks of 16) on the serve
                 phase's trace, tokens equal to the slot engine's there,
                 the host ledger equal to the device's tables and free
                 stack; P2 64 requests of 80-token prompts and 32 tokens
                 at step 0 through the slot engine (8 x 1024 columns) and
                 the paged one (64 slots, 512 blocks: the same k/v/pos
                 bytes), peak sessions >= 4x, tok/s, p99 TTFT, prefill
                 tokens; P3 the same trace on 256 blocks (preemptions,
                 every budget served, ledger = device); P4 16 requests
                 on one 512-token system prompt without and with the
                 prefix cache (15 hits, >= 2x fewer prefill tokens, the
                 store's 32 blocks held after); P5 the int8 slot engine
                 on P1's trace (resident reductions gated, greedy match
                 and margins reported), ``serve_greedy_parity`` at its
                 smoke config and paged + int8 against slot int8 on its
                 trained weights (decided requests all match); P6 one
                 paged and one int8 paged chunk of 8 live slots under
                 the sync check; P7 no kernel launched. Tokens that may
                 round differently (other slot counts, a prefix-hit
                 prefill, a resumed preemption) are held by the gap rule
                 (a divergence where the top two logits of one forward
                 over the prompt and the reference tokens lie within
                 SERVE_GAP_TOL)
  16. paper      the paper's tables and the single-device benchmarks
                 (``repro_torch.benchmarks``): (a) the pimsim model's
                 Tables I-II and Figs. 10-13 beside the paper's values
                 (the model's numbers, from the paper's ReRAM and V100
                 constants, not the card's; headlines held to
                 PIMSIM_HEADLINES); (b) Fig. 3 and Fig. 4(b) (NumPy, n
                 256, 20 samples); (c) kernel_bench's accuracy ladder
                 (20/1/0, 20/4/0, 20/4/2) through the CUDA neumann_inv,
                 each stage held to the plain version, bits against
                 float64, wall ms; (d) kfac_convergence's quadratic probe
                 and its 60-step smoke LM probe on the card (both kernels
                 launched); (e) the main path's losses beside its
                 inv_method="exact" run's (phase 5): whether the loss
                 rise is INV's accuracy or lr and damping; (f) paper Sec.
                 VI-C at full width: the main path's model and traffic,
                 60 steps through ``launch.train.run`` of K-FAC with the
                 probe's hyperparameters (composed: neumann_inv once a
                 refresh, fused_precond once a step; exact: no
                 neumann_inv) and of SGD (no kernel), each arm's losses,
                 steps to the probe's target, first non-finite step,
                 median phase seconds and peak memory (which arm wins is
                 reported, not checked), the composed arm's last refresh
                 through the run-data kernel checks
  17. tooling    the reference's single-device benchmarks and examples
                 through the port: (a) ``precision_ladder`` at the
                 reference's sizes (five rungs, 4-step trajectories, 40
                 training steps for int8 serving; int8 and hilo updates
                 >= 16 bits, decided greedy requests all matched); (b)
                 ``wu_fusion`` on its three smoke archs at block 16 and
                 on the main path's model at full width, block 128 (18816
                 tiles): per variant (per_leaf, fused, fused+ew_pool,
                 fused+kernel) paired-median wall ms and the kernel
                 launches, product calls and ATen calls of profiled
                 calls (host records); fused bitwise per_leaf, fewer product calls fused,
                 the kernel route within KERNEL_TOL, fused_precond
                 launched; (c) ``serve_engine`` and (d) ``serve_scale``
                 on qwen2-0.5b at published widths with the reference's
                 traffic (serve_scale's session, byte and prefill counts
                 gated); (e) ``obs_overhead``, the train step on the main
                 path's model and decode on qwen2-0.5b, 60/20 paired
                 rounds, the obs variant's JSONL rows; (f) the examples:
                 quickstart, precision_inv_demo (its CUDA neumann_inv vs
                 plain), serve_batched, train_kfac_100m --smoke (24
                 steps, then a device loss at step 12), and its ~100M
                 model 200 steps at its own block 256 (the kernels' large
                 route) with a checkpoint every 25 and a device loss at
                 step 100 (one recovery, the last loss below the first,
                 both kernels launched, every launch at block 256).
                 Wall-clock
                 guards (wu_fusion's paired guard, serve_engine's
                 engine >= static, obs_overhead's 2% budget) are printed
                 with their verdicts, not gated; launch counters zeroed
                 just before each sub-phase and read just after
  18. large_blocks  the kernels' route for block and tile sides of
                 129..1024 (every kernel's on ``csrc/hilo_tma.cuh``): (a)
                 neumann_inv at 129, 176, 256, 512 and 1024 (2-8 blocks)
                 and fused_precond indexed and gathered at (256, 256),
                 (256, 176), (176, 256), (1024, 176), (176, 1024), (130,
                 200) and (200, 130) (out's rows no multiple of 4), each
                 against its plain version (float64 inv too), launches,
                 bitwise its repeat, timed beside its plain version, its
                 library call (fused_precond: the gather + fp32 matmul
                 chain) and its bound (fused_precond: also the route's
                 bytes floor, ``wu_schedule``); a grouped call over leaves
                 of 128, 176 and 256 bitwise the per-leaf calls; (b) the
                 main path's model and traffic at block 256 (sides 256 and
                 176), 4 steps of ``launch.train.run`` with the launch
                 counters zeroed just before and read just after (both
                 kernels on every side and tile shape, the counts of the
                 plans), the whole refresh timed with its workspace and
                 peak memory beside torch.linalg.inv of the same damped
                 blocks and the schedule's bytes floor, the run's
                 inverses and its largest WU group against the plain
                 versions, each step's WU ms and each of its three WU
                 groups' fused_precond call timed beside the gather +
                 fp32 matmul chain; (c) one step at the
                 reference's default block 1024 (sides 1024 and 176)
                 through the same checks; (d) smw_update at (bs, k) of
                 (129..1024, 64), (256, 128), (176, 129), (256, 256) and
                 (1024, 1024) at unit and G-side scale, indefinite
                 inverses at (256, 64), and fused_gram_inv at 129..1024
                 (T 2048, fp32 and bf16), each against its plain version,
                 float64, its repeat (bitwise) and its plans' launches,
                 timed beside its plain version, library call and bound
                 (smw_update's solve also alone: its share), the Gram
                 inverse against the two-step route too; at (2, 1024,
                 1024) Y, S, Z and out stage by stage against the plain
                 version's and float64; (e)
                 ``--smw`` at block 256, 4 steps at rank 64 and then 2 at
                 rank 256 (the seeding step and an SMW step: the solve
                 above 128), launches by side and rank, each run's first
                 SMW step updated again against the plain version and
                 float64, timed beside ref.exact_smw_update; (f)
                 fused_gram_inv on the main path's first batch at block
                 256 (A sides 256 and 176) against its plain version, the
                 two-step route and float64
  19. dist       the main path over several ranks: two ranks sharing
                 the one card over gloo (NCCL refuses two ranks on one
                 device; gloo moves CUDA tensors through the host, every
                 kernel still runs on the card), or one rank a card over
                 NCCL; the parent frees its cache first and spawns them
                 (``dist.spawn.run_ranks``). On each rank: (a) one
                 data-parallel stats step of the main path (8 x 256 split
                 over the ranks, Grams reduced), its 3120 factor blocks
                 through a plan of the rank count, the rank's
                 neumann_inv launches and blocks against the plan, its
                 kernel ms (CUDA events) apart from the gather's, bitwise
                 the one-rank grouped refresh; (b) the same at block 256
                 (768 blocks of 256, 1152 of 176: the large route); (c)
                 ``solve.refresh_and_precondition`` in owner and gather
                 mode on the main path's 18816 WU tiles, the inverses
                 bitwise the one-rank call's, the tiles within 1e-6 of
                 its largest entry (whether bitwise is printed); (d) 4
                 data-parallel ``--dist-inv`` steps of
                 ``KFACProgram(mesh=)``: params bitwise equal across
                 ranks, losses within 0.2% of the same steps on one
                 rank with the gradient accumulated over the ranks' row
                 split (train_accum 2: the bf16 rounding of each part's
                 weight gradient) and the first gradient norm within
                 1e-6 of that run's, the gap to the main path's printed;
                 the same 4 steps at fp32 compute within 0.2% of the
                 plain one-rank run at fp32; on every rank neumann_inv's
                 launches and blocks those of (a)'s plan a refresh (its
                 pool rows alone) and fused_precond once a WU group a
                 step (summed into the kernels line); (e) ``compressed_allreduce_tree`` of each rank's
                 gradient of (d)'s last batch: within s / 127 of the
                 exact mean, 8 steps of error feedback within one step;
                 each rank's peak memory
  20. tp         the main path's model split megatron-style over two
                 model ranks (``--model-parallel 2 --dist-inv``) on the
                 same two ranks, mesh (1, 2): 4 steps at fp32 (against
                 one rank) and bf16 (steps 0-1 against the main path),
                 the split refresh bitwise the one-rank refresh's blocks,
                 the replicated leaves bitwise across ranks, a checkpoint
                 of the gathered state restored bitwise
  21. ep         moonshot-v1-16b-a3b at published widths, 1 of 48 layers,
                 on the main path's traffic (``train_accum`` 4): one rank
                 alone at fp32, then its 64 experts split over two model
                 ranks sharing the card (mesh (1, 2), 32 experts a rank,
                 the router replicated): (a) fp32 steps 0-1 within 1e-5
                 of the one rank (the rest and a bf16 run printed); (b)
                 each rank's expert factor stacks and WU tiles those of
                 its 32 experts, every block inverted once over the two
                 ranks, ``neumann_inv`` as the split refresh plans and
                 ``fused_precond`` once a WU group a step on each rank;
                 (c) each rank's inverses, largest refresh and one
                 ``fused_precond`` call against their plain versions;
                 (d) the router bitwise equal across ranks after every
                 step; (e) rank 0's checkpoint of the gathered state
                 restored bitwise; (f) on the same inputs (the initial
                 params, step 0's batch) the loss within 1e-6 and each
                 gathered gradient leaf within 1e-5 of one rank's, every
                 routing decision equal, pairs dropped; the routing
                 decisions the two fp32 trajectories differ in, by step
  22. pp         the main path's model cut into two pipeline stages
                 (``--pp 2 --dist-inv``, the free partition: 18 and 6
                 layers, 2 microbatches) over two ranks sharing the
                 card, against one rank at ``train_accum`` 2 (fp32):
                 (a) on the same inputs the loss within 1e-6, each
                 stage's gradient leaves within 1e-5 of their largest
                 entry, its statistics within 1e-5 of the one rank's
                 for the same layers, its refresh bitwise the one-rank
                 refresh of the same factors; (b) 4 steps under 1F1B,
                 steps 0-1 within 1e-5 of the one rank; (c) GPipe's
                 losses and params bitwise 1F1B's; (d) the ranks'
                 blocks and WU tiles summing to the one-rank program's,
                 both kernels launched on both ranks and held to their
                 plain versions; (e) each stage's peak stashed inputs
                 the schedule's stash plan
  23. elastic    the loss drill of ``runtime.elastic`` on the main path's
                 model at fp32 with ``--dist-inv``: two ranks sharing the
                 card on a (2, 1) mesh, a checkpoint every 2 steps, rank
                 1 losing a device at step 3; rank 0 re-forms (1, 1),
                 restores the checkpoint of step 2 and ends 5 steps: one
                 recovery, two remesh events and the counter at 2, rank
                 1's summary saying it was excluded, every loss within
                 0.2% of one rank's, after the re-mesh every block
                 inverted and every WU tile on rank 0, its kernels held
                 to their plain versions; the restore's seconds
  24. ranks_solvers  ``--smw``, ``--async-inv --dist-inv`` and the SGD
                 baseline on the same two ranks at (2, 1), fp32, against
                 one rank: (a) 4 SMW steps, the fallback steps the same
                 on both ranks and one rank, ``smw_update`` launched on
                 each rank, the inverses bitwise equal across the ranks,
                 rank 0's first SMW-only update through the kernel held
                 to its plain version; (b) 4 async steps, every
                 ``neumann_inv`` launch on the side stream, losses within
                 0.2% of one rank's, the refresh's overlap with the main
                 stream (gloo's) printed; (c) 2 SGD steps within 0.2%
  25. trace      the main path's four steps again, the fourth under
                 torch.profiler (kernels only): the device's busy time
                 against the step's wall time, and the top kernels; last,
                 so that the profiler session cannot perturb the phases
                 timed before it

Then the script's seconds, a JSON line of per-kernel results (with
whisper's launches, the serve and paged phases' (none), the paper
phase's and the tooling phase's, the large routes' at block 256, and
the dist, tp, ep, pp, elastic and ranks_solvers phases' summed over
their ranks),
the nvidia-smi line, and last
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
# the block-paged pool, the prefix cache and int8 serving on SERVE's
# model: P2/P3's short requests all offered at step 0 (as the reference's
# benchmarks/serve_scale.py), P4's shared system prompt, two arrivals a
# step; the smoke config's int8 parity harness trains this many steps
PAGED = dict(block_len=16, n_blocks=512, under_blocks=256,
             short=dict(requests=64, prompt_len=80, gen=32, seed=0,
                        paged_slots=64),
             prefix=dict(requests=16, sys_len=512, sfx_len=8, gen=16,
                         seed=3),
             parity_steps=30, parity_arch="qwen2-0.5b")
# a greedy divergence between the engine and the static path must start
# where the static run's top two logits lie within this: both compute in
# bf16 but round differently (the engine prefills a padded bucket and
# attends over its 1024 columns), and random weights give near-flat
# logits (15 of 16 requests diverged, at gaps of 0.0035-0.0167, on an
# H100 80GB HBM3 at 700 W)
SERVE_GAP_TOL = 0.05
# phase paper (f), paper Sec. VI-C at full width: the main path's model,
# traffic, seed and block, 60 steps of each arm; the K-FAC arms with
# kfac_convergence.lm_probe's hyperparameters (lr, damping, stats and
# refresh cadence, factor EMA) and KFAC_COUNTS, SGD at the probe's lr with
# momentum 0.9
PAPER = dict(steps=60, cadence=5, lr=0.08, damping=0.1, ema_decay=0.8,
             sgd_lr=0.3)
# the pimsim model's headlines (the paper's ReRAM and V100 constants, not
# a card's), as tests/test_torch_benchmarks.py holds them to the
# reference's on the CPU
PIMSIM_HEADLINES = {
    "table2_chip_area_mm2": 87.2, "fig10_best_vmm_per_inv": 32,
    "fig11_speedup_vs_gpu2_mean": 176.6,
    "fig11_speedup_vs_pipelayer_mean": 7.3,
    "fig11_speedup_vs_pipelayer_large_nets_mean": 2.2,
    "fig11_epoch_overhead_vs_pipelayer_pct_mean": 8.2,
    "fig12_energy_vs_pipelayer_mean": 12.8,
    "fig12_energy_vs_gpu2_mean": 4575.0,
    "fig13b_write_reduction_mean_pct": 60.2,
}
# phase tooling: the reference's single-device benchmarks and examples.
# wu_fusion's full-width case is the main path's model and block (its
# 18816 WU tiles); serve_engine, serve_scale and obs_overhead's decode run
# qwen2-0.5b at its published widths with each module's own traffic, and
# obs_overhead's train step the main path's model; train_kfac_100m's ~100M
# model takes 200 steps at the example's own block (256), a device loss
# at step 100
TOOLING = dict(wu_full=dict(arch="qwen1.5-0.5b", block_size=128,
                            n_tiles=18816),
               obs_reps=(60, 20),
               k100=dict(steps=200, batch=8, seq=128, inject_at=100,
                         keep=3),
               smoke_inject_at=12)
KFAC_COUNTS = dict(ns_iters=20, taylor_terms=4, refine_steps=2)
# phase large_blocks: the kernels' large route (sides of 129..1024). (a)
# neumann_inv at these (blocks, side), a grouped call over leaves of
# mixed sides, fused_precond at these (tiles, bi, bo; the last one's bo
# no multiple of 4, so out's and g's rows take the epilogue's masked
# entries), each tile's pools as a WU plan makes them (runs of POOL_RUN
# tiles on one A block, the G blocks cycling); (b) the main path's model
# at block 256 (sides 256 and 176); (c) one step at the reference's
# default block 1024 (sides 1024 and 176); (d) smw_update at these
# (blocks, k, bs) at unit and G-side scale and one case of indefinite
# inverses, fused_gram_inv at these (T, nb, n) in fp32 and bf16; (e)
# --smw at block 256 (rank 64, then one SMW step at smw_rank); (f)
# fused_gram_inv at block 256 on the main path's first batch
LARGE = dict(
    sides=((8, 129), (8, 176), (8, 256), (4, 512), (2, 1024)),
    grouped=((5, 256), (3, 128), (6, 176), (2, 256), (4, 128), (0, 176)),
    tiles=((1536, 256, 256), (3072, 256, 176), (1536, 176, 256),
           (768, 1024, 176), (384, 176, 1024), (512, 130, 200),
           (512, 200, 130)),
    pool_run=8, block_size=256, default_block=1024,
    smw=((8, 64, 129), (8, 64, 176), (8, 64, 256), (4, 64, 512),
         (2, 64, 1024), (8, 128, 256), (8, 129, 176), (4, 256, 256),
         (2, 1024, 1024)),
    smw_indefinite=(4, 64, 256), smw_stages=(2, 1024, 1024),
    gram=((2048, 8, 129), (2048, 8, 176), (2048, 8, 256), (2048, 4, 512),
          (2048, 2, 1024)),
    smw_rank=256)
# phase dist: the main path's model and traffic over DIST["ranks"] ranks
# (two sharing the one card over gloo, else one a card over NCCL): (a)
# the refresh of one data-parallel stats step's factors at block 128,
# (b) at block 256, (c) the fused INV->VMM program in both modes on the
# main path's WU tiles, (d) 4 data-parallel --dist-inv steps (and again
# at fp32 compute), (e) the compressed all-reduce of (d)'s gradients with
# EF_STEPS steps of error feedback; pre_tol: (c)'s preconditioned tiles
# against the one-rank call, of the largest entry; loss_tol: (d)'s losses
# against the one-rank run with the same row split accumulated, and at
# fp32 against the plain one-rank run ("Rounding on the card",
# ROADMAP.md)
DIST = dict(block_256=256, ef_steps=8, pre_tol=1e-6, loss_tol=2e-3,
            grad_seed=1)
# phase tp: --model-parallel 2 at fp32 compute against the one-rank fp32
# run (only the fp32 summation order of the row-parallel outputs and the
# input cotangents differs; the data-parallel fp32 witness landed 5.0e-5),
# and at bf16 steps 0-1 against the main path
TP = dict(fp32_tol=1e-4, bf16_tol=2e-3)
# phase ep: moonshot-v1-16b-a3b's experts over two model ranks, at its
# published widths and one of its 48 layers (two ranks, each with the
# embedding, the head and half the experts, share the card); fp32 steps
# 0-1 against one rank (only the fp32 summation order of the experts'
# partial outputs and of the row-parallel attention differs); on the same
# inputs the loss and each gradient leaf (of its largest entry) against
# one rank, at the summation-order tolerances of the CPU tests
EP = dict(arch="moonshot-v1-16b-a3b", layers=1, published_layers=48,
          fp32_tol=1e-5, same_tol=1e-6, grad_tol=1e-5)
# phase pp: the main path's model over 2 pipeline stages, 2 microbatches
PP = dict(stages=2, micro=2, same_tol=1e-6, grad_tol=1e-5, gram_tol=1e-5,
          fp32_tol=1e-5)
# phases elastic and ranks_solvers: the main path's model at fp32 on two
# gloo ranks sharing the card. elastic: 5 steps, a checkpoint every 2, one
# rank lost at step 3; ranks_solvers: --smw, --async-inv --dist-inv and
# the SGD baseline. Their losses within 0.2% of one rank's at fp32 (the
# main path's steps 3-4 move that much with summation order, "Rounding
# on the card", ROADMAP.md)
ELASTIC = dict(steps=5, ckpt_every=2, fail_at=3, lost=1, loss_tol=2e-3)
SOLVERS = dict(smw_steps=4, async_steps=4, sgd_steps=2, sgd_lr=1e-2,
               loss_tol=2e-3)
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


def leaves_by_side(factors) -> dict:
    """{block side: [blocks of each leaf of that side]} of a factor tree."""
    sides = {}
    for d in factors.values():
        for t in d.values():
            sides.setdefault(t.shape[-1], []).append(
                math.prod(t.shape[:-2]))
    return sides


def kfac_launch_checks(check, name, state, hist, launches, wu) -> int:
    """A K-FAC run's launches: ``fused_precond`` once a WU group a step
    where the group's tiles are at most 128 a side (else the large
    route's three a chunk), ``neumann_inv`` once a block side (and 32
    leaves) a refresh up to 128 (else the large route's sequence a
    chunk: ``kernels.neumann_inv.expected_launches``). Returns the
    launches a refresh makes."""
    from repro_torch.kernels import fused_precond as kf
    from repro_torch.kernels import neumann_inv as kn

    # a group of bi == bo reads one pool as both sides (split once)
    per_step = sum(kf.expected_launches(g.n_tiles, g.bi, g.bo,
                                        shared=g.bi == g.bo)
                   for g in wu.groups)
    check(launches["fused_precond"] == len(hist) * per_step,
          f"{name}: fused_precond once a WU group (or chunk) a step")
    per_refresh = kn.expected_launches(leaves_by_side(state.kfac.factors),
                                       **KFAC_COUNTS)
    refreshes = sum("inv" in h["phase_s"] for h in hist)
    check(launches["neumann_inv"] == refreshes * per_refresh,
          f"{name}: neumann_inv once a block side (or chunk) a refresh")
    return per_refresh


def kfac_kernel_checks(torch, dev, check, name, box, kcfg, wu, reps=5,
                       every_group=False):
    """The kernels of a K-FAC run held to their plain versions and
    timed: the run's inverses (``box["state"]``, popped so that its
    memory can go before the WU's tiles are made) against the plain
    ``neumann_inv`` on the same factor blocks; the refresh of the
    largest block side, one grouped call; and one ``fused_precond``
    call on the WU plan ``wu``'s largest group (the run's inverse pools,
    random tiles), each beside its library call and its bound. Returns
    ``(worst inverse, refresh row, fused_precond row)``; ``reps``: the
    timed runs a median is taken of. ``every_group``: the row also times
    every group of the plan, kernel and library call (``groups``), on the
    run's pools as the WU passes them."""
    from repro_torch.core import kfac, soi
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import neumann_inv as kn

    import gc

    import numpy as np

    state = box.pop("state")
    by_side = leaves_by_side(state.kfac.factors)
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
        launches=kn.expected_launches(
            {n_big: [x.shape[0] for x in blocks]}, **KFAC_COUNTS),
        ms=time_ms(torch, lambda: ops.neumann_inv_grouped(
            blocks, lams, **KFAC_COUNTS), reps),
        plain_ms=time_ms(torch, lambda: [ref.neumann_inv_ref(
            x, y, **KFAC_COUNTS) for x, y in big], reps),
        library_ms=time_ms(torch, lambda: torch.linalg.inv(
            cat + cat_lam[:, None, None] * eye), reps),
        bound_ms=inv_b_ms, bound_by=inv_b_by)
    del cat, cat_lam, leaves, big, blocks, lams

    # one fused_precond call on the family's own WU plan: its largest
    # group, the run's inverse pools, random gradient tiles; the
    # plain version in chunks of 8192 tiles (the tiles are
    # independent: the same function with a bounded footprint)
    grp = max(wu.groups, key=lambda g: g.n_tiles)
    pools = kfac.inverse_pools(state.kfac.inverses, wu.inv_plan)
    pa, pg = pools[grp.bi], pools[grp.bo]
    del state
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
                                                    g_src), reps),
        plain_ms=time_ms(torch, plain, reps),
        library_ms=time_ms(torch, lambda: torch.matmul(
            torch.matmul(pa[a_idx], g), pg[g_idx]), reps),
        bound_ms=wu_b_ms, bound_by=wu_b_by)
    del out, dots, p_out, p_dots, g, a_idx, g_idx
    if every_group:
        precond_row["groups"] = []
        for grp in wu.groups:
            pa, pg = pools[grp.bi], pools[grp.bo]
            g = torch.randn(grp.n_tiles, grp.bi, grp.bo, device=dev,
                            generator=gen)
            a_src, g_src = grp.src_on(dev)
            a_idx, g_idx = a_src.long(), g_src.long()
            precond_row["groups"].append(dict(
                shape=[grp.n_tiles, grp.bi, grp.bo],
                ms=time_ms(torch, lambda: ops.fused_precond(
                    pa, g, pg, a_src, g_src), reps),
                library_ms=time_ms(torch, lambda: torch.matmul(
                    torch.matmul(pa[a_idx], g), pg[g_idx]), reps)))
            del g, a_idx, g_idx
        precond_row["groups_ms"] = sum(r["ms"]
                                       for r in precond_row["groups"])
        precond_row["groups_library_ms"] = sum(
            r["library_ms"] for r in precond_row["groups"])
    del pools, pa, pg
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


def sync_checked_chunk(torch, eng, dev):
    """One decode chunk of ``eng`` (after its pre-chunk host work) under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on a host
    synchronisation (the chunk's program is built before it: a CUDA
    graph's capture synchronises, its replays do not). Returns the
    chunk's tokens and emitted flags (host arrays) and its record:
    tokens emitted, dispatch and wall seconds."""
    eng._pre_decode()
    eng.build_chunk()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emitted = eng.decode_chunk()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    dispatch_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    toks, emitted = toks.cpu().numpy(), emitted.cpu().numpy()
    return toks, emitted, dict(tokens=int(emitted.sum()),
                               dispatch_s=dispatch_s, wall_s=wall_s)


def serve_phase(torch, dev, check):
    """Phase ``serve``: the serving path of :data:`SERVE`'s model at full
    width, weights from the seed: the static path; the engine on
    ``synthetic_trace``, held to the static path (greedy) request by
    request; one decode chunk under ``set_sync_debug_mode("error")``;
    then the recurrent families through the engine, each held to its
    static path. No kernel is launched (checked). Returns the phase's
    record, with the engine's tokens ``{rid: tokens}`` under
    ``engine_tokens`` (for the paged phase, not printed)."""
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
        toks, emitted, chunk_row = sync_checked_chunk(torch, eng, dev)
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
            sync_checked_chunk=chunk_row)

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
               phase_seconds=time.perf_counter() - t_phase,
               engine_tokens={rid: f.tokens for rid, f in done.items()})
    return out


def gap_held(torch, cfg, params, prompt, got, ref, dev,
             first_may_differ=False):
    """Tokens ``got`` held to ``ref`` for the same ``prompt`` by the gap
    rule: equal, or equal up to a divergence where the top two logits of
    one forward pass over the prompt and ``ref``'s tokens before it lie
    within :data:`SERVE_GAP_TOL`, and not at the first token unless
    ``first_may_differ`` (the two runs prefilled differently). Returns
    ``(ok, step of the divergence or None, top-2 gap there)``."""
    import numpy as np

    from repro_torch.launch import steps as steps_mod

    if len(got) != len(ref):
        return False, None, None
    j = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)
    if j is None:
        return True, None, None
    toks = np.concatenate([prompt, np.asarray(ref[:j], np.int32)])
    logits, _ = steps_mod.model_module(cfg).forward(
        cfg, params, {"tokens": torch.from_numpy(toks[None]).to(dev)},
        last_only=True)
    top = torch.topk(logits[0, -1].float(), 2).values
    gap = float(top[0] - top[1])
    return (j > 0 or first_may_differ) and gap <= SERVE_GAP_TOL, j, gap


def hold_by_gap(torch, cfg, params, got, ref, reqs, dev,
                first_may_differ=False):
    """Every request's tokens in ``got`` held to ``ref``'s by
    :func:`gap_held`, each served to its whole budget. Returns ``(all held,
    divergences [dict(rid, step, top2_gap)])``."""
    ok, div = True, []
    for r in reqs:
        if r.rid not in got:
            ok = False
            continue
        g, want = got[r.rid].tokens, ref[r.rid].tokens
        ok_r, j, gap = gap_held(torch, cfg, params, r.prompt, g, want, dev,
                                first_may_differ)
        ok &= ok_r and len(g) == r.max_new_tokens
        if j is not None:
            div.append(dict(rid=r.rid, step=j, top2_gap=gap))
    return ok, div


def ledger_matches_device(torch, eng) -> bool:
    """The paged engine's host ledger against the device's tables,
    mapped counts, free stack and stack top, in one read."""
    import numpy as np

    pool, led = eng._pool, eng._ledger
    dev = torch.cat([pool["table"].flatten(), pool["n_mapped"],
                     pool["free"], pool["free_top"][None]]).cpu().numpy()
    want = np.concatenate([led.table.flatten(), led.n_mapped, led.free,
                           [led.top]])
    return bool(np.array_equal(dev, want))


def drive(torch, eng, reqs, arrivals, dev):
    """Run a trace step by step (as the reference's
    ``benchmarks/serve_scale.py``): the finished requests, the peak of
    concurrent sessions after a step, tok/s over the wall and the p99
    of the requests' TTFT."""
    import numpy as np

    pending = sorted(zip(arrivals, range(len(reqs))))
    done, peak, step_i = {}, 0, 0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    while pending or eng.scheduler.n_queued or eng._slots:
        while pending and pending[0][0] <= step_i:
            eng.submit(reqs[pending.pop(0)[1]])
        for fin in eng.step():
            done[fin.rid] = fin
        peak = max(peak, eng.n_active)
        step_i += 1
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    n_tok = sum(len(f.tokens) for f in done.values())
    return done, dict(
        requests=len(reqs), peak_sessions=peak, wall_s=wall,
        tok_per_s=n_tok / max(wall, 1e-9),
        p99_ttft_s=float(np.percentile(
            [f.ttft_s for f in done.values()], 99)),
        prefill_tokens=eng.stats["prefill_tokens"], steps=step_i)


def kv_bytes(pool) -> dict:
    """A pool's cache-leaf bytes (k, v, pos and int8 scales) and its
    bookkeeping bytes (lengths, table, free stack) apart."""
    cache = sum(t.numel() * t.element_size() for k, t in pool.items()
                if "/" in k)
    rest = sum(t.numel() * t.element_size() for k, t in pool.items()
               if "/" not in k and hasattr(t, "numel"))
    return dict(kv=cache, bookkeeping=rest)


def paged_phase(torch, dev, check, serve_tokens):
    """Phase ``paged``: the block-paged pool, the prefix cache and int8
    serving on :data:`SERVE`'s model at full width, weights from its
    seed (checks P1-P7 of the module docstring). ``serve_tokens`` are the
    serve phase's engine tokens ``{rid: tokens}``. Returns the phase's
    record."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.lowp import serve_parity
    from repro_torch.serve import (EngineConfig, PagedConfig,
                                   PagedServeEngine, Request, ServeEngine,
                                   synthetic_trace)

    t_phase = time.perf_counter()
    parse = serve_mod.build_parser().parse_args
    cfg = get_config(SERVE["arch"])
    name, bl = cfg.name, PAGED["block_len"]
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    out = dict(arch=name, block_len=bl)
    secs = {}
    with torch.no_grad():
        params = serve_mod.init_params(cfg, SERVE["seed"], dev)
        en_args = ["--arch", name, "--requests", str(SERVE["requests"]),
                   "--prompt-len", str(SERVE["prompt_len"]),
                   "--gen", str(SERVE["gen"]),
                   "--max-slots", str(SERVE["max_slots"]),
                   "--max-len", str(SERVE["max_len"]),
                   "--decode-chunk", str(SERVE["decode_chunk"]),
                   "--seed", str(SERVE["seed"])]
        reqs, _ = synthetic_trace(cfg.vocab, SERVE["requests"],
                                  SERVE["prompt_len"], SERVE["gen"],
                                  SERVE["max_slots"], seed=SERVE["seed"])

        # P1: paged = slot on the serve phase's trace, 512 blocks of 16
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        p1_args = parse(en_args + ["--paged", "--block-len", str(bl),
                                   "--kv-blocks", "0"])
        eng = serve_mod.build_engine(cfg, p1_args, params)
        p1_sum, p1_done = serve_mod.serve_engine(cfg, p1_args, dev,
                                                 engine=eng)
        p1_tokens = {r.rid: p1_done[r.rid].tokens for r in reqs}
        check(p1_tokens == serve_tokens,
              "paged P1: tokens equal to the slot engine's")
        check(eng._n_blocks == PAGED["n_blocks"]
              and ledger_matches_device(torch, eng),
              "paged P1: the ledger equals the device state")
        fp_bytes = eng.resident_bytes()
        out["p1"] = dict(engine=p1_sum, n_blocks=eng._n_blocks,
                         equal_tokens=p1_tokens == serve_tokens,
                         n_differing=sum(p1_tokens[k] != serve_tokens.get(k)
                                         for k in p1_tokens),
                         kv_bytes=kv_bytes(eng._pool),
                         peak_mem_gb=torch.cuda.max_memory_allocated(dev)
                         / 1e9)
        del eng
        secs["p1"] = time.perf_counter() - t0

        # P2: sessions at equal KV bytes; P3: the pool undersubscribed
        t0 = time.perf_counter()
        sh = PAGED["short"]
        rng = np.random.default_rng(sh["seed"])
        short = [Request(i, rng.integers(0, cfg.vocab, sh["prompt_len"])
                         .astype(np.int32), max_new_tokens=sh["gen"])
                 for i in range(sh["requests"])]
        arr0 = [0] * len(short)
        common = dict(max_len=SERVE["max_len"],
                      decode_chunk=SERVE["decode_chunk"])
        slot = ServeEngine(cfg, params, EngineConfig(
            max_slots=SERVE["max_slots"], **common))
        s_done, s_row = drive(torch, slot, short, arr0, dev)
        s_row["kv_bytes"] = kv_bytes(slot._pool)
        del slot
        runs = {}
        for key, nb in (("p2", PAGED["n_blocks"]),
                        ("p3", PAGED["under_blocks"])):
            eng = PagedServeEngine(cfg, params, PagedConfig(
                max_slots=sh["paged_slots"], block_len=bl, n_blocks=nb,
                **common))
            done, row = drive(torch, eng, short, arr0, dev)
            ok, div = hold_by_gap(torch, cfg, params, done, s_done, short,
                                  dev)
            row.update(kv_bytes=kv_bytes(eng._pool), n_blocks=nb,
                       preemptions=eng.stats["preemptions"],
                       ledger_ok=ledger_matches_device(torch, eng),
                       gap_ok=ok, divergences=div,
                       free_blocks_low_watermark=eng._ledger.low_watermark)
            check(ok, f"paged {key}: tokens held to the slot engine's")
            check(row["ledger_ok"], f"paged {key}: ledger = device")
            runs[key] = row
            del eng
        p2, p3 = runs["p2"], runs["p3"]
        check(p2["kv_bytes"]["kv"] == s_row["kv_bytes"]["kv"],
              "paged P2: equal k/v/pos bytes")
        check(p2["peak_sessions"] >= 4 * s_row["peak_sessions"],
              "paged P2: >= 4x the slot engine's concurrent sessions")
        check(p3["preemptions"] >= 1, "paged P3: preemptions")
        out.update(p2=dict(slot=s_row, paged=p2,
                           session_gain=p2["peak_sessions"]
                           / max(s_row["peak_sessions"], 1)), p3=p3)
        secs["p2_p3"] = time.perf_counter() - t0

        # P4: the prefix cache
        t0 = time.perf_counter()
        pf = PAGED["prefix"]
        rng = np.random.default_rng(pf["seed"])
        sys_p = rng.integers(0, cfg.vocab, pf["sys_len"]).astype(np.int32)
        pre = [Request(i, np.concatenate(
            [sys_p, rng.integers(0, cfg.vocab, pf["sfx_len"])
             .astype(np.int32)]), max_new_tokens=pf["gen"])
            for i in range(pf["requests"])]
        arr = [i // 2 for i in range(len(pre))]
        rows, dones = {}, {}
        for cache in (False, True):
            eng = PagedServeEngine(cfg, params, PagedConfig(
                max_slots=SERVE["max_slots"], block_len=bl,
                n_blocks=PAGED["n_blocks"], prefix_cache=cache, **common))
            dones[cache], rows[cache] = drive(torch, eng, pre, arr, dev)
            rows[cache].update({k: eng.stats[k] for k in (
                "prefix_hits", "prefix_hit_tokens", "evictions")})
            if cache:
                led = eng._ledger
                n_sys = pf["sys_len"] // bl
                check(eng.stats["prefix_hits"] == len(pre) - 1
                      and eng.stats["prefix_hit_tokens"]
                      == (len(pre) - 1) * pf["sys_len"],
                      "paged P4: 15 prefix hits of the system prompt")
                check(len(eng._store) == n_sys
                      and led.top == led.n_blocks - n_sys
                      and ledger_matches_device(torch, eng),
                      "paged P4: the store's blocks held, the rest free")
                rows[cache]["store_blocks"] = len(eng._store)
            del eng
        check(rows[False]["prefill_tokens"]
              >= 2 * rows[True]["prefill_tokens"],
              "paged P4: prefill tokens cut >= 2x")
        ok, div = hold_by_gap(torch, cfg, params, dones[True], dones[False],
                              pre, dev, first_may_differ=True)
        check(ok, "paged P4: prefix-cache tokens held to the uncached run's")
        out["p4"] = dict(no_cache=rows[False], cache=rows[True],
                         prefill_cut=rows[False]["prefill_tokens"]
                         / max(rows[True]["prefill_tokens"], 1),
                         divergences=div)
        secs["p4"] = time.perf_counter() - t0

        # P5: int8 at full width, then the smoke contract
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        q_args = parse(en_args + ["--quant", "int8"])
        q_eng = serve_mod.build_engine(cfg, q_args, params)
        q_sum, q_done = serve_mod.serve_engine(cfg, q_args, dev,
                                               engine=q_eng)
        q_bytes = q_eng.resident_bytes()
        q_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        del q_eng
        margins = [dict(rid=r.rid,
                        match=q_done[r.rid].tokens == serve_tokens[r.rid],
                        fp_margin=serve_parity.greedy_margin(
                            cfg, params, r.prompt, serve_tokens[r.rid]))
                   for r in reqs]
        p_red = fp_bytes["params"] / q_bytes["params"]
        k_red = fp_bytes["pool"] / q_bytes["pool"]
        check(p_red > 1.5 and k_red > 1.3,
              "paged P5: int8 resident reductions (> 1.5x weights, "
              "> 1.3x pool)")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        par = serve_parity.serve_greedy_parity(
            PAGED["parity_arch"], train_steps=PAGED["parity_steps"],
            device=dev)
        check(par["decided_matched"] == par["decided_total"] >= 2,
              "paged P5: serve_greedy_parity's smoke contract")
        scfg = get_smoke_config(PAGED["parity_arch"])
        tp, ds = serve_parity.trained_params(
            scfg, steps=PAGED["parity_steps"], device=dev)
        preq = [Request(i, ds.batch_slice(100 + i, 0, 1)[0, :12].astype(
            np.int32), max_new_tokens=8) for i in range(6)]
        parr = list(np.arange(6) // 2)
        small = dict(max_slots=2, max_len=48, decode_chunk=3,
                     buckets=(16,), quant="int8")
        ps_out = ServeEngine(scfg, tp, EngineConfig(**small)).run(preq, parr)
        pp_out = PagedServeEngine(scfg, tp, PagedConfig(
            block_len=16, n_blocks=6, **small)).run(preq, parr)
        decided = [r.rid for r in preq if serve_parity.greedy_margin(
            scfg, tp, r.prompt, ps_out[r.rid].tokens)
            >= serve_parity.MARGIN_FLOOR]
        check(len(decided) >= 2 and all(
            ps_out[i].tokens == pp_out[i].tokens for i in decided),
            "paged P5: paged int8 = slot int8 on decided requests")
        out["p5"] = dict(
            engine=q_sum, resident_fp=fp_bytes, resident_int8=q_bytes,
            param_reduction=p_red, pool_reduction=k_red,
            peak_mem_gb=q_peak,
            greedy_matched=sum(m["match"] for m in margins),
            margins=margins,
            parity={k: par[k] for k in (
                "matched", "total", "decided_matched", "decided_total",
                "param_reduction", "pool_reduction")},
            parity_margins=[rec["margin"] for rec in par["records"]],
            paged_int8_decided=len(decided),
            paged_int8_matched=sum(ps_out[i].tokens == pp_out[i].tokens
                                   for i in decided))
        del tp
        secs["p5"] = time.perf_counter() - t0

        # P6: a paged chunk and an int8 paged chunk of 8 live slots under
        # the sync check
        t0 = time.perf_counter()
        params = serve_mod.init_params(cfg, SERVE["seed"], dev)
        sync_rows = {}
        for quant in ("none", "int8"):
            eng = PagedServeEngine(cfg, params, PagedConfig(
                max_slots=SERVE["max_slots"], block_len=bl,
                n_blocks=PAGED["n_blocks"], quant=quant, **common))
            for r in reqs[:SERVE["max_slots"]]:
                eng.submit(r)
            eng._do_admissions()
            _, emitted, sync_rows[quant] = sync_checked_chunk(torch, eng,
                                                              dev)
            check(bool(emitted.all()) and ledger_matches_device(torch, eng),
                  f"paged P6: the sync-checked {quant} chunk")
            del eng
        out["p6"] = sync_rows
        del params
        gc.collect()
        torch.cuda.empty_cache()
        secs["p6"] = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(set(launches.values()) == {0}, "paged P7: no kernel launched")
    out.update(launches=launches, seconds=secs,
               phase_seconds=time.perf_counter() - t_phase)
    return out


def paper_phase(torch, dev, check, main_losses, exact_losses):
    """Phase ``paper``: (a) the pimsim model's tables and headlines
    (host; the paper's ReRAM and V100 constants, not the card's),
    headlines held to :data:`PIMSIM_HEADLINES`; (b) ``soi_precision``
    and ``inv_convergence`` at the reference's sizes (host); (c)
    ``kernel_bench``'s accuracy ladder on the card, each stage's CUDA
    inverse held to the plain version; (d) ``kfac_convergence``'s
    quadratic probe and ``lm_probe()`` at its defaults on the card; (e)
    the main path's losses beside those of its ``inv_method="exact"``
    run; (f) paper Sec. VI-C at full width: :data:`PAPER`'s arms through
    ``launch.train.run`` on the main path's model and traffic, each with
    its losses, steps to the probe's target, first non-finite step,
    median phase seconds and peak memory, the composed arm's last
    refresh through :func:`kfac_kernel_checks`. Which arm wins is
    reported, not checked. ``launches``: each driven run's kernel
    launches, counters zeroed just before it and read just after (the
    checks' own calls excluded)."""
    from repro_torch.benchmarks import (area, dse, energy, inv_convergence,
                                        kernel_bench, kfac_convergence,
                                        mapping_impact, soi_precision,
                                        soi_sizes, speedup)
    from repro_torch.configs import get_config
    from repro_torch.core import kfac
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as train_mod

    import gc
    import types

    t_phase = time.perf_counter()
    secs, launches = {}, {}

    def counted(tag, fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize(dev)
        launches[tag] = ops.launch_counts()
        return out

    # (a) the pimsim model: host arithmetic, bitwise the reference's
    t0 = time.perf_counter()
    heads = [area.headline(), dse.headline(), *speedup.headline(),
             *energy.headline(), mapping_impact.headline()]
    check({h["name"]: h["value"] for h in heads} == PIMSIM_HEADLINES,
          "paper: pimsim headlines equal the CPU test's")
    out = {"pimsim": dict(
        source="the pimsim model (the paper's ReRAM and V100 "
               "constants), not a measurement of this card",
        headlines=heads, table1=soi_sizes.rows(), table2=area.rows(),
        fig10=dse.rows(), fig11=speedup.rows(), fig12=energy.rows(),
        fig13a=mapping_impact.rows_blocksize(),
        fig13b=mapping_impact.rows_writes())}
    secs["pimsim"] = time.perf_counter() - t0

    # (b) Fig. 3 and Fig. 4(b): NumPy on the host, n 256, 20 samples
    t0 = time.perf_counter()
    fig3 = soi_precision.rows()
    fig4b = inv_convergence.rows()
    out["host_studies"] = dict(
        fig3=fig3, fig3_headline=soi_precision.headline(fig3),
        fig4b_at_18=[r for r in fig4b if r["loop_a_iters"] == 18],
        fig4b_headline=inv_convergence.headline(fig4b))
    secs["host_studies"] = time.perf_counter() - t0

    # (c) kernel_bench on the card: the ladder's inverses against the
    # plain version on the same block
    t0 = time.perf_counter()
    invs = {}
    ladder = counted("kernel_bench", lambda: kernel_bench.accuracy_ladder(
        device=dev, out=invs))
    a, damp, _ = kernel_bench.ladder_problem()
    a_t, d_t = torch.from_numpy(a).to(dev), torch.from_numpy(damp).to(dev)
    for row, (tag, kw) in zip(ladder, kernel_bench.STAGES):
        plain = ref.neumann_inv_ref(a_t, d_t, **kw)
        err = float((invs[tag] - plain).abs().max())
        scale = float(plain.abs().max())
        row.update(counts=kw, max_abs_err=err, max_abs_plain=scale,
                   tol=REL_TOL * scale)
        check(err <= REL_TOL * scale,
              f"paper: kernel_bench {tag}: CUDA inverse vs plain")
    # a warm-up and one timed call a stage
    check(launches["kernel_bench"]["neumann_inv"]
          == 2 * len(kernel_bench.STAGES),
          "paper: kernel_bench launches neumann_inv for every stage")
    out["kernel_bench"] = dict(ladder=ladder,
                               traffic_model=kernel_bench.traffic_model())
    secs["kernel_bench"] = time.perf_counter() - t0

    # (d) kfac_convergence on the card
    t0 = time.perf_counter()
    quad = kfac_convergence.quadratic_probe(device=dev)
    probe = counted("lm_probe", lambda: kfac_convergence.lm_probe(
        device=dev))
    n = len(probe["kfac_losses"])
    check(all(math.isfinite(x) for x in
              probe["kfac_losses"] + probe["sgd_losses"]),
          "paper: lm_probe finite losses")
    # the same number of launches at each of its 12 refreshes (one a block
    # side) and at each of its 60 steps (one a WU group)
    nv, fp = (launches["lm_probe"][k] for k in ("neumann_inv",
                                                 "fused_precond"))
    check(nv > 0 and nv % -(-n // 5) == 0 and fp > 0 and fp % n == 0,
          "paper: lm_probe's K-FAC arm launches both kernels")
    out["kfac_convergence"] = dict(quadratic=quad, lm_probe=probe)
    secs["kfac_convergence"] = time.perf_counter() - t0

    # (e) Queue 3's open check: the main path's 4 steps with the
    # composed inverse and with float64-accurate ones (phase 5's run)
    rises = exact_losses[-1] > exact_losses[0]
    out["open_check"] = dict(
        composed=main_losses, exact=exact_losses, exact_rises=rises,
        cause=("lr and damping: the float64-accurate inverse's run rises "
               "too" if rises else "INV accuracy: the float64-accurate "
               "inverse's run does not rise"))

    # (f) Sec. VI-C at full width
    cfg = get_config(MAIN["arch"])
    bs = min(MAIN["block_size"], cfg.soi_block)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=MAIN["seq"],
                         global_batch=MAIN["batch"], seed=MAIN["seed"])
    kcfg = kfac.KFACConfig(
        lr=PAPER["lr"], damping=PAPER["damping"],
        ema_decay=PAPER["ema_decay"], stats_every=PAPER["cadence"],
        inv_every=PAPER["cadence"], block_size=bs,
        stats_batch=MAIN["batch"], stats_seq=MAIN["seq"], **KFAC_COUNTS)
    arms = dict(
        composed=lambda: train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                               device="cuda"),
        exact=lambda: train_mod.KFACProgram(
            cfg, dataclasses.replace(kcfg, inv_method="exact"),
            seed=MAIN["seed"], device="cuda"),
        sgd=lambda: train_mod.SGDProgram(cfg, lr=PAPER["sgd_lr"],
                                         seed=MAIN["seed"], device="cuda"))
    snap = {}

    def keep_refresh(state, rec):
        # the composed arm's last refresh at a finite loss (a diverging
        # run's later factors are not finite): its factors and inverses
        if "inv" in rec["phase_s"] and math.isfinite(rec["loss"]):
            snap["kfac"] = types.SimpleNamespace(
                factors=state.kfac.factors, inverses=state.kfac.inverses)

    runs = {}
    for arm, make in arms.items():
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        program = make()
        state, hist = counted(arm, lambda: train_mod.run(
            program, ds, PAPER["steps"],
            on_step=keep_refresh if arm == "composed" else None))
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        losses = [h["loss"] for h in hist]
        phases = sorted({k for h in hist for k in h["phase_s"]})
        runs[arm] = dict(
            losses=losses,
            first_nonfinite_step=next((i for i, x in enumerate(losses)
                                       if not math.isfinite(x)), None),
            median_phase_s={p: statistics.median(
                h["phase_s"][p] for h in hist if p in h["phase_s"])
                for p in phases},
            peak_mem_gb=peak, launches=launches[arm])
        if arm == "composed":
            wu = train_mod.steps_mod.make_wu_plan_for(cfg, state)
            del state, program
            check("kfac" in snap, "paper: the composed arm refreshed")
            worst, refresh_row, precond_row = kfac_kernel_checks(
                torch, dev, check, "paper/composed",
                {"state": types.SimpleNamespace(kfac=snap.pop("kfac"))},
                kcfg, wu)
            runs[arm].update(worst_inverse=worst, refresh=refresh_row,
                             fused_precond=precond_row)
        else:
            del state, program
        runs[arm]["seconds"] = time.perf_counter() - t0
    refreshes = -(-PAPER["steps"] // PAPER["cadence"])
    check(launches["composed"]["neumann_inv"] == refreshes
          and launches["composed"]["fused_precond"] == PAPER["steps"],
          "paper: composed arm, neumann_inv once a refresh and "
          "fused_precond once a step")
    check(launches["exact"]["neumann_inv"] == 0
          and launches["exact"]["fused_precond"] == PAPER["steps"],
          "paper: exact arm, no neumann_inv and fused_precond once a step")
    check(set(launches["sgd"].values()) == {0},
          "paper: sgd arm launches no kernel")
    target, firsts = kfac_convergence.steps_to_target(
        *(runs[arm]["losses"] for arm in arms))
    for arm, first in zip(arms, firsts):
        runs[arm]["steps_to_target"] = first
    out["sec6c"] = dict(
        arch=cfg.name, layers=cfg.n_layers, batch=MAIN["batch"],
        seq=MAIN["seq"], block_size=bs, steps=PAPER["steps"],
        target=target, target_rule="70% of the best drop below the "
        "composed arm's first loss", **runs)
    torch.cuda.empty_cache()
    out.update(launches=launches, seconds=secs,
               phase_seconds=time.perf_counter() - t_phase)
    return out


def tooling_phase(torch, dev, check):
    """Phase ``tooling``: the reference's single-device benchmarks and
    its examples, ported (``repro_torch.benchmarks``,
    ``repro_torch.examples``). (a) ``precision_ladder.main`` at the
    reference's sizes; (b) ``wu_fusion`` on the reference's three smoke
    archs at block 16 and on the main path's model at full width, block
    128; (c) ``serve_engine`` and (d) ``serve_scale`` on qwen2-0.5b at its
    published widths; (e) ``obs_overhead`` (the train step on the main
    path's model, decode on qwen2-0.5b, both at full width); (f) the four
    examples, ``train_kfac_100m``'s ~100M model 200 steps at its own
    block 256.
    Gated: correctness and counts (the modules' own asserts on bits,
    bitwise flags, product counts, sessions and prefill tokens; the
    kernel route against per-leaf; launches). Wall-clock guards
    (wu_fusion's paired guard, serve_engine's ratio, the obs budget) are
    printed with their verdicts, not gated. ``launches``: each driven
    sub-phase's, counters zeroed just before it and read just after."""
    from repro_torch.benchmarks import (obs_overhead, precision_ladder,
                                        serve_engine, serve_scale,
                                        wu_fusion)
    from repro_torch.examples import (precision_inv_demo, quickstart,
                                      serve_batched, train_kfac_100m)
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as train_mod

    import gc

    t_phase = time.perf_counter()
    secs, launches, out = {}, {}, {}

    def counted(tag, fn):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize(dev)
        launches[tag] = ops.launch_counts()
        secs[tag] = time.perf_counter() - t0
        return res

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    try:
        # (a) the precision ladder, every rung, 4-step trajectories, 40
        # training steps for the int8 serving parity
        data = counted("precision_ladder", lambda: precision_ladder.main(
            ["--device", str(dev), "--out",
             os.path.join(tmp, "BENCH_precision.json")]))
        upd = {r["precision"]: r["min_bits"] for r in data["update"]}
        sv = data["serve"][0]
        check(upd["int8"] >= 16 and upd["hilo"] >= 16,
              "tooling: precision_ladder int8 and hilo updates >= 16 bits")
        check(sv["decided_matched"] == sv["decided_total"] > 0,
              "tooling: precision_ladder decided greedy requests match")
        check(launches["precision_ladder"]["neumann_inv"] > 0,
              "tooling: precision_ladder refreshes through neumann_inv")
        out["precision_ladder"] = dict(
            update=data["update"], trajectory=data["trajectory"],
            serve=data["serve"], headline=precision_ladder.headline(data),
            block_final=[r for r in data["block"]
                         if r["loop_a_iter"] == 12])

        # (b) wu_fusion: the reference's smoke archs, then full width
        cases = []
        for arch in wu_fusion.ARCHS + wu_fusion.EXTRA_ARCHS:
            cases.append(counted(f"wu_fusion/{arch}", lambda: (
                wu_fusion._wu_case(arch, device=dev))))
        full = TOOLING["wu_full"]
        cases.append(counted("wu_fusion/full", lambda: wu_fusion._wu_case(
            full["arch"], smoke=False, block_size=full["block_size"],
            device=dev)))
        check(cases[-1]["n_tiles"] == full["n_tiles"],
              "tooling: wu_fusion full width on the main path's plan")
        wu_rows = []
        for c, tag in zip(cases, [f"wu_fusion/{a}" for a in wu_fusion.ARCHS
                                  + wu_fusion.EXTRA_ARCHS]
                          + ["wu_fusion/full"]):
            name = f"tooling: {tag}"
            v = c["variants"]
            check(all(c["bitwise_equal"].values()),
                  f"{name}: fused and fused+ew_pool bitwise per_leaf")
            if c["arch"] in wu_fusion.ARCHS:
                check(v["fused"]["gemms"] < v["per_leaf"]["gemms"],
                      f"{name}: fewer product calls fused than per leaf")
            check(c["kernel_max_rel_err"] <= wu_fusion.KERNEL_TOL,
                  f"{name}: fused+kernel within KERNEL_TOL of per_leaf")
            check(launches[tag]["fused_precond"] > 0,
                  f"{name}: fused_precond launched")
            wu_rows.append(dict(
                c, launches=launches[tag], wall_guard=wu_fusion.wall_guard(c),
                wall_guard_rule="paired diff >= -0.15 x per_leaf wall "
                                "(reported, not gated)"))
        out["wu_fusion"] = wu_rows

        # (c) serve_engine at published widths, the reference's traffic
        rows = counted("serve_engine", lambda: serve_engine.rows(
            smoke=False, device=dev))
        out["serve_engine"] = dict(
            rows=rows, speedup=serve_engine.speedup(rows),
            reference_guard="engine >= static (reported, not gated)",
            guard_holds=serve_engine.speedup(rows) >= 1.0)

        # (d) serve_scale at published widths: its asserts are counts
        try:
            rows = counted("serve_scale", lambda: serve_scale.rows(
                smoke=False, device=dev))
            out["serve_scale"] = dict(rows=rows,
                                      headline=serve_scale.headline(rows))
        except AssertionError as e:
            check(False, f"tooling: serve_scale: {e}")

        # (e) obs_overhead: both hot paths at full width
        obs_dir = os.path.join(tmp, "obs")
        reps_train, reps_decode = TOOLING["obs_reps"]
        rows = counted("obs_overhead", lambda: obs_overhead.rows(
            reps_train, reps_decode, smoke=False, device=dev,
            out_dir=obs_dir))
        with open(os.path.join(obs_dir, "train", "events.jsonl")) as f:
            obs_rows = [json.loads(line) for line in f]
        check([r["case"] for r in rows] == ["train_step", "decode_chunk"]
              and all(r["off_us_med"] > 0 and r["obs_us_med"] > 0
                      for r in rows),
              "tooling: obs_overhead both variants ran")
        check(len(obs_rows) == 1 + 10 * ((reps_train - 1) // 10)
              and all(r["kind"] == "train_step"
                      and math.isfinite(r["loss"]) for r in obs_rows),
              "tooling: obs_overhead's obs variant wrote its rows")
        out["obs_overhead"] = dict(
            rows=rows, jsonl_rows=len(obs_rows),
            budget=[dict(case=r["case"], budget_us=obs_overhead.budget_us(r),
                         within=r["paired_diff_med_us"]
                         <= obs_overhead.budget_us(r)) for r in rows],
            budget_rule="paired diff <= max(2% of bare, 100 us) (reported, "
                        "not gated)")

        # (f) the examples
        qs = counted("quickstart", lambda: quickstart.main(
            ["--device", str(dev)]))
        demo = counted("precision_inv_demo", lambda: precision_inv_demo.main(
            ["--device", str(dev)]))
        plain = ref.neumann_inv_ref(demo["blocks"], demo["damping"],
                                    **KFAC_COUNTS)
        err = float((demo["inverse"] - plain).abs().max())
        check(err <= REL_TOL * float(plain.abs().max()),
              "tooling: precision_inv_demo's CUDA inverse vs plain")
        check(launches["precision_inv_demo"]["neumann_inv"] == 1,
              "tooling: precision_inv_demo launches neumann_inv once")
        out["examples"] = dict(
            quickstart=qs,
            precision_inv_demo=dict(
                {k: v for k, v in demo.items()
                 if k not in ("inverse", "blocks", "damping")},
                max_abs_err_vs_plain=err))
        sb = counted("serve_batched", lambda: serve_batched.main(
            ["--device", str(dev)]))
        out["examples"]["serve_batched"] = dict(
            engine=sb["engine"][0], static=sb["static"][0])

        # --smoke's run (the example's main() without its asserts:
        # "last below first" compares one batch's loss with another's,
        # and the seed decides it: the reference's own run fails it on
        # seeds 2 and 4 of 0-5, the port's on seed 0, while on the
        # reference's weights the port's run drops as the reference's
        # does; tests/test_torch_examples.py holds both. Reported, not
        # gated)
        smoke_runs = {}
        cfg_s = train_kfac_100m.config_smoke()
        for tag, inject_at in (("smoke", -1),
                               ("smoke_inject", TOOLING["smoke_inject_at"])):
            s = counted(f"train_kfac_100m/{tag}",
                        lambda: train_kfac_100m.train(
                            cfg_s, train_kfac_100m.kfac_config(cfg_s, 4, 32),
                            steps=24, batch=4, seq=32,
                            ckpt_dir=os.path.join(tmp, f"ck_{tag}"),
                            inject_at=inject_at, device=dev))
            losses = [h["loss"] for h in s["history"]]
            check(all(math.isfinite(x) for x in losses),
                  f"tooling: train_kfac_100m {tag} finite losses")
            smoke_runs[tag] = dict(
                losses=losses, recoveries=s["recoveries"], wall_s=s["wall_s"],
                last_below_first=losses[-1] < losses[0],
                launches=launches[f"train_kfac_100m/{tag}"])
        check(smoke_runs["smoke_inject"]["recoveries"] == 1,
              "tooling: train_kfac_100m --smoke: one recovery")

        # the ~100M model at the example's own configuration (block
        # min(256, soi_block) = 256: the kernels' large route), 200 steps,
        # a device loss at 100
        k100 = TOOLING["k100"]
        cfg = train_kfac_100m.config_100m()
        kcfg = train_kfac_100m.kfac_config(cfg, k100["batch"], k100["seq"])
        check(kcfg.block_size == 256,
              "tooling: train_kfac_100m's own block is 256")
        prog = train_mod.KFACProgram(cfg, kcfg, device=dev)
        like = prog.init_state()
        state_bytes = tensor_bytes(like)
        ck_dir = os.path.join(tmp, "ck100m")
        free_disk = shutil.disk_usage(tmp).free
        check(free_disk > (k100["keep"] + 0.5) * state_bytes,
              f"free disk for {k100['keep']} checkpoints of "
              f"{state_bytes} bytes")
        torch.cuda.reset_peak_memory_stats(dev)
        s = counted("train_kfac_100m", lambda: train_kfac_100m.train(
            cfg, kcfg, steps=k100["steps"], batch=k100["batch"],
            seq=k100["seq"], ckpt_dir=ck_dir, inject_at=k100["inject_at"],
            device=dev))
        hist = s["history"]
        losses = [h["loss"] for h in hist]
        executed = [h["step"] for h in hist]
        replayed = len(executed) - k100["steps"]
        l100 = launches["train_kfac_100m"]
        check(all(math.isfinite(x) for x in losses),
              "tooling: train_kfac_100m finite losses")
        check(losses[-1] < losses[0],
              "tooling: train_kfac_100m's last loss below its first")
        check(s["recoveries"] == 1 and s["steps"] == k100["steps"],
              "tooling: train_kfac_100m one recovery, every step")
        check(l100["neumann_inv"] > 0 and l100["fused_precond"] > 0,
              "tooling: train_kfac_100m launches both kernels")
        keys100 = ops.launch_keys()
        check(set(keys100["neumann_inv"]) == {"n256"}
              and all("256" in k and "128" not in k
                      for k in keys100["fused_precond"]),
              "tooling: train_kfac_100m's launches all at block 256")
        by_step = {}
        for h in hist:
            by_step.setdefault(h["step"], []).append(h["loss"])
        step_s = [h["phase_s"]["train"] for h in hist
                  if set(h["phase_s"]) == {"train", "wu"}]
        # what the recovery paid beside its lost steps: one restore of a
        # checkpoint of this state
        from repro_torch.checkpoint import restore

        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        restored, _ = restore(ck_dir, like)
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        del restored, like, prog
        out["examples"]["train_kfac_100m"] = dict(
            block_size=kcfg.block_size, launch_keys=keys100,
            params=cfg.param_count(), state_bytes=state_bytes,
            smoke=smoke_runs, steps=k100["steps"], batch=k100["batch"],
            seq=k100["seq"], executed_steps=len(executed),
            replayed_steps=replayed, recoveries=s["recoveries"],
            loss_first=losses[0], loss_last=losses[-1],
            losses_every_25=[by_step[i][-1] for i in range(0, k100["steps"],
                                                           25)],
            replay_bitwise=all(len(set(v)) == 1 for v in by_step.values()),
            train_s_median=statistics.median(step_s),
            refresh_step_s_median=statistics.median(
                sum(v for k, v in h["phase_s"].items() if k != "wu")
                for h in hist if "inv" in h["phase_s"]),
            restore_s=restore_s,
            loop_wall_s=s["wall_s"], ckpt_write_s=s.get("ckpt_write_s"),
            peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    finally:
        shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    out.update(launches=launches, seconds=secs,
               phase_seconds=time.perf_counter() - t_phase)
    return out


def bits(x, ref64) -> float:
    """Achieved bits of ``x`` against the float64 ``ref64``: -log2 of the
    largest error over ``ref64``'s largest entry (64 where exact)."""
    e = float((x.double() - ref64).abs().max())
    return 64.0 if e == 0 else -math.log2(e / float(ref64.abs().max()))


def woodbury64(inv, v, *, decay, cscale):
    """The Woodbury update of ``smw_update`` in float64, and its
    capacitance S: the yardstick of the kernel's rounding."""
    import torch

    inv, v = inv.double(), v.double()
    m = (inv + inv.transpose(-1, -2)) * (0.5 / decay)
    y = v @ m
    s = y @ v.transpose(-1, -2) + torch.eye(
        v.shape[-2], device=v.device, dtype=torch.float64) / cscale
    return m - y.transpose(-1, -2) @ torch.linalg.solve(s, y), s


def smw_stage_bits(torch, inv, v, *, decay, cscale) -> dict:
    """Where the large route's rounding goes, stage by stage: Y, S
    (before 1/c), Z and out of the route (``smw_update.route_stages``, one
    chunk) and of the plain version, each in bits (:func:`bits`) against
    its float64 Woodbury stage; the solve alone: the route's blocked LU
    and the plain version's ``solve_ex`` on the same fp32 S and Y (the
    plain version's), against float64's solve of those, which tells a
    solve's own rounding from its inputs'; and out with one stage
    swapped (the plain version's S and Y through the LU, the route's
    through ``solve_ex``), which tells which stage loses the bits."""
    from repro_torch.core.quantize import hilo_matmul
    from repro_torch.kernels import ref
    from repro_torch.kernels import smw_update as ks

    inv_decay, inv_c = ref.smw_scalars(decay, cscale)
    k = v.shape[-2]
    eye = torch.eye(k, device=v.device)
    route = ks.route_stages(inv, v, decay=decay, cscale=cscale)
    m = (inv + inv.transpose(-1, -2)) * inv_decay
    plain = dict(y=hilo_matmul(v, m))
    plain["s"] = hilo_matmul(plain["y"], v.transpose(-1, -2))
    sc = plain["s"] + eye * inv_c
    plain["z"] = torch.linalg.solve_ex(sc, plain["y"])[0]
    plain["out"] = m - hilo_matmul(plain["y"].transpose(-1, -2),
                                   plain["z"])
    m64 = (inv.double() + inv.double().transpose(-1, -2)) * (0.5 / decay)
    ex = dict(y=v.double() @ m64)
    ex["s"] = ex["y"] @ v.double().transpose(-1, -2)
    ex["z"] = torch.linalg.solve(ex["s"] + eye.double() / cscale, ex["y"])
    ex["out"] = m64 - ex["y"].transpose(-1, -2) @ ex["z"]
    row = {f"bits_{name}_{who}": bits(got[name], ex[name])
           for name in ("y", "s", "z", "out")
           for who, got in (("route", route), ("plain", plain))}
    z64 = torch.linalg.solve(sc.double(), plain["y"].double())
    z_lu = ks.solve(plain["s"], plain["y"], inv_c)
    row["bits_solve_lu"] = bits(z_lu, z64)
    row["bits_solve_lapack"] = bits(plain["z"], z64)
    # out with one stage swapped: the plain version's products and the
    # LU; the route's Y and S and solve_ex (the last product plain's)
    row["bits_out_plain_lu"] = bits(
        m - hilo_matmul(plain["y"].transpose(-1, -2), z_lu), ex["out"])
    z_rs = torch.linalg.solve_ex(route["s"] + eye * inv_c, route["y"])[0]
    row["bits_out_route_lapack"] = bits(
        m - hilo_matmul(route["y"].transpose(-1, -2), z_rs), ex["out"])
    return row


def smw_keeper(kept: dict):
    """``on_step`` of an SMW run that fills ``kept``, on the host (so that
    the path's peak memory is its own): the params and inverses entering
    the first step without a fallback, and that step's factors and
    inverses."""
    def to_host(tree):
        return {n: {k: t.cpu() for k, t in d.items()}
                for n, d in tree.items()}

    def keep(st, rec):
        if "factors" in kept:
            return
        if rec["smw_fallback"] == 0.0:
            kept.update(step=rec["step"], factors=to_host(st.kfac.factors),
                        inverses=to_host(st.kfac.inverses))
        else:
            kept.update(params={k: p.cpu() for k, p in st.params.items()},
                        inverses0=to_host(st.kfac.inverses))

    return keep


def smw_step_again(torch, dev, check, cfg, kcfg, ds, rank, kept,
                   label="") -> list:
    """The update of the SMW step that :func:`smw_keeper` kept, done again
    from the inverses it started from and its own batch's columns: the
    kernel, its plain version, the fp32 route and float64 Woodbury, each
    against float64 ``torch.linalg.inv`` of the step's damped factors
    (the last tells the algorithm's error from the rounding's), beside a
    full re-inversion of those factors. One row a factor leaf, with the
    kernel's time on it (CUDA events, warm, median of 5), that of its
    library call (``ref.exact_smw_update``: fp32 matmuls and
    ``torch.linalg.solve``) and the bytes and operations its bound
    counts; the kernel held to the plain
    version within :data:`REL_TOL_RUN` and within a bit of its
    accuracy."""
    from repro_torch.core import kfac, soi
    from repro_torch.data.pipeline import DataCursor
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.solve import smw as smw_mod

    if "factors" not in kept:
        return []
    bs, decay = kcfg.block_size, kcfg.ema_decay
    specs = lm.kfac_specs(cfg)
    rows = []
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
            n = f.shape[-1]
            flat = f.reshape(-1, n, n)
            lam = soi.tikhonov_damping(flat, kcfg.damping)
            exact = torch.linalg.inv(
                flat.double() + lam.double()[:, None, None]
                * torch.eye(n, device=dev, dtype=torch.float64))
            inv0 = kept["inverses0"][name][side + "_inv"].to(dev) \
                .reshape(-1, n, n).contiguous()
            w = 1.0 / v.shape[-2] if side == "A" else 1.0
            v = smw_mod._subsample_cols(v, rank)
            v = v.reshape(-1, *v.shape[-2:]).contiguous()
            args = dict(decay=decay, cscale=(1.0 - decay) * w)
            mine = ops.smw_update(inv0, v, **args)
            plain = ref.smw_update_ref(inv0, v, **args)
            nb, k = v.shape[0], v.shape[-2]
            run_inv = kept["inverses"][name][side + "_inv"].to(dev) \
                .reshape(-1, n, n)
            full = ops.neumann_inv(flat.contiguous(), lam, **KFAC_COUNTS)
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
                bits_full_reinversion=bits(full, exact),
                side=n, k=k, blocks=nb,
                ms=time_ms(torch, lambda: ops.smw_update(inv0, v, **args)),
                library_ms=time_ms(torch, lambda: ref.exact_smw_update(
                    inv0, v, **args)),
                # what the update must move and compute (phase 3's count)
                bytes=4.0 * nb * (2 * n * n + k * n),
                flops=2.0 * 3 * nb * (k * n * n + k * k * n + n * n * k),
                fp32_flops=nb * (2.0 / 3.0 * k ** 3 + 2.0 * k * k * n))
            rows.append(row)
            check(err <= REL_TOL_RUN * scale,
                  f"{label}{row['leaf']} smw_update kernel vs plain (run)")
            check(row["bits_kernel"] >= row["bits_plain"] - 1.0,
                  f"{label}{row['leaf']} smw_update as accurate as plain")
            del exact, mine, plain, full
    return rows


def first_batch_acts(torch, dev, cfg, kcfg, ds) -> dict:
    """The activations of the main path's first batch at the seed's
    weights, through ``soi.blocked_tokens`` at ``kcfg``'s block size, for
    every A leaf: ``{"name/A": (T, nb, n)}``."""
    from repro_torch.core import kfac
    from repro_torch.data.pipeline import DataCursor
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm

    bs = kcfg.block_size
    specs = lm.kfac_specs(cfg)
    params0 = train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                    device=dev).init_state().params
    batch0 = ds.batch(DataCursor(0), device=dev)
    n_tok = batch0["tokens"].numel()
    _, _, cols0, _ = kfac.stats_rank_k(
        lambda p, tp, bt: lm.loss_fn(cfg, p, bt, taps=tp, collect="cols",
                                     soi_block=bs),
        params0, lm.build_taps(cfg, specs, n_tok, device=dev), batch0,
        specs, bs)
    acts = {f"{name}/A": c["A"].movedim(-2, 0).reshape(
        n_tok, -1, c["A"].shape[-1]).contiguous()
        for name, c in cols0.items() if "A" in c}
    del params0, cols0
    torch.cuda.empty_cache()
    return acts


def hold_fused_gram(torch, dev, check, acts, fused, fg_kw, damping,
                    label="") -> list:
    """``fused`` (``ops.fused_gram_inv`` of each leaf of ``acts``) against
    its plain version and against the two-step route (gram_from_tokens,
    the K-FAC path's damping, neumann_inv), and each against float64
    torch.linalg.inv. The two-step tolerance is the reference's
    cross-route one, atol 5e-3 on inverses with entries of order 1
    (tests/test_kernels.py::test_fused_matches_composed_inverse_path),
    held relative to the largest entry where entries exceed 1. Both
    tolerances presume an iteration that has converged, which 20
    Newton-Schulz steps are not on ill-conditioned blocks: there the
    inverse moves with the rounding of its Gram. So each leaf also
    measures that: the plain route on the float64 Gram rounded to fp32,
    another equally valid rounding of the same Gram. A route may differ
    from the plain version by twice what that rounding alone moves it.
    One row a leaf, with the kernel's and the library call's times
    (``ref.exact_gram_inv``) and the bound."""
    from repro_torch.core import soi
    from repro_torch.kernels import ops, ref

    prods = (5 * fg_kw["ns_iters"] + 5 * (fg_kw["taylor_terms"] - 1)
             + 6 * fg_kw["refine_steps"])
    report = []
    for leaf, x in acts.items():
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
        # the bound as phase 3 counts it: the activations read once, the
        # inverses written once; the Gram's partials and the inverse's
        t, nb, n = x.shape
        b_ms, b_by = bound(
            x.element_size() * t * nb * n + 4.0 * nb * n * n,
            2.0 * nb * ((3 if x.dtype == torch.float32 else 1) * t * n * n
                        + prods * n ** 3))
        row.update(
            ms=time_ms(torch, lambda: ops.fused_gram_inv(x, **fg_kw)),
            library_ms=time_ms(torch, lambda: ref.exact_gram_inv(x,
                                                                 damping)),
            bound_ms=b_ms, bound_by=b_by)
        report.append(row)
        check(err <= max(REL_TOL_RUN * scale, 2.0 * sens),
              f"{label}{leaf} fused_gram_inv kernel vs plain (run)")
        check(row["bits_fused"] >= row["bits_plain"] - 1.0,
              f"{label}{leaf} fused_gram_inv as accurate as plain")
        check(gap <= max(5e-3 * max(1.0, two_scale), 2.0 * sens),
              f"{label}{leaf} fused_gram_inv vs the two-step route")
        del plain, gram, two_step, gram64, exact, g_alt, alt
    return report


def large_solve_kernels(torch, dev, check, gen):
    """Phase ``large_blocks`` (d): ``smw_update`` at :data:`LARGE`'s
    (blocks, k, bs), at unit scale (c as on the A side at 2048 tokens)
    and at the G side's (columns at 3e-4, inverse entries ~1e7, c =
    0.05), and one case of indefinite inverses (S not SPD, its
    conditioning decides how far any fp32 solve lands from float64: held
    to float64 Woodbury within a bit of the plain version instead);
    ``fused_gram_inv`` at its (T, nb, n) in fp32 and bf16. Each held to
    its plain version within :data:`REL_TOL`, to its own repeat
    (bitwise) and to the launches of its plans, its achieved bits
    against float64 reported beside the plain version's (as (a) reports
    them), and timed (CUDA events, warm, median of 5; the smw cases
    on the G side) beside its plain version, its library call
    (``ref.exact_smw_update``: fp32 matmuls and ``torch.linalg.solve``;
    ``ref.exact_gram_inv``: an fp32 einsum and ``torch.linalg.inv``) and
    its bound, ``smw_update``'s solve also alone on the route's S and Y
    (``solve_ms``, ``solve_share``); at :data:`LARGE`'s ``smw_stages``,
    unit scale, the route's stages against the plain version's and
    float64 (:func:`smw_stage_bits`); ``fused_gram_inv`` also against the
    two-step route (the fp32 Gram, then ``neumann_inv``) within the
    reference's cross-route atol 5e-3. Returns ``(smw rows, gram
    rows)``."""
    from repro_torch.core import kfac, soi
    from repro_torch.kernels import fused_gram_solve as kg
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import smw_update as ks

    decay = kfac.KFACConfig().ema_decay
    damping = kfac.KFACConfig().damping
    prods = (5 * KFAC_COUNTS["ns_iters"]
             + 5 * (KFAC_COUNTS["taylor_terms"] - 1)
             + 6 * KFAC_COUNTS["refine_steps"])

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def smw_case(nb, k, bs, scale):
        v0 = torch.randn(nb, 2 * bs, bs, device=dev, generator=gen,
                         dtype=torch.float64) * scale
        f = v0.transpose(-1, -2) @ v0 / (2 * bs)
        lam = soi.tikhonov_damping(f, 0.03)
        inv64 = torch.linalg.inv(f + lam[:, None, None] * torch.eye(
            bs, device=dev, dtype=torch.float64))
        v = torch.randn(nb, k, bs, device=dev, generator=gen) * scale
        return inv64.float().contiguous(), v

    def indefinite(nb, k, bs):
        q = torch.linalg.qr(torch.randn(nb, bs, bs, device=dev,
                                        generator=gen,
                                        dtype=torch.float64))[0]
        ev = torch.rand(nb, bs, device=dev, generator=gen,
                        dtype=torch.float64) * 1.5 + 0.5
        ev = ev * torch.where(torch.arange(bs, device=dev) % 3 == 0, -1.0,
                              1.0)
        inv = (q * ev[:, None, :]) @ q.transpose(-1, -2)
        return inv.float().contiguous(), torch.randn(
            nb, k, bs, device=dev, generator=gen)

    smw_rows = []
    cases = [(c, scale, cs) for c in LARGE["smw"] for scale, cs in (
        (1.0, (1 - decay) / (MAIN["batch"] * MAIN["seq"])),
        (3e-4, 1 - decay))] + [(LARGE["smw_indefinite"], None, 0.05)]
    for (nb, k, bs), scale, c in cases:
        if scale is None:
            inv, v = indefinite(nb, k, bs)
        else:
            inv, v = smw_case(nb, k, bs, scale)
        args = dict(decay=decay, cscale=c)
        ops.reset_launch_counts()
        got = ops.smw_update(inv, v, **args)
        torch.cuda.synchronize(dev)
        launches = ops.launch_counts()["smw_update"]
        want = ref.smw_update_ref(inv, v, **args)
        w64 = woodbury64(inv, v, **args)[0]
        row = dict(blocks=nb, k=k, bs=bs,
                   scale="indefinite" if scale is None else scale,
                   cscale=c, rel_err=rel(got, want),
                   max_abs_err=float((got - want).abs().max()),
                   bits_kernel=bits(got, w64), bits_plain=bits(want, w64),
                   launches=launches,
                   repeat_bitwise=torch.equal(got, ops.smw_update(
                       inv, v, **args)))
        what = f"large_blocks: smw_update ({nb}, {k}, {bs}) {row['scale']}"
        if scale is None:
            check(bool(torch.isfinite(got).all()), f"{what} finite")
            check(row["bits_kernel"] >= row["bits_plain"] - 1.0,
                  f"{what} as accurate as plain")
        else:
            check(row["rel_err"] <= REL_TOL, f"{what} vs plain")
        check(row["repeat_bitwise"], f"{what} bitwise its repeat")
        check(launches == ks.expected_launches(bs, k, nb),
              f"{what} launches")
        if (nb, k, bs) == LARGE["smw_stages"] and scale == 1.0:
            row["stages"] = smw_stage_bits(torch, inv, v, **args)
        if scale == 3e-4:
            # the solve alone, on the route's own S and Y (its share of
            # the update; ks.solve copies S and Y first)
            st = ks.route_stages(inv, v, **args)
            kind = "slab" if k <= ks.ONE_CTA_N else "lu"
            inv_c = ref.smw_scalars(decay, c)[1]
            row["solve_ms"] = time_ms(torch, lambda: ks.solve(
                st["s"], st["y"], inv_c, kind))
            del st
            # bytes: inv and v read, out written; operations: 3 partials
            # of V M, Y V^T and Y^T Z, and the fp32 solve (LU of k x k,
            # two triangular solves on bs columns)
            b_ms, b_by = bound(
                4.0 * nb * (2 * bs * bs + k * bs),
                2.0 * 3 * nb * (k * bs * bs + k * k * bs + bs * bs * k),
                nb * (2.0 / 3.0 * k ** 3 + 2.0 * k * k * bs))
            row.update(
                ms=time_ms(torch, lambda: ops.smw_update(inv, v, **args)),
                plain_ms=time_ms(torch, lambda: ref.smw_update_ref(
                    inv, v, **args)),
                library_ms=time_ms(torch, lambda: ref.exact_smw_update(
                    inv, v, **args)),
                bound_ms=b_ms, bound_by=b_by)
            row["solve_share"] = row["solve_ms"] / row["ms"]
        smw_rows.append(row)
        del inv, v, got, want, w64

    gram_rows = []
    fg_kw = dict(rel_damp=damping, **KFAC_COUNTS)
    for t, nb, n in LARGE["gram"]:
        acts32 = torch.randn(t, nb, n, device=dev, generator=gen)
        for dtype, tag in ((torch.float32, "fp32"),
                           (torch.bfloat16, "bf16")):
            x = acts32.to(dtype)
            ops.reset_launch_counts()
            got = ops.fused_gram_inv(x, **fg_kw)
            torch.cuda.synchronize(dev)
            counts = ops.launch_counts()
            launches = {lib: counts[lib] for lib in ("fused_gram_inv",
                                                     "neumann_inv")}
            want = ref.fused_gram_inv_ref(x, **fg_kw)
            gram = soi.gram_from_tokens(x.float())
            two = ops.neumann_inv(gram.contiguous(),
                                  soi.tikhonov_damping(gram, damping),
                                  **KFAC_COUNTS)
            gram64 = soi.gram_from_tokens(x.double())
            exact = torch.linalg.inv(
                gram64 + soi.tikhonov_damping(gram64, damping)[:, None, None]
                * torch.eye(n, device=dev, dtype=torch.float64))
            gap = float((got - two).abs().max())
            partials = 3 if dtype == torch.float32 else 1
            b_ms, b_by = bound(
                x.element_size() * t * nb * n + 4.0 * nb * n * n,
                2.0 * nb * (partials * t * n * n + prods * n ** 3))
            row = dict(
                shape=[t, nb, n], dtype=tag, rel_err=rel(got, want),
                max_abs_err=float((got - want).abs().max()),
                max_abs_gap_two_step=gap,
                rel_gap_two_step=gap / float(two.abs().max()),
                bits_kernel=bits(got, exact), bits_plain=bits(want, exact),
                bits_two_step=bits(two, exact), launches=launches,
                repeat_bitwise=torch.equal(got, ops.fused_gram_inv(
                    x, **fg_kw)),
                ms=time_ms(torch, lambda: ops.fused_gram_inv(x, **fg_kw)),
                plain_ms=time_ms(torch, lambda: ref.fused_gram_inv_ref(
                    x, **fg_kw)),
                library_ms=time_ms(torch, lambda: ref.exact_gram_inv(
                    x, damping)),
                bound_ms=b_ms, bound_by=b_by)
            gram_rows.append(row)
            what = f"large_blocks: fused_gram_inv ({t}, {nb}, {n}) {tag}"
            check(row["rel_err"] <= REL_TOL, f"{what} vs plain")
            check(gap <= 5e-3 * max(1.0, float(two.abs().max())),
                  f"{what} vs the two-step route")
            check(row["bits_kernel"] >= row["bits_plain"] - 1.0,
                  f"{what} as accurate as plain")
            check(row["repeat_bitwise"], f"{what} bitwise its repeat")
            check(launches == kg.expected_launches(x.shape, dtype,
                                                   **KFAC_COUNTS),
                  f"{what} launches")
            del x, got, want, gram, two, gram64, exact
        del acts32
    return smw_rows, gram_rows


def dist_rank(rank, world):
    """One rank of phase ``dist`` (run by ``dist.spawn.run_ranks``; see
    :func:`dist_phase`): every check's inputs and this rank's timings,
    launches and peak memory."""
    import hashlib

    import torch
    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.core import kfac
    from repro_torch.data.pipeline import (DataCursor, SyntheticTokens,
                                           make_global_batch)
    from repro_torch.dist import compression
    from repro_torch.dist.api import all_gather_rows, all_reduce, \
        mesh_position
    from repro_torch.kernels import fused_precond as fp_mod
    from repro_torch.kernels import neumann_inv as nv_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.solve import (invert_factor_tree, make_plan,
                                   make_wu_plan, refresh_and_precondition)
    from repro_torch.solve.block_solver import invert_pools

    dev = torch.device("cuda", torch.cuda.current_device())
    train_mod.fp32_matmuls()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_dev_mesh()
    pos = mesh_position(mesh)
    cfg = get_config(MAIN["arch"])
    bs = min(MAIN["block_size"], cfg.soi_block)
    kcfg = kfac.KFACConfig(
        stats_every=MAIN["stats_every"], inv_every=MAIN["inv_every"],
        block_size=bs, stats_batch=MAIN["batch"], stats_seq=MAIN["seq"])
    specs = steps_mod.kfac_specs(cfg)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=MAIN["seq"],
                         global_batch=MAIN["batch"], seed=MAIN["seed"])
    batch = make_global_batch(ds, DataCursor(0), mesh, device=dev)
    program = train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                    device=dev, mesh=mesh, dist_inv=True)
    params = program.init_state().params
    out = {"rank": rank, "position": pos, "device": str(dev),
           "rows": list(batch["tokens"].shape)}

    def synced(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, (time.perf_counter() - t0) * 1e3

    def event_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    def refresh_case(block):
        """(a)/(b): one data-parallel stats step's factors at ``block``,
        through a plan of ``world`` devices: this rank's launches and
        blocks, its kernel and gather ms, bitwise the one-rank refresh."""
        kc = dataclasses.replace(kcfg, block_size=block)
        state = steps_mod.TrainState(params, kfac.init(params, specs, kc))
        state, _ = steps_mod.make_stats_step(cfg, kc, data_mesh=mesh)(
            state, batch)
        factors = state.kfac.factors
        del state
        plan = make_plan(factors, world, kc)
        counts = dict(ns_iters=kc.ns_iters, taylor_terms=kc.taylor_terms,
                      refine_steps=kc.refine_steps)
        invert_pools(factors, kc, plan, mesh)          # warm
        ops.reset_launch_counts()
        shards, kernel_ms = event_ms(
            lambda: invert_pools(factors, kc, plan, mesh))
        launches = ops.launch_counts()["neumann_inv"]
        keys = ops.launch_keys()["neumann_inv"]
        _, gather_ms = synced(lambda: [all_gather_rows(x, mesh)
                                       for x in shards])
        del shards
        got, call_ms = synced(lambda: invert_factor_tree(
            factors, kc, mesh=mesh, plan=plan))
        one = invert_factor_tree(factors, kc)
        bitwise = all(torch.equal(got[n][k], one[n][k])
                      for n in one for k in one[n])
        fsum = float(sum(f.double().sum() for d in factors.values()
                         for f in d.values()))
        del got, one
        want = nv_mod.expected_launches(
            {g.bs: [g.per_device] for g in plan.groups}, **counts)
        s = plan.summary()
        return factors, plan, {
            "block": block, "plan": s, "launches": launches,
            "launch_keys": keys, "expected_launches": want,
            "blocks": s["device_blocks"][pos],
            "real_blocks": sum(int((g.slots[pos] >= 0).sum())
                               for g in plan.groups),
            "block_bound": sum(-(-g.n_blocks // world) for g in plan.groups),
            "inverted": sum(g.per_device for g in plan.groups),
            "kernel_ms": kernel_ms, "gather_ms": gather_ms,
            "call_ms": call_ms, "bitwise_one_rank": bitwise,
            "factor_sum": fsum}

    # (a), then (b) at block 256 (the large route, chunked per rank)
    factors, plan, out["a"] = refresh_case(bs)
    _, _, out["b"] = refresh_case(DIST["block_256"])
    torch.cuda.empty_cache()

    # (c) the fused INV->VMM program, both modes, on the main path's WU
    # tiles, against the one-rank call
    gen = torch.Generator(device=dev).manual_seed(DIST["grad_seed"])
    grads = {n: torch.randn(s.stack + (s.d_in, s.d_out), device=dev,
                            generator=gen) for n, s in sorted(specs.items())}
    wu = make_wu_plan(specs, factors, kcfg, ndev=world)
    inv1, pre1 = refresh_and_precondition(
        factors, grads, kcfg, make_wu_plan(specs, factors, kcfg))
    out["c"] = {"tiles": wu.total_tiles}
    for mode in ("owner", "gather"):
        refresh_and_precondition(factors, grads, kcfg, wu, mesh=mesh,
                                 mode=mode)                  # warm
        (inv, pre), ms = synced(lambda: refresh_and_precondition(
            factors, grads, kcfg, wu, mesh=mesh, mode=mode))
        err = max(float((pre[n] - pre1[n]).abs().max()
                        / pre1[n].abs().max()) for n in pre1)
        out["c"][mode] = {
            "ms": ms, "inverses_bitwise": all(
                torch.equal(inv[n][k], inv1[n][k])
                for n in inv1 for k in inv1[n]),
            "pre_bitwise": all(torch.equal(pre[n], pre1[n]) for n in pre1),
            "pre_max_rel_err": err}
        del inv, pre
    _, out["c"]["one_rank_ms"] = synced(lambda: refresh_and_precondition(
        factors, grads, kcfg, make_wu_plan(specs, factors, kcfg)))
    # (d)'s schedule: the trainer's WU runs on every rank on the one-rank
    # WU plan (the gathered inverses); its refresh on (a)'s plan
    out["fused_precond_per_step"] = sum(
        fp_mod.expected_launches(g.n_tiles, g.bi, g.bo, shared=g.bi == g.bo)
        for g in make_wu_plan(specs, factors, kcfg).groups)
    del inv1, pre1, grads, factors, plan, wu, params
    torch.cuda.empty_cache()

    # (d) 4 data-parallel --dist-inv steps of the main path
    ops.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, hist = train_mod.run(program, ds, MAIN["steps"])
    torch.cuda.synchronize(dev)
    h = hashlib.sha256()
    for k in kfac.tree_order(state.params):
        h.update(state.params[k].contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    out["d"] = {"losses": [r["loss"] for r in hist],
                "grad_norms": [r["grad_norm"] for r in hist],
                "phase_s": [r["phase_s"] for r in hist],
                "wall_s": time.perf_counter() - t0,
                "launches": ops.launch_counts(),
                "launch_keys": ops.launch_keys(),
                "blocks_inverted": ops.launch_items()["neumann_inv"],
                "params_digest": h.hexdigest()[:16]}

    # (e) the compressed all-reduce of this rank's own gradient of (d)'s
    # last batch, against the exact mean, and error feedback
    _, g = steps_mod._grads(cfg, state.params, make_global_batch(
        ds, DataCursor(MAIN["steps"] - 1), mesh, device=dev))
    del state
    g = {k: g[k] for k in kfac.tree_order(g)}
    exact = {k: all_reduce(v.clone(), mesh) / world for k, v in g.items()}
    errs = compression.init_error_buffers(g)
    (means, errs), ms = synced(lambda: compression.compressed_allreduce_tree(
        g, errs, mesh, ("pod", "data")))
    worst, acc = 0.0, {k: m.clone() for k, m in means.items()}
    for k, v in g.items():
        s_k = all_reduce(v.abs().max().reshape(1), mesh, "max")[0]
        worst = max(worst, float((means[k] - exact[k]).abs().max()
                                 / (s_k / 127)))
    del means
    for _ in range(DIST["ef_steps"] - 1):
        m, errs = compression.compressed_allreduce_tree(
            g, errs, mesh, ("pod", "data"))
        acc = {k: acc[k] + m[k] for k in acc}
        del m
    ef = 0.0
    for k, v in g.items():
        step = all_reduce((v.abs() + errs[k].abs()).max().reshape(1), mesh,
                          "max")[0] / 127
        ef = max(ef, float((acc[k] - DIST["ef_steps"] * exact[k]).abs()
                           .max() / step))
    n = sum(v.numel() for v in g.values())
    out["e"] = {"elements": n, "leaves": len(g), "compressed_ms": ms,
                "max_err_over_s127": worst, "ef_sum_err_over_step": ef,
                "fp32_bytes": 4 * n, "int8_bytes": n + 4 * len(g)}
    del g, errs, acc, exact
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.empty_cache()

    # (d) at fp32 compute: the same 4 steps, where no bf16 rounding of a
    # rank's gradient stands between data parallelism and one rank
    torch.cuda.reset_peak_memory_stats(dev)
    _, hist = train_mod.run(train_mod.KFACProgram(
        dataclasses.replace(cfg, dtype="float32"), kcfg, seed=MAIN["seed"],
        device=dev, mesh=mesh, dist_inv=True), ds, MAIN["steps"])
    out["d_fp32"] = {"losses": [r["loss"] for r in hist],
                     "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                     / 1e9}
    out["backend"] = tdist.get_backend()
    return out


def dist_phase(torch, dev, check, main_losses):
    """Phase ``dist``: the main path over several ranks. With one card two
    ranks share ``cuda:0`` over gloo (NCCL refuses two ranks on one
    device; gloo moves the CUDA tensors through the host, and every
    kernel still runs on the card), else one rank a card over NCCL;
    :func:`dist_rank` on each. Checks: (a) and (b) each rank's
    ``neumann_inv`` launches as its plan rows' schedule gives
    (``plan.summary()``), the refresh bitwise the one-rank grouped
    refresh; (c) the inverses of both modes bitwise the one-rank call's,
    the tiles within ``pre_tol`` of its largest entry (the fp32 batched
    product may take another cuBLAS kernel for another batch count, so
    not held bitwise); (d) params bitwise equal across ranks, losses
    within ``loss_tol`` of the same 4 steps on one rank with the
    gradient accumulated over the ranks' row split (the bf16 rounding of
    each part's weight gradient is the arithmetic of data parallelism;
    the gap to the main path's losses is reported) and the first step's
    gradient norm within 1e-6 of that run's, the same 4 steps at fp32
    compute within ``loss_tol`` of the plain one-rank run at fp32, and
    on every rank ``neumann_inv`` launched as (a)'s plan gives a refresh
    on the rank's pool rows alone (the blocks each launch covered are
    counted) and ``fused_precond`` once a WU group a step; (e) every
    element within
    s / 127 of the exact mean, the error-feedback sum within one step.
    A failed rank fails the phase."""
    from repro_torch.configs import get_config
    from repro_torch.core import kfac
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.dist.spawn import backend_for, run_ranks
    from repro_torch.launch import train as train_mod

    n_cards = torch.cuda.device_count()
    world = 2 if n_cards == 1 else n_cards
    backend = backend_for("cuda", world)
    emit({"phase": "dist_setup", "ranks": world, "cards": n_cards,
          "backend": backend,
          "placement": ("two ranks share cuda:0 over gloo" if n_cards == 1
                        else "one rank a card over NCCL")})
    # (d)'s yardstick: the same 4 steps on this one rank with each step's
    # gradient accumulated over the ranks' row split (train_accum = the
    # rank count): data parallelism's arithmetic on one rank. The model
    # computes in bf16, and each weight gradient is rounded to bf16 per
    # microbatch (per rank), which moves the main path's chaotic step 3
    # by ~2% (train_accum 2 against 1) on one rank too
    cfg = get_config(MAIN["arch"])
    kcfg = kfac.KFACConfig(
        stats_every=MAIN["stats_every"], inv_every=MAIN["inv_every"],
        block_size=min(MAIN["block_size"], cfg.soi_block),
        stats_batch=MAIN["batch"], stats_seq=MAIN["seq"])
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=MAIN["seq"],
                         global_batch=MAIN["batch"], seed=MAIN["seed"])
    _, acc_hist = train_mod.run(train_mod.KFACProgram(
        dataclasses.replace(cfg, train_accum=world), kcfg,
        seed=MAIN["seed"], device="cuda"), ds, MAIN["steps"])
    accum_losses = [h["loss"] for h in acc_hist]
    torch.cuda.empty_cache()
    # and the plain one-rank run at fp32 compute, (d)'s fp32 yardstick
    _, hist32 = train_mod.run(train_mod.KFACProgram(
        dataclasses.replace(cfg, dtype="float32"), kcfg, seed=MAIN["seed"],
        device="cuda"), ds, MAIN["steps"])
    fp32_losses = [h["loss"] for h in hist32]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(dist_rank, world, device="cuda", timeout=900)
    seconds = time.perf_counter() - t0
    for r in ranks:
        tag = f"dist rank {r['rank']}"
        for case in ("a", "b"):
            c = r[case]
            check(c["bitwise_one_rank"],
                  f"{tag} ({case}): refresh bitwise the one-rank refresh")
            check(c["launches"] == c["expected_launches"] > 0,
                  f"{tag} ({case}): neumann_inv launches as planned")
            check(c["real_blocks"] == c["blocks"] <= c["block_bound"],
                  f"{tag} ({case}): the rank's pool rows hold its "
                  f"plan.summary() blocks, within the plan's bound")
            check(c["factor_sum"] == ranks[0][case]["factor_sum"],
                  f"{tag} ({case}): the same reduced factors on every rank")
        for mode in ("owner", "gather"):
            c = r["c"][mode]
            check(c["inverses_bitwise"],
                  f"{tag} (c) {mode}: inverses bitwise the one-rank call")
            check(c["pre_max_rel_err"] <= DIST["pre_tol"],
                  f"{tag} (c) {mode}: tiles within the tolerance")
        d = r["d"]
        check(d["params_digest"] == ranks[0]["d"]["params_digest"],
              f"{tag} (d): params bitwise equal across ranks")
        check(d["losses"] == ranks[0]["d"]["losses"],
              f"{tag} (d): the same losses on every rank")
        check(all(abs(x - y) <= DIST["loss_tol"] * abs(y)
                  for x, y in zip(d["losses"], accum_losses))
              and len(d["losses"]) == len(accum_losses),
              f"{tag} (d): losses within {DIST['loss_tol']} of the one-rank "
              f"run accumulated over the same row split")
        check(abs(d["grad_norms"][0] - acc_hist[0]["grad_norm"])
              <= 1e-6 * acc_hist[0]["grad_norm"],
              f"{tag} (d): the first step's reduced gradient norm that of "
              f"the one-rank run accumulated over the same row split")
        d32 = r["d_fp32"]["losses"]
        check(len(d32) == len(fp32_losses) and all(
            abs(x - y) <= DIST["loss_tol"] * abs(y)
            for x, y in zip(d32, fp32_losses)),
              f"{tag} (d) fp32: losses within {DIST['loss_tol']} of the "
              f"plain one-rank run")
        check(d32 == ranks[0]["d_fp32"]["losses"],
              f"{tag} (d) fp32: the same losses on every rank")
        # the trainer's refresh splits the blocks as (a)'s plan does: each
        # refresh inverts this rank's pool rows alone, one launch a side
        refreshes = sum("inv" in p for p in d["phase_s"])
        check(refreshes > 0 and d["launches"]["neumann_inv"]
              == refreshes * r["a"]["expected_launches"],
              f"{tag} (d): neumann_inv launches as planned")
        check(d["blocks_inverted"] == {
            f"n{g['bs']}": refreshes * g["per_device"]
            for g in r["a"]["plan"]["groups"]}
              and r["a"]["inverted"] < r["a"]["plan"]["total_blocks"],
              f"{tag} (d): each refresh inverted the rank's pool rows, "
              f"not every block")
        check(d["launches"]["fused_precond"]
              == len(d["losses"]) * r["fused_precond_per_step"] > 0,
              f"{tag} (d): fused_precond once a WU group a step")
        e = r["e"]
        check(e["max_err_over_s127"] <= 1.0 + 1e-6,
              f"{tag} (e): compressed mean within s/127")
        check(e["ef_sum_err_over_step"] <= 1.0 + 1e-3,
              f"{tag} (e): error feedback within one step")
    launches = {name: sum(r["d"]["launches"][name] for r in ranks)
                for name in ranks[0]["d"]["launches"]}
    d_losses = ranks[0]["d"]["losses"]
    d32 = ranks[0]["d_fp32"]["losses"]
    return {"ranks": world, "backend": backend, "seconds": seconds,
            "losses": d_losses, "accum_losses": accum_losses,
            "main_path_losses": list(main_losses),
            "rel_to_accum": [abs(x - y) / abs(y)
                             for x, y in zip(d_losses, accum_losses)],
            "rel_to_main_path": [abs(x - y) / abs(y)
                                 for x, y in zip(d_losses, main_losses)],
            "fp32_losses": d32, "fp32_one_rank_losses": fp32_losses,
            "fp32_rel_to_one_rank": [abs(x - y) / abs(y)
                                     for x, y in zip(d32, fp32_losses)],
            "launches": launches, "per_rank": ranks}


def tp_rank(rank, world, model, ckpt_dir):
    """One rank of phase ``tp`` (run by ``dist.spawn.run_ranks``; see
    :func:`tp_phase`): the main path's model split over a ``(data,
    model)`` mesh of ``model`` ranks a model group, every check's inputs,
    and this rank's timings, traffic, launches and peak memory."""
    import torch
    import torch.distributed as tdist

    from repro_torch.checkpoint import CheckpointManager, restore
    from repro_torch.configs import get_config
    from repro_torch.core import kfac
    from repro_torch.data.pipeline import (DataCursor, SyntheticTokens,
                                           make_global_batch)
    from repro_torch.dist import api, sharding
    from repro_torch.kernels import fused_precond as fp_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.solve import make_wu_plan

    dev = torch.device("cuda", torch.cuda.current_device())
    train_mod.fp32_matmuls()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_dev_mesh(model)
    cfg = get_config(MAIN["arch"])
    kcfg = kfac.KFACConfig(
        stats_every=MAIN["stats_every"], inv_every=MAIN["inv_every"],
        block_size=min(MAIN["block_size"], cfg.soi_block),
        stats_batch=MAIN["batch"], stats_seq=MAIN["seq"])
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=MAIN["seq"],
                         global_batch=MAIN["batch"], seed=MAIN["seed"])

    def digest(tree):
        return train_mod.params_digest(tree)

    def program(dtype):
        return train_mod.KFACProgram(
            dataclasses.replace(cfg, dtype=dtype), kcfg, seed=MAIN["seed"],
            device=dev, mesh=mesh, dist_inv=True)

    def traced_run(prog):
        """``MAIN["steps"]`` steps of ``run``: the history, each step's
        digest of the replicated leaves, the launches, blocks and seam
        traffic, the wall seconds."""
        digests = []

        def on_step(state, rec):
            digests.append(digest({k: v for k, v in state.params.items()
                                   if prog.shards.dims.get(k) is None}))

        ops.reset_launch_counts()
        api.SEAM_TRAFFIC.update(reductions=0, bytes=0)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, hist = train_mod.run(prog, ds, MAIN["steps"], on_step=on_step)
        torch.cuda.synchronize(dev)
        return state, {
            "losses": [h["loss"] for h in hist],
            "phase_s": [h["phase_s"] for h in hist],
            "wall_s": time.perf_counter() - t0,
            "replicated_digests": digests,
            "launches": ops.launch_counts(),
            "blocks_inverted": ops.launch_items()["neumann_inv"],
            "seam_reductions": api.SEAM_TRAFFIC["reductions"],
            "seam_bytes": api.SEAM_TRAFFIC["bytes"]}

    out = {"rank": rank, "backend": tdist.get_backend(),
           "mesh": api.axis_sizes(mesh)}
    sec = out["seconds"] = {}
    clock = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        sec[name] = now - clock[0]
        clock[0] = now

    lap("start")
    # (a) at the config's bf16 compute and (e): 4 --dist-inv steps, timed
    prog = program(cfg.dtype)
    shards = prog.shards
    state, out["bf16"] = traced_run(prog)
    out["bf16"]["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    lap("bf16_run")
    # (b) the gathered params on every rank; (d) rank 0 writes the full
    # state's checkpoint, as the loop does, while (c) runs
    full = prog.full_state(state)
    out["bf16"]["params_digest"] = digest(full.params)
    lap("gather")
    writer = CheckpointManager(ckpt_dir) if rank == 0 else None
    if writer is not None:
        writer.save_async(MAIN["steps"], full)
    lap("save_snapshot")

    # (a) fp32 compute: 4 --dist-inv steps, held to the one-rank fp32 run
    # (while rank 0's checkpoint is written)
    torch.cuda.reset_peak_memory_stats(dev)
    prog32 = program("float32")
    state32, out["fp32"] = traced_run(prog32)
    out["fp32"]["params_digest"] = digest(
        sharding.full_params(state32.params, shards))
    out["fp32"]["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del state32, prog32
    torch.cuda.empty_cache()
    lap("fp32_run")

    # (c) the one-rank stats step's factors, sliced to this rank and
    # refreshed under --dist-inv, against the one-rank refresh
    gen = torch.Generator(device=dev).manual_seed(MAIN["seed"])
    full_params = steps_mod.init_params(cfg, generator=gen, device=dev)
    specs = steps_mod.kfac_specs(cfg)
    one = steps_mod.TrainState(full_params, kfac.init(full_params, specs,
                                                      kcfg))
    one, _ = steps_mod.make_stats_step(cfg, kcfg)(one, make_global_batch(
        ds, DataCursor(0), None, device=dev))
    factors = one.kfac.factors
    del one, full_params
    want = sharding.local_factors(kfac.invert_factors(factors, kcfg), shards)
    local = sharding.local_factors(factors, shards)
    refresh = steps_mod.make_inv_refresh(cfg, kcfg, mesh=mesh,
                                         distributed=True, shards=shards)
    meta = steps_mod.init_params(cfg, generator=None, device="meta")
    sliced = {k: v for k, v in meta.items() if shards.dims.get(k) is not None}

    def sliced_factors(tree):
        return {n: {s: t for s, t in d.items()
                    if shards.factor_dim(n, s, t.ndim) is not None}
                for n, d in tree.items()}

    refresh(local)                                     # warm, plans built
    ops.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got = refresh(local)
    torch.cuda.synchronize(dev)
    lspecs = steps_mod.kfac_specs(cfg, shards)
    wu = make_wu_plan(lspecs, local)
    out["c"] = {
        "bitwise": all(torch.equal(got[n][k], want[n][k])
                       for n in want for k in want[n]),
        "refresh_ms": (time.perf_counter() - t0) * 1e3,
        "launches": ops.launch_counts()["neumann_inv"],
        "blocks": ops.launch_items()["neumann_inv"],
        "one_rank_blocks": sum(math.prod(t.shape[:-2])
                               for d in factors.values()
                               for t in d.values()),
        "fused_precond_per_step": sum(
            fp_mod.expected_launches(g.n_tiles, g.bi, g.bo,
                                     shared=g.bi == g.bo)
            for g in wu.groups),
        "wu_tiles": wu.total_tiles,
        # the sliced leaves' weights and factors: this rank's bytes, and
        # the full model's
        "sliced_weight_bytes": [tensor_bytes(sharding.local_params(
            sliced, shards)), tensor_bytes(sliced)],
        "sliced_factor_bytes": [tensor_bytes(sliced_factors(local)),
                                tensor_bytes(sliced_factors(factors))]}
    del got, want, local, factors
    torch.cuda.empty_cache()
    lap("c")

    # (d) the checkpoint restored into a one-rank program (rank 0) and
    # into this run (every rank, as the loop restores)
    if writer is not None:
        writer.wait()
        out["write_s"] = writer.write_s[-1]
    tdist.barrier()
    lap("save_wait")
    like = (train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"], device=dev)
            if rank == 0 else prog).init_state()
    restored, _ = restore(ckpt_dir, like)
    del like
    lap("restore")

    def same(a, b):
        return (all(torch.equal(a.params[k], b.params[k]) for k in b.params)
                and all(torch.equal(a.kfac.factors[n][s], b.kfac.factors[n][s])
                        and torch.equal(a.kfac.inverses[n][s + "_inv"],
                                        b.kfac.inverses[n][s + "_inv"])
                        for n in b.kfac.factors for s in b.kfac.factors[n])
                and all(torch.equal(getattr(a.kfac, m)[k],
                                    getattr(b.kfac, m)[k])
                        for m in ("momentum", "adam_mu", "adam_nu")
                        for k in getattr(b.kfac, m)))

    out["d"] = {"one_rank": same(restored, full) if rank == 0 else None,
                "this_run": same(prog.local_state(restored), state)}
    del restored, full, state
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    tdist.barrier()
    lap("compare")
    return out


def tp_phase(torch, dev, check, main_losses, fp32_losses):
    """Phase ``tp``: the main path's model split megatron-style over the
    ``model`` axis (``--model-parallel 2 --dist-inv``): two gloo ranks
    sharing ``cuda:0`` on a (1, 2) mesh, or one rank a card over NCCL on
    a (cards / 2, 2) one; :func:`tp_rank` on each. Checks: (a) at fp32
    compute every step within ``TP["fp32_tol"]`` of the one-rank fp32
    run (``dist_phase``'s), at bf16 steps 0-1 within ``TP["bf16_tol"]``
    of the main path (steps 2-3 printed: the step-2 transient amplifies
    the ranks' bf16 rounding); (b) the gathered params bitwise equal on
    every rank, the replicated leaves bitwise equal across ranks at every
    step; (c) the one-rank stats step's factors, sliced and refreshed
    under --dist-inv, bitwise the one-rank refresh's blocks, the blocks
    ``neumann_inv`` inverted summed over ranks the one-rank plan's, and
    in the runs ``neumann_inv`` as (c) a refresh and ``fused_precond``
    once a WU group a step on each rank; (d) rank 0's checkpoint of the
    full state restored bitwise into a one-rank program and into the
    run. (e) is printed: each rank's phase seconds, seam reductions and
    bytes a step, peak GB. A failed rank fails the phase."""
    from repro_torch.dist.spawn import backend_for, run_ranks

    n_cards = torch.cuda.device_count()
    world = 2 if n_cards == 1 else n_cards - n_cards % 2
    backend = backend_for("cuda", world)
    emit({"phase": "tp_setup", "ranks": world, "cards": n_cards,
          "backend": backend, "mesh": {"data": world // 2, "model": 2},
          "placement": ("two ranks share cuda:0 over gloo" if n_cards == 1
                        else "one rank a card over NCCL")})
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(tp_rank, world, device="cuda", args=(2, ckpt),
                          timeout=600)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    seconds = time.perf_counter() - t0
    steps = MAIN["steps"]
    r0 = ranks[0]
    for r in ranks:
        tag = f"tp rank {r['rank']}"
        f32, b16, c = r["fp32"], r["bf16"], r["c"]
        check(len(f32["losses"]) == len(fp32_losses) == steps and all(
            abs(x - y) <= TP["fp32_tol"] * abs(y)
            for x, y in zip(f32["losses"], fp32_losses)),
              f"{tag} (a): fp32 losses within {TP['fp32_tol']} of one rank")
        check(all(abs(x - y) <= TP["bf16_tol"] * abs(y)
                  for x, y in zip(b16["losses"][:2], main_losses[:2])),
              f"{tag} (a): bf16 steps 0-1 within {TP['bf16_tol']} of the "
              f"main path")
        for run in ("fp32", "bf16"):
            check(r[run]["params_digest"] == r0[run]["params_digest"]
                  and r[run]["losses"] == r0[run]["losses"],
                  f"{tag} (b) {run}: gathered params and losses equal "
                  f"across ranks")
            check(len(r[run]["replicated_digests"]) == steps
                  and r[run]["replicated_digests"]
                  == r0[run]["replicated_digests"],
                  f"{tag} (b) {run}: replicated leaves bitwise equal across "
                  f"ranks at every step")
            refreshes = sum("inv" in p for p in r[run]["phase_s"])
            check(refreshes > 0 and r[run]["launches"]["neumann_inv"]
                  == refreshes * c["launches"]
                  and r[run]["blocks_inverted"]
                  == {k: refreshes * n for k, n in c["blocks"].items()},
                  f"{tag} (c) {run}: neumann_inv as the split refresh plans")
            check(r[run]["launches"]["fused_precond"]
                  == steps * c["fused_precond_per_step"] > 0,
                  f"{tag} (c) {run}: fused_precond once a WU group a step")
        check(c["bitwise"], f"{tag} (c): the split refresh bitwise the "
                            f"one-rank refresh's blocks")
        check(r["d"]["this_run"], f"{tag} (d): the checkpoint restored "
                                  f"bitwise into the run")
    check(r0["d"]["one_rank"], "tp (d): rank 0's checkpoint restored "
                               "bitwise into a one-rank program")
    blocks = sum(sum(r["c"]["blocks"].values()) for r in ranks)
    check(blocks == r0["c"]["one_rank_blocks"],
          f"tp (c): neumann_inv covered each block once over the mesh "
          f"({blocks} blocks)")
    launches = {name: sum(r["bf16"]["launches"][name] for r in ranks)
                for name in r0["bf16"]["launches"]}

    def rel(xs, ys):
        return [abs(x - y) / abs(y) for x, y in zip(xs, ys)]

    return {"ranks": world, "backend": backend, "seconds": seconds,
            "fp32_losses": r0["fp32"]["losses"],
            "fp32_one_rank_losses": list(fp32_losses),
            "fp32_rel_to_one_rank": rel(r0["fp32"]["losses"], fp32_losses),
            "bf16_losses": r0["bf16"]["losses"],
            "main_path_losses": list(main_losses),
            "bf16_rel_to_main_path": rel(r0["bf16"]["losses"], main_losses),
            "launches": launches,
            "per_rank": [{
                "rank": r["rank"], "mesh": r["mesh"],
                "phase_s": r["bf16"]["phase_s"],
                "fp32_phase_s": r["fp32"]["phase_s"],
                "seam_reductions_a_step": r["bf16"]["seam_reductions"]
                / steps,
                "seam_bytes_a_step": r["bf16"]["seam_bytes"] / steps,
                "wall_s": r["bf16"]["wall_s"],
                "refresh_ms": r["c"]["refresh_ms"],
                "neumann_inv_blocks": r["c"]["blocks"],
                "wu_tiles": r["c"]["wu_tiles"],
                "sliced_weight_bytes": r["c"]["sliced_weight_bytes"],
                "sliced_factor_bytes": r["c"]["sliced_factor_bytes"],
                "seconds": r["seconds"], "write_s": r.get("write_s"),
                "peak_mem_gb": r["peak_mem_gb"],
                "fp32_peak_mem_gb": r["fp32"]["peak_mem_gb"],
                "bf16_peak_mem_gb": r["bf16"]["peak_mem_gb"]}
                for r in ranks]}


@contextlib.contextmanager
def logged_routes(torch, step):
    """Inside: each ``models.moe.route`` call records, under the step
    ``step[0]``, its pairs' global expert ids and whether this rank
    kept each (a pair of another rank's expert: not kept), on the host
    as numpy arrays. Yields ``{step: [(eid, keep), ...]}``."""
    from repro_torch.models import moe

    orig = moe.route
    log = {}

    def spy(cfg, router, xf, *rest):
        out = orig(cfg, router, xf, *rest)
        with torch.no_grad():
            eid = moe._top_k(cfg, router, xf)[1]
        log.setdefault(step[0], []).append(
            (eid.to(torch.int16).cpu().numpy(), out[2].cpu().numpy()))
        return out

    moe.route = spy
    try:
        yield log
    finally:
        moe.route = orig


def route_diffs(one, ranks):
    """Routing decisions of one rank (``one``, a :func:`logged_routes`
    log) against the model ranks' (``ranks``, one log each, a pair kept
    on the rank that owns its expert), step by step: the pairs, the
    pairs sent to another expert, the pairs kept on one side only, the
    pairs one rank dropped; None where the calls do not line up."""
    out = {}
    for s in sorted(one):
        calls = [one[s]] + [r.get(s, []) for r in ranks]
        if len({len(c) for c in calls}) != 1 or any(
                len({c[i][0].shape for c in calls}) != 1
                for i in range(len(one[s]))):
            out[s] = None
            continue
        row = dict(pairs=0, expert_differs=0, keep_differs=0, dropped=0)
        for i, (eid, keep) in enumerate(one[s]):
            kept = ranks[0][s][i][1].copy()
            for r in ranks[1:]:
                kept |= r[s][i][1]
            row["pairs"] += int(eid.size)
            row["expert_differs"] += int((eid != ranks[0][s][i][0]).sum())
            row["keep_differs"] += int((keep != kept).sum())
            row["dropped"] += int((~keep).sum())
        out[s] = row
    return out


def ep_same_input(torch, cfg, ds, dev, shards, rank):
    """Gate (f)'s run: the seeded initial params and step 0's batch, in
    the train step's microbatches, through the ``(1, 2)`` layout (every
    rank) and, on rank 0, through one rank: the losses, each gathered
    gradient leaf's largest difference over its largest entry, and both
    sides' routing logs (rank 0's one-rank log under ``"one"``)."""
    from repro_torch.data.pipeline import DataCursor
    from repro_torch.dist import sharding
    from repro_torch.launch import steps as steps_mod

    gen = torch.Generator(device=dev).manual_seed(MAIN["seed"])
    full = steps_mod.init_params(cfg, generator=gen, device=dev)
    local = sharding.local_params(full, shards)
    if rank:
        del full
    batch = ds.batch(DataCursor(), device=dev)
    accum = cfg.train_accum
    mb = batch["tokens"].shape[0] // accum

    def loss_grads(params, on):
        loss, grads = 0.0, None
        with steps_mod.bound(on):
            for i in range(accum):
                l_i, g_i = steps_mod._grads(cfg, params, steps_mod.batch_rows(
                    batch, i * mb, (i + 1) * mb))
                loss += float(l_i) / accum
                grads = ({k: g / accum for k, g in g_i.items()}
                         if grads is None else
                         {k: grads[k] + g_i[k] / accum for k in grads})
        return loss, grads

    step = [0]
    with logged_routes(torch, step) as log:
        loss, grads = loss_grads(local, shards)
    grads = sharding.full_params(grads, shards)
    out = {"loss": loss, "log": log}
    del local
    if rank == 0:
        with logged_routes(torch, step) as one_log:
            one_loss, one_grads = loss_grads(full, None)
        out.update(one_loss=one_loss, one=one_log, grad_rel={
            k: float((grads[k] - g).abs().max() / g.abs().max())
            for k, g in one_grads.items() if float(g.abs().max()) > 0})
        del full, one_grads
    del grads
    torch.cuda.empty_cache()
    return out


def ep_rank(rank, world, ckpt_dir):
    """One rank of phase ``ep`` (run by ``dist.spawn.run_ranks``; see
    :func:`ep_phase`): moonshot at published widths over a ``(1, 2)``
    mesh, its experts split over the two model ranks. Returns every gate's inputs and this rank's timings, launches and
    peak memory; ``fails`` lists the kernel checks that failed."""
    import torch
    import torch.distributed as tdist

    from repro_torch.checkpoint import CheckpointManager, restore
    from repro_torch.core import kfac
    from repro_torch.dist import api
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_dev_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    train_mod.fp32_matmuls()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_dev_mesh(2)
    cfg, kcfg, ds = ep_setup()
    fails = []

    def check(ok, what):
        if not ok:
            fails.append(f"ep rank {rank}: {what}")

    def program(dtype, on=mesh):
        return train_mod.KFACProgram(
            dataclasses.replace(cfg, dtype=dtype), kcfg, seed=MAIN["seed"],
            device=dev, mesh=on, dist_inv=True)

    def traced_run(prog, steps, log_routes=False):
        """``steps`` steps of ``run`` with the launch counts zeroed just
        before and read just after: the history, each step's router
        digest, the launches and blocks, the wall seconds; with
        ``log_routes`` each step's routing decisions."""
        routers = []
        step = [0]

        def on_step(state, rec):
            routers.append(train_mod.params_digest(
                {k: v for k, v in state.params.items()
                 if k.endswith("moe/router")}))
            step[0] += 1

        ops.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with (logged_routes(torch, step) if log_routes
              else contextlib.nullcontext({})) as log:
            state, hist = train_mod.run(prog, ds, steps, on_step=on_step)
        torch.cuda.synchronize(dev)
        return state, {
            "routes": log,
            "losses": [h["loss"] for h in hist],
            "phase_s": [h["phase_s"] for h in hist],
            "wall_s": time.perf_counter() - t0, "routers": routers,
            "launches": ops.launch_counts(),
            "blocks_inverted": ops.launch_items()["neumann_inv"],
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}

    out = {"rank": rank, "backend": tdist.get_backend(),
           "mesh": api.axis_sizes(mesh), "layers": cfg.n_layers}
    sec = out["seconds"] = {}
    clock = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        sec[name] = now - clock[0]
        clock[0] = now

    lap("start")
    prog = program("float32")
    shards = prog.shards
    # (f) the same inputs through both layouts, before any step
    out["same_input"] = ep_same_input(
        torch, dataclasses.replace(cfg, dtype="float32"), ds, dev, shards,
        rank)
    lap("same_input")
    # (a) 4 --dist-inv steps at fp32 compute, the routing logged
    state, out["fp32"] = traced_run(prog, MAIN["steps"], log_routes=True)
    lap("fp32_run")
    # (b) the expert leaves' factor stacks, and one refresh's launches
    out["expert_stacks"] = sorted({
        int(t.shape[1]) for n, d in state.kfac.factors.items()
        if "/moe/" in n for t in d.values()})
    refresh = steps_mod.make_inv_refresh(cfg, kcfg, mesh=mesh,
                                         distributed=True, shards=shards)
    refresh(state.kfac.factors)                     # plans built
    ops.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    refresh(state.kfac.factors)
    torch.cuda.synchronize(dev)
    wu = steps_mod.make_wu_plan_for(cfg, state, shards=shards)
    out["refresh"] = {
        "ms": (time.perf_counter() - t0) * 1e3,
        "launches": ops.launch_counts()["neumann_inv"],
        "blocks": ops.launch_items()["neumann_inv"],
        "expert_blocks": sum(
            math.prod(t.shape[:-2]) for n, d in state.kfac.factors.items()
            if "/moe/" in n for t in d.values()),
        "fused_precond_per_step": sum(
            fp_expected(g) for g in wu.groups),
        "wu_tiles": wu.total_tiles,
        "expert_wu_stacks": sorted({
            tuple(leaf.stack) for g in wu.groups for leaf in g.leaves
            if "/moe/" in leaf.name})}
    lap("refresh")
    # (e) the gathered state (rank 0 keeps a host copy), written by rank
    # 0 beside the kernel checks and the bf16 run
    full = prog.full_state(state)
    meta = steps_mod.init_params(cfg, generator=None, device="meta")
    out["full_shapes_one_rank"] = all(
        tuple(full.params[k].shape) == tuple(v.shape)
        for k, v in meta.items()) and set(full.params) == set(meta)
    writer = None
    if rank == 0:
        full = host_state(torch, full)
        writer = CheckpointManager(ckpt_dir)
        writer.save_async(MAIN["steps"], full)
    else:
        del full
    torch.cuda.empty_cache()
    lap("gather_snapshot")
    # (c) the run's inverses, its largest refresh and one fused_precond
    # call on this rank's WU plan against their plain versions, timed
    box = {"state": state}
    del state
    worst, refresh_row, precond_row = kfac_kernel_checks(
        torch, dev, check, f"ep rank {rank}", box, kcfg, wu)
    out["c"] = {"worst_inverse": worst, "refresh": refresh_row,
                "fused_precond": precond_row}
    del box, prog
    torch.cuda.empty_cache()
    lap("c")
    # (a) the same 4 steps at the config's bf16 compute, printed
    torch.cuda.reset_peak_memory_stats(dev)
    prog16 = program(cfg.dtype)
    state16, out["bf16"] = traced_run(prog16, MAIN["steps"])
    del state16, prog16
    torch.cuda.empty_cache()
    lap("bf16_run")
    # (e) rank 0's checkpoint restored bitwise (the gathered state's host
    # copy its template: the one-rank layout, checked above)
    if writer is not None:
        writer.wait()
        out["write_s"] = writer.write_s[-1]
        restored, _ = restore(ckpt_dir, full)
        out["restored_bitwise"] = (
            all(torch.equal(restored.params[k], full.params[k])
                for k in full.params)
            and all(torch.equal(restored.kfac.factors[n][s],
                                full.kfac.factors[n][s])
                    and torch.equal(restored.kfac.inverses[n][s + "_inv"],
                                    full.kfac.inverses[n][s + "_inv"])
                    for n in full.kfac.factors for s in full.kfac.factors[n])
            and all(torch.equal(getattr(restored.kfac, m)[k],
                                getattr(full.kfac, m)[k])
                    for m in ("momentum", "adam_mu", "adam_nu")
                    for k in getattr(full.kfac, m)))
        del restored, full
    tdist.barrier()
    lap("restore")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["fails"] = fails
    return out


def host_state(torch, state):
    """A TrainState with every tensor copied to the host."""
    def host(tree):
        return {k: (host(v) if isinstance(v, dict) else v.cpu())
                for k, v in tree.items()}

    k = state.kfac
    return type(state)(host(state.params), dataclasses.replace(
        k, factors=host(k.factors), inverses=host(k.inverses),
        momentum=host(k.momentum), adam_mu=host(k.adam_mu),
        adam_nu=host(k.adam_nu)))


def fp_expected(g) -> int:
    """``fused_precond``'s launches for one WU group."""
    from repro_torch.kernels import fused_precond as fp_mod

    return fp_mod.expected_launches(g.n_tiles, g.bi, g.bo,
                                    shared=g.bi == g.bo)


def ep_setup():
    """Phase ``ep``'s model, K-FAC config and data: :data:`EP`'s arch at
    its published widths, depth cut, on the main path's traffic."""
    from repro_torch.configs import get_config
    from repro_torch.core import kfac
    from repro_torch.data.pipeline import SyntheticTokens

    cfg = dataclasses.replace(get_config(EP["arch"]), n_layers=EP["layers"])
    kcfg = kfac.KFACConfig(
        stats_every=MAIN["stats_every"], inv_every=MAIN["inv_every"],
        block_size=min(MAIN["block_size"], cfg.soi_block),
        stats_batch=MAIN["batch"], stats_seq=MAIN["seq"])
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=MAIN["seq"],
                         global_batch=MAIN["batch"], seed=MAIN["seed"])
    return cfg, kcfg, ds


def ep_phase(torch, dev, check):
    """Phase ``ep``: :data:`EP`'s MoE model (moonshot-v1-16b-a3b at
    published widths, depth cut) with its experts split over the
    ``model`` axis (``--model-parallel 2 --dist-inv``): first one rank
    alone in this process at fp32 compute, then two gloo ranks sharing
    ``cuda:0`` on a (1, 2) mesh, :func:`ep_rank` on each. Checks: (a)
    the fp32 losses of steps 0-1 within ``EP["fp32_tol"]`` of the one
    rank's (steps 2-3 and the bf16 run printed); (b) each rank's expert
    factors stacks of ``n_experts / 2``, every block of the one-rank
    tree inverted once over the two ranks, and on each rank
    ``neumann_inv`` as its refresh plans and ``fused_precond`` once a
    WU group a step, in the fp32 and the bf16 run; (c) on each rank the
    run's inverses, its largest refresh and one ``fused_precond`` call
    on its WU plan against their plain versions; (d) the router bitwise
    equal across ranks after every step; (e) rank 0's checkpoint of the
    gathered state (the one-rank layout) restored bitwise; (f) on the
    same inputs (the initial params, step 0's batch) the loss within
    ``EP["same_tol"]`` of one rank's, each gathered gradient leaf
    within ``EP["grad_tol"]`` of its largest entry, every routing
    decision equal and capacity binding. The routing decisions that
    differ between the two fp32 trajectories are printed step by step.
    The data-parallel MoE path is not run here: two ranks each holding
    the whole model do not fit the card. A failed rank fails the
    phase."""
    from repro_torch.core import soi
    from repro_torch.dist.spawn import backend_for, run_ranks
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod

    import gc

    t0 = time.perf_counter()
    cfg, kcfg, ds = ep_setup()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step = [0]

    def next_step(state, rec):
        step[0] += 1

    with logged_routes(torch, step) as one_routes:
        one_state, one_hist = train_mod.run(train_mod.KFACProgram(
            dataclasses.replace(cfg, dtype="float32"), kcfg,
            seed=MAIN["seed"], device=dev), ds, MAIN["steps"],
            on_step=next_step)
    one_losses = [h["loss"] for h in one_hist]
    one_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del one_state
    gc.collect()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    reserved_gb = torch.cuda.memory_reserved(dev) / 1e9
    backend = backend_for("cuda", 2)
    emit({"phase": "ep_setup", "ranks": 2, "backend": backend,
          "mesh": {"data": 1, "model": 2}, "arch": cfg.name,
          "layers": cfg.n_layers, "published_layers": EP["published_layers"],
          "experts": cfg.n_experts, "one_rank_peak_gb": one_peak,
          "held_by_parent_gb": held_gb,
          "reserved_by_parent_gb": reserved_gb,
          "free_gb": torch.cuda.mem_get_info(dev)[0] / 1e9,
          "card_gb": card_gb,
          "placement": "two ranks share cuda:0 over gloo"})
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ep_")
    t1 = time.perf_counter()
    # two ranks' allocators share the card: segments that grow in place
    # leave less of it stranded between them
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = run_ranks(ep_rank, 2, device="cuda", args=(ckpt,),
                          timeout=600)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    spawn_s = time.perf_counter() - t1
    steps = MAIN["steps"]
    r0 = ranks[0]
    e_loc = cfg.n_experts // 2
    for r in ranks:
        tag = f"ep rank {r['rank']}"
        for what in r["fails"]:
            check(False, what)
        f32 = r["fp32"]
        check(len(f32["losses"]) == steps and all(
            abs(x - y) <= EP["fp32_tol"] * abs(y)
            for x, y in zip(f32["losses"][:2], one_losses[:2])),
              f"{tag} (a): fp32 steps 0-1 within {EP['fp32_tol']} of one "
              f"rank")
        check(all(math.isfinite(x) for x in f32["losses"]
                  + r["bf16"]["losses"]), f"{tag} (a): finite losses")
        check(r["expert_stacks"] == [e_loc]
              and r["refresh"]["expert_wu_stacks"] == [(cfg.n_layers, e_loc)],
              f"{tag} (b): expert factors and WU tiles of {e_loc} experts")
        c = r["refresh"]
        for run in ("fp32", "bf16"):
            refreshes = sum("inv" in p for p in r[run]["phase_s"])
            check(refreshes > 0 and r[run]["launches"]["neumann_inv"]
                  == refreshes * c["launches"]
                  and r[run]["blocks_inverted"]
                  == {k: refreshes * n for k, n in c["blocks"].items()},
                  f"{tag} (b) {run}: neumann_inv as its refresh plans")
            check(r[run]["launches"]["fused_precond"]
                  == steps * c["fused_precond_per_step"] > 0,
                  f"{tag} (b) {run}: fused_precond once a WU group a step")
            check(r[run]["routers"] == r0[run]["routers"]
                  and len(r[run]["routers"]) == steps
                  and r[run]["losses"] == r0[run]["losses"],
                  f"{tag} (d) {run}: router bitwise and losses equal "
                  f"across ranks at every step")
        check(r["full_shapes_one_rank"],
              f"{tag} (e): the gathered params in the one-rank layout")
    check(r0.get("restored_bitwise") is True,
          "ep (e): rank 0's checkpoint restored bitwise")
    same = r0["same_input"]
    same_routes = route_diffs(same["one"],
                              [r["same_input"]["log"] for r in ranks])[0]
    same_rel = abs(same["loss"] - same["one_loss"]) / abs(same["one_loss"])
    grad_rel = max(same["grad_rel"].values())
    check(all(r["same_input"]["loss"] == same["loss"] for r in ranks)
          and same_rel <= EP["same_tol"],
          f"ep (f): the same inputs' loss within {EP['same_tol']} of one "
          f"rank's ({same_rel:.3g})")
    check(grad_rel <= EP["grad_tol"],
          f"ep (f): every gradient leaf within {EP['grad_tol']} of its "
          f"largest entry ({grad_rel:.3g})")
    check(same_routes is not None and same_routes["expert_differs"] == 0
          and same_routes["keep_differs"] == 0
          and same_routes["dropped"] > 0,
          f"ep (f): routing decisions equal and capacity binding "
          f"({same_routes})")
    trajectory_routes = route_diffs(
        one_routes, [r["fp32"]["routes"] for r in ranks])
    blocks = sum(sum(r["refresh"]["blocks"].values()) for r in ranks)
    one_blocks = sum(math.prod(shape[:-2])
                     for spec in train_mod.steps_mod.kfac_specs(cfg).values()
                     for shape in soi.factor_shapes(
                         spec, kcfg.block_size).values())
    check(blocks == one_blocks,
          f"ep (b): neumann_inv covered each block once over the ranks "
          f"({blocks} of {one_blocks})")
    launches = {name: sum(r["bf16"]["launches"][name]
                          + r["fp32"]["launches"][name] for r in ranks)
                for name in ops.launch_counts()}

    def rel(xs, ys):
        return [abs(x - y) / abs(y) for x, y in zip(xs, ys)]

    return {"ranks": 2, "backend": backend,
            "seconds": time.perf_counter() - t0, "one_rank_s": one_s,
            "spawn_s": spawn_s, "layers": cfg.n_layers,
            "published_layers": EP["published_layers"],
            "one_rank_peak_gb": one_peak,
            "fp32_losses": r0["fp32"]["losses"],
            "fp32_one_rank_losses": one_losses,
            "fp32_rel_to_one_rank": rel(r0["fp32"]["losses"], one_losses),
            "fp32_routing_differs_by_step": trajectory_routes,
            "same_input": {"loss": same["loss"],
                           "one_rank_loss": same["one_loss"],
                           "loss_rel": same_rel, "grad_rel_max": grad_rel,
                           "grad_rel": same["grad_rel"],
                           "routing": same_routes},
            "bf16_losses": r0["bf16"]["losses"],
            "launches": launches,
            "per_rank": [{
                "rank": r["rank"], "mesh": r["mesh"],
                "phase_s": r["bf16"]["phase_s"],
                "fp32_phase_s": r["fp32"]["phase_s"],
                "wall_s": r["bf16"]["wall_s"],
                "refresh_ms": r["refresh"]["ms"],
                "neumann_inv_blocks": r["refresh"]["blocks"],
                "expert_blocks": r["refresh"]["expert_blocks"],
                "wu_tiles": r["refresh"]["wu_tiles"],
                "kernel_checks": r["c"],
                "seconds": r["seconds"], "write_s": r.get("write_s"),
                "peak_mem_gb": r["peak_mem_gb"],
                "fp32_peak_mem_gb": r["fp32"]["peak_mem_gb"],
                "bf16_peak_mem_gb": r["bf16"]["peak_mem_gb"]}
                for r in ranks]}


def pp_setup():
    """Phase ``pp``'s model (the main path's, at fp32), K-FAC config and
    data."""
    from repro_torch.configs import get_config
    from repro_torch.core import kfac
    from repro_torch.data.pipeline import SyntheticTokens

    cfg = dataclasses.replace(get_config(MAIN["arch"]), dtype="float32")
    kcfg = kfac.KFACConfig(
        stats_every=MAIN["stats_every"], inv_every=MAIN["inv_every"],
        block_size=min(MAIN["block_size"], cfg.soi_block),
        stats_batch=MAIN["batch"], stats_seq=MAIN["seq"])
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=MAIN["seq"],
                         global_batch=MAIN["batch"], seed=MAIN["seed"])
    return cfg, kcfg, ds


def pp_same_input(torch, cfg, kcfg, ds, prog, dev):
    """Gate (a) on one stage rank: the initial params and step 0's batch
    through the pipeline (loss, this stage's gradients, its statistics
    and its refresh) against one rank's on the same inputs (the full
    model, ``train_accum`` 2), each compared on this stage's leaves."""
    from repro_torch.core import kfac
    from repro_torch.data.pipeline import DataCursor, make_global_batch
    from repro_torch.dist import sharding
    from repro_torch.dist.api import DATA, MODEL
    from repro_torch.launch import steps as steps_mod
    from repro_torch.pipeline import split_microbatches

    shards = prog.shards
    batch = make_global_batch(ds, DataCursor(0), prog.mesh, device=dev)
    state = prog.init_state()
    step = steps_mod.make_pipeline_step(cfg, kcfg, mesh=prog.mesh,
                                        pp=PP["stages"], shards=shards)
    micro = split_microbatches(batch, PP["micro"])
    loss, grads = step.grads_fn(state.params, micro)
    stats = steps_mod.make_stats_step(cfg, kcfg, shards=shards)
    sub = {"tokens": batch["tokens"][:kcfg.stats_batch, :kcfg.stats_seq]}
    factors = stats(state, sub)[0].kfac.factors
    refresh = steps_mod.make_inv_refresh(
        cfg, kcfg, mesh=prog.mesh[DATA, MODEL], distributed=True)
    inv = refresh(factors)
    one_inv = steps_mod.make_inv_refresh(cfg, kcfg)(factors)
    bitwise = all(torch.equal(inv[n][k], one_inv[n][k])
                  for n in inv for k in inv[n])
    del state, inv, one_inv
    # one rank on the same inputs: the full model, its rows in two
    # microbatches, and its statistics step
    gen = torch.Generator(device=dev).manual_seed(MAIN["seed"])
    full = steps_mod.init_params(cfg, generator=gen, device=dev)
    one_loss = torch.zeros((), device=dev)
    one = {k: torch.zeros_like(v) for k, v in full.items()}
    for mb in range(PP["micro"]):
        l_i, g_i = steps_mod._grads(cfg, full,
                                    {k: v[mb] for k, v in micro.items()})
        one_loss = one_loss + l_i / PP["micro"]
        for k in one:
            one[k].add_(g_i[k] / PP["micro"])
        del g_i
    one = sharding.stage_local_params(one, shards)
    grad_rel = {k: float((grads[k] - one[k]).abs().max()
                         / one[k].abs().max()) for k in grads}
    del one, grads
    one_state = steps_mod.TrainState(full, kfac.init(
        full, steps_mod.kfac_specs(cfg), kcfg))
    one_fac = sharding.stage_local_factors(
        steps_mod.make_stats_step(cfg, kcfg)(one_state, sub)[0]
        .kfac.factors, shards)
    gram_rel = {f"{n}/{k}": float(torch.linalg.norm(factors[n][k]
                                                    - one_fac[n][k])
                                  / torch.linalg.norm(one_fac[n][k]))
                for n in factors for k in factors[n]}
    return {"loss": float(loss), "one_loss": float(one_loss),
            "grad_rel": grad_rel, "gram_rel": gram_rel,
            "refresh_bitwise": bitwise, "leaves": len(grad_rel),
            "factor_leaves": len(gram_rel)}


def pp_rank(rank, world):
    """One rank of phase ``pp`` (run by ``dist.spawn.run_ranks``; see
    :func:`pp_phase`): the main path's model at fp32 over a ``(2, 1, 1)``
    pipeline mesh. Returns every gate's inputs and this rank's timings,
    launches and memory; ``fails`` lists the kernel checks that
    failed."""
    import torch
    import torch.distributed as tdist

    from repro_torch.core import soi
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_pipeline_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    train_mod.fp32_matmuls()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_pipeline_mesh(PP["stages"])
    cfg, kcfg, ds = pp_setup()
    fails = []

    def check(ok, what):
        if not ok:
            fails.append(f"pp rank {rank}: {what}")

    def program(schedule):
        return train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                     device=dev, mesh=mesh, pp=PP["stages"],
                                     pp_schedule=schedule, dist_inv=True)

    out = {"rank": rank, "backend": tdist.get_backend()}
    sec = out["seconds"] = {}
    clock = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        sec[name] = now - clock[0]
        clock[0] = now

    prog = program("1f1b")
    shards = prog.shards
    out["stage"] = shards.stage
    out["layers"] = list(shards.part.layer_counts())
    lap("start")
    out["same_input"] = pp_same_input(torch, cfg, kcfg, ds, prog, dev)
    torch.cuda.empty_cache()
    lap("same_input")
    runs = {}
    for schedule in ("1f1b", "gpipe"):
        p = prog if schedule == "1f1b" else program(schedule)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, hist = train_mod.run(p, ds, MAIN["steps"])
        torch.cuda.synchronize(dev)
        runs[schedule] = {
            "losses": [h["loss"] for h in hist],
            "phase_s": [h["phase_s"] for h in hist],
            "wall_s": time.perf_counter() - t0,
            "digest": train_mod.params_digest(state.params),
            "peak_stash": p.train_fn.grads_fn.peak_stash,
            "launches": ops.launch_counts(),
            "launch_keys": ops.launch_keys(),
            "blocks_inverted": ops.launch_items()["neumann_inv"],
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        if schedule == "1f1b":
            kept = state
        del state
        lap(schedule)
    out["runs"] = runs
    # (d) this stage's blocks and WU tiles, its state's bytes, and its
    # kernels against their plain versions
    specs = steps_mod.kfac_specs(cfg, shards)
    wu = steps_mod.make_wu_plan_for(cfg, kept, shards=shards)
    out["blocks"] = sum(math.prod(shape[:-2]) for spec in specs.values()
                        for shape in soi.factor_shapes(
                            spec, kcfg.block_size).values())
    out["wu_tiles"] = wu.total_tiles
    out["fused_precond_per_step"] = sum(fp_expected(g) for g in wu.groups)
    out["state_gb"] = tensor_bytes(kept) / 1e9
    box = {"state": kept}
    del kept
    worst, refresh_row, precond_row = kfac_kernel_checks(
        torch, dev, check, f"pp rank {rank}", box, kcfg, wu)
    out["c"] = {"worst_inverse": worst, "refresh": refresh_row,
                "fused_precond": precond_row}
    lap("kernel_checks")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["fails"] = fails
    return out


def pp_phase(torch, dev, check):
    """Phase ``pp``: the main path's model (qwen1.5-0.5b at published
    widths, fp32 compute) cut into :data:`PP`'s two pipeline stages
    (``--pp 2 --dist-inv``, the free partition, 2 microbatches): first
    one rank alone in this process at ``train_accum`` 2, then two gloo
    ranks sharing ``cuda:0`` on a ``(2, 1, 1)`` mesh, :func:`pp_rank` on
    each. Gates (a)-(e) as the module's docstring lists them; each
    rank's state bytes and peak memory beside one rank's, printed. The
    checkpoint of the gathered state is held on the CPU only
    (``tests/test_torch_dist_pp.py``). A failed rank fails the phase."""
    from repro_torch.core import soi
    from repro_torch.dist.spawn import backend_for, run_ranks
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.pipeline import make_schedule

    import gc

    t0 = time.perf_counter()
    cfg, kcfg, ds = pp_setup()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    one_prog = train_mod.KFACProgram(
        dataclasses.replace(cfg, train_accum=PP["micro"]), kcfg,
        seed=MAIN["seed"], device=dev)
    one_state, one_hist = train_mod.run(one_prog, ds, MAIN["steps"])
    one_losses = [h["loss"] for h in one_hist]
    one_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    one_state_gb = tensor_bytes(one_state) / 1e9
    one_wu = steps_mod.make_wu_plan_for(cfg, one_state)
    one_tiles = one_wu.total_tiles
    one_blocks = sum(math.prod(shape[:-2])
                     for spec in steps_mod.kfac_specs(cfg).values()
                     for shape in soi.factor_shapes(
                         spec, kcfg.block_size).values())
    del one_state, one_wu
    gc.collect()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    backend = backend_for("cuda", 2)
    t1 = time.perf_counter()
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = run_ranks(pp_rank, 2, device="cuda", timeout=600)
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    spawn_s = time.perf_counter() - t1
    steps = MAIN["steps"]
    r0 = ranks[0]
    for r in ranks:
        tag = f"pp rank {r['rank']} (stage {r['stage']})"
        for what in r["fails"]:
            check(False, what)
        same = r["same_input"]
        rel = abs(same["loss"] - same["one_loss"]) / abs(same["one_loss"])
        check(rel <= PP["same_tol"],
              f"{tag} (a): the same inputs' loss within {PP['same_tol']} "
              f"of one rank's ({rel:.3g})")
        check(max(same["grad_rel"].values()) <= PP["grad_tol"],
              f"{tag} (a): every gradient leaf within {PP['grad_tol']} of "
              f"its largest entry ({max(same['grad_rel'].values()):.3g})")
        check(max(same["gram_rel"].values()) <= PP["gram_tol"],
              f"{tag} (a): the stage's statistics within {PP['gram_tol']} "
              f"of one rank's ({max(same['gram_rel'].values()):.3g})")
        check(same["refresh_bitwise"],
              f"{tag} (a): the stage's refresh bitwise the one-rank "
              f"refresh of its factors")
        f1, gp = r["runs"]["1f1b"], r["runs"]["gpipe"]
        check(len(f1["losses"]) == steps and all(
            abs(x - y) <= PP["fp32_tol"] * abs(y)
            for x, y in zip(f1["losses"][:2], one_losses[:2])),
              f"{tag} (b): 1f1b steps 0-1 within {PP['fp32_tol']} of one "
              f"rank")
        check(all(math.isfinite(x) for x in f1["losses"] + gp["losses"]),
              f"{tag} (b): finite losses")
        check(f1["losses"] == r0["runs"]["1f1b"]["losses"],
              f"{tag} (b): the ranks' losses equal")
        check(gp["losses"] == f1["losses"] and gp["digest"] == f1["digest"],
              f"{tag} (c): gpipe's losses and params bitwise 1f1b's")
        for kind, run in r["runs"].items():
            refreshes = sum("inv" in p for p in run["phase_s"])
            check(run["launches"]["neumann_inv"] > 0 and refreshes > 0
                  and sum(run["blocks_inverted"].values())
                  == refreshes * r["blocks"],
                  f"{tag} (d) {kind}: neumann_inv on this stage's "
                  f"{r['blocks']} blocks a refresh")
            check(run["launches"]["fused_precond"]
                  == steps * r["fused_precond_per_step"] > 0,
                  f"{tag} (d) {kind}: fused_precond once a WU group a step")
            want = make_schedule(kind, PP["stages"], PP["micro"]) \
                .stash_plan.act_depth[r["stage"]]
            check(run["peak_stash"] == want,
                  f"{tag} (e) {kind}: peak stash {run['peak_stash']}, the "
                  f"plan's {want}")
    blocks = sum(r["blocks"] for r in ranks)
    tiles = sum(r["wu_tiles"] for r in ranks)
    check(blocks == one_blocks and tiles == one_tiles,
          f"pp (d): the stages' blocks and tiles ({blocks}, {tiles}) sum "
          f"to one rank's ({one_blocks}, {one_tiles})")
    launches = {name: sum(run["launches"][name] for r in ranks
                          for run in r["runs"].values())
                for name in ops.launch_counts()}

    def rel(xs, ys):
        return [abs(x - y) / abs(y) for x, y in zip(xs, ys)]

    f1 = r0["runs"]["1f1b"]
    return {"ranks": 2, "backend": backend, "mesh": [PP["stages"], 1, 1],
            "layers": [r["layers"][r["stage"]] for r in ranks],
            "micro": PP["micro"],
            "seconds": time.perf_counter() - t0, "one_rank_s": one_s,
            "spawn_s": spawn_s,
            "fp32_losses": f1["losses"],
            "fp32_one_rank_losses": one_losses,
            "fp32_rel_to_one_rank": rel(f1["losses"], one_losses),
            "gpipe_bitwise": all(
                r["runs"]["gpipe"]["losses"] == r["runs"]["1f1b"]["losses"]
                and r["runs"]["gpipe"]["digest"]
                == r["runs"]["1f1b"]["digest"] for r in ranks),
            "blocks": [r["blocks"] for r in ranks], "one_rank_blocks":
            one_blocks, "wu_tiles": [r["wu_tiles"] for r in ranks],
            "one_rank_wu_tiles": one_tiles,
            "one_rank_state_gb": one_state_gb,
            "one_rank_peak_gb": one_peak,
            "launches": launches,
            "per_rank": [{
                "rank": r["rank"], "stage": r["stage"],
                "same_input": {
                    "loss": r["same_input"]["loss"],
                    "one_rank_loss": r["same_input"]["one_loss"],
                    "grad_rel_max": max(r["same_input"]["grad_rel"]
                                        .values()),
                    "gram_rel_max": max(r["same_input"]["gram_rel"]
                                        .values()),
                    "refresh_bitwise": r["same_input"]["refresh_bitwise"]},
                "peak_stash": {k: v["peak_stash"]
                               for k, v in r["runs"].items()},
                "launch_keys": {k: v["launch_keys"]
                                for k, v in r["runs"].items()},
                "phase_s": r["runs"]["1f1b"]["phase_s"],
                "wall_s": {k: v["wall_s"] for k, v in r["runs"].items()},
                "kernel_checks": r["c"], "state_gb": r["state_gb"],
                "peak_mem_gb": r["peak_mem_gb"],
                "run_peak_mem_gb": {k: v["peak_mem_gb"]
                                    for k, v in r["runs"].items()},
                "seconds": r["seconds"]} for r in ranks]}


def elastic_rank(rank, world, ckpt_dir):
    """One rank of phase ``elastic`` (run by ``dist.spawn.run_ranks``; see
    :func:`elastic_phase`): ``runtime.TrainLoop`` over the main path's
    model at fp32 on a ``(2, 1)`` mesh with ``--dist-inv``, a checkpoint
    every :data:`ELASTIC`'s steps, rank 1 raising ``DeviceLoss(1)`` from
    the ``inject`` hook. Returns the loop's summary and losses, the
    launches before and after the re-mesh, and on the survivor its
    remesh events and counter, the restore's seconds, its blocks and WU
    tiles after the re-mesh, and its kernels held to their plain
    versions; ``fails`` lists the kernel checks that failed."""
    import torch

    from repro_torch import obs as obs_mod
    from repro_torch.core import soi
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.runtime import DeviceLoss, LoopConfig, TrainLoop

    dev = torch.device("cuda", torch.cuda.current_device())
    train_mod.fp32_matmuls()
    cfg, kcfg, ds = pp_setup()
    fails = []

    def check(ok, what):
        if not ok:
            fails.append(f"elastic rank {rank}: {what}")

    obs = obs_mod.Observability() if rank == 0 else obs_mod.NULL
    program = train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                    device=dev, mesh=make_dev_mesh(obs=obs),
                                    dist_inv=True)
    before = {}
    remesh = program.remesh

    def remesh_counted(mesh):
        # the launches of the first mesh's steps, then the re-formed one's
        before.update(launches=ops.launch_counts(),
                      blocks=ops.launch_items()["neumann_inv"])
        ops.reset_launch_counts()
        return remesh(mesh)

    program.remesh = remesh_counted
    fired = []

    def inject(step):
        if rank == 1 and step == ELASTIC["fail_at"] and not fired:
            fired.append(step)
            raise DeviceLoss(ELASTIC["lost"], "elastic drill on rank 1")

    loop = TrainLoop(LoopConfig(ELASTIC["steps"], ckpt_dir=ckpt_dir,
                                ckpt_every=ELASTIC["ckpt_every"], keep=1,
                                hang_factor=None),
                     program, ds, inject=inject, obs=obs)
    ops.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = loop.run()
    torch.cuda.synchronize(dev)
    out = {"rank": rank, "wall_s": time.perf_counter() - t0,
           "summary": {k: v for k, v in res.items() if k != "history"},
           "history": [(h["step"], h["loss"]) for h in res["history"]],
           "phase_s": [h["phase_s"] for h in res["history"]],
           "launches_before": before.get("launches"),
           "blocks_before": before.get("blocks"),
           "launches_after": ops.launch_counts(),
           "blocks_after": ops.launch_items()["neumann_inv"],
           "fails": fails}
    if res.get("excluded"):
        return out
    events = obs.tracer.to_chrome()["traceEvents"]
    out["remesh"] = [e["args"] for e in events if e["name"] == "remesh"]
    out["remesh_total"] = obs.counter("runtime_remesh_total").snapshot()[
        "samples"]
    out["restore_s"] = [e["dur"] / 1e6 for e in events
                        if e["name"] == "ckpt_restore"]
    state = loop.final_state
    specs = steps_mod.kfac_specs(cfg, loop.program.shards)
    out["blocks"] = sum(math.prod(shape[:-2]) for spec in specs.values()
                        for shape in soi.factor_shapes(
                            spec, kcfg.block_size).values())
    wu = steps_mod.make_wu_plan_for(cfg, state, shards=loop.program.shards)
    out["wu_tiles"] = wu.total_tiles
    out["fused_precond_per_step"] = sum(fp_expected(g) for g in wu.groups)
    box = {"state": state}
    del state
    loop.final_state = None
    worst, refresh_row, precond_row = kfac_kernel_checks(
        torch, dev, check, f"elastic rank {rank}", box, kcfg, wu, reps=3)
    out["kernel_checks"] = {"worst_inverse": worst, "refresh": refresh_row,
                            "fused_precond": precond_row}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def elastic_phase(torch, dev, check):
    """Phase ``elastic``: the loss drill of ``runtime.elastic`` on the
    main path's model at fp32 with ``--dist-inv``: first one rank alone
    in this process (:data:`ELASTIC`'s steps), then two gloo ranks
    sharing ``cuda:0`` on a ``(2, 1)`` mesh, :func:`elastic_rank` on
    each: rank 1 loses a device at step 3, rank 0 re-forms ``(1, 1)``,
    restores the checkpoint of step 2 and ends the run. Gates: one
    recovery; on rank 0 two remesh events, ``(2, 1)`` then ``(1, 1)``,
    and the counter at 2; rank 1's summary saying it was excluded at
    step 3; every loss within :data:`ELASTIC`'s ``loss_tol`` of the one
    rank's; after the re-mesh rank 0 inverts every block a refresh
    (``neumann_inv``'s blocks the one-rank plan's) and its WU plan holds
    every tile (``fused_precond`` once a WU group a step); its kernels
    against their plain versions; the restore's seconds printed. A
    failed rank fails the phase."""
    from repro_torch.core import soi
    from repro_torch.dist.spawn import backend_for, run_ranks
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod

    import gc

    t0 = time.perf_counter()
    cfg, kcfg, ds = pp_setup()
    torch.cuda.empty_cache()
    one_state, one_hist = train_mod.run(
        train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"], device=dev),
        ds, ELASTIC["steps"])
    one_losses = [h["loss"] for h in one_hist]
    one_tiles = steps_mod.make_wu_plan_for(cfg, one_state).total_tiles
    one_blocks = sum(math.prod(shape[:-2])
                     for spec in steps_mod.kfac_specs(cfg).values()
                     for shape in soi.factor_shapes(
                         spec, kcfg.block_size).values())
    del one_state
    gc.collect()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    t1 = time.perf_counter()
    try:
        ranks = run_ranks(elastic_rank, 2, device="cuda", timeout=600,
                          args=(tmp,))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spawn_s = time.perf_counter() - t1
    r0, r1 = ranks
    for r in ranks:
        for what in r["fails"]:
            check(False, what)
        check(r["summary"]["recoveries"] == 1,
              f"elastic rank {r['rank']}: one recovery")
        check(r["summary"]["mesh"] == {"data": 1, "model": 1},
              f"elastic rank {r['rank']}: the re-formed mesh (1, 1)")
    s1 = r1["summary"]
    check(s1.get("excluded") is True and s1.get("excluded_at_step")
          == ELASTIC["fail_at"],
          "elastic: rank 1's summary says it was excluded at step "
          f"{ELASTIC['fail_at']}")
    check([e["shape"] for e in r0["remesh"]]
          == [{"data": 2, "model": 1}, {"data": 1, "model": 1}]
          and [e["excluded"] for e in r0["remesh"]] == [0, 1],
          "elastic: rank 0 recorded two remesh events, (2, 1) then (1, 1)")
    check([row["value"] for row in r0["remesh_total"]] == [2],
          "elastic: runtime_remesh_total is 2")
    steps = [s for s, _ in r0["history"]]
    want = list(range(ELASTIC["fail_at"]))
    want += list(range(ELASTIC["fail_at"] - ELASTIC["fail_at"]
                       % ELASTIC["ckpt_every"], ELASTIC["steps"]))
    check(steps == want and r0["summary"]["steps"] == ELASTIC["steps"],
          f"elastic: rank 0 ran steps {want}")
    rel = [abs(x - one_losses[s]) / abs(one_losses[s])
           for s, x in r0["history"]]
    check(max(rel) <= ELASTIC["loss_tol"] and all(
        math.isfinite(x) for _, x in r0["history"]),
          f"elastic: every loss within {ELASTIC['loss_tol']} of one "
          f"rank's at fp32 (worst {max(rel):.3g})")
    # the steps before the loss on the first mesh, the replay on (1, 1)
    first = r0["phase_s"][:ELASTIC["fail_at"]]
    replay = r0["phase_s"][ELASTIC["fail_at"]:]
    refreshes = sum("inv" in p for p in replay)
    after = r0["launches_after"]
    check(refreshes > 0 and sum(r0["blocks_after"].values())
          == refreshes * one_blocks == refreshes * r0["blocks"],
          f"elastic: after the re-mesh each refresh inverted all "
          f"{one_blocks} blocks on rank 0")
    check(r0["wu_tiles"] == one_tiles
          and after["fused_precond"] == len(replay)
          * r0["fused_precond_per_step"] > 0,
          f"elastic: after the re-mesh rank 0's WU holds all {one_tiles} "
          f"tiles, fused_precond once a WU group a step")
    check(0 < sum(r0["blocks_before"].values())
          < sum("inv" in p for p in first) * one_blocks,
          "elastic: before the re-mesh rank 0 inverted its share only")
    check(bool(r0["restore_s"]), "elastic: the restore was timed")
    launches = {name: sum((r["launches_before"] or {}).get(name, 0)
                          + r["launches_after"][name] for r in ranks)
                for name in ops.launch_counts()}
    return {"ranks": 2, "backend": backend_for("cuda", 2),
            "mesh": [[2, 1], [1, 1]], "seconds": time.perf_counter() - t0,
            "one_rank_s": one_s, "spawn_s": spawn_s,
            "history": r0["history"], "one_rank_losses": one_losses,
            "rel_to_one_rank": rel, "restore_s": r0["restore_s"],
            "remesh": r0["remesh"], "excluded": s1,
            "blocks_after": r0["blocks_after"], "one_rank_blocks":
            one_blocks, "wu_tiles": r0["wu_tiles"],
            "one_rank_wu_tiles": one_tiles,
            "launches_before": [r["launches_before"] for r in ranks],
            "launches_after": [r["launches_after"] for r in ranks],
            "launches": launches, "phase_s": r0["phase_s"],
            "wall_s": [r["wall_s"] for r in ranks],
            "ckpt_write_s": r0["summary"].get("ckpt_write_s"),
            "kernel_checks": r0["kernel_checks"],
            "peak_mem_gb": r0["peak_mem_gb"]}


def solvers_rank(rank, world):
    """One rank of phase ``ranks_solvers`` (run by
    ``dist.spawn.run_ranks``; see :func:`ranks_solvers_phase`): on a
    ``(2, 1)`` mesh at fp32, (a) ``--smw --dist-inv``, (b) ``--async-inv
    --dist-inv``, (c) the SGD baseline. Returns each run's losses, its
    launches (by stream for (b)), digests, (a)'s fallback flags and first
    SMW-only update through the kernel against the plain version (rank
    0), (b)'s refresh intervals against the main stream's."""
    import torch

    from repro_torch.data.pipeline import DataCursor, make_global_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_dev_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    train_mod.fp32_matmuls()
    cfg, kcfg, ds = pp_setup()
    mesh = make_dev_mesh()
    out = {"rank": rank}

    def digest(tree):
        return train_mod.params_digest({f"{n}/{s}": t for n, d in
                                        tree.items() for s, t in d.items()})

    # (a) --smw: the first SMW-only update's inputs kept (rank 0)
    seen = []
    smw_refresh = steps_mod.smw_mod.smw_refresh

    def keeping(inverses, factors, cols, cfg_, scfg, ks=None):
        if rank == 0 and len(seen) == 1:
            seen.append({n: {s: (inverses[n][s + "_inv"].clone(),
                                 v.clone(), (ks or {}).get(n, {}).get(s))
                             for s, v in c.items()}
                         for n, c in cols.items()})
        elif len(seen) == 0:
            seen.append(None)
        return smw_refresh(inverses, factors, cols, cfg_, scfg, ks=ks)

    steps_mod.smw_mod.smw_refresh = keeping
    try:
        prog = train_mod.KFACProgram(
            cfg, kcfg, seed=MAIN["seed"], device=dev, mesh=mesh,
            dist_inv=True, smw=True, smw_rank=SMW["rank"],
            smw_drift_budget=SMW["drift_budget"])
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = train_mod.run(prog, ds, SOLVERS["smw_steps"])
        torch.cuda.synchronize(dev)
    finally:
        steps_mod.smw_mod.smw_refresh = smw_refresh
    out["smw"] = {"losses": [h["loss"] for h in hist],
                  "fallbacks": [h["smw_fallback"] for h in hist],
                  "drifts": [h["smw_drift"] for h in hist],
                  "phase_s": [h["phase_s"] for h in hist],
                  "wall_s": time.perf_counter() - t0,
                  "launches": ops.launch_counts(),
                  "inverses_digest": digest(state.kfac.inverses)}
    del state, prog
    if rank == 0 and len(seen) == 2:
        rows = []
        for n, d in seen[1].items():
            for s, (inv, v, k) in d.items():
                w = 1.0 / (k or v.shape[-2]) if s == "A" else 1.0
                bs = inv.shape[-1]
                inv, v = inv.reshape(-1, bs, bs), v.reshape(
                    (-1,) + tuple(v.shape[-2:])).contiguous()
                args = dict(decay=kcfg.ema_decay,
                            cscale=(1.0 - kcfg.ema_decay) * w)
                mine = ops.smw_update(inv, v, **args)
                plain = ref.smw_update_ref(inv, v, **args)
                rows.append(dict(leaf=f"{n}/{s}", k=v.shape[-2],
                                 rel_err=float((mine - plain).abs().max()
                                               / plain.abs().max())))
                del mine, plain
        out["smw"]["update_vs_plain"] = rows
    seen.clear()
    torch.cuda.empty_cache()

    # (b) --async-inv --dist-inv, stepped here: each refresh's interval
    # on its side stream (CUDA events) against the main stream's
    # interval from the dispatch's return to the step's end
    prog = train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"], device=dev,
                                 mesh=mesh, dist_inv=True, async_inv=True)
    state = prog.init_state()
    step_fn = prog.make_step(state)
    refresher = prog.refresher
    into = refresher.refresh_into
    marks = []

    def timed_into(factors, buf):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()                        # on the side stream
        res = into(factors, buf)
        ev[1].record()
        ev[2].record(torch.cuda.default_stream(dev))
        marks.append(ev)
        return res

    refresher.refresh_into = timed_into
    ops.reset_launch_counts()
    losses, rows = [], []
    t0 = time.perf_counter()
    for i in range(SOLVERS["async_steps"]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        n_marks = len(marks)
        state, m = step_fn(state, make_global_batch(ds, DataCursor(i), mesh,
                                                    device=dev))
        end.record()
        torch.cuda.synchronize(dev)
        losses.append(float(m["loss"]))
        if len(marks) > n_marks:
            s0, s1, ret = marks[-1]
            t = {k: start.elapsed_time(e) for k, e in
                 (("s0", s0), ("s1", s1), ("ret", ret), ("end", end))}
            rows.append(dict(step=i, refresh_ms=t["s1"] - t["s0"],
                             main_after_dispatch_ms=t["end"] - t["ret"],
                             overlap_ms=max(0.0, min(t["s1"], t["end"])
                                            - max(t["s0"], t["ret"])),
                             inv_dispatch_s=m["phase_s"]["inv"],
                             train_s=m["phase_s"]["train"]))
    streams = ops.launch_streams()["neumann_inv"]
    out["async"] = {"losses": losses, "wall_s": time.perf_counter() - t0,
                    "launches": ops.launch_counts(),
                    "neumann_inv_streams": {str(k): v
                                            for k, v in streams.items()},
                    "side_stream": refresher.stream.cuda_stream,
                    "main_stream": torch.cuda.default_stream(
                        dev).cuda_stream,
                    "dispatched": refresher.n_dispatched,
                    "swapped": refresher.n_swapped,
                    "overlap": rows,
                    "params_digest": train_mod.params_digest(state.params)}
    del state, step_fn, prog, refresher
    torch.cuda.empty_cache()

    # (c) the SGD baseline
    prog = train_mod.SGDProgram(cfg, lr=SOLVERS["sgd_lr"], seed=MAIN["seed"],
                                device=dev, mesh=mesh)
    ops.reset_launch_counts()
    state, hist = train_mod.run(prog, ds, SOLVERS["sgd_steps"])
    out["sgd"] = {"losses": [h["loss"] for h in hist],
                  "launches": ops.launch_counts(),
                  "params_digest": train_mod.params_digest(state[0])}
    del state, prog
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def ranks_solvers_phase(torch, dev, check):
    """Phase ``ranks_solvers``: ``--smw``, ``--async-inv`` and the SGD
    baseline across two gloo ranks sharing ``cuda:0`` on a ``(2, 1)``
    mesh, the main path's model at fp32 (:func:`solvers_rank` on each),
    against the same runs on one rank in this process first. Gates: (a)
    ``--smw``: the fallback steps the same on both ranks and on one
    rank, ``smw_update`` launched on each rank, the inverses bitwise
    equal across the ranks, rank 0's first SMW-only update through the
    kernel within :data:`REL_TOL_RUN` of the plain version on every
    leaf, the losses within :data:`SOLVERS`' ``loss_tol`` of one rank's;
    (b) ``--async-inv --dist-inv``: every ``neumann_inv`` launch on the
    refresher's side stream (counted by stream), 2 dispatched and 1
    swapped, the losses within ``loss_tol`` of one rank's
    ``--async-inv``; the refresh's overlap with the main stream printed
    (gloo's: its collectives copy through the host); (c) SGD: the losses
    within ``loss_tol`` of one rank's, no kernel launched. A failed rank
    fails the phase."""
    from repro_torch.dist.spawn import backend_for, run_ranks
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod

    t0 = time.perf_counter()
    cfg, kcfg, ds = pp_setup()
    torch.cuda.empty_cache()
    one = {}
    _, hist = train_mod.run(train_mod.KFACProgram(
        cfg, kcfg, seed=MAIN["seed"], device=dev, smw=True,
        smw_rank=SMW["rank"], smw_drift_budget=SMW["drift_budget"]), ds,
        SOLVERS["smw_steps"])
    one["smw"] = ([h["loss"] for h in hist],
                  [h["smw_fallback"] for h in hist])
    _, hist = train_mod.run(train_mod.KFACProgram(
        cfg, kcfg, seed=MAIN["seed"], device=dev, async_inv=True), ds,
        SOLVERS["async_steps"])
    one["async"] = [h["loss"] for h in hist]
    _, hist = train_mod.run(train_mod.SGDProgram(
        cfg, lr=SOLVERS["sgd_lr"], seed=MAIN["seed"], device=dev), ds,
        SOLVERS["sgd_steps"])
    one["sgd"] = [h["loss"] for h in hist]
    del hist
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ranks = run_ranks(solvers_rank, 2, device="cuda", timeout=600)
    spawn_s = time.perf_counter() - t1
    tol = SOLVERS["loss_tol"]

    def within(xs, ys):
        return len(xs) == len(ys) and all(
            math.isfinite(x) and abs(x - y) <= tol * abs(y)
            for x, y in zip(xs, ys))

    def rel(xs, ys):
        return [abs(x - y) / abs(y) for x, y in zip(xs, ys)]

    r0 = ranks[0]
    for r in ranks:
        tag = f"ranks_solvers rank {r['rank']}"
        a, b, c = r["smw"], r["async"], r["sgd"]
        check(a["fallbacks"] == r0["smw"]["fallbacks"] == one["smw"][1],
              f"{tag} (a): the fallback steps the same on both ranks and "
              f"on one rank")
        check(a["launches"]["smw_update"] > 0,
              f"{tag} (a): smw_update launched")
        check(a["inverses_digest"] == r0["smw"]["inverses_digest"],
              f"{tag} (a): the inverses bitwise equal across the ranks")
        check(within(a["losses"], one["smw"][0]),
              f"{tag} (a): losses within {tol} of one rank's")
        check(set(b["neumann_inv_streams"]) == {str(b["side_stream"])}
              and b["side_stream"] != b["main_stream"]
              and sum(b["neumann_inv_streams"].values())
              == b["launches"]["neumann_inv"] > 0,
              f"{tag} (b): every neumann_inv launch on the side stream")
        check((b["dispatched"], b["swapped"]) == (2, 1),
              f"{tag} (b): 2 refreshes dispatched, 1 swapped in")
        check(within(b["losses"], one["async"])
              and b["params_digest"] == r0["async"]["params_digest"],
              f"{tag} (b): losses within {tol} of one rank's --async-inv, "
              f"params bitwise equal across the ranks")
        check(within(c["losses"], one["sgd"])
              and c["params_digest"] == r0["sgd"]["params_digest"]
              and not any(c["launches"].values()),
              f"{tag} (c): SGD losses within {tol} of one rank's, no "
              f"kernel launched")
    upd = r0["smw"].get("update_vs_plain", [])
    check(bool(upd) and max(u["rel_err"] for u in upd) <= REL_TOL_RUN,
          f"ranks_solvers (a): rank 0's first SMW-only update through the "
          f"kernel within {REL_TOL_RUN} of the plain version on every leaf")
    launches = {name: sum(r[run]["launches"][name] for r in ranks
                          for run in ("smw", "async", "sgd"))
                for name in ops.launch_counts()}
    return {"ranks": 2, "backend": backend_for("cuda", 2), "mesh": [2, 1],
            "seconds": time.perf_counter() - t0, "one_rank_s": one_s,
            "spawn_s": spawn_s,
            "smw": {"losses": r0["smw"]["losses"],
                    "one_rank_losses": one["smw"][0],
                    "rel_to_one_rank": rel(r0["smw"]["losses"],
                                           one["smw"][0]),
                    "fallbacks": r0["smw"]["fallbacks"],
                    "drifts": r0["smw"]["drifts"],
                    "phase_s": r0["smw"]["phase_s"],
                    "wall_s": [r["smw"]["wall_s"] for r in ranks],
                    "launches": [r["smw"]["launches"] for r in ranks],
                    "update_vs_plain_worst": max(
                        (u["rel_err"] for u in upd), default=None),
                    "update_leaves": len(upd)},
            "async": {"losses": r0["async"]["losses"],
                      "one_rank_losses": one["async"],
                      "rel_to_one_rank": rel(r0["async"]["losses"],
                                             one["async"]),
                      "launches": [r["async"]["launches"] for r in ranks],
                      "neumann_inv_streams": [
                          r["async"]["neumann_inv_streams"] for r in ranks],
                      "overlap_gloo": [r["async"]["overlap"]
                                       for r in ranks],
                      "wall_s": [r["async"]["wall_s"] for r in ranks]},
            "sgd": {"losses": r0["sgd"]["losses"],
                    "one_rank_losses": one["sgd"],
                    "rel_to_one_rank": rel(r0["sgd"]["losses"],
                                           one["sgd"])},
            "launches": launches,
            "peak_mem_gb": [r["peak_mem_gb"] for r in ranks]}


def large_blocks_phase(torch, dev, check):
    """Phase ``large_blocks``: the kernels' route for sides of 129..1024
    (``csrc/hilo_tma.cuh``). (a) ``neumann_inv``
    at :data:`LARGE`'s sides and ``fused_precond`` (indexed, as the WU
    calls it, and gathered) at its tile shapes against their plain
    versions, each timed (CUDA events, warm, median of 5) beside its
    plain version, its library call and its bound (``fused_precond``:
    also the route's bytes floor, ``wu_schedule``), and a grouped call
    over leaves of mixed sides bitwise the per-leaf calls; (b) the main
    path's model and traffic at block 256 (sides 256 and 176): 4 steps
    of ``launch.train.run`` with the launch counters zeroed just before and
    read just after (both kernels on both sides, the counts the plans
    give), finite losses, phase seconds and peak memory, the whole
    refresh of its last stats step timed (beside ``torch.linalg.inv`` of
    the same damped blocks, its bound and the schedule's bytes floor,
    ``neumann_inv.schedule_bytes``), the run's inverses and its
    largest WU group against the plain versions (``kfac_kernel_checks``);
    (c) one step at the reference's default block 1024 (sides 1024 and
    176): its refresh and WU through the same checks, peak memory;
    (d) ``smw_update`` and ``fused_gram_inv`` on their large routes
    against their plain versions, float64, their own repeats and the
    plans' launches, timed beside the plain versions, the library calls
    and the bounds (``fused_gram_inv`` also against the two-step route);
    (e) ``--smw`` at block 256 on the main path's model and traffic: 4
    steps at rank 64, then 2 at :data:`LARGE`'s ``smw_rank`` (the seeding
    step and one SMW step, the solve above 128), launches by side and
    rank, and each run's first SMW step updated again
    (:func:`smw_step_again`); (f) ``fused_gram_inv`` at block 256 on the
    main path's first batch, every A leaf (:func:`hold_fused_gram`).
    Returns the phase's record."""
    from repro_torch.configs import get_config
    from repro_torch.core import kfac, soi
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import fused_gram_solve as kg
    from repro_torch.kernels import fused_precond as kf
    from repro_torch.kernels import neumann_inv as kn
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import smw_update as ks
    from repro_torch.launch import train as train_mod

    import gc

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(MAIN["seed"])
    prods = (5 * KFAC_COUNTS["ns_iters"]
             + 5 * (KFAC_COUNTS["taylor_terms"] - 1)
             + 6 * KFAC_COUNTS["refine_steps"])

    def damped(nb, n):
        m = torch.randn(nb, n, 2 * n, device=dev, generator=gen)
        a = m @ m.transpose(-1, -2) / (2 * n)
        return a, soi.tikhonov_damping(a, 0.03)

    def inv_bound(nb, n):
        # each block read once, its inverse written once, the damping read
        return bound(4.0 * (2 * nb * n * n + nb), 2.0 * n ** 3 * prods * nb)

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    # (a) the kernels against their plain versions
    inv_rows = []
    for nb, n in LARGE["sides"]:
        a, lam = damped(nb, n)
        eye = torch.eye(n, device=dev)
        ops.reset_launch_counts()
        got = ops.neumann_inv(a, lam, **KFAC_COUNTS)
        torch.cuda.synchronize(dev)
        launches = ops.launch_counts()["neumann_inv"]
        want = ref.neumann_inv_ref(a, lam, **KFAC_COUNTS)
        exact = torch.linalg.inv(a.double() + lam.double()[:, None, None]
                                 * eye.double())
        b_ms, b_by = inv_bound(nb, n)
        row = dict(
            blocks=nb, n=n, rel_err=rel(got, want),
            max_abs_err=float((got - want).abs().max()),
            plain_rel_to_float64=rel(want.double(), exact),
            kernel_rel_to_float64=rel(got.double(), exact),
            launches=launches,
            repeat_bitwise=torch.equal(got, ops.neumann_inv(
                a, lam, **KFAC_COUNTS)),
            ms=time_ms(torch, lambda: ops.neumann_inv(a, lam,
                                                      **KFAC_COUNTS)),
            plain_ms=time_ms(torch, lambda: ref.neumann_inv_ref(
                a, lam, **KFAC_COUNTS)),
            library_ms=time_ms(torch, lambda: torch.linalg.inv(
                a + lam[:, None, None] * eye)),
            bound_ms=b_ms, bound_by=b_by)
        inv_rows.append(row)
        check(row["rel_err"] <= REL_TOL,
              f"large_blocks: neumann_inv n={n} vs plain")
        check(launches == kn.expected_launches({n: [nb]}, **KFAC_COUNTS),
              f"large_blocks: neumann_inv n={n} launches")
        check(row["repeat_bitwise"],
              f"large_blocks: neumann_inv n={n} bitwise its repeat")
        del a, lam, got, want, exact

    leaves = [damped(nb, n) for nb, n in LARGE["grouped"]]
    blocks, lams = [x for x, _ in leaves], [y for _, y in leaves]
    sides = {}
    for nb, n in LARGE["grouped"]:
        sides.setdefault(n, []).append(nb)
    ops.reset_launch_counts()
    grouped = ops.neumann_inv_grouped(blocks, lams, **KFAC_COUNTS)
    torch.cuda.synchronize(dev)
    g_launches, g_keys = ops.launch_counts()["neumann_inv"], \
        ops.launch_keys()["neumann_inv"]
    per_leaf = [ops.neumann_inv(x, y, **KFAC_COUNTS) for x, y in leaves]
    grouped_row = dict(
        leaves=[[nb, n] for nb, n in LARGE["grouped"]],
        launches=g_launches, launch_keys=g_keys,
        bitwise_equal_per_leaf=all(torch.equal(x, y)
                                   for x, y in zip(grouped, per_leaf)))
    check(grouped_row["bitwise_equal_per_leaf"],
          "large_blocks: grouped mixed sides bitwise the per-leaf calls")
    check(g_launches == kn.expected_launches(sides, **KFAC_COUNTS),
          "large_blocks: grouped launches")
    del leaves, blocks, lams, grouped, per_leaf

    wu_rows = []
    run = LARGE["pool_run"]
    for nt, bi, bo in LARGE["tiles"]:
        na = -(-nt // run)
        ng = max(1, min(run, nt))
        pa = torch.randn(na, bi, bi, device=dev, generator=gen)
        pg = torch.randn(ng, bo, bo, device=dev, generator=gen)
        g = torch.randn(nt, bi, bo, device=dev, generator=gen)
        t = torch.arange(nt, device=dev)
        a_src = (t // run).to(torch.int32)
        g_src = (t % ng).to(torch.int32)
        a_idx, g_idx = a_src.long(), g_src.long()
        a_sel, g_sel = pa[a_idx], pg[g_idx]
        ops.reset_launch_counts()
        out, dots = ops.fused_precond(pa, g, pg, a_src, g_src)
        torch.cuda.synchronize(dev)
        launches = ops.launch_counts()["fused_precond"]
        p_out, p_dots = ref.fused_precond_ref(pa, g, pg, a_src, g_src)
        gout, gdots = ops.fused_precond(a_sel, g, g_sel)
        flops = 2.0 * nt * 3 * (bi * bi * bo + bi * bo * bo)
        b_ms, b_by = bound(4.0 * (2 * nt * bi * bo + nt + na * bi * bi
                                  + ng * bo * bo), flops)
        gb_ms, gb_by = bound(4.0 * nt * (bi * bi + 2 * bi * bo + bo * bo
                                         + 1), flops)
        floor_ms, _ = bound(kf.wu_schedule(nt, bi, bo, (na, ng))
                            .floor_bytes, 0.0)
        again = ops.fused_precond(pa, g, pg, a_src, g_src)
        row = dict(
            shape=[nt, bi, bo], pool_blocks=[na, ng], rel_err=rel(out, p_out),
            max_abs_err=float((out - p_out).abs().max()),
            dots_rel_err=rel(dots, p_dots), launches=launches,
            gathered_bitwise=torch.equal(out, gout)
            and torch.equal(dots, gdots),
            repeat_bitwise=torch.equal(out, again[0])
            and torch.equal(dots, again[1]),
            ms=time_ms(torch, lambda: ops.fused_precond(pa, g, pg, a_src,
                                                        g_src)),
            plain_ms=time_ms(torch, lambda: ref.fused_precond_ref(
                pa, g, pg, a_src, g_src)),
            # the library call: the gather + fp32 matmul chain
            library_ms=time_ms(torch, lambda: torch.matmul(
                torch.matmul(pa[a_idx], g), pg[g_idx])),
            bound_ms=b_ms, bound_by=b_by,
            # the design's bytes floor (kernels.fused_precond.wu_schedule)
            floor_ms=floor_ms,
            gathered_ms=time_ms(torch, lambda: ops.fused_precond(
                a_sel, g, g_sel)),
            gathered_library_ms=time_ms(torch, lambda: torch.matmul(
                torch.matmul(a_sel, g), g_sel)),
            gathered_bound_ms=gb_ms, gathered_bound_by=gb_by)
        wu_rows.append(row)
        check(row["rel_err"] <= REL_TOL and row["dots_rel_err"] <= REL_TOL,
              f"large_blocks: fused_precond {bi}x{bo} vs plain")
        check(row["gathered_bitwise"],
              f"large_blocks: fused_precond {bi}x{bo} indexed bitwise "
              f"gathered")
        check(row["repeat_bitwise"],
              f"large_blocks: fused_precond {bi}x{bo} bitwise its repeat")
        check(launches == kf.expected_launches(nt, bi, bo),
              f"large_blocks: fused_precond {bi}x{bo} launches")
        del pa, pg, g, out, dots, p_out, p_dots, gout, gdots, a_sel, g_sel
        del again
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the main path's model at block 256, (c) one step at block 1024
    cfg = get_config(MAIN["arch"])
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=MAIN["seq"],
                         global_batch=MAIN["batch"], seed=MAIN["seed"])
    runs = {}
    for tag, block, steps in (("block_256", LARGE["block_size"],
                               MAIN["steps"]),
                              ("block_1024", LARGE["default_block"], 1)):
        t_run = time.perf_counter()
        bs = min(block, cfg.soi_block)
        kcfg = kfac.KFACConfig(
            stats_every=MAIN["stats_every"], inv_every=MAIN["inv_every"],
            block_size=bs, stats_batch=MAIN["batch"], stats_seq=MAIN["seq"])
        program = train_mod.KFACProgram(cfg, kcfg, seed=MAIN["seed"],
                                        device=dev)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = train_mod.run(program, ds, steps)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches, keys = ops.launch_counts(), ops.launch_keys()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        losses = [h["loss"] for h in hist]
        name = f"large_blocks {tag}"
        check(all(math.isfinite(x) for x in losses), f"{name}: finite losses")
        wu = train_mod.steps_mod.make_wu_plan_for(cfg, state)
        per_refresh = kfac_launch_checks(check, name, state, hist,
                                         launches, wu)
        sides = leaves_by_side(state.kfac.factors)
        check({f"n{n}" for n in sides} == set(keys["neumann_inv"]),
              f"{name}: neumann_inv launched on every side")
        check({f"{g.bi}x{g.bo}" for g in wu.groups}
              == set(keys["fused_precond"]),
              f"{name}: fused_precond launched on every tile shape")
        check(min(sides) > 128,
              f"{name}: every side takes the large route")
        # the whole refresh of the run's last factors, one grouped call
        flats, lams = [], []
        for d in state.kfac.factors.values():
            for f in d.values():
                flat = f.reshape(-1, f.shape[-1], f.shape[-1])
                flats.append(flat)
                lams.append(soi.tikhonov_damping(flat, kcfg.damping))
        nbs = {n: sum(v) for n, v in sides.items()}
        ops_total = sum(2.0 * n ** 3 * prods * nb for n, nb in nbs.items())
        bytes_total = sum(4.0 * (2 * nb * n * n + nb)
                          for n, nb in nbs.items())
        b_ms, b_by = bound(bytes_total, ops_total)
        # the schedule's own traffic: its state passes through device
        # memory between products
        design_ms, _ = bound(sum(
            nb * kn.schedule_bytes(n, **KFAC_COUNTS)
            for n, nb in nbs.items()), 0.0)
        torch.cuda.reset_peak_memory_stats(dev)
        whole_ms = time_ms(torch, lambda: ops.neumann_inv_grouped(
            flats, lams, **KFAC_COUNTS), 3)
        refresh_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        by_n = {}
        for x, y in zip(flats, lams):
            by_n.setdefault(x.shape[-1], []).append((x, y))
        damped_sides = {n: torch.cat([x + y[:, None, None] * torch.eye(
            n, device=dev) for x, y in v]) for n, v in by_n.items()}
        del by_n
        lib_ms = time_ms(torch, lambda: [torch.linalg.inv(x) for x in
                                         damped_sides.values()], 3)
        del damped_sides
        refresh_all = dict(
            sides={str(n): nb for n, nb in nbs.items()},
            launches=per_refresh, ms=whole_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, design_bytes_ms=design_ms,
            peak_mem_gb=refresh_peak,
            workspace_gb={str(n): max(w for _, _, w in kn.large_plan(v, n))
                          / 1e9 for n, v in sides.items()})
        del flats, lams
        box = {"state": state}
        del state, program
        worst, refresh_row, precond_row = kfac_kernel_checks(
            torch, dev, check, name, box, kcfg, wu,
            reps=5 if block <= 256 else 3, every_group=block == 256)
        runs[tag] = dict(
            block_size=bs, steps=steps, losses=losses,
            phase_s=[h["phase_s"] for h in hist],
            wu_ms=[h["phase_s"].get("wu", 0.0) * 1e3 for h in hist],
            wall_s=wall,
            peak_mem_gb=peak, launches=launches, launch_keys=keys,
            neumann_inv_per_refresh=per_refresh,
            wu_groups=[[g.n_tiles, g.bi, g.bo] for g in wu.groups],
            inv_blocks=wu.inv_plan.total_blocks, wu_tiles=wu.total_tiles,
            refresh_all=refresh_all, worst_inverse=worst,
            refresh=refresh_row, fused_precond=precond_row,
            seconds=time.perf_counter() - t_run)
        gc.collect()
        torch.cuda.empty_cache()
    smw_rows, gram_rows = large_solve_kernels(torch, dev, check, gen)
    bs = LARGE["block_size"]
    kcfg = kfac.KFACConfig(
        stats_every=MAIN["stats_every"], inv_every=MAIN["inv_every"],
        block_size=bs, stats_batch=MAIN["batch"], stats_seq=MAIN["seq"])

    # (e) --smw at block 256: rank 64 for SMW's steps, then the seeding
    # step and one SMW step at the larger rank
    for tag, rank, steps in (("smw_256", SMW["rank"], SMW["steps"]),
                             ("smw_256_rank256", LARGE["smw_rank"], 2)):
        t_run = time.perf_counter()
        program = train_mod.KFACProgram(
            cfg, kcfg, seed=MAIN["seed"], device=dev, smw=True,
            smw_drift_budget=SMW["drift_budget"], smw_rank=rank)
        kept = {}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = train_mod.run(program, ds, steps,
                                    on_step=smw_keeper(kept))
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches, keys = ops.launch_counts(), ops.launch_keys()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        losses = [h["loss"] for h in hist]
        fallbacks = sum(h["smw_fallback"] for h in hist)
        name = f"large_blocks {tag}"
        check(all(math.isfinite(x) for x in losses), f"{name}: finite losses")
        sides = leaves_by_side(state.kfac.factors)
        k = min(rank, MAIN["batch"] * MAIN["seq"])
        want_keys = {ks.launch_key(n, k): steps * sum(
            ks.expected_launches(n, k, nb) for nb in nbs)
            for n, nbs in sides.items()}
        check(set(sides) == {256, 176}, f"{name}: sides 256 and 176")
        check(keys["smw_update"] == want_keys,
              f"{name}: smw_update on both sides, the launches of its "
              f"plans")
        check(launches["neumann_inv"]
              == fallbacks * kn.expected_launches(sides, **KFAC_COUNTS),
              f"{name}: neumann_inv's large route a gate fallback")
        check("factors" in kept, f"{name}: an SMW step without a fallback")
        del state, program
        gc.collect()
        torch.cuda.empty_cache()
        rows = smw_step_again(torch, dev, check, cfg, kcfg, ds, rank, kept,
                              label=f"{name}: ")
        runs[tag] = dict(
            block_size=bs, rank=rank, k=k, steps=steps, losses=losses,
            drift=[h["smw_drift"] for h in hist],
            fallback=[h["smw_fallback"] for h in hist],
            phase_s=[h["phase_s"] for h in hist], wall_s=wall,
            peak_mem_gb=peak, launches=launches, launch_keys=keys,
            bits_step=kept.get("step"), bits=rows,
            **{"min_" + key: min((r[key] for r in rows), default=None)
               for key in ("bits_smw", "bits_kernel", "bits_plain",
                           "bits_woodbury64", "bits_full_reinversion")},
            max_rel_err_vs_plain=max((r["rel_err_vs_plain"] for r in rows),
                                     default=None),
            update_ms=sum(r["ms"] for r in rows),
            update_library_ms=sum(r["library_ms"] for r in rows),
            update_bound=bound(sum(r["bytes"] for r in rows),
                               sum(r["flops"] for r in rows),
                               sum(r["fp32_flops"] for r in rows)),
            seconds=time.perf_counter() - t_run)
        kept.clear()

    # (f) fused_gram_inv at block 256 on the main path's first batch
    t_run = time.perf_counter()
    damping = kfac.KFACConfig().damping
    fg_kw = dict(rel_damp=damping, **KFAC_COUNTS)
    acts = first_batch_acts(torch, dev, cfg, kcfg, ds)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fused = {leaf: ops.fused_gram_inv(x, **fg_kw) for leaf, x in acts.items()}
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches, keys = ops.launch_counts(), ops.launch_keys()
    want = {"fused_gram_inv": 0, "neumann_inv": 0}
    for x in acts.values():
        for lib, c in kg.expected_launches(x.shape, x.dtype,
                                           **KFAC_COUNTS).items():
            want[lib] += c
    check({x.shape[-1] for x in acts.values()} == {256, 176},
          "large_blocks gram_256: A sides 256 and 176")
    check({lib: launches[lib] for lib in want} == want,
          "large_blocks gram_256: the launches of the plans")
    report = hold_fused_gram(torch, dev, check, acts, fused, fg_kw, damping,
                             label="large_blocks gram_256: ")
    runs["gram_256"] = dict(
        leaves={leaf: list(x.shape) for leaf, x in acts.items()},
        wall_s=wall, launches={lib: launches[lib] for lib in want},
        launch_keys=keys["fused_gram_inv"], fused_gram_inv=report,
        min_bits_fused=min(r["bits_fused"] for r in report),
        min_bits_two_step=min(r["bits_two_step"] for r in report),
        seconds=time.perf_counter() - t_run)
    del acts, fused
    gc.collect()
    torch.cuda.empty_cache()
    return dict(neumann_inv=inv_rows, grouped=grouped_row,
                fused_precond=wu_rows, smw_update=smw_rows,
                fused_gram_inv=gram_rows, **runs,
                phase_seconds=time.perf_counter() - t_phase)


def main() -> int:
    t_script = time.perf_counter()
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
    from repro_torch.data.pipeline import DataCursor, SyntheticTokens
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
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, smw_hist = train_mod.run(smw_prog, ds, SMW["steps"],
                                on_step=smw_keeper(kept))
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

    # that step's update again (smw_step_again)
    smw_bits = smw_step_again(torch, dev, check, cfg, kcfg, ds, SMW["rank"],
                              kept)

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

    # the main path's first batch, for every A leaf (all of block width
    # 128 here)
    acts_run = first_batch_acts(torch, dev, cfg, kcfg, ds)

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

    fused_report = hold_fused_gram(torch, dev, check, acts_run, fused,
                                   fg_kw, damping)
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
    serve_tokens = serve_row.pop("engine_tokens")
    emit({"phase": "serve", "nvidia_smi": smi, **serve_row})

    # 15. paged: the block-paged pool, the prefix cache and int8 serving
    # (P1-P7); no kernel
    paged_row = paged_phase(torch, dev, check, serve_tokens)
    emit({"phase": "paged", "nvidia_smi": smi, **paged_row})

    # 16. paper: the pimsim tables, the Fig. 3/4(b) studies, kernel_bench
    # and kfac_convergence on the card, the open check's answer, and Sec.
    # VI-C at full width (composed, exact and SGD arms, 60 steps each)
    paper_row = paper_phase(torch, dev, check, losses, ex_losses)
    emit({"phase": "paper", "nvidia_smi": smi, **paper_row})

    # 17. tooling: the reference's single-device benchmarks and examples
    # (precision_ladder, wu_fusion, serve_engine, serve_scale,
    # obs_overhead; quickstart, precision_inv_demo, serve_batched,
    # train_kfac_100m)
    tooling_row = tooling_phase(torch, dev, check)
    emit({"phase": "tooling", "nvidia_smi": smi, **tooling_row})

    # 18. large_blocks: the kernels' route for sides of 129..1024: the
    # kernels against their plain versions, the main path's model at
    # block 256, one step at the reference's default block 1024, then
    # smw_update and fused_gram_inv above 128, --smw at block 256 and the
    # Gram inverse of its first batch
    t0 = time.perf_counter()
    large_row = large_blocks_phase(torch, dev, check)
    emit({"phase": "large_blocks", "nvidia_smi": smi, **large_row})

    # 19. dist: the main path over two ranks on the one card (or a rank
    # a card): the distributed refresh at blocks 128 and 256, the fused
    # INV->VMM program, 4 data-parallel steps, the compressed all-reduce
    dist_row = dist_phase(torch, dev, check, losses)
    emit({"phase": "dist", "nvidia_smi": smi, **dist_row})

    # 20. tp: the main path's model split megatron-style over two model
    # ranks (--model-parallel 2 --dist-inv), at fp32 and bf16 compute,
    # its split refresh and a checkpoint of the full state
    tp_row = tp_phase(torch, dev, check, losses,
                      dist_row["fp32_one_rank_losses"])
    emit({"phase": "tp", "nvidia_smi": smi, **tp_row})

    # 21. ep: the MoE family's experts split over two model ranks
    # (--model-parallel 2 --dist-inv) at published widths, against one
    # rank; its refresh and WU on each rank's own experts, the router
    # across ranks, a checkpoint of the gathered state
    torch.cuda.empty_cache()
    ep_row = ep_phase(torch, dev, check)
    emit({"phase": "ep", "nvidia_smi": smi, **ep_row})

    # 22. pp: the main path's model over two pipeline stages (--pp 2
    # --dist-inv) on two ranks sharing the card, against one rank at
    # train_accum 2: the same inputs' loss, gradients, statistics and
    # refresh, 4 steps under 1F1B and GPipe, each stage's kernels, blocks,
    # tiles and stash
    torch.cuda.empty_cache()
    pp_row = pp_phase(torch, dev, check)
    emit({"phase": "pp", "nvidia_smi": smi, **pp_row})

    # 23. elastic: the main path's model at fp32 on two ranks with
    # --dist-inv, a device lost at step 3; the survivor re-forms (1, 1),
    # restores and ends the run
    torch.cuda.empty_cache()
    elastic_row = elastic_phase(torch, dev, check)
    emit({"phase": "elastic", "nvidia_smi": smi, **elastic_row})

    # 24. ranks_solvers: --smw, --async-inv --dist-inv and the SGD
    # baseline on the same two ranks, against one rank
    torch.cuda.empty_cache()
    solvers_row = ranks_solvers_phase(torch, dev, check)
    emit({"phase": "ranks_solvers", "nvidia_smi": smi, **solvers_row})

    # 25. trace: the main path's fourth step (FP, BP and WU only) under
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

    emit({"phase": "timing", "script_seconds": time.perf_counter() - t_script,
          "dist_seconds": dist_row["seconds"],
          "tp_seconds": tp_row["seconds"],
          "ep_seconds": ep_row["seconds"],
          "pp_seconds": pp_row["seconds"],
          "elastic_seconds": elastic_row["seconds"],
          "ranks_solvers_seconds": solvers_row["seconds"],
          "tooling_seconds": tooling_row["phase_seconds"],
          "large_blocks_seconds": large_row["phase_seconds"]})
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
    # the large route at the main path's model and block 256 (phase
    # large_blocks (b): its launches; the whole refresh and the largest
    # WU group, timed)
    b256 = large_row["block_256"]
    large_route = {
        "neumann_inv": dict(
            launches=b256["launches"]["neumann_inv"],
            refresh_ms=b256["refresh_all"]["ms"],
            refresh_library_ms=b256["refresh_all"]["library_ms"],
            refresh_bound_ms=b256["refresh_all"]["bound_ms"],
            refresh_design_bytes_ms=b256["refresh_all"]["design_bytes_ms"],
            largest_side=b256["refresh"]),
        "fused_precond": dict(
            launches=b256["launches"]["fused_precond"],
            wu_ms=b256["wu_ms"],
            groups_ms=b256["fused_precond"]["groups_ms"],
            groups_library_ms=b256["fused_precond"]["groups_library_ms"],
            largest_group={k: v for k, v in b256["fused_precond"].items()
                           if k != "groups"})}
    # smw_update's and fused_gram_inv's large routes (phase large_blocks:
    # (e) and (f)'s launches, (d)'s timed shapes at block 256 and 1024)
    timed = [r for r in large_row["smw_update"] if "ms" in r]
    smw_run, rank_run = large_row["smw_256"], large_row["smw_256_rank256"]
    large_route["smw_update"] = dict(
        launches=smw_run["launches"]["smw_update"],
        launch_keys=smw_run["launch_keys"]["smw_update"],
        rank256_launches=rank_run["launches"]["smw_update"],
        rank256_launch_keys=rank_run["launch_keys"]["smw_update"],
        update_ms=smw_run["update_ms"],
        update_library_ms=smw_run["update_library_ms"],
        rank256_update_ms=rank_run["update_ms"],
        rank256_update_library_ms=rank_run["update_library_ms"],
        block_256=next(r for r in timed if (r["bs"], r["k"]) == (256, 64)),
        largest=timed[-1])
    grams = [r for r in large_row["fused_gram_inv"] if r["dtype"] == "fp32"]
    large_route["fused_gram_inv"] = dict(
        launches=large_row["gram_256"]["launches"],
        launch_keys=large_row["gram_256"]["launch_keys"],
        block_256=next(r for r in grams if r["shape"][2] == 256),
        largest=grams[-1])
    # whisper's launches beside them, the serving phases' (none: the
    # serving path runs no TPU kernel's counterpart) and the paper
    # phase's (its driven runs together)
    emit({"kernels": [dict(name=name, launches=path_launches[name],
                           large_blocks_launches=b256["launches"][name],
                           large_route=large_route.get(name),
                           **{k: r[k] for k in keys},
                           whisper_launches=whisper_row["launches"][name],
                           serve_launches=serve_row["launches"][name],
                           paged_launches=paged_row["launches"][name],
                           paper_launches=sum(
                               c[name] for c in
                               paper_row["launches"].values()),
                           tooling_launches=sum(
                               c[name] for c in
                               tooling_row["launches"].values()),
                           dist_launches=dist_row["launches"][name],
                           tp_launches=tp_row["launches"][name],
                           ep_launches=ep_row["launches"][name],
                           pp_launches=pp_row["launches"][name],
                           elastic_launches=elastic_row["launches"][name],
                           ranks_solvers_launches=solvers_row[
                               "launches"][name])
                      for name, r in results.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
