"""Serving driver on one GPU (counterpart of ``repro.launch.serve``):
the continuous-batching engine (default) or the fixed-batch path
(``--static``, and the only path for the vlm and audio families, whose
prompts carry modality inputs).

  python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 16 --max-slots 8 --prompt-len 512 --gen 64 --max-len 1024

runs the full-width model on CUDA; ``--smoke --device cpu`` runs the
reduced config on the CPU:

  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
      --device cpu --requests 6 --max-slots 2 --prompt-len 24 --gen 8
  python -m repro_torch.launch.serve --arch whisper-tiny --smoke \\
      --device cpu --batch 2 --prompt-len 4 --gen 8

Both paths sample on the device (greedy by default; ``--no-greedy``
samples with ``--temperature``/``--top-k`` from a generator seeded by
``--seed``) and run once before the timed run (``--warmup``). Weights
are random, from ``--seed``. Not ported yet, and refused: ``--paged``
and ``--prefix-cache`` (the block-paged pool, ``serve/paged.py``),
``--quant int8`` (``lowp/serve_quant.py``), both ROADMAP Queue 1 item
7, and ``--model-parallel`` above 1 (multi-GPU, item 8).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.train import fp32_matmuls, resolve_device
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               synthetic_trace)
from repro_torch.serve.sampling import make_sampler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; raises if CUDA is asked for and "
                         "absent")
    ap.add_argument("--static", action="store_true",
                    help="fixed-batch path (no continuous batching)")
    ap.add_argument("--batch", type=int, default=4,
                    help="static path: fixed batch size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-parallel devices; only 1 is ported")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="greedy decoding (default); --no-greedy "
                         "samples with --temperature / --top-k")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="with --no-greedy: restrict sampling to the "
                         "top-k logits (0 = full distribution)")
    ap.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run each path once before timing")
    # engine path
    ap.add_argument("--quant", choices=("none", "int8"), default="none",
                    help="resident weight and KV precision; int8 is not "
                         "ported yet")
    ap.add_argument("--requests", type=int, default=8,
                    help="engine path: synthetic trace size")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=0,
                    help="engine pool columns (0: prompt-len + gen)")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV pool (not ported yet)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix cache on the paged pool (not "
                         "ported yet)")
    # observability (repro_torch.obs)
    ap.add_argument("--obs", action="store_true",
                    help="enable the telemetry spine: TTFT/TPOT/queue/"
                         "occupancy metrics, spans, console summary")
    ap.add_argument("--obs-dir", default=None,
                    help="write JSONL events + Prometheus snapshot + "
                         "Chrome trace here (implies --obs)")
    ap.add_argument("--obs-annotate", action="store_true",
                    help="also enter torch.profiler.record_function for "
                         "every span")
    return ap


def check_ported(args) -> None:
    """Refuse the options whose code is not ported yet, naming where it
    waits; nothing falls back."""
    if args.paged or args.prefix_cache:
        raise NotImplementedError(
            "--paged/--prefix-cache: the block-paged pool "
            "(serve/paged.py, layers.paged_kv_read/write) and its prefix "
            "cache are not ported yet: ROADMAP Queue 1 item 7")
    if args.quant == "int8":
        raise NotImplementedError(
            "--quant int8: int8 serving (lowp/serve_quant.py) is not "
            "ported yet: ROADMAP Queue 1 item 7")
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs several GPUs: ROADMAP Queue 1 "
            "item 8")


def sampling_args(args) -> dict:
    if args.greedy:
        return {"method": "greedy", "temperature": 1.0, "top_k": 0}
    return {"method": "top_k" if args.top_k else "temperature",
            "temperature": args.temperature, "top_k": args.top_k}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_params(cfg, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return steps_mod.init_params(cfg, generator=gen, device=device)


def serve_engine(cfg, args, device, obs=None, params=None):
    """The engine on :func:`serve.synthetic_trace`; returns ``(summary,
    {rid: FinishedRequest})``."""
    obs = obs if obs is not None else obs_mod.NULL
    max_len = args.max_len or (args.prompt_len + args.gen)
    params = params if params is not None else init_params(
        cfg, args.seed, device)
    eng = ServeEngine(cfg, params, EngineConfig(
        max_slots=args.max_slots, max_len=max_len,
        decode_chunk=args.decode_chunk, seed=args.seed,
        quant=args.quant, **sampling_args(args)))
    reqs, arrivals = synthetic_trace(cfg.vocab, args.requests,
                                     args.prompt_len, args.gen,
                                     args.max_slots, seed=args.seed)
    if args.warmup:
        # every prefill bucket the trace will hit and a chunk, off the
        # clock; the warm-up requests free their slots, and their stats
        # are dropped
        buckets = {eng.scheduler.bucket_for(len(r.prompt)): r
                   for r in reqs}
        warm = [Request(-1 - i, r.prompt, max_new_tokens=max(
                    1, min(args.decode_chunk + 1, max_len - len(r.prompt))))
                for i, r in enumerate(buckets.values())]
        with obs.span("serve_warmup"):
            eng.run(warm)
        eng.reset_stats()
    eng.set_obs(obs)
    _sync(device)
    t0 = time.monotonic()
    with obs.span("serve_trace", fence=lambda: eng._tok):
        done = eng.run(reqs, arrivals=arrivals)
        _sync(device)
    wall = time.monotonic() - t0
    n_tok = sum(len(f.tokens) for f in done.values())
    st = eng.stats
    summary = {
        "schema": 1, "kind": "serve_summary", "arch": cfg.name,
        "mode": "engine", "device": str(device),
        "scheduler": {"queued": eng.scheduler.n_queued,
                      "free_slots": eng.scheduler.n_free},
        "sampling": sampling_args(args)["method"], "quant": args.quant,
        "resident_bytes": eng.resident_bytes(), "requests": len(done),
        "max_slots": args.max_slots, "max_len": max_len,
        "decode_chunk": args.decode_chunk, "generated_tokens": n_tok,
        "wall_s": wall, "prefill_s": st["prefill_s"],
        "decode_s": st["decode_s"],
        "decode_tok_per_s": st["decode_tokens"] / max(st["decode_s"], 1e-9),
        "tok_per_s": n_tok / max(wall, 1e-9),
        "ttft_s": {rid: f.ttft_s for rid, f in sorted(done.items())},
        "sample_tokens": done[0].tokens[:8] if 0 in done else [],
    }
    if obs.enabled:
        rb = summary["resident_bytes"]
        obs.gauge("serve_resident_params_bytes",
                  "resident weight-tree bytes").set(rb["params"])
        obs.gauge("serve_resident_pool_bytes",
                  "resident KV pool bytes").set(rb["pool"])
    return summary, done


def static_batch(cfg, args, device) -> dict:
    """The fixed batch's prompts: ``--batch`` rows of ``--prompt-len``
    synthetic tokens, with zero image embeddings and (3, B, T) positions
    for the vlm family and seeded frame embeddings
    (``steps.enc_len_for`` frames, the reference's numpy draws) for the
    audio family."""
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=args.prompt_len,
                         global_batch=args.batch, seed=args.seed)
    batch = {"tokens": torch.from_numpy(
        ds.batch_slice(0, 0, args.batch)).to(device)}
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.zeros(
            (args.batch, cfg.n_img_tokens, cfg.vision_dim), device=device)
        pos = torch.arange(args.prompt_len, dtype=torch.int32,
                           device=device).expand(args.batch, -1)
        batch["positions"] = torch.stack([pos, pos, pos])
    if cfg.family == "audio":
        frames = np.random.default_rng(args.seed).standard_normal(
            (args.batch, steps_mod.enc_len_for(cfg, args.prompt_len),
             cfg.d_model)).astype(np.float32)
        batch["enc_embeds"] = torch.from_numpy(frames).to(device)
    return batch


def serve_static(cfg, args, device, params=None):
    """Prefill a fixed batch, then ``--gen - 1`` decode steps; returns
    ``(summary, (batch, gen) generated tokens)``."""
    mod = steps_mod.model_module(cfg)
    total = args.prompt_len + args.gen
    sampler = make_sampler(**sampling_args(args))
    params = params if params is not None else init_params(
        cfg, args.seed, device)
    batch = static_batch(cfg, args, device)
    prefill = steps_mod.make_prefill_step(cfg)
    decode = steps_mod.make_decode_step(cfg)

    def make_cache():
        if cfg.family == "audio":
            return mod.init_cache(cfg, args.batch, total,
                                  steps_mod.enc_len_for(cfg,
                                                        args.prompt_len),
                                  device=device)
        return mod.init_cache(cfg, args.batch, total, device=device)

    def generate():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        cache = make_cache()
        _sync(device)
        t0 = time.monotonic()
        logits, cache = prefill(params, batch, cache)
        _sync(device)
        t_prefill = time.monotonic() - t0
        tok = sampler(logits, gen)[:, None]
        out = [tok]
        t1 = time.monotonic()
        for _ in range(args.gen - 1):
            logits, cache = decode(params, tok, cache)
            tok = sampler(logits, gen)[:, None]
            out.append(tok)
        _sync(device)
        return torch.cat(out, dim=1), t_prefill, time.monotonic() - t1

    t_warm0 = time.monotonic()
    if args.warmup:
        generate()
    t_warmup = time.monotonic() - t_warm0
    gen_tokens, t_prefill, t_decode = generate()
    gen_tokens = gen_tokens.cpu().numpy()
    summary = {
        "schema": 1, "kind": "serve_summary", "arch": cfg.name,
        "mode": "static", "device": str(device),
        "sampling": sampling_args(args)["method"], "batch": args.batch,
        "prompt_len": args.prompt_len, "generated": args.gen,
        "warmup_s": t_warmup, "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": args.batch * (args.gen - 1)
        / max(t_decode, 1e-9),
        "sample_tokens": gen_tokens[0, :8].tolist(),
    }
    return summary, gen_tokens


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    fp32_matmuls()
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    obs = obs_mod.from_args(args)
    with torch.no_grad():
        # vlm/audio prompts need modality inputs the engine does not
        # take: those archs serve on the fixed-batch path
        if args.static or cfg.family in ("vlm", "audio"):
            with obs.span("serve_static"):
                summary, out = serve_static(cfg, args, device)
        else:
            summary, out = serve_engine(cfg, args, device, obs=obs)
    if obs.enabled:
        paths = obs.flush(summary=summary)
        print(obs.console("serve summary"))
        if paths:
            print(json.dumps({"obs_artifacts": paths}, indent=1))
        obs.close()
    print(json.dumps(summary, indent=1))
    return summary, out


if __name__ == "__main__":
    main()
