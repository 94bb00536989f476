"""Greedy-token parity of the int8 engine against the fp32 engine
(counterpart of ``repro.lowp.serve_parity``).

Greedy parity under weight quantization is a well-posed claim only where
the fp32 decision margin (top-1 minus top-2 logit along the greedy path)
exceeds the logit perturbation the quantization causes. A random-init
model has near-flat logits (margins of a few hundredths at smoke size),
inside that perturbation, so parity there is a coin flip by
construction. After a brief training run the margins of in-distribution
prompts grow by about 10x and parity becomes a real invariant.

So the harness (a) trains the smoke model for a few dozen SGD steps,
(b) decodes in-distribution prompts through both engines, (c) reports
each request's match and its fp32 margin along the greedy path. The
contract: **every request whose margin clears ``margin_floor`` matches
exactly**; requests below the floor are reported and cannot fail.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.train import resolve_device

__all__ = ["MARGIN_FLOOR", "trained_params", "serve_greedy_parity"]

# fp32 margins below this lie within the int8 logit perturbation
# measured at smoke size: argmax there is not decided
MARGIN_FLOOR = 0.05


def trained_params(cfg, *, steps: int = 40, lr: float = 0.3,
                   batch: int = 8, seq: int = 32, seed: int = 0,
                   device="cuda", params: Optional[dict] = None):
    """A briefly trained checkpoint: ``steps`` of heavy-ball SGD
    (``steps.make_sgd_step``) on :class:`SyntheticTokens`, from
    ``params`` (default: the port's init from ``seed``). Returns
    ``(params, dataset)``."""
    device = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = steps_mod.init_params(cfg, generator=gen, device=device)
    sgd = steps_mod.make_sgd_step(cfg, lr=lr)
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    state = (params, {k: torch.zeros_like(v) for k, v in params.items()})
    for i in range(steps):
        state, _ = sgd(state, {"tokens": torch.from_numpy(
            ds.batch_slice(i, 0, batch)).to(device)})
    return {k: v.detach() for k, v in state[0].items()}, ds


def greedy_margin(cfg, params, prompt: np.ndarray, tokens) -> float:
    """The smallest top-1 minus top-2 logit over the positions that
    decided ``tokens`` after ``prompt``, from one forward pass over the
    prompt and the tokens."""
    mod = steps_mod.model_module(cfg)
    dev = next(iter(params.values())).device
    full = np.concatenate([prompt, np.asarray(tokens, np.int32)])
    with torch.no_grad():
        lg, _ = mod.forward(cfg, params, {"tokens": torch.from_numpy(
            full[None]).to(dev)})
    steps_lg = lg[0, len(prompt) - 1:-1].to(torch.float32)
    top2 = torch.topk(steps_lg, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def serve_greedy_parity(arch: str = "qwen2-0.5b", *,
                        n_requests: int = 6, prompt_len: int = 12,
                        new_tokens: int = 8, train_steps: int = 40,
                        seed: int = 0,
                        margin_floor: float = MARGIN_FLOOR,
                        device="cuda") -> dict:
    """The same greedy requests through the fp32 and the int8 engine on
    a briefly trained checkpoint (:func:`trained_params`). Returns
    per-request ``{"match", "margin"}`` records, both engines' resident
    bytes and the contract's counts:
    ``decided_total``/``decided_matched`` count only the requests whose
    fp32 margin clears ``margin_floor``."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    cfg = get_smoke_config(arch)
    params, ds = trained_params(cfg, steps=train_steps, seed=seed,
                                device=device)
    reqs = [Request(i, ds.batch_slice(100 + i, 0, 1)[0, :prompt_len]
                    .astype(np.int32), max_new_tokens=new_tokens)
            for i in range(n_requests)]
    arrival = list(np.arange(n_requests) // 2)

    def run(quant):
        eng = ServeEngine(cfg, params, EngineConfig(
            max_slots=2, max_len=48, decode_chunk=3, buckets=(16,),
            quant=quant))
        with torch.no_grad():
            out = eng.run(reqs, arrival)
        return out, eng.resident_bytes()

    out_fp, mem_fp = run("none")
    out_q, mem_q = run("int8")
    records = []
    for r in reqs:
        fp, q = out_fp[r.rid].tokens, out_q[r.rid].tokens
        records.append({"rid": r.rid, "match": fp == q,
                        "margin": greedy_margin(cfg, params, r.prompt, fp)})
    decided = [rec for rec in records if rec["margin"] >= margin_floor]
    return {
        "arch": arch,
        "records": records,
        "matched": sum(rec["match"] for rec in records),
        "total": len(records),
        "decided_matched": sum(rec["match"] for rec in decided),
        "decided_total": len(decided),
        "margin_floor": margin_floor,
        "mem_fp32": mem_fp,
        "mem_int8": mem_q,
        "param_reduction": mem_fp["params"] / mem_q["params"],
        "pool_reduction": mem_fp["pool"] / mem_q["pool"],
    }
