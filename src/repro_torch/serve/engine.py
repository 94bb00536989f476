"""Continuous-batching serving engine (counterpart of
``repro.serve.engine``), on the contiguous slot pool.

* **Slot pool** (``serve.pool``): the decode cache's batch dim is slots;
  a finished request frees its slot and a queued one takes it mid-run.
* **Scheduler**: FIFO admission and length-bucketed prefill. Prompts are
  right-padded to a bucket length, the padded tail re-masked when the
  row enters the pool; the hybrid family prefills at the exact length
  (its windowed ring needs column c to hold position c).
* **Decode chunk**: ``decode_chunk`` single-token steps with on-device
  sampling, per-slot termination (token budget and EOS) and an active
  mask, launched back to back with no host read inside the chunk; the
  host reads the chunk's tokens once, harvests finished requests and
  admits queued ones. (The reference compiles the chunk as one
  ``lax.scan`` program.)

Token-only prompt families: dense, moe, ssm, hybrid. The vlm and audio
families need modality inputs at prefill and serve on the static path
(``launch.serve --static``), as in the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import NULL as NULL_OBS
from repro_torch.serve import pool as pool_mod
from repro_torch.serve.sampling import make_sampler


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One generation request."""

    rid: int
    prompt: np.ndarray              # (Tp,) int32 token ids
    max_new_tokens: int = 16
    eos_id: int = -1                # -1: no EOS termination


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    prompt: np.ndarray
    tokens: List[int]               # generated ids (EOS included if hit)
    finish_reason: str              # "length" | "eos"
    ttft_s: float = float("nan")    # submit -> first sampled token


@dataclasses.dataclass
class _SlotState:
    """Host-side record of the request occupying a slot."""

    req: Request
    tokens: List[int]
    ttft_s: float = float("nan")


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

def default_buckets(max_len: int, lo: int = 16) -> Tuple[int, ...]:
    """Power-of-two prefill buckets up to ``max_len``."""
    out, b = [], lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def synthetic_trace(vocab: int, n: int, prompt_len: int, gen: int,
                    max_slots: int, seed: int = 0):
    """The reference's synthetic mixed-length trace, bit for bit (numpy
    draws): prompt lengths in [prompt_len//2, prompt_len], budgets in
    [gen//2, gen], one arrival wave per ``max_slots`` requests. Returns
    ``(requests, arrivals)``."""
    rng = np.random.default_rng(seed)
    reqs, arrivals = [], []
    for i in range(n):
        tp = int(rng.integers(max(prompt_len // 2, 1), prompt_len + 1))
        g = int(rng.integers(max(gen // 2, 1), gen + 1))
        reqs.append(Request(
            i, rng.integers(0, vocab, size=tp).astype(np.int32),
            max_new_tokens=g))
        arrivals.append(i // max(max_slots, 1))
    return reqs, arrivals


class Scheduler:
    """Admission queue, slot bookkeeping and prefill length buckets."""

    def __init__(self, max_slots: int, buckets: Sequence[int],
                 exact: bool = False):
        self.queue: collections.deque = collections.deque()
        self.free: List[int] = list(range(max_slots))[::-1]
        self.buckets = tuple(sorted(buckets))
        self.exact = exact

    def bucket_for(self, n: int) -> int:
        """Prefill length for an ``n``-token prompt."""
        if self.exact:
            return n
        for b in self.buckets:
            if b >= n:
                return b
        return n

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def admit(self) -> List[Tuple[int, Request]]:
        """Pop ``(slot, request)`` pairs, FIFO, while a free slot and a
        queued request exist."""
        out = []
        while self.queue and self.free:
            out.append((self.free.pop(), self.queue.popleft()))
        return out

    def release(self, slot: int) -> None:
        self.free.append(slot)

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    @property
    def n_free(self) -> int:
        return len(self.free)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    max_len: int = 256              # per-slot cache columns
    decode_chunk: int = 8           # tokens per decode chunk
    method: str = "greedy"          # greedy | temperature | top_k
    temperature: float = 1.0
    top_k: int = 0
    buckets: Optional[Tuple[int, ...]] = None
    seed: int = 0
    # "int8" (resident int8 weights and KV cache) is not ported yet:
    # ROADMAP Queue 1 item 7, lowp/serve_quant
    quant: str = "none"


def tree_bytes(tree) -> int:
    """Bytes of the tensors in a flat dict."""
    return sum(t.numel() * t.element_size() for t in tree.values()
               if torch.is_tensor(t))


class ServeEngine:
    """The engine over ``params`` (the port's flat parameters, on the
    device the engine runs on). ``mesh`` must be None: one device."""

    def __init__(self, cfg, params, ecfg: EngineConfig, mesh=None,
                 obs=None):
        if cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"{cfg.family} requests need modality inputs at prefill; "
                "the continuous-batching engine serves token-only prompt "
                "families (dense/moe/ssm/hybrid)")
        if ecfg.quant == "int8":
            raise NotImplementedError(
                "int8 serving (resident int8 weights and KV cache) is not "
                "ported yet: ROADMAP Queue 1 item 7, lowp/serve_quant")
        if ecfg.quant != "none":
            raise ValueError(f"unknown quant mode {ecfg.quant!r}; "
                             "one of ('none', 'int8')")
        if mesh is not None:
            raise NotImplementedError(
                "a serving mesh is multi-GPU work: ROADMAP Queue 1 item 8")
        from repro_torch.launch import steps as steps_mod

        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.mod = steps_mod.model_module(cfg)
        self.device = next(iter(params.values())).device
        dev = self.device
        B = ecfg.max_slots
        self._pool = pool_mod.init_pool(cfg, B, ecfg.max_len, device=dev)
        self._empty = pool_mod.empty_row_like(self._pool)
        self._tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self._active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._remaining = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._eos = torch.full((B,), -1, dtype=torch.int32, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(ecfg.seed)

        # the hybrid's windowed ring needs slot column c == position c,
        # so its prompts prefill at their exact length; padded prefill
        # is safe elsewhere (pad columns are re-masked, and the
        # recurrent mixers take their state at the real boundary)
        self.scheduler = Scheduler(
            B, ecfg.buckets or default_buckets(ecfg.max_len),
            exact=cfg.family == "hybrid")
        self._slots: Dict[int, _SlotState] = {}
        self._t_submit: Dict[int, float] = {}
        self._sampler = make_sampler(ecfg.method, ecfg.temperature,
                                     ecfg.top_k)
        self.stats: Dict[str, Any] = {}
        self.reset_stats()
        self._obs = obs if obs is not None else NULL_OBS
        self._init_obs_handles()

    def set_obs(self, obs) -> None:
        """(Re)bind the observability sink (the CLI attaches it after
        the warm-up, so the histograms hold steady-state numbers)."""
        self._obs = obs if obs is not None else NULL_OBS
        self._init_obs_handles()

    def _init_obs_handles(self) -> None:
        o = self._obs
        if not o.enabled:
            return
        self._h_ttft = o.histogram(
            "serve_ttft_s", "submit -> first sampled token")
        self._h_tpot = o.histogram(
            "serve_tpot_s", "decode-chunk wall / tokens emitted")
        self._h_chunk = o.histogram(
            "serve_decode_chunk_s", "decode-chunk wall")
        self._h_prefill = o.histogram(
            "serve_prefill_s", "per-admission prefill wall")
        self._c_req = o.counter(
            "serve_requests_total", "requests submitted")
        self._c_fin = o.counter(
            "serve_finished_total", "requests finished, by reason")
        self._c_tok = o.counter(
            "serve_tokens_total", "decode tokens emitted")
        self._g_queue = o.gauge(
            "serve_queue_depth", "requests waiting for a slot")
        self._g_occ = o.gauge(
            "serve_slot_occupancy", "active slots / max_slots")

    def reset_stats(self) -> None:
        """Zero the counters (after a warm-up, so that timed numbers are
        steady-state only)."""
        self.stats.clear()
        self.stats.update({"prefills": 0, "decode_chunks": 0,
                           "decode_tokens": 0, "prefill_tokens": 0,
                           "prefill_s": 0.0, "decode_s": 0.0})

    # -- device programs ---------------------------------------------------

    def _prefill(self, tokens: torch.Tensor, length: int):
        """One request's prefill into a fresh one-slot cache."""
        cache = self.mod.init_cache(self.cfg, 1, self.ecfg.max_len,
                                    device=self.device)
        length_t = torch.full((1,), length, dtype=torch.int32,
                              device=self.device)
        return self.mod.prefill(self.cfg, self.params, {"tokens": tokens},
                                cache, length=length_t)

    def decode_chunk(self):
        """``decode_chunk`` model steps with sampling and termination,
        issued back to back with no host read: returns the chunk's
        tokens and which of them each slot emitted, both
        (chunk, max_slots) on the device. Inactive slots keep stepping
        on their last token; for dense and moe their cache writes are
        diverted past the last column (``idx`` -> ``max_len``) and
        dropped, so idle slots' columns stay bitwise untouched; the
        hybrid's ring and the recurrent states of idle slots are
        rewritten by the next ``write_slot``."""
        cfg, mod, params = self.cfg, self.mod, self.params
        max_len = self.ecfg.max_len
        mask_idle = cfg.family in ("dense", "moe")
        pool, tok = self._pool, self._tok
        active, remaining = self._active, self._remaining
        toks, emitted = [], []
        for _ in range(self.ecfg.decode_chunk):
            step_pool = pool
            if mask_idle:
                step_pool = {**pool, "idx": torch.where(
                    active, pool["idx"], max_len).to(torch.int32)}
            logits, new_pool = mod.decode_step(cfg, params, tok, step_pool)
            pool = {**pool, "idx": new_pool["idx"].to(torch.int32)}
            nxt = self._sampler(logits, self._gen)
            nxt = torch.where(active, nxt, tok[:, 0])
            emitted.append(active)
            remaining = remaining - active.to(torch.int32)
            hit_eos = (nxt == self._eos) & (self._eos >= 0)
            active = active & (remaining > 0) & ~hit_eos
            tok = nxt[:, None]
            toks.append(nxt)
        self._pool, self._tok = pool, tok
        self._active, self._remaining = active, remaining
        return torch.stack(toks), torch.stack(emitted)

    # -- public API --------------------------------------------------------

    def resident_bytes(self) -> Dict[str, int]:
        """Bytes of the resident weights and KV pool."""
        return {"params": tree_bytes(self.params),
                "pool": tree_bytes(self._pool)}

    def submit(self, req: Request) -> None:
        tp = len(req.prompt)
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1 (the "
                "first token is sampled from the prefill logits)")
        if tp + req.max_new_tokens > self.ecfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({tp}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_len "
                f"({self.ecfg.max_len})")
        if self.cfg.family == "hybrid" and self.cfg.window \
                and tp > self.cfg.window:
            raise ValueError(
                f"request {req.rid}: prompt ({tp}) exceeds the local-"
                f"attention ring ({self.cfg.window}); slot columns and "
                "positions would no longer be identity-mapped")
        self._t_submit[req.rid] = time.monotonic()
        self.scheduler.submit(req)
        if self._obs.enabled:
            self._c_req.inc()
            self._g_queue.set(self.scheduler.n_queued)

    @property
    def n_active(self) -> int:
        return len(self._slots)

    def _do_admissions(self) -> None:
        for slot, req in self.scheduler.admit():
            t0 = time.monotonic()
            tp = len(req.prompt)
            bucket = self.scheduler.bucket_for(tp)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :tp] = req.prompt
            logits, row = self._prefill(
                torch.from_numpy(toks).to(self.device), tp)
            first = self._sampler(logits, self._gen)[0]
            pool_mod.write_slot(self._pool, slot, row, tp)
            self._tok[slot, 0] = first
            alive = (req.max_new_tokens > 1) & ~(
                (first == req.eos_id) & (req.eos_id >= 0))
            self._active[slot] = alive
            self._remaining[slot] = req.max_new_tokens - 1
            self._eos[slot] = req.eos_id
            first = int(first)
            now = time.monotonic()
            ttft = now - self._t_submit.pop(req.rid, t0)
            self._slots[slot] = _SlotState(req, [first], ttft)
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += bucket
            self.stats["prefill_s"] += now - t0
            if self._obs.enabled:
                self._h_prefill.observe(now - t0)
                self._h_ttft.observe(ttft)

    def _release_slot(self, slot: int) -> None:
        pool_mod.reset_slot(self._pool, slot, self._empty)
        self.scheduler.release(slot)

    def _harvest(self, active: Optional[np.ndarray] = None
                 ) -> List[FinishedRequest]:
        done = []
        if active is None:
            active = self._active.cpu().numpy()
        for slot in sorted(self._slots):
            if active[slot]:
                continue
            st = self._slots.pop(slot)
            reason = "eos" if (st.req.eos_id >= 0 and st.tokens
                               and st.tokens[-1] == st.req.eos_id) \
                else "length"
            done.append(FinishedRequest(st.req.rid, st.req.prompt,
                                        st.tokens, reason, st.ttft_s))
            self._release_slot(slot)
            if self._obs.enabled:
                self._c_fin.inc(reason=reason)
                self._obs.write({
                    "kind": "request_finished", "rid": st.req.rid,
                    "reason": reason, "ttft_s": st.ttft_s,
                    "n_tokens": len(st.tokens)})
        return done

    def step(self) -> List[FinishedRequest]:
        """One engine iteration: admit, decode one chunk, harvest.
        Returns the requests that finished in it."""
        self._do_admissions()
        if not self._slots:
            return self._harvest()
        # an admission can finish at once (one token, or EOS first)
        done = self._harvest()
        if not self._slots:
            return done
        t0 = time.monotonic()
        chunk = self.ecfg.decode_chunk
        with self._obs.span("decode_chunk", cat="serve"):
            toks, emitted = self.decode_chunk()
            # the chunk's one host read: tokens, emitted flags, and the
            # active mask the harvest reads
            host = torch.cat([toks, emitted.to(torch.int32),
                              self._active.to(torch.int32)[None]]).cpu()
        host = host.numpy()
        toks, emitted = host[:chunk], host[chunk:2 * chunk].astype(bool)
        dt = time.monotonic() - t0
        self.stats["decode_chunks"] += 1
        self.stats["decode_s"] += dt
        n_emitted = 0
        for slot, st in self._slots.items():
            got = toks[emitted[:, slot], slot]
            st.tokens.extend(int(t) for t in got)
            n_emitted += int(emitted[:, slot].sum())
        self.stats["decode_tokens"] += n_emitted
        if self._obs.enabled:
            self._h_chunk.observe(dt)
            if n_emitted:
                self._c_tok.inc(n_emitted)
                self._h_tpot.observe(dt / n_emitted)
            self._g_queue.set(self.scheduler.n_queued)
            self._g_occ.set(len(self._slots) / self.ecfg.max_slots)
        return done + self._harvest(host[2 * chunk].astype(bool))

    def run(self, requests: Sequence[Request],
            arrivals: Optional[Sequence[int]] = None,
            max_steps: int = 10_000) -> Dict[int, FinishedRequest]:
        """Drive a whole trace: ``arrivals[i]`` is the engine step at
        which ``requests[i]`` is submitted (default: all at step 0).
        Returns ``{rid: FinishedRequest}``."""
        arrivals = list(arrivals or [0] * len(requests))
        if len(arrivals) != len(requests):
            raise ValueError("arrivals and requests length mismatch")
        pending = sorted(zip(arrivals, range(len(requests))),
                         key=lambda p: p[0])
        out: Dict[int, FinishedRequest] = {}
        step_i = 0
        while pending or self.scheduler.n_queued or self._slots:
            while pending and pending[0][0] <= step_i:
                _, i = pending.pop(0)
                self.submit(requests[i])
            for fin in self.step():
                out[fin.rid] = fin
            step_i += 1
            if step_i > max_steps:
                raise RuntimeError("engine did not drain the trace "
                                   f"within {max_steps} steps")
        return out
