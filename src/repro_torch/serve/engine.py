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
  admits queued ones. With greedy sampling the chunk is captured once
  and replayed (a CUDA graph on the card, a TorchScript trace on the
  CPU), as the reference compiles it as one ``lax.scan`` program.

``EngineConfig(quant="int8")`` keeps the weights and the KV pool
resident as int8 codes with fp32 scales (``lowp.serve_quant``): each
prefill and each decode chunk dequantizes them in fp32, an admitted row
is quantized into the pool, and after a chunk the pool is requantized
(for dense and moe only the slots active at the chunk's entry; the
others carry their codes bitwise).

Token-only prompt families: dense, moe, ssm, hybrid. The vlm and audio
families need modality inputs at prefill and serve on the static path
(``launch.serve --static``), as in the reference. The block-paged pool
and the prefix cache are ``serve.paged``, a subclass.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.lowp import serve_quant
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

    def admit(self, can_admit=None, limit: Optional[int] = None
              ) -> List[Tuple[int, Request]]:
        """Pop ``(slot, request)`` pairs, FIFO, while a free slot and a
        queued request exist, at most ``limit``. ``can_admit(req)`` adds
        a condition beyond the free slot (the paged engine's free
        blocks); a queue head that fails it blocks the queue (no
        bypass)."""
        out = []
        while self.queue and self.free and (limit is None
                                            or len(out) < limit):
            if can_admit is not None and not can_admit(self.queue[0]):
                break
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

def _capture(fn, state, n_fixed: int):
    """``fn(*state)`` as one captured program, replayed on the same
    ``state`` tensors at every call; ``fn`` writes its new state into
    ``state[n_fixed:]`` and returns its outputs. It is built on a copy
    of those, so the first replay is the first call that counts. On the
    card a CUDA graph (warmed up once on the copy); on the CPU a
    TorchScript trace. Either holds ``fn``'s shapes fixed, and ``fn``
    must read nothing back to the host: the graph's capture refuses a
    sync, and a trace would keep the value it read as a constant (its
    warnings, silenced here, are the models' shape tests)."""
    import warnings

    warm = state[:n_fixed] + tuple(t.clone() for t in state[n_fixed:])
    if state[-1].is_cuda:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*warm)
        torch.cuda.current_stream().wait_stream(side)
        del warm
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = fn(*state)

        def replay(*args):
            if any(a is not b for a, b in zip(args[n_fixed:],
                                              state[n_fixed:])):
                raise RuntimeError("a captured chunk replays on the "
                                   "tensors it was captured on")
            graph.replay()
            return tuple(o.clone() for o in outs)

        return replay
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        traced = torch.jit.trace(fn, warm, check_trace=False)

    def run(*args):
        # the graph as traced: the executor's optimizing passes take
        # longer than the chunks of a short run and speed none of them
        with torch.jit.optimized_execution(False):
            return traced(*args)

    return run


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
    # "int8": resident weights and KV cache as int8 codes with fp32
    # scales (lowp.serve_quant), dequantized by each prefill and chunk
    quant: str = "none"


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
        if ecfg.quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {ecfg.quant!r}; "
                             "one of ('none', 'int8')")
        if mesh is not None:
            raise NotImplementedError(
                "a serving mesh is multi-GPU work: ROADMAP Queue 1 item 8.5")
        from repro_torch.launch import steps as steps_mod

        self.cfg = cfg
        self.ecfg = ecfg
        self.mod = steps_mod.model_module(cfg)
        self.device = next(iter(params.values())).device
        self._quant = ecfg.quant == "int8"
        # resident weights: int8 codes and per-channel scales
        self.params = serve_quant.quantize_params(params) if self._quant \
            else params
        self._weights = [t for p in self.params.values() for t in
                         (p if isinstance(p, serve_quant.QTensor) else (p,))]
        dev = self.device
        B = ecfg.max_slots
        self._pool = self._build_pool()
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
        self._program = None         # the chunk, built at its first call
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

    def _build_pool(self) -> dict:
        """The resident KV pool (a hook: the paged engine builds a block
        pool instead) and the empty row a released slot takes."""
        pool = pool_mod.init_pool(self.cfg, self.ecfg.max_slots,
                                  self.ecfg.max_len, device=self.device)
        if self._quant:
            # int8 codes with *_scale siblings, which the pool's slot
            # writes and resets address like their parents
            pool = serve_quant.quantize_kv(pool)
        self._empty = pool_mod.empty_row_like(pool)
        return pool

    def _float_params(self) -> dict:
        """The weights a prefill or chunk computes with: the resident
        ones, or in int8 mode their fp32 dequantization."""
        return serve_quant.dequantize_params(self.params) if self._quant \
            else self.params

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
        return self.mod.prefill(self.cfg, self._float_params(),
                                {"tokens": tokens}, cache, length=length_t)

    def decode_chunk(self):
        """``decode_chunk`` model steps with sampling and termination,
        issued back to back with no host read: returns the chunk's
        tokens and which of them each slot emitted, both
        (chunk, max_slots) on the device, and leaves the engine's
        resident state (pool, last tokens, active mask, budgets) updated
        in place. Inactive slots keep stepping on their last token; for
        dense and moe their cache writes are diverted past the last
        column (``idx`` -> ``max_len``) and dropped, so idle slots'
        columns stay bitwise untouched; the hybrid's ring and the
        recurrent states of idle slots are rewritten by the next
        ``write_slot``.

        In int8 mode the chunk runs on the fp32 dequantization of the
        weights and the pool, and the pool is requantized at its end:
        for dense and moe only the slots active at the chunk's entry
        (the only ones written), the others keeping their codes and
        scales bitwise; for ssm and hybrid the whole pool.

        With greedy sampling the chunk runs as one captured program,
        built at its first call on the resident state: a CUDA graph on
        the card, a TorchScript trace on the CPU. So a chunk is one
        dispatch, as the reference's compiled chunk is, and computes
        what the op-by-op chunk computes. The stochastic samplers draw
        from a ``torch.Generator``, which neither capture replays: they
        issue the chunk op by op."""
        self.build_chunk()
        with torch.no_grad():
            return self._program(*self._state())

    def build_chunk(self) -> None:
        """Build the chunk's program on the resident state now (the
        first :meth:`decode_chunk` does otherwise): a capture may
        synchronise the card, a replay does not."""
        if self._program is not None:
            return
        with torch.no_grad():
            self._program = _capture(
                self._chunk_program, self._state(), len(self._weights)) \
                if self.ecfg.method == "greedy" else self._chunk_program

    def _state(self) -> tuple:
        """The chunk's inputs, flat: the resident weights (an int8
        weight as its codes and scale), the pool's leaves, then the last
        tokens, active mask, budgets and EOS ids (the same tensors at
        every call: the chunk writes them in place)."""
        return (*self._weights, *self._pool.values(), self._tok,
                self._active, self._remaining, self._eos)

    def _chunk_program(self, *state):
        """The chunk on the flat ``state`` of :meth:`_state`; writes the
        new state into it and returns ``(toks, emitted)``."""
        n_p, n_c = len(self._weights), len(self._pool)
        leaves, params = iter(state[:n_p]), {}
        for key, p in self.params.items():
            params[key] = serve_quant.QTensor(next(leaves), next(leaves)) \
                if isinstance(p, serve_quant.QTensor) else next(leaves)
        pool_in = dict(zip(self._pool, state[n_p:n_p + n_c]))
        tok_in, active_in, remaining_in, eos = state[n_p + n_c:]
        if self._quant:
            params = serve_quant.dequantize_params(params)
        tok, active, remaining = tok_in, active_in, remaining_in
        pool, dirty = self._chunk_pool(pool_in, active)
        toks, emitted = [], []
        for _ in range(self.ecfg.decode_chunk):
            logits, pool = self._decode_step(params, tok, pool, active)
            nxt = self._sampler(logits, self._gen)
            nxt = torch.where(active, nxt, tok[:, 0])
            emitted.append(active)
            remaining = remaining - active.to(torch.int32)
            hit_eos = (nxt == eos) & (eos >= 0)
            active = active & (remaining > 0) & ~hit_eos
            tok = nxt[:, None]
            toks.append(nxt)
        if self._quant:
            pool = serve_quant.requantize_kv(pool, like=pool_in,
                                             dirty=dirty)
        # stacked before the write-back: emitted[0] is the entry mask
        out = torch.stack(toks), torch.stack(emitted)
        for key, buf in pool_in.items():
            if pool[key] is not buf:
                buf.copy_(pool[key])
        tok_in.copy_(tok)
        active_in.copy_(active)
        remaining_in.copy_(remaining)
        return out

    def _chunk_pool(self, pool, active):
        """The pool a chunk's steps run on (fp32 in int8 mode) and the
        ``dirty`` mask of the entries they can write along axis 1 of the
        KV leaves: the chunk-entry active slots for dense and moe, None
        (all) otherwise. (A hook: the paged engine grows its tables
        here.)"""
        dirty = active if self.cfg.family in ("dense", "moe") else None
        if self._quant:
            pool = serve_quant.dequantize_kv(pool)
        return pool, dirty

    def _decode_step(self, params, tok, pool, active):
        """One model step of the chunk; returns ``(logits, pool)``. Dense
        and moe idle slots write at ``max_len`` (dropped)."""
        step_pool = pool
        if self.cfg.family in ("dense", "moe"):
            step_pool = {**pool, "idx": torch.where(
                active, pool["idx"], self.ecfg.max_len).to(torch.int32)}
        logits, new_pool = self.mod.decode_step(self.cfg, params, tok,
                                                step_pool)
        return logits, {**pool, "idx": new_pool["idx"].to(torch.int32)}

    # -- public API --------------------------------------------------------

    def resident_bytes(self) -> Dict[str, int]:
        """Bytes of the resident weights and KV pool (in int8 mode the
        codes and their scales)."""
        return {"params": serve_quant.tree_bytes(self.params),
                "pool": serve_quant.tree_bytes(self._pool)}

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
            if self._quant:
                row = serve_quant.quantize_kv(row)
            pool_mod.write_slot(self._pool, slot, row, tp)
            self._admit_state(slot, first, req.max_new_tokens - 1,
                              req.eos_id)
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

    def _admit_state(self, slot: int, first: torch.Tensor,
                     n_remaining: int, eos_id: int) -> None:
        """An admitted slot's device state: its first token, budget, EOS
        id, and active unless the budget is spent or ``first`` is EOS."""
        self._tok[slot, 0] = first
        self._active[slot] = (n_remaining > 0) & ~(
            (first == eos_id) & (eos_id >= 0))
        self._remaining[slot] = n_remaining
        self._eos[slot] = eos_id

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

    def _pre_decode(self) -> None:
        """Run before each chunk is issued (a hook: the paged engine
        grows its block tables here, with backpressure)."""

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
        self._pre_decode()
        if not self._slots:      # backpressure may have preempted all
            return done + self._harvest()
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
