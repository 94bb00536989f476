"""Block-paged KV pool and shared-prefix cache for the serving engine
(counterpart of ``repro.serve.paged``).

The slot pool (``serve.pool``) reserves ``max_len`` cache columns a
slot whatever a request uses, so device memory, not compute, caps the
sessions a card holds. This module carves the same cache tensors into
fixed-size **position blocks** (the vLLM/PagedAttention layout, on this
repo's cache machinery):

* **Physical pool**: every KV leaf becomes ``(L, n_blocks, block_len,
  ...)``: ``init_cache(cfg, n_blocks, block_len)`` with the batch dim
  read as blocks. A device free *stack* (``free`` and ``free_top``) and
  a per-slot **block table** ``(max_slots, nbps)`` map column ``c`` of a
  slot to block ``table[c // bl]``, column ``c % bl``. Unmapped entries
  hold the reference's sentinel id ``n_blocks``; every device index
  formed from the table is clamped into range and its result masked
  (an out-of-range index is a device assert on CUDA), so the tables and
  the free stack stay bitwise the reference's.
* **Paged attention** (``models.layers.paged_kv_read``/``_write``):
  decode gathers a virtual ``(B, nbps*bl, ...)`` cache whose column c is
  position c, the slot pool's column order, so paged decode gives the
  slot engine's tokens.
* **Shared-prefix cache** (:class:`PrefixStore`): a prompt's full
  blocks are content-addressed by their token prefix; a prompt whose
  head blocks hit the store maps them by reference and prefills only
  the suffix. Only full blocks are registered and decode writes land at
  columns ``>= prompt_len``, so shared blocks are never written.
* **Backpressure**: admission needs free blocks for the prompt; growth
  that outruns the free stack first evicts store entries (LRU), then
  preempts the youngest admission, which is requeued at the head and
  resumed from its prompt and generated tokens.

Allocator discipline: the host :class:`BlockLedger` replays every push
and pop of the device free stack in the same order, so the host knows
the tables, the free count and the refcounts without reading the card;
a decode chunk (table growth, steps, int8 requantization) has no host
read. A freed block's positions are reset to the sentinel, so a reused
block never exposes a previous tenant's columns.

Families: dense and moe. The ssm and hybrid caches are carried state,
not position-indexed storage: nothing to page (they raise).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.lowp import serve_quant
from repro_torch.models.layers import UNWRITTEN_POS
from repro_torch.serve.engine import (
    EngineConfig,
    Request,
    ServeEngine,
    _SlotState,
)

__all__ = [
    "PagedConfig",
    "PagedServeEngine",
    "BlockLedger",
    "PrefixStore",
    "init_paged_pool",
    "paged_write_slot",
    "grow_tables",
    "release_slot_blocks",
    "push_blocks",
]

#: the bookkeeping entries of a paged pool; the others are cache leaves
BOOKKEEPING = ("idx", "table", "n_mapped", "free", "free_top")


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedConfig(EngineConfig):
    """Engine config and paging knobs. ``n_blocks = 0`` allocates the
    slot pool's capacity, ``max_slots * max_len / block_len``; fewer
    blocks serve more sessions than the memory could hold as slots,
    backed by admission backpressure."""

    block_len: int = 16
    n_blocks: int = 0
    prefix_cache: bool = False
    # blocks admission keeps free as growth headroom (0: admit greedily
    # and rely on eviction and preemption)
    admit_watermark: int = 0


# ---------------------------------------------------------------------------
# Pool construction and block ops (device state, written in place)
# ---------------------------------------------------------------------------

def init_paged_pool(cfg, max_slots: int, max_len: int, block_len: int,
                    n_blocks: int, *, device) -> Dict[str, Any]:
    """The block pool: the model's decode cache allocated as
    ``(n_blocks, block_len)`` rows (``layers/k``, ``layers/v``
    ``(L, n_blocks, bl, kv, hd)``, ``layers/pos`` ``(L, n_blocks, bl)``),
    with ``idx`` (max_slots,) lengths, ``table`` (max_slots, nbps) block
    ids (``n_blocks``: unmapped), ``n_mapped`` (max_slots,), the free
    stack ``free`` (n_blocks,) and ``free_top`` (0-d; entries below it
    are free, popped top down)."""
    from repro_torch.launch import steps as steps_mod

    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"paged KV serving needs a position-indexed cache; the "
            f"{cfg.family!r} family carries recurrent state (nothing to "
            "page): use the slot engine (repro_torch.serve.ServeEngine)")
    if block_len < 1:
        raise ValueError(f"block_len must be >= 1, got {block_len}")
    if max_len % block_len:
        raise ValueError(f"max_len ({max_len}) must be a multiple of "
                         f"block_len ({block_len})")
    nbps = max_len // block_len
    if n_blocks < nbps:
        raise ValueError(
            f"n_blocks ({n_blocks}) < blocks per max-length request "
            f"({nbps}): a single session could never fit")
    mod = steps_mod.model_module(cfg)
    cache = mod.init_cache(cfg, n_blocks, block_len, device=device)
    del cache["idx"]
    i32 = dict(dtype=torch.int32, device=device)
    return {**cache,
            "idx": torch.zeros((max_slots,), **i32),
            "table": torch.full((max_slots, nbps), n_blocks, **i32),
            "n_mapped": torch.zeros((max_slots,), **i32),
            "free": torch.arange(n_blocks, **i32),
            "free_top": torch.tensor(n_blocks, **i32)}


def _pool_dims(pool) -> Tuple[int, int, int]:
    """(n_blocks, block_len, nbps) from the tensors' shapes."""
    n_blocks, bl = pool["layers/pos"].shape[1:3]
    return n_blocks, bl, pool["table"].shape[1]


def _cache_keys(pool) -> List[str]:
    return [k for k in pool if k not in BOOKKEEPING]


def _is_pos(key: str) -> bool:
    return key.rsplit("/", 1)[-1] == "pos"


def paged_write_slot(pool, slot: int, row, length: int, shared_ids,
                     n_shared: int, n_total: int):
    """Admit a prefilled request into ``slot``: map ``n_total`` blocks,
    the first ``n_shared`` by reference from ``shared_ids`` (prefix
    hits), the rest popped off the free stack, and copy the dense
    prefill ``row`` (leaves ``(L, 1, max_len, ...)``) into the fresh
    blocks only; shared blocks are never written (other slots may map
    them). The host's ledger mirrors the pops: ``n_total - n_shared``,
    top down. ``slot``, ``length`` and the counts are host ints (the
    ledger's), the fresh ids are read off the device stack."""
    n_blocks, bl, nbps = _pool_dims(pool)
    dev = pool["table"].device
    n_fresh = n_total - n_shared
    k = torch.arange(n_fresh, device=dev)
    # the host guarantees n_fresh <= free_top (the ledger raises first);
    # the clamp keeps the device index in range regardless
    fresh = pool["free"][torch.clamp(pool["free_top"] - 1 - k, 0,
                                     n_blocks - 1).long()]
    shared = torch.as_tensor(np.asarray(shared_ids[:n_shared], np.int32),
                             device=dev)
    pad = torch.full((nbps - n_total,), n_blocks, dtype=torch.int32,
                     device=dev)
    pool["table"][slot] = torch.cat([shared, fresh, pad])
    if n_fresh:
        ids = fresh.long()
        for key in _cache_keys(pool):
            src = row[key][:, 0]                          # (L, S, ...)
            if _is_pos(key):
                cols = torch.arange(src.shape[1], device=dev)
                src = torch.where(cols < length, src,
                                  torch.full_like(src, UNWRITTEN_POS))
            src = src.reshape(src.shape[0], nbps, bl, *src.shape[2:])
            pool[key][:, ids] = src[:, n_shared:n_total].to(pool[key].dtype)
    pool["n_mapped"][slot] = n_total
    pool["idx"][slot] = length
    pool["free_top"].sub_(n_fresh)
    return pool


def grow_tables(pool, active: torch.Tensor, chunk: int):
    """Map fresh blocks so every active slot can write the next ``chunk``
    positions ``[idx, idx + chunk)``. Pops go slot-major, then
    block-major, off the stack's top: the order
    :meth:`BlockLedger.apply_grow` replays. The host makes sure the
    stack holds enough (backpressure runs before the chunk); nothing is
    read back."""
    n_blocks, bl, nbps = _pool_dims(pool)
    table, free, top = pool["table"], pool["free"], pool["free_top"]
    idx, nm = pool["idx"], pool["n_mapped"]
    need = torch.clamp((idx + chunk + bl - 1) // bl, max=nbps)
    need_new = torch.clamp(need - nm, min=0) * active.to(torch.int32)
    offs = torch.cumsum(need_new, 0, dtype=torch.int32) - need_new
    rows = torch.arange(table.shape[0], device=table.device)
    for k in range(chunk // bl + 1):
        take = k < need_new
        # the reference drops a row without a pop here by aiming it at
        # column nbps; each row writes its own clamped column, a row
        # without a pop the value already there
        col = torch.clamp(nm + k, max=nbps - 1).long()
        bid = free[torch.clamp(top - 1 - (offs + k), 0,
                               n_blocks - 1).long()]
        table[rows, col] = torch.where(take, bid, table[rows, col])
    nm.add_(need_new)
    top.sub_(need_new.sum().to(torch.int32))
    return pool


def _push_reset(pool, ids: torch.Tensor, push) -> None:
    """Push ``ids[push]`` on the free stack (in ``ids`` order) and reset
    their positions to the far-future sentinel: a reused block must
    never expose a previous tenant's columns. ``push`` is the host's
    mask (the ledger's), so the pushed entries are picked on the host
    and no sentinel index is formed on the device."""
    sel = np.flatnonzero(np.asarray(push, bool))
    if not len(sel):
        return
    dev = pool["free"].device
    bids = ids[torch.from_numpy(sel).to(dev)]
    top = pool["free_top"]
    pool["free"][top + torch.arange(len(sel), device=dev)] = bids
    for key in _cache_keys(pool):
        if _is_pos(key):
            pool[key][:, bids.long()] = UNWRITTEN_POS
    top.add_(len(sel))


def release_slot_blocks(pool, slot: int, free_mask):
    """Unmap ``slot``'s table. ``free_mask`` (nbps,), from the host's
    refcounts, says which of its blocks return to the free stack (a
    block shared with the prefix store or another slot stays)."""
    n_blocks = pool["free"].shape[0]
    _push_reset(pool, pool["table"][slot].clone(), free_mask)
    pool["table"][slot] = n_blocks
    pool["n_mapped"][slot] = 0
    pool["idx"][slot] = 0
    return pool


def push_blocks(pool, ids, valid):
    """Return evicted store blocks (no table maps them) to the free
    stack; ``ids`` and ``valid`` are host arrays."""
    ids = np.asarray(ids, np.int32)
    push = np.asarray(valid, bool) & (ids < pool["free"].shape[0])
    _push_reset(pool, torch.from_numpy(ids).to(pool["free"].device), push)
    return pool


# ---------------------------------------------------------------------------
# Host mirrors: allocator ledger and prefix store
# ---------------------------------------------------------------------------

class BlockLedger:
    """Deterministic host mirror of the device allocator.

    Every device push and pop (admission, growth, release, eviction) is
    replayed here in the same order, so the host knows the block
    tables, the free count and per-block refcounts without reading
    device state. ``refcount[b]`` counts holders: each slot whose table
    maps ``b``, and the prefix store if it has an entry for ``b``; a
    block frees when it drops to zero."""

    def __init__(self, n_blocks: int, max_slots: int, nbps: int,
                 block_len: int):
        self.n_blocks, self.nbps, self.bl = n_blocks, nbps, block_len
        self.table = np.full((max_slots, nbps), n_blocks, np.int32)
        self.n_mapped = np.zeros(max_slots, np.int64)
        self.idx = np.zeros(max_slots, np.int64)
        self.free = np.arange(n_blocks, dtype=np.int32)
        self.top = n_blocks
        self.refcount = np.zeros(n_blocks, np.int64)
        # the tightest the free stack got: how close to backpressure the
        # run came (exported by the obs layer)
        self.low_watermark = n_blocks

    def _pop(self, n: int) -> List[int]:
        if n > self.top:
            raise RuntimeError(
                f"free-stack underflow: pop {n} with {self.top} free "
                "(backpressure must run before any pop)")
        ids = [int(self.free[self.top - 1 - k]) for k in range(n)]
        self.top -= n
        if self.top < self.low_watermark:
            self.low_watermark = self.top
        return ids

    def _push(self, bid: int) -> None:
        self.free[self.top] = bid
        self.top += 1

    def assign(self, slot: int, shared: Sequence[int], n_total: int,
               length: int) -> List[int]:
        """Mirror :func:`paged_write_slot`; returns the slot's mapped
        block ids (shared head, fresh tail)."""
        row = list(shared) + self._pop(n_total - len(shared))
        self.table[slot, :] = self.n_blocks
        self.table[slot, :n_total] = row
        self.n_mapped[slot] = n_total
        self.idx[slot] = length
        for bid in row:
            self.refcount[bid] += 1
        return row

    def grow_need(self, slots: Sequence[int], chunk: int) -> int:
        """Blocks :func:`grow_tables` will pop for the coming chunk."""
        return sum(self._need_new(s, chunk) for s in slots)

    def _need_new(self, slot: int, chunk: int) -> int:
        need = min(-(-(self.idx[slot] + chunk) // self.bl), self.nbps)
        return int(max(need - self.n_mapped[slot], 0))

    def apply_grow(self, slots: Sequence[int], chunk: int) -> None:
        """Mirror :func:`grow_tables` (slot-major pops) and advance each
        slot's length by the coming chunk. A slot that stops inside the
        chunk is released before the next growth, so the advance is
        never compared with the device."""
        for slot in sorted(slots):
            n_new = self._need_new(slot, chunk)
            for bid in self._pop(n_new):
                self.table[slot, self.n_mapped[slot]] = bid
                self.n_mapped[slot] += 1
                self.refcount[bid] += 1
            self.idx[slot] += chunk

    def release(self, slot: int) -> np.ndarray:
        """Drop ``slot``'s holds; returns the (nbps,) mask of its blocks
        whose refcount reached zero: the device's free mask."""
        mask = np.zeros(self.nbps, bool)
        for j in range(int(self.n_mapped[slot])):
            bid = int(self.table[slot, j])
            self.refcount[bid] -= 1
            if self.refcount[bid] == 0:
                mask[j] = True
                self._push(bid)
        self.table[slot, :] = self.n_blocks
        self.n_mapped[slot] = 0
        self.idx[slot] = 0
        return mask

    def drop_ref(self, bid: int) -> bool:
        """Store eviction: drop one hold; True if the block freed (the
        caller then pushes it on the device stack too)."""
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            self._push(bid)
            return True
        return False


class PrefixStore:
    """Content-addressed cache of full prompt blocks (a host index; the
    payload is the block pool).

    Key: a digest of the prompt's first ``(i+1) * block_len`` tokens;
    value: the block holding positions ``[i*bl, (i+1)*bl)`` of that
    prefix. Only full blocks are registered, so shared blocks are never
    written. A hit refreshes the LRU order; eviction drops the store's
    hold, and a block still mapped by a live slot stays until the slot
    releases it."""

    def __init__(self, block_len: int):
        self.bl = block_len
        self.entries: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self.entries)

    def _key(self, tokens: np.ndarray, n_blocks: int) -> bytes:
        return hashlib.sha1(np.ascontiguousarray(
            tokens[: n_blocks * self.bl], np.int32).tobytes()).digest()

    def lookup(self, tokens: np.ndarray) -> List[int]:
        """The longest chain of consecutive full-block hits from
        position 0; refreshes the hits' LRU order."""
        hits: List[int] = []
        for i in range(len(tokens) // self.bl):
            key = self._key(tokens, i + 1)
            if key not in self.entries:
                break
            self.entries.move_to_end(key)
            hits.append(self.entries[key])
        return hits

    def register(self, tokens: np.ndarray, row_ids: Sequence[int],
                 lo: int, hi: int) -> List[int]:
        """Publish blocks ``lo..hi-1`` of a freshly prefilled prompt;
        returns the ids inserted (the caller adds the store's hold on
        each)."""
        new = []
        for i in range(lo, hi):
            key = self._key(tokens, i + 1)
            if key not in self.entries:
                self.entries[key] = int(row_ids[i])
                new.append(int(row_ids[i]))
        return new

    def evict_lru(self) -> Optional[int]:
        """Drop the least recently used entry; returns its block id."""
        if not self.entries:
            return None
        _, bid = self.entries.popitem(last=False)
        return bid


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Resume:
    """A preempted request back in the queue: its generated tokens join
    its prompt on re-admission (greedy decode is deterministic in the
    prefix, so the resumed stream continues the same text)."""

    req: Request
    tokens: List[int]
    ttft_s: float

    @property
    def rid(self):
        return self.req.rid


def _effective_prompt(item) -> np.ndarray:
    if isinstance(item, _Resume):
        return np.concatenate([np.asarray(item.req.prompt, np.int32),
                               np.asarray(item.tokens, np.int32)])
    return np.asarray(item.prompt, np.int32)


class PagedServeEngine(ServeEngine):
    """The continuous-batching engine on the block-paged pool.

    Inherits the scheduler, ``step`` and ``run`` from
    :class:`ServeEngine`; overrides the pool, the decode chunk's pool
    hooks (table growth, the paged step, the dirty-block requant) and
    admission and release (prefix cache, refcounted reclaim,
    backpressure)."""

    def __init__(self, cfg, params, ecfg: PagedConfig, mesh=None,
                 obs=None):
        if not isinstance(ecfg, PagedConfig):
            ecfg = PagedConfig(**dataclasses.asdict(ecfg))
        super().__init__(cfg, params, ecfg, mesh, obs=obs)
        self._ledger = BlockLedger(self._n_blocks, ecfg.max_slots,
                                   self._nbps, self._bl)
        self._store: Optional[PrefixStore] = \
            PrefixStore(self._bl) if ecfg.prefix_cache else None
        self._admit_seq = 0
        self._slot_seq: Dict[int, int] = {}

    def _init_obs_handles(self) -> None:
        super()._init_obs_handles()
        o = self._obs
        if not o.enabled:
            return
        self._g_free = o.gauge(
            "serve_free_blocks", "paged free-list depth")
        self._g_lowwater = o.gauge(
            "serve_free_blocks_low_watermark",
            "tightest free-list depth seen (BlockLedger)")
        self._c_prefix = o.counter(
            "serve_prefix_hits_total",
            "admissions served partly from the prefix store")
        self._c_prefix_tok = o.counter(
            "serve_prefix_hit_tokens_total",
            "prompt tokens skipped via shared prefix blocks")
        self._c_preempt = o.counter(
            "serve_preemptions_total",
            "mid-flight youngest-admission preemptions")
        self._c_evict = o.counter(
            "serve_evictions_total", "prefix-store LRU evictions")

    # -- construction ------------------------------------------------------

    def _build_pool(self) -> dict:
        e = self.ecfg
        self._bl = e.block_len
        self._nbps = e.max_len // e.block_len if e.block_len else 0
        self._n_blocks = e.n_blocks or e.max_slots * self._nbps
        pool = init_paged_pool(self.cfg, e.max_slots, e.max_len,
                               e.block_len, self._n_blocks,
                               device=self.device)
        return serve_quant.quantize_kv(pool) if self._quant else pool

    def reset_stats(self) -> None:
        super().reset_stats()
        self.stats.update({"prefix_hits": 0, "prefix_hit_tokens": 0,
                           "preemptions": 0, "evictions": 0})

    @property
    def free_blocks(self) -> int:
        return int(self._ledger.top)

    # -- device programs ---------------------------------------------------

    def _prefill_ext(self, tokens: torch.Tensor, hit_ids: Sequence[int],
                     suffix_len: int):
        """Prefix-hit prefill: gather the shared head blocks into the
        first columns of a fresh one-slot cache, then prefill only the
        suffix (positions continue from the shared length). In int8
        mode the gathered blocks are dequantized (elementwise, so the
        values are those of a dequantized pool)."""
        cfg, dev = self.cfg, self.device
        ns = len(hit_ids) * self._bl
        ids = torch.as_tensor(np.asarray(hit_ids, np.int64), device=dev)
        shared = {key: self._pool[key][:, ids]
                  for key in _cache_keys(self._pool)}
        if self._quant:
            shared = serve_quant.dequantize_kv(shared)
        cache = self.mod.init_cache(cfg, 1, self.ecfg.max_len, device=dev)
        for key, g in shared.items():
            dst = cache[key]
            dst[:, :, :ns] = g.reshape(dst.shape[0], 1, ns,
                                       *dst.shape[3:]).to(dst.dtype)
        cache["idx"] = ns
        length = torch.full((1,), suffix_len, dtype=torch.int32,
                            device=dev)
        return self.mod.prefill(cfg, self._float_params(),
                                {"tokens": tokens}, cache, length=length)

    def _chunk_pool(self, pool, active):
        """Grow the tables for the chunk's write range, and mark the
        blocks it writes (those covering each active slot's
        ``[idx, idx + chunk)``: the dirty set of the int8 requant,
        exact because idle rows' writes drop)."""
        chunk, bl, nbps = self.ecfg.decode_chunk, self._bl, self._nbps
        n_blocks = self._n_blocks
        grow_tables(pool, active, chunk)
        table, idx = pool["table"], pool["idx"]
        rows = torch.arange(table.shape[0], device=table.device)
        start = idx // bl
        hits = torch.zeros((n_blocks,), dtype=torch.int32,
                           device=table.device)
        for k in range(chunk // bl + 1):
            col = start + k
            ids = table[rows, torch.clamp(col, max=nbps - 1).long()]
            ok = active & (col * bl < idx + chunk) & (col < nbps) \
                & (ids < n_blocks)
            hits.index_add_(0, torch.clamp(ids, max=n_blocks - 1).long(),
                            ok.to(torch.int32))
        dirty = hits > 0
        fpool = serve_quant.dequantize_kv(pool) if self._quant else pool
        return dict(fpool), dirty

    def _decode_step(self, params, tok, pool, active):
        """One paged model step: idle rows write at ``max_len``, past the
        table (dropped); their own lengths are kept."""
        step = {**pool, "idx": torch.where(
            active, pool["idx"], self.ecfg.max_len).to(torch.int32)}
        logits, _ = self.mod.decode_step(self.cfg, params, tok, step)
        return logits, {**pool, "idx": pool["idx"]
                        + active.to(torch.int32)}

    # -- admission / release / backpressure --------------------------------

    def _plan(self, item):
        """(tokens, tp, n_hit_blocks, hit_ids, n_total_blocks) for a
        queued item: prefix-store hits capped so that at least one
        suffix token remains to prefill and the shared length plus the
        suffix's bucket fit the row cache."""
        tokens = _effective_prompt(item)
        tp = len(tokens)
        bl = self._bl
        hits = self._store.lookup(tokens) if self._store is not None \
            else []
        n_hit = min(len(hits), (tp - 1) // bl)
        while n_hit > 0 and n_hit * bl + self.scheduler.bucket_for(
                tp - n_hit * bl) > self.ecfg.max_len:
            n_hit -= 1
        return tokens, tp, n_hit, hits[:n_hit], -(-tp // bl)

    def _evict_store(self, want: int) -> int:
        """Evict store entries, LRU first, until ``want`` blocks are
        freed or the store is empty; pushes the freed ids on the device
        stack. Returns the number freed."""
        if self._store is None:
            return 0
        freed: List[int] = []
        while len(freed) < want and len(self._store):
            bid = self._store.evict_lru()
            self.stats["evictions"] += 1
            if self._obs.enabled:
                self._c_evict.inc()
            if self._ledger.drop_ref(bid):
                freed.append(bid)
        if freed:
            push_blocks(self._pool, freed, np.ones(len(freed), bool))
        return len(freed)

    def _do_admissions(self) -> None:
        e = self.ecfg

        def can_admit(item):
            _, _, n_hit, _, n_total = self._plan(item)
            budget = self._ledger.top - e.admit_watermark
            if n_total - n_hit <= budget:
                return True
            self._evict_store(n_total - n_hit - budget)
            return n_total - n_hit <= self._ledger.top - e.admit_watermark

        # one admission at a time, so that can_admit sees the blocks the
        # previous one took (the reference pops every pair the slots
        # allow against the same free count, and when one then cannot
        # be placed, the pairs after it are lost)
        while True:
            pairs = self.scheduler.admit(can_admit, limit=1)
            if not pairs:
                break
            (slot, item), = pairs
            t0 = time.monotonic()
            # re-plan until the block budget holds: an eviction inside
            # can_admit may have dropped some of this prompt's own hits
            while True:
                tokens, tp, n_hit, hit_ids, n_total = self._plan(item)
                short = n_total - n_hit - self._ledger.top
                if short <= 0 or not self._evict_store(short):
                    break
            if n_total - n_hit > self._ledger.top:
                # it cannot be placed after all: back to the queue's head
                self.scheduler.queue.appendleft(item)
                self.scheduler.release(slot)
                break
            req = item.req if isinstance(item, _Resume) else item
            prior = list(item.tokens) if isinstance(item, _Resume) else []
            if n_hit:
                suffix = tokens[n_hit * self._bl:]
                bucket = self.scheduler.bucket_for(len(suffix))
                toks = np.zeros((1, bucket), np.int32)
                toks[0, :len(suffix)] = suffix
                logits, row = self._prefill_ext(
                    torch.from_numpy(toks).to(self.device), hit_ids,
                    len(suffix))
                self.stats["prefix_hits"] += 1
                self.stats["prefix_hit_tokens"] += n_hit * self._bl
                if self._obs.enabled:
                    self._c_prefix.inc()
                    self._c_prefix_tok.inc(n_hit * self._bl)
            else:
                bucket = self.scheduler.bucket_for(tp)
                toks = np.zeros((1, bucket), np.int32)
                toks[0, :tp] = tokens
                logits, row = self._prefill(
                    torch.from_numpy(toks).to(self.device), tp)
            first = self._sampler(logits, self._gen)[0]
            if self._quant:
                row = serve_quant.quantize_kv(row)
            paged_write_slot(self._pool, slot, row, tp, hit_ids, n_hit,
                             n_total)
            row_ids = self._ledger.assign(slot, hit_ids, n_total, tp)
            self._admit_state(slot, first,
                              req.max_new_tokens - len(prior) - 1,
                              req.eos_id)
            if self._store is not None:
                # publish this prompt's fresh full blocks (never the
                # partial tail: decode writes into it)
                orig = np.asarray(req.prompt, np.int32)
                for bid in self._store.register(
                        orig, row_ids, n_hit, len(orig) // self._bl):
                    self._ledger.refcount[bid] += 1
            now = time.monotonic()
            ttft = item.ttft_s if isinstance(item, _Resume) else \
                now - self._t_submit.pop(req.rid, t0)
            self._slots[slot] = _SlotState(req, prior + [int(first)], ttft)
            self._slot_seq[slot] = self._admit_seq
            self._admit_seq += 1
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += bucket
            self.stats["prefill_s"] += now - t0
            if self._obs.enabled:
                self._h_prefill.observe(now - t0)
                if not isinstance(item, _Resume):
                    # a resumed request keeps its first TTFT
                    self._h_ttft.observe(ttft)

    def _release_slot(self, slot: int) -> None:
        mask = self._ledger.release(slot)
        release_slot_blocks(self._pool, slot, mask)
        self._slot_seq.pop(slot, None)
        self.scheduler.release(slot)

    def _preempt(self, slot: int) -> None:
        """Evict the youngest admission mid-flight: free its blocks and
        requeue it at the queue's head with its generated tokens. The
        freed blocks let the older sessions grow."""
        st = self._slots.pop(slot)
        self._release_slot(slot)
        self._active[slot] = False
        self.scheduler.queue.appendleft(
            _Resume(st.req, st.tokens, st.ttft_s))
        self.stats["preemptions"] += 1
        if self._obs.enabled:
            self._c_preempt.inc()
            self._obs.event("preempt", rid=st.req.rid, slot=slot,
                            n_tokens=len(st.tokens))

    def _pre_decode(self) -> None:
        """Backpressure: before a chunk is issued, make sure the free
        stack covers every active slot's growth: evict store entries
        first, then preempt the youngest admissions. One slot's demand
        always fits (``n_blocks >= nbps`` is checked at construction),
        so the loop ends."""
        chunk = self.ecfg.decode_chunk
        while True:
            slots = sorted(self._slots)
            shortage = self._ledger.grow_need(slots, chunk) \
                - self._ledger.top
            if shortage <= 0:
                break
            if self._evict_store(shortage):
                continue
            if len(slots) <= 1:
                raise RuntimeError(
                    "paged pool exhausted with a single active session: "
                    "the n_blocks accounting is broken (construction "
                    "checks n_blocks >= max_len / block_len)")
            self._preempt(max(slots, key=lambda s: self._slot_seq[s]))
        self._ledger.apply_grow(sorted(self._slots), chunk)
        if self._obs.enabled:
            self._g_free.set(self._ledger.top)
            self._g_lowwater.set(self._ledger.low_watermark)
