"""Paged KV-cache subsystem: ref-counted page pool, block tables, and
prefix sharing between the probe and ensemble stages.

The port of ``repro/serving/kv_pool.py`` on one device, with all four
page layouts, for the wave engine and the step-level loop:

* **PagePool** — a fixed pool of ``page_size``-token pages with
  reference counts. Allocation, retain, and release are host-side and
  deterministic; double frees and use-after-free raise typed errors
  instead of corrupting block tables; exhaustion raises
  ``PoolExhausted`` with the pool left intact.
* **Block tables** — each sequence maps logical token positions to
  pages via an int32 table row. The N probe samples of one prompt
  *share* the read-only full prompt pages (one ref per owner) and only
  hold private pages for the region decode writes — the partial
  prompt-tail page is materialised per sample by a copy-on-write fork.
* **PagedKVServer** — per-model serving state: the device page tensors
  (``self.pages``) on the server's device, the pool, a ref-counted
  prompt-prefix cache (cross-request reuse of identical prompts), and
  the wave orchestration the engine calls: ``probe_wave`` (N samples,
  one prefill, shared prefix pages), ``reuse_decode`` (an ensemble
  member seeded from the probe's retained prompt pages, prefill
  skipped) and ``generate`` (paged single-sample waves).

One server serves one layout (``models.transformer.resolve_layout``);
every leaf keeps the page (or lane) id on axis 1:

* ``"dense"`` — ``{k, v}`` of ``(L, P, page_size, KV, Dh)`` in the
  model dtype.
* ``"quant"`` — ``{k, v}`` int8 codes plus ``{k_scale, v_scale}``
  ``(L, P, page_size, KV)`` f32 per-vector scale planes
  (``models.attention.quantize_kv``): Dh + 4 bytes per position and
  head instead of 2 * Dh * itemsize.
* ``"ring"`` — pages in the model dtype, but a row only ever holds
  ``ceil(min(prompt+new, window)/page_size)`` pages; positions wrap in
  place (a sliding-window member's KV stops growing with the prompt).
* ``"lanes"`` — recurrent-state lanes for SSM members:
  ``{conv: (L, LANES, conv_width-1, d_in), h: (L, LANES, d_in, N)}``;
  a "page" is one sequence's whole state, block tables are one lane id
  wide, and a fork is a state copy.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.params import torch_dtype
from repro_torch.models.transformer import resolve_layout
from repro_torch.serving.compaction import bucket_size


# ----------------------------------------------------------------------
# errors
# ----------------------------------------------------------------------
class PagePoolError(RuntimeError):
    """Base class for page-pool accounting violations."""


class PoolExhausted(PagePoolError):
    """Allocation request exceeds the pool's free pages. The pool state
    is unchanged: no partial allocation escapes."""


class PageAccountingError(PagePoolError):
    """Refcount violation: double free or retain of a free page."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` positions."""
    return -(-int(n_tokens) // page_size) if n_tokens > 0 else 0


@dataclass(frozen=True)
class RowGeometry:
    """Page accounting for one row of ``prompt_len`` tokens decoding up
    to ``max_new`` more. ``n_shared`` prompt pages are read-only
    shareable across a row's lanes; ``nbp`` pages hold the prompt
    (shared + the COW tail); each decode lane holds ``n_tail`` private
    pages and a block table ``nb`` entries wide; the decode attention
    span is ``cache_len`` positions."""
    n_shared: int
    tail_tokens: int        # tokens in the COW prompt-tail page
    nbp: int                # prompt pages per row
    nb: int                 # block-table width per decode lane
    n_tail: int             # private pages per decode lane
    cache_len: int          # decode attention span (dense-equivalent)


# ----------------------------------------------------------------------
# page pool
# ----------------------------------------------------------------------
class PagePool:
    """Fixed pool of KV pages with reference counting.

    Pure host-side bookkeeping (the device tensors live in
    ``PagedKVServer``); every operation is deterministic — the free
    list is LIFO, so identical call sequences produce identical page
    ids.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._refs = np.zeros(self.num_pages, np.int32)
        # LIFO free list, seeded so the first allocations are 0,1,2,...
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self.highwater = 0
        self.allocs_total = 0

    # ------------------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def alloc(self, n: int) -> np.ndarray:
        """Allocate ``n`` pages (refcount 1 each). All-or-nothing:
        raises ``PoolExhausted`` leaving the pool untouched."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise PoolExhausted(
                f"requested {n} pages, {len(self._free)} free "
                f"(pool {self.num_pages} x {self.page_size} tokens)")
        ids = [self._free.pop() for _ in range(n)]
        self._refs[ids] = 1
        self.allocs_total += n
        if self.pages_in_use > self.highwater:
            self.highwater = self.pages_in_use
        return np.asarray(ids, np.int32)

    def retain(self, pages: Sequence[int]) -> None:
        """Add one reference to each page (prefix sharing / COW fork)."""
        for p in np.asarray(pages, np.int64).ravel():
            if self._refs[p] <= 0:
                raise PageAccountingError(
                    f"retain of free page {int(p)}")
            self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference from each page; pages hitting zero return
        to the free list (LIFO)."""
        for p in np.asarray(pages, np.int64).ravel():
            if self._refs[p] <= 0:
                raise PageAccountingError(
                    f"double free of page {int(p)}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(int(p))


# ----------------------------------------------------------------------
# stats
# ----------------------------------------------------------------------
@dataclass
class KVStats:
    """Measured paged-KV accounting for one model's server."""
    model: str = ""
    page_size: int = 0
    page_bytes: int = 0                 # bytes per page (all layers, K+V)
    pool_pages: int = 0
    pages_in_use: int = 0               # latest sample
    pages_highwater: int = 0            # pool-lifetime peak
    # peak pages referenced by one probe wave (shared prompt pages +
    # canonical tails + sample-private pages) — the counterpart of the
    # dense tile_cache working set, excluding prefix-cache retention
    probe_pages_highwater: int = 0
    prefill_tokens_computed: int = 0
    prefill_tokens_reused_probe: int = 0    # probe -> ensemble seeding
    prefill_tokens_reused_prefix: int = 0   # cross-request prompt reuse
    cow_forks: int = 0                  # partial-tail pages materialised
    prefill_chunks: int = 0             # chunked-prefill calls issued
    prefix_evictions: int = 0           # cost-aware cache evictions

    @property
    def prefill_tokens_reused(self) -> int:
        return (self.prefill_tokens_reused_probe
                + self.prefill_tokens_reused_prefix)

    @property
    def probe_highwater_bytes(self) -> int:
        return self.probe_pages_highwater * self.page_bytes


def dense_tile_slots(batch: int, n_samples: int, prompt_len: int,
                     max_new_tokens: int) -> int:
    """Token slots the dense ``tile_cache`` probe path materialises for
    one wave: every sample row holds a full prompt+new cache."""
    return batch * n_samples * (prompt_len + max_new_tokens)


# ----------------------------------------------------------------------
# prefix cache (cross-request reuse of identical prompts)
# ----------------------------------------------------------------------
@dataclass
class _PrefixEntry:
    shared: np.ndarray          # full prompt pages (read-only, cache ref)
    tail: Optional[int]         # pristine partial prompt-tail page
    logits0: torch.Tensor       # (V,) last-position prefill logits
    tokens: int = 0             # prompt tokens a hit saves recomputing
    hits: int = 0               # hits since insertion
    seq: int = 0                # insertion order (deterministic ties)

    @property
    def pages_held(self) -> int:
        return int(self.shared.size) + (1 if self.tail is not None
                                        else 0)

    @property
    def score(self) -> float:
        """Cost-aware retention value: prefill tokens saved per page
        held. A hit saves ``tokens`` of prefill; un-hit entries carry
        one optimistic expected hit so fresh prompts are not evicted
        before they can prove themselves."""
        return self.tokens * (self.hits + 1) / max(self.pages_held, 1)


# ----------------------------------------------------------------------
# probe wave handle
# ----------------------------------------------------------------------
@dataclass
class ProbeHandle:
    """Per-wave retention of the probe's prompt pages, so ensemble
    members sharing the probe's model can seed their decode from them.
    Rows are released the moment their route resolves (``resolve``);
    ``close`` drops whatever is left."""
    server: "PagedKVServer"
    prompt_len: int
    max_new_tokens: int
    logits0: torch.Tensor                  # (B, V) float32, on device
    shared: List[np.ndarray]               # per row: full prompt pages
    tails: List[Optional[int]]             # per row: canonical tail page
    live: np.ndarray                       # (B,) bool — handle refs held

    @property
    def batch(self) -> int:
        return self.live.shape[0]

    def _release_row(self, r: int) -> None:
        if not self.live[r]:
            return
        self.server.pool.release(self.shared[r])
        if self.tails[r] is not None:
            self.server.pool.release([self.tails[r]])
        self.live[r] = False

    def resolve(self, keep_rows: Sequence[int]) -> None:
        """Free every row's prompt pages except ``keep_rows`` (the rows
        some ensemble member will still seed its decode from)."""
        keep = set(int(r) for r in keep_rows)
        for r in range(self.batch):
            if r not in keep:
                self._release_row(r)
        self.server._sample_usage()

    def close(self) -> None:
        for r in range(self.batch):
            self._release_row(r)
        self.server._sample_usage()


# ----------------------------------------------------------------------
# per-model paged serving state
# ----------------------------------------------------------------------
class PagedKVServer:
    """Paged KV serving state for one model (one set of params).

    Owns the device page tensors, the pool, and the prefix cache. The
    engine creates one server per distinct ``params`` object, so an
    ensemble member that *is* the probe model shares the probe's
    server — which is what makes probe->ensemble prefill reuse sound
    (KV caches are functions of params, not just configs).
    """

    def __init__(self, cfg: ModelConfig, *, page_size: int = 8,
                 prefix_cache_entries: int = 32,
                 device: Union[str, torch.device] = "cuda"):
        layout = resolve_layout(cfg)
        if layout is None:
            raise ValueError(
                f"config {cfg.name!r} is not paged-KV capable "
                "(GQA, linear cache, and dense or gather-dispatch "
                "MoE FFN required; hybrid stacks stay dense)")
        self.cfg = cfg
        self.layout = layout
        self.device = torch.device(device)
        self.page_size = int(page_size)
        # ring pages are per-lane snapshots and lane state depends on
        # the decode horizon; neither is a reusable read-only prompt
        # prefix, so the prefix cache only runs for dense/quant
        self.prefix_cache_entries = (int(prefix_cache_entries)
                                     if layout in ("dense", "quant")
                                     else 0)
        # simulated shard loss (serving/faults.py): a lost server's
        # pool is abandoned — allocations and prefix hits must fail so
        # no new row can land on dead pages
        self.lost = False
        self.pool: Optional[PagePool] = None
        self.pages: Optional[dict] = None
        self._scratch: Optional[np.ndarray] = None
        self._prefix: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()
        self._prefix_seq = 0
        self._capacity_key: Optional[Tuple[int, int, int, int]] = None
        self.stats = KVStats(
            model=cfg.name, page_size=self.page_size,
            page_bytes=self._page_bytes())

    def _page_bytes(self) -> int:
        """Bytes one page (all layers) holds under this layout: K and V
        of page_size positions, or one lane's whole recurrent state."""
        cfg = self.cfg
        itemsize = torch_dtype(cfg).itemsize
        if self.layout == "lanes":
            d_in, _, n = ssm_mod.ssm_dims(cfg)
            w = cfg.ssm.conv_width
            return cfg.num_layers * ((w - 1) * d_in * itemsize
                                     + d_in * n * 4)
        hd = cfg.resolved_head_dim
        per_vec = (2 * (hd + 4) if self.layout == "quant"   # codes+scale
                   else 2 * hd * itemsize)
        return cfg.num_layers * self.page_size * cfg.num_kv_heads * per_vec

    # -- layout geometry -----------------------------------------------
    @property
    def chunked(self) -> bool:
        """Whether this server's rows may prefill in chunks. Only the
        dense layout composes chunk by chunk (a quant chunk would
        re-read the already-quantised prefix, ring pages overwrite in
        place, a lane prefill is one recurrent scan)."""
        return self.layout == "dense"

    def row_geometry(self, prompt_len: int,
                     max_new_tokens: int) -> RowGeometry:
        """Page accounting for one row under this server's layout."""
        s, m, ps = int(prompt_len), int(max_new_tokens), self.page_size
        if self.layout in ("dense", "quant"):
            n_shared = s // ps
            nbp = pages_for(s, ps)
            nb = pages_for(s + m, ps)
            return RowGeometry(
                n_shared=n_shared, tail_tokens=s - n_shared * ps,
                nbp=nbp, nb=nb, n_tail=nb - n_shared, cache_len=s + m)
        if self.layout == "ring":
            cl = min(s + m, self.cfg.window)
            nb = pages_for(cl, ps)
            # no read-only sharing: every lane writes into (and wraps
            # over) its whole snapshot, so lanes fork all nbp pages
            return RowGeometry(n_shared=0, tail_tokens=0, nbp=nb,
                               nb=nb, n_tail=nb, cache_len=cl)
        # lanes: one "page" is the row's entire recurrent state
        return RowGeometry(n_shared=0, tail_tokens=0, nbp=1, nb=1,
                           n_tail=1, cache_len=s + m)

    def table_width(self, prompt_len: int, max_new_tokens: int) -> int:
        """Block-table width one decode lane needs."""
        return self.row_geometry(prompt_len, max_new_tokens).nb

    # -- capacity ------------------------------------------------------
    def _ensure_capacity(self, batch: int, prompt_len: int,
                         n_samples: int, max_new_tokens: int) -> None:
        """(Re)build the pool and page tensors when a wave's worst case
        outgrows them. Only called at wave boundaries, when no handle
        holds pages; rebuilding drops the prefix cache."""
        key = (batch, prompt_len, n_samples, max_new_tokens)
        if self._capacity_key is not None and self.pool is not None:
            b0, s0, n0, m0 = self._capacity_key
            if (batch <= b0 and prompt_len <= s0 and n_samples <= n0
                    and max_new_tokens <= m0):
                return
            key = (max(batch, b0), max(prompt_len, s0),
                   max(n_samples, n0), max(max_new_tokens, m0))
        b, s, n, m = key
        g = self.row_geometry(s, m)
        need = (b * (g.nbp + n * g.n_tail)  # probe wave peak
                + b * g.nb                  # one member wave (own prefill)
                + self.prefix_cache_entries * g.nbp
                + g.nbp)                    # scratch pages
        self._rebuild(need, g.nbp, key)

    def _zero_pages(self, num_pages: int) -> dict:
        """Freshly zeroed page tensors on the server's device (axis 1 =
        page or lane id): the model dtype for dense and ring pages, int8
        codes plus f32 scale planes for quant pages, and for lanes the
        {conv, h} state in the dtypes ``ssm.mamba_step`` emits (the
        model dtype, f32), so parking a state is a pure copy."""
        cfg = self.cfg
        if self.layout == "lanes":
            d_in, _, n = ssm_mod.ssm_dims(cfg)
            w = cfg.ssm.conv_width
            return {"conv": torch.zeros(
                        (cfg.num_layers, num_pages, w - 1, d_in),
                        dtype=torch_dtype(cfg), device=self.device),
                    "h": torch.zeros((cfg.num_layers, num_pages, d_in, n),
                                     dtype=torch.float32,
                                     device=self.device)}
        shape = (cfg.num_layers, num_pages, self.page_size,
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        dt = torch.int8 if self.layout == "quant" else torch_dtype(cfg)
        pages = {"k": torch.zeros(shape, dtype=dt, device=self.device),
                 "v": torch.zeros(shape, dtype=dt, device=self.device)}
        if self.layout == "quant":
            for name in ("k_scale", "v_scale"):
                pages[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                          device=self.device)
        return pages

    def _rebuild(self, num_pages: int, scratch_pages: int,
                 key: Tuple[int, int, int, int]) -> None:
        if self.pool is not None:
            self.drop_prefix_cache()
            # only the OLD scratch pages may remain held — they are
            # discarded with the old pool; user pages must be gone
            old_scratch = self._scratch.size \
                if self._scratch is not None else 0
            if self.pool.pages_in_use > old_scratch:
                raise PagePoolError(
                    "cannot rebuild the page pool while pages are held")
        self.pool = PagePool(num_pages, self.page_size)
        self.pages = None           # free the old tensors first
        self.pages = self._zero_pages(num_pages)
        # scratch pages soak up the writes of bucket-padding rows; never
        # referenced by any live block table, so their contents are
        # dead by construction
        self._scratch = self.pool.alloc(scratch_pages)
        self._capacity_key = key
        self.stats.pool_pages = num_pages
        self._sample_usage()

    def drop_prefix_cache(self) -> None:
        for entry in self._prefix.values():
            self._release_entry(entry)
        self._prefix.clear()

    def _sample_usage(self) -> None:
        if self.pool is not None:
            self.stats.pages_in_use = self.pool.pages_in_use
            self.stats.pages_highwater = self.pool.highwater

    # -- prefix cache --------------------------------------------------
    def _prefix_lookup(self, key: bytes) -> Optional[_PrefixEntry]:
        if self.lost or self.prefix_cache_entries <= 0:
            return None
        entry = self._prefix.get(key)
        if entry is not None:
            entry.hits += 1
        return entry

    def _release_entry(self, entry: _PrefixEntry) -> None:
        self.pool.release(entry.shared)
        if entry.tail is not None:
            self.pool.release([entry.tail])

    def _evict_one(self) -> bool:
        """Evict the lowest-value cache entry (prefill-tokens-saved
        per page held; insertion order breaks ties deterministically).
        Returns False when the cache is empty."""
        if not self._prefix:
            return False
        worst = min(self._prefix,
                    key=lambda k: (self._prefix[k].score,
                                   self._prefix[k].seq))
        self._release_entry(self._prefix.pop(worst))
        self.stats.prefix_evictions += 1
        return True

    def evict_prefix(self, pages_needed: int) -> int:
        """Cost-aware eviction until at least ``pages_needed`` pages
        are free, the cache is empty, or an eviction round frees
        nothing (a victim whose pages are still shared by a live row
        releases references without returning a page). Returns the
        free-page count."""
        while self.pool.free_pages < pages_needed:
            before = self.pool.free_pages
            if not self._evict_one():
                break                  # cache empty
            if self.pool.free_pages == before:
                break                  # victim fully shared: no progress
        self._sample_usage()
        return self.pool.free_pages

    def _alloc_retry(self, n: int) -> np.ndarray:
        """Pool allocation with the evict-and-retry loop: on
        exhaustion, shed prefix-cache entries (cheapest value per page
        first) and retry; ``PoolExhausted`` escapes once eviction
        cannot free enough."""
        if self.lost:
            raise PoolExhausted(
                f"server {self.stats.model!r} is marked lost; its "
                "page pool is abandoned")
        try:
            return self.pool.alloc(n)
        except PoolExhausted:
            if self.evict_prefix(n) < n:
                raise
            return self.pool.alloc(n)

    def _prefix_insert(self, key: bytes, shared: np.ndarray,
                       tail: Optional[int], logits0: torch.Tensor,
                       tokens: int = 0) -> None:
        if self.prefix_cache_entries <= 0:
            return
        old = self._prefix.pop(key, None)
        if old is not None:
            self._release_entry(old)
        self.pool.retain(shared)
        if tail is not None:
            self.pool.retain([tail])
        self._prefix[key] = _PrefixEntry(
            shared=shared.copy(), tail=tail, logits0=logits0.clone(),
            tokens=tokens, seq=self._prefix_seq)
        self._prefix_seq += 1
        while len(self._prefix) > self.prefix_cache_entries:
            self._evict_one()

    # -- waves ---------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def probe_wave(self, params: dict, ids: np.ndarray, n_samples: int,
                   *, max_new_tokens: int, temperature: float, key,
                   eos_id: int, pad_id: int, row_keys=None):
        """N-sample probe decode with shared prefix pages.

        One prefill per distinct uncached prompt; the N samples of a
        prompt share its full prompt pages read-only and fork only the
        partial tail page (COW). ``row_keys`` ((B*N, 2) uint32) opts
        into per-row sampling key streams. Returns
        ``(GenerateOutput, ProbeHandle)`` with the tokens on the host;
        the handle retains each row's prompt pages for ensemble seeding
        until ``resolve``/``close``.
        """
        from repro_torch.sampling import sampler as S

        b, s = ids.shape
        n = int(n_samples)
        self._ensure_capacity(b, s, n, max_new_tokens)
        g = self.row_geometry(s, max_new_tokens)

        # 1. prompt pages per row: prefix-cache hit -> retain the
        # cached pages; miss -> allocate fresh ones (handle-owned). On
        # any failure, release whatever this wave accumulated so an
        # exhausted pool stays consistent.
        shared_rows: List[np.ndarray] = []
        tail_rows: List[Optional[int]] = []
        miss: List[int] = []
        hits: List[Optional[_PrefixEntry]] = []
        try:
            for r in range(b):
                entry = self._prefix_lookup(ids[r].tobytes())
                hits.append(entry)
                if entry is not None:
                    self.pool.retain(entry.shared)
                    if entry.tail is not None:
                        self.pool.retain([entry.tail])
                    shared_rows.append(entry.shared.copy())
                    tail_rows.append(entry.tail)
                    self.stats.prefill_tokens_reused_prefix += s
                else:
                    pages = self._alloc_retry(g.nbp)
                    if self.layout in ("dense", "quant"):
                        shared_rows.append(pages[:g.n_shared])
                        tail_rows.append(int(pages[g.n_shared])
                                         if g.tail_tokens else None)
                    else:
                        # ring / lanes: the whole allocation is the
                        # row's private prompt snapshot
                        shared_rows.append(pages)
                        tail_rows.append(None)
                    miss.append(r)

            # 2. one prefill over the uncached rows, gathered into a
            # power-of-two bucket (padding rows replicate the first
            # miss and write into scratch pages)
            logits0 = torch.zeros((b, self.cfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
            if miss:
                bucket = bucket_size(len(miss), cap=b)
                rows_idx = miss + [miss[0]] * (bucket - len(miss))
                pf_table = np.empty((bucket, g.nbp), np.int32)
                for i, r in enumerate(rows_idx):
                    if i < len(miss):
                        row_pages = list(shared_rows[r])
                        if g.tail_tokens:
                            row_pages.append(tail_rows[r])
                        pf_table[i] = row_pages
                    else:
                        pf_table[i] = self._scratch[:g.nbp]
                if self.layout == "lanes":
                    lg, self.pages = S.prefill_lanes(
                        self.cfg, params, self._tensor(ids[rows_idx]),
                        self.pages, self._tensor(pf_table[:, 0]))
                else:
                    lg, self.pages = S.prefill_paged(
                        self.cfg, params, self._tensor(ids[rows_idx]),
                        self.pages, self._tensor(pf_table),
                        cache_len=(s + max_new_tokens
                                   if self.layout == "ring" else None))
                logits0[miss] = lg[:len(miss)].float()
                # the bucket's padding rows compute real (discarded)
                # prefill work — count what actually ran
                self.stats.prefill_tokens_computed += bucket * s
            for r, entry in enumerate(hits):
                if entry is not None:
                    logits0[r] = entry.logits0

            # 3. publish the fresh rows to the prefix cache
            for r in miss:
                self._prefix_insert(ids[r].tobytes(), shared_rows[r],
                                    tail_rows[r], logits0[r], tokens=s)
        except BaseException:
            for r in range(len(shared_rows)):
                self.pool.release(shared_rows[r])
                if tail_rows[r] is not None:
                    self.pool.release([tail_rows[r]])
            self._sample_usage()
            raise

        # the handle owns the prompt pages from here on: any failure
        # below must close it (and drop the sample pages)
        handle = ProbeHandle(
            server=self, prompt_len=s, max_new_tokens=max_new_tokens,
            logits0=logits0, shared=shared_rows, tails=tail_rows,
            live=np.ones(b, bool))
        sample_tails = None
        try:
            # 4. sample-private pages + fork of the prompt state each
            # lane mutates: dense/quant COW-fork only the partial tail
            # page; ring/lanes fork the row's whole prompt snapshot
            sample_tails = self._alloc_retry(b * n * g.n_tail).reshape(
                b, n, g.n_tail)
            self.stats.probe_pages_highwater = max(
                self.stats.probe_pages_highwater,
                b * (g.nbp + n * g.n_tail))
            block_table = np.empty((b * n, g.nb), np.int32)
            for r in range(b):
                for j in range(n):
                    block_table[r * n + j, :g.n_shared] = \
                        shared_rows[r][:g.n_shared]
                    block_table[r * n + j, g.n_shared:] = \
                        sample_tails[r, j]
            if g.tail_tokens:
                src = np.repeat(np.asarray(tail_rows, np.int64), n)
                dst = sample_tails[:, :, 0].reshape(-1)
                S.fork_pages(self.pages, src, dst)
                self.stats.cow_forks += b * n
            elif g.n_shared == 0:
                src = np.repeat(np.stack(shared_rows), n,
                                axis=0).reshape(-1)
                S.fork_pages(self.pages, src, sample_tails.reshape(-1))
                self.stats.cow_forks += b * n * g.nbp

            # 5. decode the expanded (B*N) wave over the shared pages
            out, self.pages = S.decode_paged(
                self.cfg, params,
                torch.repeat_interleave(logits0, n, dim=0),
                self.pages, self._tensor(block_table), key,
                start_pos=s, max_new_tokens=max_new_tokens,
                temperature=temperature, eos_id=eos_id, pad_id=pad_id,
                row_keys=row_keys)
            # tokens to the host before the sample pages are recycled
            out = _to_host(out)
        except BaseException:
            if sample_tails is not None:
                self.pool.release(sample_tails.reshape(-1))
            handle.close()
            raise
        self.pool.release(sample_tails.reshape(-1))
        self._sample_usage()
        return out, handle

    def reuse_decode(self, params: dict, handle: ProbeHandle,
                     rows: Sequence[int], *, max_new_tokens: int,
                     temperature: float, key, eos_id: int,
                     pad_id: int, row_keys=None):
        """Ensemble decode seeded from the probe's prompt pages: prefill
        is skipped — the rows' shared pages are read in place, the
        canonical tail page is COW-forked per decode row, and the
        prefill logits come from the handle. Only sound when ``params``
        is the probe's params (the engine keys servers by params
        identity)."""
        from repro_torch.sampling import sampler as S

        rows = [int(r) for r in rows]
        s = handle.prompt_len
        g = self.row_geometry(s, max_new_tokens)
        if self.layout == "ring":
            g0 = self.row_geometry(s, handle.max_new_tokens)
            if g.cache_len != g0.cache_len:
                raise ValueError(
                    "ring prompt snapshot was compressed for "
                    f"cache_len {g0.cache_len}; a member decoding to "
                    f"cache_len {g.cache_len} cannot reuse it")
        for r in rows:
            if not handle.live[r]:
                raise PageAccountingError(
                    f"reuse of row {r} after its pages were resolved")

        nr = len(rows)
        tails = self._alloc_retry(nr * g.n_tail).reshape(nr, g.n_tail)
        try:
            block_table = np.empty((nr, g.nb), np.int32)
            for i, r in enumerate(rows):
                block_table[i, :g.n_shared] = \
                    handle.shared[r][:g.n_shared]
                block_table[i, g.n_shared:] = tails[i]
            if g.tail_tokens:
                S.fork_pages(self.pages, [handle.tails[r] for r in rows],
                             tails[:, 0])
                self.stats.cow_forks += nr
            elif g.n_shared == 0:
                S.fork_pages(self.pages,
                             np.stack([handle.shared[r]
                                       for r in rows]).reshape(-1),
                             tails.reshape(-1))
                self.stats.cow_forks += nr * g.nbp
            out, self.pages = S.decode_paged(
                self.cfg, params, handle.logits0[rows], self.pages,
                self._tensor(block_table), key, start_pos=s,
                max_new_tokens=max_new_tokens, temperature=temperature,
                eos_id=eos_id, pad_id=pad_id, row_keys=row_keys)
            out = _to_host(out)
        finally:
            self.pool.release(tails.reshape(-1))
            self._sample_usage()
        self.stats.prefill_tokens_reused_probe += s * nr
        return out

    def generate(self, params: dict, ids: np.ndarray, *,
                 max_new_tokens: int, temperature: float, key,
                 eos_id: int, pad_id: int, row_keys=None):
        """Paged single-sample generation (a probe wave with N=1 whose
        prompt pages are released at once): page-granular allocation
        instead of batch-max padded dense caches, plus cross-request
        prompt reuse through the prefix cache."""
        out, handle = self.probe_wave(
            params, ids, 1, max_new_tokens=max_new_tokens,
            temperature=temperature, key=key, eos_id=eos_id,
            pad_id=pad_id, row_keys=row_keys)
        handle.close()
        return out

    # -- step-level serving support ------------------------------------
    def stream_row_pages(self, prompt_len: int, lanes_per_row: int,
                         max_new_tokens: int) -> int:
        """Worst-case pages one step-loop row holds on this server:
        the prompt pages (shared read-only for dense/quant, the
        forkable snapshot for ring/lanes) plus each lane's private
        pages (probe samples and seeded ensemble decodes alike)."""
        g = self.row_geometry(prompt_len, max_new_tokens)
        return g.nbp + lanes_per_row * g.n_tail

    def ensure_capacity_stream(self, max_rows: int, prompt_len: int,
                               lanes_per_row: int,
                               max_new_tokens: int) -> None:
        """Size the pool for the step-level loop's steady state:
        ``max_rows`` rows concurrently resident, each holding its
        prompt pages and ``lanes_per_row`` private lanes — plus the
        prefix cache and a scratch region wide enough for a *full*
        (prompt+decode) pad-row block table. Must run before any pages
        are held (the step loop calls it at admission of the first
        row)."""
        g = self.row_geometry(prompt_len, max_new_tokens)
        need = (max_rows * self.stream_row_pages(
                    prompt_len, lanes_per_row, max_new_tokens)
                + self.prefix_cache_entries * g.nbp
                + g.nb)                              # scratch pages
        key = (max_rows, prompt_len, lanes_per_row, max_new_tokens)
        if (self._capacity_key is not None and self.pool is not None
                and self.pool.num_pages >= need
                and self._scratch is not None
                and self._scratch.size >= g.nb):
            return
        self._rebuild(need, g.nb, key)


def _to_host(out):
    """A GenerateOutput with its tensors copied to the host."""
    return type(out)(*(t.cpu() for t in out))
