"""Sharded serving subsystem: a request-parallel device mesh over
per-shard paged KV pools.

The port of ``repro/serving/mesh.py``, with one controller in one
process:

* **ServingMesh** — a ``("data",)`` or 2-D ``("data", "model")`` grid
  of ``torch.device``s (built by ``launch.mesh.make_serving_mesh``).
  Each *data* row is one *shard*: an independent serving executor with
  its own slice of every model's KV page pool. When the mesh carries a
  "model" axis each shard's program additionally runs tensor-parallel
  across its model columns: member params split column-parallel per
  ``sharding.tp.tp_param_specs`` and each cell's pages hold only its
  kv-head slice. ``run(body, per_cell_args)`` is the port's
  ``shard_map``: it runs ``body`` once on every cell — each on a
  persistent worker thread of its own, under the cell's device and a
  tensor-parallel context naming the cell's column group, so the
  model's ``tp_all_gather`` points meet the row's other columns — and
  returns the per-cell results in grid order. Without a "model" axis
  the shards need no collective and run one after the other on the
  calling thread. A failure in any cell aborts its row's gathers, and
  ``run`` raises it in the caller once every cell has stopped.
* **ShardedPagedKVServer** — one model's paged KV state partitioned
  across the mesh. Each cell holds its own contiguous page tensors
  ``(L, P, page, KV / m, Dh)`` (int8 codes plus scale planes for the
  quant layout) — never slices of one global tensor: the kernels take
  contiguous pages, and TMA needs their alignment. The host-side
  allocation state is *per shard*: each shard has its own ``PagePool``
  (shard-local page ids and LIFO free list), prompt prefix cache,
  scratch region and ``KVStats`` — exposed through ``_ShardView``
  objects that present the ``PagedKVServer`` host interface, so the
  step loop's page plumbing runs unmodified against any shard. Every
  column of a shard shares that shard's page ids.

Why this is bit-equivalent to single-device execution: a row's decode
is a pure function of (its prompt, its pages, its admission-indexed
sampling key stream). Pages never alias across shards, the sampling
keys are keyed by *global* admission index, and every host decision
(placement, grouping, retirement) is deterministic — so moving a row
to a different shard changes where its bytes live, never what tokens
it samples. Under tensor parallelism every contraction over a split
axis first gathers its operand back to full length in column order
(``sharding/tp.py``), so it sums the same products in the same order.
"""
from __future__ import annotations

import contextlib
import queue
import sys
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import torch_dtype
from repro_torch.serving.kv_pool import (
    KVStats, PagedKVServer, PagePool, PagePoolError)
from repro_torch.sharding.tp import (
    ColumnGroup, TpGatherAborted, tp_check_cfg, tp_context,
    tp_param_specs)

# seconds a column waits at a gather for the rest of its row before it
# gives up (a cell that never arrives must not hang the mesh)
GATHER_TIMEOUT_S = 600.0
# the interpreter's thread switch interval while the cells run: a
# column released from a gather's barrier waits for the GIL, by default
# up to 5 ms, at every gather
CELL_SWITCH_INTERVAL_S = 5e-5


def _device_ctx(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


class _Worker:
    """One persistent thread running jobs for one mesh cell."""

    def __init__(self, name: str):
        self.jobs: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(target=self._loop, name=name,
                                       daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        while True:
            job = self.jobs.get()
            if job is None:
                return
            job()


class ServingMesh:
    """A ("data",) or ("data", "model") request-parallel serving mesh.

    Adds to the device grid the placement helpers the sharded servers
    need — ``replicate`` / ``place_params`` (member weights) and
    ``shard_rows`` (per-shard operands) — and ``run``, which executes
    one program on every cell.
    """

    def __init__(self, data: Optional[int] = None, mesh=None, *,
                 model: int = 1):
        if mesh is None:
            from repro_torch.launch.mesh import make_serving_mesh
            mesh = make_serving_mesh(data, model=model)
        names = tuple(mesh.axis_names)
        if names not in (("data",), ("data", "model")):
            raise ValueError(
                f"serving mesh must be ('data',) or "
                f"('data', 'model'), got {mesh.axis_names}")
        self.mesh = mesh
        # (n_shards, n_model) view of the device grid
        self.grid = mesh.devices.reshape(self.n_shards, self.n_model)
        kinds = {d.type for d in mesh.devices.reshape(-1)}
        if len(kinds) != 1:
            raise ValueError(f"serving mesh mixes device kinds {kinds}")
        self.device_type = kinds.pop()
        self._workers: Optional[List[_Worker]] = None

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape["data"])

    @property
    def n_model(self) -> int:
        return int(self.mesh.shape.get("model", 1))

    def device(self, k: int, j: int = 0) -> torch.device:
        """The device of cell (shard k, column j)."""
        return self.grid[k, j]

    def cells(self):
        """(shard, column, device) of every cell, in grid order."""
        for k in range(self.n_shards):
            for j in range(self.n_model):
                yield k, j, self.grid[k, j]

    # -- placement -----------------------------------------------------
    def replicate(self, tree):
        """One copy of a tree per cell, in grid order; cells on one
        device share the same tensors (no copy)."""
        return [_tree_to(tree, dev) for _, _, dev in self.cells()]

    def place_params(self, cfg: ModelConfig, params):
        """One member's params for every cell, in grid order: the same
        on every data shard, and — when the mesh carries a "model"
        axis — column j holds the j-th contiguous slice of the last
        axis of each column-parallel leaf (``tp_param_specs``); every
        other leaf is shared, with no copy where a cell shares the
        params' device. Slices are made contiguous here, once, never
        per call. Validates divisibility up front so a bad fleet/mesh
        pairing fails at placement, not mid-run."""
        m = self.n_model
        if m == 1:
            return self.replicate(params)
        tp_check_cfg(cfg, m)
        specs = tp_param_specs(params)
        cache: Dict[tuple, object] = {}
        out = []
        for _, j, dev in self.cells():
            key = (str(dev), j)
            if key not in cache:
                cache[key] = _slice_tree(params, specs, j, m, dev)
            out.append(cache[key])
        return out

    def shard_rows(self, x) -> List[torch.Tensor]:
        """Per-cell operands from an array whose leading axis is the
        shard index: cell (k, j) gets ``x[k]`` on its device (one
        transfer per distinct device of the shard)."""
        t = torch.as_tensor(np.ascontiguousarray(x)) \
            if not isinstance(x, torch.Tensor) else x
        out = []
        for k in range(self.n_shards):
            per_dev: Dict[str, torch.Tensor] = {}
            for j in range(self.n_model):
                dev = self.grid[k, j]
                if str(dev) not in per_dev:
                    per_dev[str(dev)] = t[k].to(dev)
                out.append(per_dev[str(dev)])
        return out

    # -- execution -----------------------------------------------------
    def run(self, body: Callable, per_cell_args: Sequence[tuple]
            ) -> list:
        """Run ``body(*per_cell_args[c])`` once on every cell c (grid
        order) and return the results in grid order. Each cell runs
        under its device; on a 2-D mesh each runs on its own worker
        thread inside a tensor-parallel context whose column group is
        its data row, so ``tp_all_gather`` meets the row's other
        columns. A failing cell aborts its row's gathers; once every
        cell has stopped the first failure is raised here."""
        cells = list(self.cells())
        if len(per_cell_args) != len(cells):
            raise ValueError(f"{len(per_cell_args)} argument sets for "
                             f"{len(cells)} cells")
        if self.n_model == 1:
            out = []
            for (k, j, dev), args in zip(cells, per_cell_args):
                with _device_ctx(dev):
                    out.append(body(*args))
            return out
        return self._run_threads(body, cells, per_cell_args)

    def _run_threads(self, body, cells, per_cell_args) -> list:
        if self._workers is None:
            self._workers = [_Worker(f"mesh-cell-{k}-{j}")
                             for k, j, _ in cells]
        m = self.n_model
        groups = [ColumnGroup(m, timeout=GATHER_TIMEOUT_S)
                  for _ in range(self.n_shards)]
        results: list = [None] * len(cells)
        errors: list = [None] * len(cells)
        finished = threading.Semaphore(0)
        grad = torch.is_grad_enabled()
        infer = torch.is_inference_mode_enabled()

        def job(c, k, j, dev, args):
            def run_cell():
                try:
                    with _device_ctx(dev), \
                            torch.inference_mode(infer), \
                            torch.set_grad_enabled(grad), \
                            tp_context("model", m, groups[k], j):
                        results[c] = body(*args)
                except BaseException as e:      # noqa: BLE001
                    errors[c] = e
                    groups[k].abort()
                finally:
                    finished.release()
            return run_cell

        # one data row at a time: a row's columns must run together to
        # meet at its gathers, while the rows need no collective (their
        # launches still queue on the device back to back)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(min(interval, CELL_SWITCH_INTERVAL_S))
        try:
            for k in range(self.n_shards):
                row = range(k * m, (k + 1) * m)
                for c in row:
                    _, j, dev = cells[c]
                    self._workers[c].jobs.put(
                        job(c, k, j, dev, per_cell_args[c]))
                for _ in row:
                    finished.acquire()
                if any(errors[c] is not None for c in row):
                    break
        finally:
            sys.setswitchinterval(interval)
        failed = [(c, e) for c, e in enumerate(errors) if e is not None]
        if failed:
            # a column that only saw its row's gather abort is not the
            # cause: raise the first cell that failed on its own
            first = next(((c, e) for c, e in failed
                          if not isinstance(e, TpGatherAborted)),
                         failed[0])
            c, e = first
            k, j, _ = cells[c]
            raise RuntimeError(
                f"serving mesh cell (data {k}, model {j}) failed: "
                f"{type(e).__name__}: {e}") from e
        return results

    def close(self) -> None:
        """Stop the worker threads (idempotent)."""
        if self._workers is not None:
            for w in self._workers:
                w.jobs.put(None)
            for w in self._workers:
                w.thread.join()
            self._workers = None

    def __del__(self):
        try:
            self.close()
        except Exception:                       # noqa: BLE001
            pass


def _tree_to(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree


def _slice_tree(tree, spec, j: int, m: int, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, spec[k], j, m, dev)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice_tree(v, s, j, m, dev)
                          for v, s in zip(tree, spec))
    if not spec:
        return tree.to(dev)
    w = tree.shape[-1] // m
    return tree[..., j * w:(j + 1) * w].to(dev).contiguous()


class _ShardView(PagedKVServer):
    """One shard's host-side face of a ``ShardedPagedKVServer``.

    Inherits every allocation/prefix-cache/stats method from
    ``PagedKVServer`` — the pool, scratch, and prefix cache are
    genuinely shard-local — but never owns device tensors (``pages``
    stays ``None``; the parent holds every cell's pages) and delegates
    capacity rebuilds to the parent, which must resize every shard in
    lockstep. ``device`` is the shard's first column's device, where
    its lanes' pending logits live.
    """

    def __init__(self, parent: "ShardedPagedKVServer", index: int,
                 cfg: ModelConfig, **kw):
        self.parent = parent
        self.index = index
        super().__init__(cfg, **kw)

    def _rebuild(self, num_pages: int, scratch_pages: int, key) -> None:
        self.parent._rebuild_all(num_pages, scratch_pages, key)


class ShardedPagedKVServer:
    """Paged KV serving state for one model, partitioned over a
    ``ServingMesh``: shard-local pools/block-tables/free-lists on the
    host, one set of contiguous page tensors per mesh cell."""

    def __init__(self, cfg: ModelConfig, smesh: ServingMesh, *,
                 page_size: int = 8, prefix_cache_entries: int = 32):
        self.cfg = cfg
        self.smesh = smesh
        self.page_size = int(page_size)
        # pages[k][j]: cell (shard k, column j)'s page tensors
        self.pages: Optional[List[List[dict]]] = None
        self.shards: List[_ShardView] = [
            _ShardView(self, i, cfg, page_size=page_size,
                       prefix_cache_entries=prefix_cache_entries,
                       device=smesh.device(i))
            for i in range(smesh.n_shards)]
        self.layout = self.shards[0].layout
        if self.layout not in ("dense", "quant"):
            # ring arenas and recurrent lanes stay single-device:
            # ShardedStepLoopRunner routes those members to its
            # contiguous-cache fallback instead
            raise ValueError(
                f"config {cfg.name!r} resolves to layout "
                f"{self.layout!r}; sharded paged serving supports "
                "'dense' and 'quant' only")

    @property
    def n_shards(self) -> int:
        return self.smesh.n_shards

    @property
    def model_name(self) -> str:
        return self.shards[0].stats.model

    def set_model_name(self, name: str) -> None:
        for sv in self.shards:
            sv.stats.model = name

    def cell_pages(self) -> List[dict]:
        """Every cell's page tensors in grid order (``ServingMesh.run``
        operands)."""
        return [c for row in self.pages for c in row]

    # -- capacity ------------------------------------------------------
    def ensure_capacity_stream(self, max_rows_per_shard: int,
                               prompt_len: int, lanes_per_row: int,
                               max_new_tokens: int) -> None:
        """Size every shard for the step loop's per-shard steady state.
        All shards are always sized identically, so checking shard 0
        suffices; a rebuild goes through ``_rebuild_all`` and resizes
        the whole set."""
        self.shards[0].ensure_capacity_stream(
            max_rows_per_shard, prompt_len, lanes_per_row,
            max_new_tokens)

    def _rebuild_all(self, num_pages: int, scratch_pages: int,
                     key) -> None:
        self._rebuild_host(num_pages, scratch_pages, key)
        self._rebuild_device(num_pages)

    def _rebuild_host(self, num_pages: int, scratch_pages: int,
                      key) -> None:
        """Shard-local host state: one fresh pool + scratch region per
        shard. Split from the device rebuild so the pool-invariant
        tests can exercise shard-local free lists without allocating
        device tensors."""
        # phase 1: every shard must be rebuildable before any is
        # touched — a half-rebuilt shard set would desync the pages
        # from the pools
        for sv in self.shards:
            if sv.lost:
                raise PagePoolError(
                    f"cannot rebuild shard {sv.index}: marked lost")
            if sv.pool is not None:
                sv.drop_prefix_cache()
                old_scratch = sv._scratch.size \
                    if sv._scratch is not None else 0
                if sv.pool.pages_in_use > old_scratch:
                    raise PagePoolError(
                        f"cannot rebuild shard {sv.index}'s page pool "
                        "while pages are held")
        for sv in self.shards:
            sv.pool = PagePool(num_pages, self.page_size)
            sv._scratch = sv.pool.alloc(scratch_pages)
            sv._capacity_key = key
            sv.stats.pool_pages = num_pages
            sv._sample_usage()

    def _rebuild_device(self, num_pages: int) -> None:
        """Fresh zeroed pages for every cell. Under tensor parallelism
        each column holds only its kv-head slice of every page, so
        per-cell page bytes shrink by the model-axis size."""
        cfg = self.cfg
        m = self.smesh.n_model
        shape = (cfg.num_layers, num_pages, self.page_size,
                 cfg.num_kv_heads // m, cfg.resolved_head_dim)
        dt = torch.int8 if self.layout == "quant" else torch_dtype(cfg)
        self.pages = None            # free the old tensors first
        grid = []
        for k in range(self.n_shards):
            row = []
            for j in range(m):
                dev = self.smesh.device(k, j)
                cell = {"k": torch.zeros(shape, dtype=dt, device=dev),
                        "v": torch.zeros(shape, dtype=dt, device=dev)}
                if self.layout == "quant":
                    for name in ("k_scale", "v_scale"):
                        cell[name] = torch.zeros(
                            shape[:-1], dtype=torch.float32, device=dev)
                row.append(cell)
            grid.append(row)
        self.pages = grid

    # -- fault simulation ----------------------------------------------
    def mark_shard_lost(self, index: int) -> None:
        """Simulated shard loss: the shard's host-side pool is
        abandoned in place (pages are forfeited, not released — a dead
        host cannot run a release path) and every allocation or prefix
        lookup against it fails from now on. The device pages are left
        as they are; displaced rows re-prefill on surviving shards."""
        self.shards[index].lost = True

    # -- accounting ----------------------------------------------------
    def aggregate_stats(self) -> KVStats:
        """Summed accounting across shards. Pool capacity, high-water
        and reuse counters add (each shard is an independent pool);
        ``page_bytes``/``page_size`` are per-page quantities and stay
        as-is."""
        base = self.shards[0].stats
        out = KVStats(model=base.model, page_size=base.page_size,
                      page_bytes=base.page_bytes)
        for sv in self.shards:
            st = sv.stats
            out.pool_pages += st.pool_pages
            out.pages_in_use += st.pages_in_use
            out.pages_highwater += st.pages_highwater
            out.probe_pages_highwater += st.probe_pages_highwater
            out.prefill_tokens_computed += st.prefill_tokens_computed
            out.prefill_tokens_reused_probe += \
                st.prefill_tokens_reused_probe
            out.prefill_tokens_reused_prefix += \
                st.prefill_tokens_reused_prefix
            out.cow_forks += st.cow_forks
            out.prefill_chunks += st.prefill_chunks
            out.prefix_evictions += st.prefix_evictions
        return out

    def per_shard_pages_in_use(self) -> Dict[int, int]:
        return {sv.index: sv.pool.pages_in_use
                for sv in self.shards if sv.pool is not None}

    def pad_fork_ids(self, k: int) -> np.ndarray:
        """(n_shards, k) self-copy page ids (each shard's first scratch
        page) — the identity fork for shards with nothing to fork."""
        out = np.empty((self.n_shards, k), np.int32)
        for sv in self.shards:
            out[sv.index] = int(sv._scratch[0])
        return out
