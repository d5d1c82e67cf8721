"""Sampling over the port's models: the wave generators (prefill, then a
fixed-length decode loop over a contiguous cache or over pool pages)
and the step-level programs over the paged KV pool.

The port of ``repro/sampling/sampler.py``. The reference compiles each
generator into one XLA program and drives decode with ``lax.scan``;
here they run eagerly and the decode steps are a Python loop whose
position is a host integer, so no step reads a value back from the
card. Temperature 0 is greedy; otherwise tokens come from the replica
of jax's categorical draw (``prng``), either with one key per step for
the whole batch (``sample_token``) or with per-row key streams
(``sample_token_rows``). Finished rows (EOS emitted) keep emitting
``pad_id``, so a wave runs a fixed number of steps. Caches and pages
are updated in place.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sampling import prng
from repro_torch.sharding.tp import tp_local_cfg

Pages = Dict[str, torch.Tensor]


class GenerateOutput(NamedTuple):
    tokens: torch.Tensor     # (B, max_new) int32, pad_id after EOS
    logprobs: torch.Tensor   # (B, max_new) float32 logprob of chosen tok
    lengths: torch.Tensor    # (B,) int32 — emitted tokens incl. EOS


def _temperature_scaled(logits: torch.Tensor,
                        temperature: float) -> torch.Tensor:
    # a true division by a tensor of the temperature (a division by a
    # Python scalar may run as a multiply by its reciprocal)
    return logits.float() / torch.full_like(logits, temperature,
                                            dtype=torch.float32)


def sample_token(logits: torch.Tensor, temperature: float,
                 key: torch.Tensor) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32. One draw for the whole batch:
    ``jax.random.categorical(key, logits / temperature)`` with key
    (2,) int64 holding uint32 values, whose Gumbel noise indexes the
    flattened (B, V) array — so a row's token depends on the batch
    shape (``sample_token_rows`` does not)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = _temperature_scaled(logits, temperature)
    g = prng.gumbel(key.reshape(1, 2), scaled.numel()).reshape(
        scaled.shape)
    return torch.argmax(g + scaled, dim=-1).to(torch.int32)


def sample_token_rows(logits: torch.Tensor, temperature: float,
                      row_keys: torch.Tensor,
                      steps: torch.Tensor) -> torch.Tensor:
    """Batch-composition-invariant sampling: one private key stream
    per row. logits: (B, V); row_keys: (B, 2) raw PRNG keys (int64
    holding uint32 values); steps: scalar or (B,) decode-step index per
    row. Row i draws from categorical(fold_in(row_keys[i], steps[i]),
    logits[i]) — a pure function of that row alone, so a row emits
    identical tokens whatever batch it shares. Returns (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = _temperature_scaled(logits, temperature)
    steps = torch.as_tensor(steps, device=logits.device).expand(
        logits.shape[0])
    keys = prng.fold_in(row_keys, steps)
    return prng.categorical(keys, scaled)


# row-key streams: disjoint tags keep probe and ensemble draws
# independent even for the same admission index
_PROBE_KEY_TAG = 0x5052_4f42      # "PROB"
_MEMBER_KEY_TAG = 0x454d_4245     # "EMBE"


def probe_row_keys(base_key: np.ndarray, admission_indices,
                   n_samples: int) -> np.ndarray:
    """Per-(task, sample) probe decode keys, (len(indices)*n, 2) uint32.

    Row ``i*n + j`` is sample j of the task with admission index
    ``admission_indices[i]`` — a stable identity independent of batch
    composition, which is what makes sampled tokens reproducible under
    any step-loop schedule."""
    idx = np.asarray(list(admission_indices), np.int64)
    tagged = prng.fold_in_np(base_key, _PROBE_KEY_TAG)
    per_task = prng.fold_in_np(np.broadcast_to(tagged, (idx.size, 2)), idx)
    per_sample = prng.fold_in_np(
        np.repeat(per_task[:, None], n_samples, axis=1),
        np.arange(n_samples, dtype=np.int64)[None])
    return per_sample.reshape(idx.size * n_samples, 2)


def member_row_keys(base_key: np.ndarray, admission_indices,
                    member_idx: int) -> np.ndarray:
    """Per-task ensemble decode keys for one member, (len(indices), 2)
    uint32."""
    idx = np.asarray(list(admission_indices), np.int64)
    tagged = prng.fold_in_np(prng.fold_in_np(base_key, _MEMBER_KEY_TAG),
                             member_idx)
    return prng.fold_in_np(np.broadcast_to(tagged, (idx.size, 2)), idx)


def fork_pages(pages: Pages, src: Sequence[int],
               dst: Sequence[int]) -> Pages:
    """Page fork, in place: page ``dst[i]`` becomes a private copy of
    ``src[i]`` across every layer of every leaf (axis 1 is the page
    axis). ``src`` may repeat (one canonical prompt page forked to N
    samples); ``dst`` must not."""
    for a in pages.values():
        s = torch.as_tensor(np.asarray(src, np.int64), device=a.device)
        d = torch.as_tensor(np.asarray(dst, np.int64), device=a.device)
        a[:, d] = a[:, s]
    return pages


def batch_invariant(cfg: ModelConfig) -> bool:
    """True when one row's forward pass cannot depend on which other
    rows share the batch: every non-MoE config, and MoE with the
    capacity-free gather dispatch. Compaction and shared-prefix prefill
    are bit-equivalent to the padded and tiled paths only for these."""
    return cfg.moe is None or cfg.moe.impl == "gather"


def _device_of(params: dict) -> torch.device:
    return params["embedding"].device


def _as_tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device)
    return torch.from_numpy(np.ascontiguousarray(tokens)).to(device)


def _decode_scan(cfg: ModelConfig, params: dict, cache, logits0: torch.Tensor,
                 start_pos: int, batch: int, max_new_tokens: int,
                 temperature: float, key, eos_id: int, pad_id: int,
                 decode_fn=None, row_keys=None
                 ) -> Tuple[GenerateOutput, object]:
    """The fixed-length decode loop over an existing prefill cache.

    ``decode_fn(cache, token, pos) -> (logits, cache)`` overrides the
    per-step transition (the paged path passes pages through it); the
    default is ``T.decode_step`` over a contiguous cache. ``pos`` is a
    host integer. Without ``row_keys`` step i draws the whole batch
    from ``split(key, max_new_tokens)[i]``; with ``row_keys`` ((B, 2)
    uint32) row r draws from ``fold_in(row_keys[r], i)``. Returns the
    output and the final cache."""
    if decode_fn is None:
        def decode_fn(cache, token, pos):
            return T.decode_step(cfg, params, cache, token, pos)

    dev = logits0.device
    if row_keys is not None:
        row_keys = prng._as_keys(row_keys, dev)
    else:
        step_keys = prng._as_keys(prng.split(key, max_new_tokens), dev)
    logits = logits0
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    emits, logps, live = [], [], []
    for i in range(max_new_tokens):
        if row_keys is None:
            tok = sample_token(logits, temperature, step_keys[i])
        else:
            tok = sample_token_rows(
                logits, temperature, row_keys,
                torch.full((batch,), i, dtype=torch.int64, device=dev))
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok_logp = torch.gather(logp, 1, tok.long()[:, None])[:, 0]
        emit = torch.where(done, torch.full_like(tok, pad_id), tok)
        emits.append(emit)
        logps.append(torch.where(done, torch.zeros_like(tok_logp),
                                 tok_logp))
        live.append(~done)
        done = done | (tok == eos_id)
        logits, cache = decode_fn(cache, emit, start_pos + i)
    # a row emits a real token (possibly EOS, possibly one that merely
    # equals pad_id) at every step it was not yet done
    lengths = torch.stack(live, dim=1).sum(dim=1).to(torch.int32)
    return GenerateOutput(tokens=torch.stack(emits, dim=1),
                          logprobs=torch.stack(logps, dim=1),
                          lengths=lengths), cache


def generate(cfg: ModelConfig, params: dict, prompt_tokens, *,
             max_new_tokens: int, temperature: float = 0.0,
             key: Optional[np.ndarray] = None, eos_id: int = -1,
             pad_id: int = 0, frontend_embeds=None,
             row_keys=None) -> GenerateOutput:
    """prompt_tokens: (B, S) int — fixed-length prompts, on the params'
    device. ``key`` is a raw (2,) uint32 key (default ``PRNGKey(0)``);
    ``row_keys`` ((B, 2) uint32) switches sampling to per-row key
    streams (batch-composition invariant; see ``sample_token_rows``).
    ``frontend_embeds``: an audio model's frames or a vision model's
    patches for the prefill (``T.prefill``)."""
    tokens = _as_tokens(prompt_tokens, _device_of(params))
    b, s = tokens.shape
    if key is None:
        key = prng.prng_key(0)
    logits0, cache = T.prefill(cfg, params, tokens, frontend_embeds,
                               cache_len=s + max_new_tokens)
    out, _ = _decode_scan(cfg, params, cache, logits0, s, b,
                          max_new_tokens, temperature, key, eos_id,
                          pad_id, row_keys=row_keys)
    return out


def tile_cache(cache: dict, n: int, batch: Optional[int] = None) -> dict:
    """Broadcast a prefill cache of batch B to B*n rows (row i's
    replicas occupy rows i*n .. i*n+n-1, matching ``np.repeat`` on the
    prompt batch). Stacked caches (``layers``, and the audio family's
    ``dec_layers`` and ``cross``) carry (L, B, ...) leaves; the
    per-layer entries (``layer_XX``) carry (B, ...). ``batch`` asserts
    the chosen axis really is the batch axis."""
    out = {}
    for k, leaves in cache.items():
        axis = 1 if k in ("layers", "dec_layers", "cross") else 0
        if batch is not None:
            for leaf in leaves.values():
                if leaf.shape[axis] != batch:
                    raise ValueError(
                        f"cache entry {k!r}: expected batch {batch} on "
                        f"axis {axis}, got shape {tuple(leaf.shape)}")
        out[k] = {name: torch.repeat_interleave(a, n, dim=axis)
                  for name, a in leaves.items()}
    return out


def generate_samples(cfg: ModelConfig, params: dict, prompt_tokens,
                     n: int, *, max_new_tokens: int,
                     temperature: float = 0.0,
                     key: Optional[np.ndarray] = None, eos_id: int = -1,
                     pad_id: int = 0, frontend_embeds=None,
                     row_keys=None) -> GenerateOutput:
    """N samples per prompt with a single shared-prefix prefill.

    prompt_tokens: (B, S) -> GenerateOutput over B*n rows, row-major in
    sample index (row i*n+j is sample j of prompt i): one prefill per
    prompt (with ``frontend_embeds`` (B, ...) as in ``generate``), its
    cache tiled to the n samples, and only the decode loop runs at B*n
    rows."""
    tokens = _as_tokens(prompt_tokens, _device_of(params))
    b, s = tokens.shape
    if key is None:
        key = prng.prng_key(0)
    logits0, cache = T.prefill(cfg, params, tokens, frontend_embeds,
                               cache_len=s + max_new_tokens)
    cache = tile_cache(cache, n, batch=b)
    logits0 = torch.repeat_interleave(logits0, n, dim=0)
    out, _ = _decode_scan(cfg, params, cache, logits0, s, b * n,
                          max_new_tokens, temperature, key, eos_id,
                          pad_id, row_keys=row_keys)
    return out


# ----------------------------------------------------------------------
# paged KV-cache path (serving/kv_pool.py owns allocation)
# ----------------------------------------------------------------------
def prefill_paged(cfg: ModelConfig, params: dict, prompt_tokens: torch.Tensor,
                  pages: Pages, prefill_table: torch.Tensor,
                  cache_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Pages]:
    """One-shot prompt prefill scattering K/V (quant: codes and scales;
    ring: the ring snapshot) into pool pages. prompt_tokens: (B, S);
    prefill_table: (B, NBp) int32; cache_len: the dense-equivalent total
    length, required for ring layouts. Returns (logits0 (B, V),
    pages)."""
    return T.prefill_paged(cfg, params, prompt_tokens, pages,
                           prefill_table, cache_len=cache_len)


def prefill_lanes(cfg: ModelConfig, params: dict,
                  prompt_tokens: torch.Tensor, pages: Pages,
                  lane_ids: torch.Tensor) -> Tuple[torch.Tensor, Pages]:
    """Prompt prefill for a recurrent-state (SSM) member, parking each
    row's final state in its pool lane, in place.

    prompt_tokens: (B, S); pages: the lane arena {conv, h} (leaves
    (L, LANES, ...)); lane_ids: (B,) lane per row. The prefill is the
    contiguous ``T.prefill`` bit for bit; only the state parking
    differs. Returns (logits0 (B, V), pages)."""
    logits0, cache = T.prefill(cfg, params, prompt_tokens)
    lanes = lane_ids.long()
    for n, st in cache["layers"].items():
        arena = pages[n]
        # a pure copy: a dtype cast here would drift the parked state
        # off the contiguous path
        assert arena.dtype == st.dtype, (arena.dtype, st.dtype)
        arena[:, lanes] = st
    return logits0, pages


def decode_paged(cfg: ModelConfig, params: dict, logits0: torch.Tensor,
                 pages: Pages, block_table: torch.Tensor, key, *,
                 start_pos: int, max_new_tokens: int,
                 temperature: float = 0.0, eos_id: int = -1,
                 pad_id: int = 0, row_keys=None
                 ) -> Tuple[GenerateOutput, Pages]:
    """Fixed-length decode over paged state, from prefill logits.

    logits0: (B, V) last-prompt-position logits (fresh or reused from a
    retained probe prefill); block_table: (B, NB) int32 page ids per
    row — the N-sample probe wave points its rows' prompt-prefix
    entries at shared read-only pages. Returns (GenerateOutput, pages).
    """
    b = logits0.shape[0]
    cache_len = start_pos + max_new_tokens
    dev = logits0.device

    def decode_fn(pages, token, pos):
        pos_t = torch.full((), pos, dtype=torch.int32, device=dev)
        return T.decode_step_paged(cfg, params, pages, block_table,
                                   token, pos_t, cache_len=cache_len)

    return _decode_scan(cfg, params, pages, logits0, start_pos, b,
                        max_new_tokens, temperature, key, eos_id, pad_id,
                        decode_fn=decode_fn, row_keys=row_keys)


def prefill_chunk_paged(cfg: ModelConfig, params: dict,
                        tokens: torch.Tensor, pages: Pages,
                        block_table: torch.Tensor,
                        start_pos: torch.Tensor, *, prompt_len: int
                        ) -> Tuple[torch.Tensor, Pages]:
    """One prompt chunk appended to the paged cache (dense layout).
    tokens: (B, C) covering absolute positions
    [start_pos[b], start_pos[b] + C) per row; block_table: (B, NB).
    Returns (chunk-final logits (B, V), pages)."""
    return T.prefill_chunk_paged(cfg, params, tokens, pages, block_table,
                                 start_pos, prompt_len=prompt_len)


def decode_step_rows(cfg: ModelConfig, params: dict, logits: torch.Tensor,
                     pages: Pages, block_table: torch.Tensor,
                     pos: torch.Tensor, row_keys: torch.Tensor,
                     steps: torch.Tensor, done: torch.Tensor, *,
                     cache_len: int, temperature: float, eos_id: int,
                     pad_id: int):
    """One decode step for a mixed batch of rows.

    logits: (B, V) each row's pending next-token logits; pos: (B,)
    per-row write position; steps: (B,) per-row decode-step index;
    done: (B,) rows already past EOS. Returns (emit, logprob, live,
    new_done, next_logits, pages)."""
    tok = sample_token_rows(logits, temperature, row_keys, steps)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_logp = torch.gather(logp, 1, tok.long()[:, None])[:, 0]
    emit = torch.where(done, torch.full_like(tok, pad_id), tok)
    new_done = done | (tok == eos_id)
    next_logits, pages = T.decode_step_paged(
        cfg, params, pages, block_table, emit, pos, cache_len=cache_len)
    return (emit, torch.where(done, torch.zeros_like(tok_logp), tok_logp),
            ~done, new_done, next_logits, pages)


def decode_megastep_rows(cfg: ModelConfig, params: dict,
                         logits: torch.Tensor, pages: Pages,
                         block_table: torch.Tensor, pos: torch.Tensor,
                         row_keys: torch.Tensor, steps: torch.Tensor,
                         done: torch.Tensor, *, n_ticks: int,
                         cache_len: int, temperature: float, eos_id: int,
                         pad_id: int):
    """``n_ticks`` decode ticks for a mixed batch of rows, with lane
    state (logits, positions, step indices, done bits) kept on the
    device between ticks. Each tick draws from the per-row key stream
    (``fold_in(row_keys[i], steps[i])``), emits pad for done rows, and
    appends the emitted token's KV at the row's current position. Rows
    that finish mid-megastep keep ticking with masked emissions; their
    write position is clamped to ``cache_len - 1`` so the dead appends
    land in the row's own tail page, never read again (attention masks
    by the true position and the host replay drops masked emissions).
    Because the key stream is indexed by the per-row step counter,
    ``n_ticks`` is a pure performance knob.

    Returns (emits (K, B), dones (K, B), next_logits (B, V), pages)."""
    lg, pos_, steps_, done_ = logits, pos, steps, done
    emits, dones = [], []
    for _ in range(n_ticks):
        tok = sample_token_rows(lg, temperature, row_keys, steps_)
        emit = torch.where(done_, torch.full_like(tok, pad_id), tok)
        done_ = done_ | (tok == eos_id)
        write_pos = torch.clamp_max(pos_, cache_len - 1)
        lg, pages = T.decode_step_paged(cfg, params, pages, block_table,
                                        emit, write_pos,
                                        cache_len=cache_len)
        pos_, steps_ = pos_ + 1, steps_ + 1
        emits.append(emit)
        dones.append(done_)
    return torch.stack(emits), torch.stack(dones), lg, pages


# ----------------------------------------------------------------------
# mesh-sharded step programs (serving/mesh.py drives these): one call
# advances every shard's bucket, each cell of the mesh running the
# single-device program above on its own operands; on a 2-D ("data",
# "model") mesh each data shard's program runs tensor-parallel across
# its model columns (sharding/tp.py). Operands come per shard — the
# reference's leading ``n_shards`` axis: host arrays (n_sh, ...) are
# copied to each shard's devices — and per cell (params, pages: lists
# in grid order, as ``ServingMesh.place_params`` and
# ``ShardedPagedKVServer.cell_pages`` give them). Per-shard results
# come from the shard's first column (every column computes the same
# full-vocab logits and tokens); pages are updated in place.
# ----------------------------------------------------------------------
def _first_columns(mesh, results) -> list:
    """Shard k's result: its first column's."""
    return [results[k * mesh.n_model] for k in range(mesh.n_shards)]


def _shard_logits(mesh, logits) -> list:
    """Per-cell copies of per-shard logits (a no-op on the shard's own
    device)."""
    return [logits[k].to(dev) for k, _, dev in mesh.cells()]


def prefill_chunk_paged_sharded(cfg: ModelConfig, params, tokens, pages,
                                block_table, start_pos, *,
                                prompt_len: int, mesh):
    """``prefill_chunk_paged`` across every shard of a serving mesh.
    tokens: (n_sh, B, C); block_table: (n_sh, B, NBp); start_pos:
    (n_sh, B); params and pages per cell. Each cell runs the exact
    single-device chunk program (on its column's heads under tensor
    parallelism), so per-row results are bit-identical to unsharded
    execution — sharding is placement, not math (under tensor
    parallelism on the CPU only: see ``sharding.tp``). Returns
    (per-shard chunk-final logits (B, V), pages)."""
    lcfg = tp_local_cfg(cfg, mesh.n_model)

    def body(p, tk, pgs, table, starts):
        return prefill_chunk_paged(lcfg, p, tk, pgs, table, starts,
                                   prompt_len=prompt_len)

    out = mesh.run(body, list(zip(
        params, mesh.shard_rows(tokens), pages,
        mesh.shard_rows(block_table), mesh.shard_rows(start_pos))))
    return ([lg for lg, _ in _first_columns(mesh, out)],
            [pg for _, pg in out])


def prefill_paged_sharded(cfg: ModelConfig, params, prompt_tokens, pages,
                          prefill_table, *, mesh):
    """``prefill_paged`` across every shard of a serving mesh — the
    whole-prompt program the step loop uses for the quant layout (a
    chunk would re-read the already-quantised prefix). prompt_tokens:
    (n_sh, B, S); prefill_table: (n_sh, B, NBp). Returns (per-shard
    logits0 (B, V), pages)."""
    lcfg = tp_local_cfg(cfg, mesh.n_model)

    def body(p, tk, pgs, table):
        return prefill_paged(lcfg, p, tk, pgs, table)

    out = mesh.run(body, list(zip(
        params, mesh.shard_rows(prompt_tokens), pages,
        mesh.shard_rows(prefill_table))))
    return ([lg for lg, _ in _first_columns(mesh, out)],
            [pg for _, pg in out])


def decode_step_rows_sharded(cfg: ModelConfig, params, logits, pages,
                             block_table, pos, row_keys, steps, done, *,
                             cache_len: int, temperature: float,
                             eos_id: int, pad_id: int, mesh):
    """``decode_step_rows`` across every shard of a serving mesh:
    logits are per shard (B, V) tensors, the other row operands
    (n_sh, B, ...) arrays. A row emits the same token whatever shard
    hosts it and whatever the model-axis size. Returns per-shard
    (emit, logprob, live, new_done, next_logits) and the pages."""
    lcfg = tp_local_cfg(cfg, mesh.n_model)

    def body(p, lg, pgs, table, pos_, keys, steps_, done_):
        return decode_step_rows(
            lcfg, p, lg, pgs, table, pos_, keys, steps_, done_,
            cache_len=cache_len, temperature=temperature, eos_id=eos_id,
            pad_id=pad_id)

    out = mesh.run(body, list(zip(
        params, _shard_logits(mesh, logits), pages,
        mesh.shard_rows(block_table), mesh.shard_rows(pos),
        mesh.shard_rows(row_keys), mesh.shard_rows(steps),
        mesh.shard_rows(done))))
    return ([o[:5] for o in _first_columns(mesh, out)],
            [o[5] for o in out])


def decode_megastep_rows_sharded(cfg: ModelConfig, params, logits, pages,
                                 block_table, pos, row_keys, steps, done,
                                 *, n_ticks: int, cache_len: int,
                                 temperature: float, eos_id: int,
                                 pad_id: int, mesh):
    """``decode_megastep_rows`` across every shard of a serving mesh
    (per-shard logits, (n_sh, B, ...) row operands). Each cell runs the
    identical fused loop, so a row emits the same tokens whatever
    shard hosts it, whatever K the planner picked and whatever the
    model-axis size; the model-axis gathers happen inside each cell's
    program. Returns (per-shard emits (K, B), per-shard dones (K, B),
    per-shard next logits (B, V), pages)."""
    lcfg = tp_local_cfg(cfg, mesh.n_model)

    def body(p, lg, pgs, table, pos_, keys, steps_, done_):
        return decode_megastep_rows(
            lcfg, p, lg, pgs, table, pos_, keys, steps_, done_,
            n_ticks=n_ticks, cache_len=cache_len,
            temperature=temperature, eos_id=eos_id, pad_id=pad_id)

    out = mesh.run(body, list(zip(
        params, _shard_logits(mesh, logits), pages,
        mesh.shard_rows(block_table), mesh.shard_rows(pos),
        mesh.shard_rows(row_keys), mesh.shard_rows(steps),
        mesh.shard_rows(done))))
    first = _first_columns(mesh, out)
    return ([o[0] for o in first], [o[1] for o in first],
            [o[2] for o in first], [o[3] for o in out])


def fork_pages_sharded(pages, src, dst, *, mesh):
    """Per-shard ``fork_pages``: src/dst (n_sh, K) shard-local page
    ids; shards with nothing to fork pass ``src == dst`` self-copies
    (the identity write). Each column copies its own kv-head slice of
    the pages — page ids are the same in every column of a shard.
    Returns the pages."""
    src, dst = np.asarray(src), np.asarray(dst)
    return mesh.run(
        lambda pgs, s, d: fork_pages(pgs, s, d),
        [(pgs, src[k], dst[k])
         for pgs, (k, _, _) in zip(pages, mesh.cells())])


def decode_text(tokens, detok) -> list:
    """Apply a detokenizer callable row-wise (host-side helper): tokens
    (B, S), a tensor or an array -> B decoded rows."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    return [detok(row) for row in np.asarray(tokens)]
