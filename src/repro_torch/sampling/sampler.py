"""Step-level sampling programs over the paged KV pool.

The port of the step-level subset of ``repro/sampling/sampler.py``: the
per-row key streams (``probe_row_keys``/``member_row_keys``), the
batch-composition-invariant draw (``sample_token_rows``), the page fork,
one prefill chunk, one decode step, and the K-tick decode megastep. The
reference compiles each into one XLA program; here they run eagerly,
and the megastep's K ticks are a Python loop over the per-tick body
(capturing it in a CUDA graph is later work). Page tensors are updated
in place.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sampling import prng

Pages = Dict[str, torch.Tensor]


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
    # a true division by a tensor of the temperature (a division by a
    # Python scalar may run as a multiply by its reciprocal)
    scaled = logits.float() / torch.full_like(logits, temperature,
                                              dtype=torch.float32)
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
