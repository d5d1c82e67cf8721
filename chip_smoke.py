#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ACAR (``src/repro_torch``) on one
NVIDIA GPU and check that it is right.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. device — refuse to run without CUDA; print the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build  — compile the hand-written kernels from ``src/repro_torch/csrc``
   with nvcc (``kernels/build.py``) and print the build time;
3. kernels — call each of the six kernels' wrappers on the card at the
   shapes the serving paths give it, hold the result against its plain
   PyTorch version on the same inputs (float32 and bfloat16; for the
   int8 kernels, q in those types over int8 codes), and time kernel,
   plain version and, where one exists, a PyTorch library call as a
   yardstick; hold each bf16 SwiGLU stage (the gate/up and the down
   tensor-core GEMMs) against its own plain version and time it; and
   check bit for bit, in bf16 and f32, that a row's output does not
   depend on the rows beside it (SwiGLU rows 0-7 of the 256-token call
   against an 8-token call, and rows 0-255 of the 4096-token call at
   recurrentgemma-2b's width against a 256-token call; prefill chunk
   positions 0-7 of the 32-position chunk against an 8-position chunk;
   paged-decode rows 0-7 alone and beside a row of 2,048, and every row
   with NaN in its stale slots and with spare table slots; dense-cache
   decode rows 0-7 alone and every row in a 2,048-position cache; the
   same for the int8 paged and dense-cache decodes, whose stale slots
   and spare pages hold codes of +-127 and NaN scales); check the
   wrappers' ``split_ranges`` against the kernels' own key ranges; check
   and time the four decodes at smollm-135m's 2,048-token context too
   (there also within 1% of the largest output), from a cold L2; and
   hold the four decodes against their plain versions at other head
   geometries and lengths; and time kernels 4 and 3 at the shapes phase
   8 gives them (one row over 105 positions; a 97-token prompt); and
   hold, check bit for bit and time the bf16 chunked prefill at head_dim
   128 at llama3-8b's and deepseek-7b's heads (G 4 and G 1), the shapes
   phase 11 gives it; and hold, check bit for bit and time the fused
   SwiGLU at the shapes phase 12 gives it (mixtral-8x22b's experts, d
   6144 / F 16384, over a decode tick's 8 rows and a 256-token chunk;
   deepseek-v2-236b's dense layer 0, d 5120 / F 12288, over a 97-token
   prompt) and in f32 at d 5120, 6144 and 8192 (the two stage kernels,
   K split over a cluster by K alone: d 4093, copied 4 bytes at a time,
   zero-padded to 4094-4096 must give the unpadded call's bits); and
   hold, check bit for bit (positions 0-7) and time the f32
   prefill at llama3-8b's heads (d 128) and over a 32-query chunk at the
   end of a 2,048-token prompt from a cold L2, profile one f32 SwiGLU
   call, one call of each stage and one f32 prefill (one
   ``swiglu_f32_gemm_kernel`` a stage, one ``chunked_prefill_f32_kernel``,
   nothing else), and check ``swiglu_f32_plan`` against the library's
   ``acar_swiglu_f32_plan`` at every K to 8,192; and hold, check bit for
   bit and time kernel 4 at whisper-medium's decode (MHA, H 16, d 64,
   8 rows of 32 positions) and kernel 3 at llava-next-mistral-7b's
   prefill (d 4096 / F 14336
   over 1152 patch positions and 97 text tokens), the shapes phase 13
   gives them; and hold kernel 3's stages as the serving mesh calls
   them (``ops.swiglu_gate_up`` on a column slice, ``ops.swiglu_down``
   over the gathered h): in bf16 and f32 the column slices' h equal the
   unsliced call's bit for bit and gate_up then down equals the fused
   call bit for bit (f32: slices at m 2 and 4), each stage against its
   plain version, timed at llama3-8b's F/2; and hold and time the
   column-invariant projection
   (``ops.projection``, every product against a column-split weight) at
   the mesh's and phase 5's decode shapes against ``torch.matmul``, its
   column slices bit for bit the unsliced call's (cuBLAS's difference
   logged), and its split (``projection_plan``) against the kernel's;
   and hold and time kernels 1, 4, 5 and 6 at more than 8 query heads
   per kv head (granite-34b's G 48 at d 128; G 12 at d 64); and hold,
   check bit for bit and time kernels 1, 4, 5 and 6 at head_dim 256 (G
   8, G 1) and at dk 192 / dv 128, kernel 2 at bf16 d 32, 96, 256 and dk
   192 / dv 128 and f32 d 256, and the selective scan (forward and
   backward) at a state size of 12, padded to 16;
4. reference — a reduced float32 model on the card agrees with the same
   calls on the CPU, where every kernel runs its plain version: chunked
   prefill and a paged decode step; one-shot prefill and decode steps
   over a dense and over an int8 contiguous cache; one-shot prefill into
   int8 pages and paged decode steps over them; deepseek-v2's MLA latent
   cache (capacity MoE, dense layer 0) and mixtral-8x22b's gather MoE on
   ring pages, prefill and two decode steps each; reduced whisper-medium
   (frames) and llava-next-mistral-7b (patches): forward, prefill, two
   decode steps and greedy tokens;
5. serve — the stepped ACAR engine serves 16 long-prompt tasks through
   a full-width smollm-135m fleet cut to its first 6 of 30 layers
   (``SERVE_LAYERS``; bf16, seed-initialised weights): every
   task retires, its three kernels launch during the run, no page leaks
   outside the prefix cache, and a second run reproduces sigma, modes
   and answers;
6. wave — the same stream through a full-width fleet cut to its first
   10 of 30 layers, whose probe and
   probe twin keep int8 KV (two dense members beside them), served by
   the wave engine from pool pages (``run_batch``, the default path of
   ``launch.serve``), by the wave engine over contiguous caches
   (``paged=False``) and by the stepped engine: on each path every task
   is answered, the path's kernels launch, no page leaks, and a rerun
   reproduces sigma, modes, answers and probe texts; on every path of
   phases 5 and 6 each run's results become TraceRecords chained in an
   ``ArtifactStore`` (``engine_traces``, the reference harness's
   materialisation), each chain audits OK and the rerun's head is
   byte-identical to the run's;
7. train — ``make_train_step`` trains falcon-mamba-7b (2 of its 64
   layers) and recurrentgemma-2b (3 of its 26 layers) at their
   published widths, bf16, ``remat="layer"``, 4 optimizer steps each,
   twice: every loss is finite, every param moves, the rerun reproduces
   losses and params bit for bit, and the scan kernels launch forward
   and backward; then ``train()``, the entry point, trains reduced
   smollm-135m on arithmetic and its checkpoint restores bit for bit;
   then reduced mixtral-8x22b and deepseek-v2-236b (the MoE family's
   published widths do not fit one card with AdamW's moments) for 4
   steps twice through ``train()``, and mixtral-8x22b with the gather
   dispatch through ``make_train_step`` (kernel 3 on every expert,
   every expert's weights moved by its backward): finite losses, the
   router's aux in the loss, reruns bit for bit; then reduced
   whisper-medium and llava-next-mistral-7b through ``train()`` (their
   synthetic frames and patches) for 4 steps twice: finite, bit for bit,
   llava's kernel 3 once a layer and step, its MLP weights moved.
8. audit (run after phase 6) — the paper's Algorithm 1 through
   ``ACAROrchestrator`` (probe -> EXTRACT -> sigma -> route by sigma ->
   ensemble -> judge -> an appended TraceRecord) over four
   ``TorchModelBackend``s (phase 5's full-width bf16 params after 20
   arithmetic training steps, so that they answer in the tokenizer's
   vocabulary: the probe, two members, the probe's twin), the 16 tasks
   one by one: 16 records, the audit OK with the
   head equal to the chain recomputed from the records' hashes, some
   task escalated, the dense-cache decode and the fused SwiGLU launched
   and no paged kernel, a rerun into a fresh store giving every record
   hash and a byte-identical head; then leave-one-out values against
   the three attribution proxies over the full-arena records (printed).
9. faults (run after phase 5) — phase 5's fleet, stream and routes
   under the port's fault tolerance and span tracing: a run traced into
   a span file and journaled (its record chain head equal to phase 5's,
   the span file verified, the lineage of every task OK, the journal's
   16 retired rows, one attribution span per full-arena row equal to
   leave-one-out), a run killed at 3/4 of phase 5's ticks and recovered
   from its journal (rows restored, one restore span each, the head
   equal to phase 5's), and the reference harness's degraded-fleet plan
   twice (every task answered or abort-traced, equal fault events and
   heads, a route degraded, two members quarantined, no page leaks);
   each run's wall is printed, the traced one beside phase 5's.
10. queued (run after phase 8, on its arithmetic-trained fleet) — the
   queued wave engine (``run_queued``: the admission queue's
   micro-batches of 8, each a wave) over phase 5's stream and forced
   routes from pool pages, over contiguous caches and as the masked
   baseline (``compact=False, shared_prefix=False``), each run twice:
   batch sizes [8, 8], every task answered, no page leaks, each path's
   kernels and no other, the rerun's head byte-identical, the masked
   head equal to the compacted one (the stepped engine's head is
   printed beside it, a finding); traced over 24 tasks, the members
   sampled at 0.9, with golds keyed to their answers (the head equal
   to the untraced run's, the span file verified, every lineage OK,
   one attribution span per full-arena row equal to leave-one-out,
   some value non-zero); ``ContinuousBatchingScheduler`` over phase 8's four
   ``TorchModelBackend``s with the probe wave prefetched on a worker
   thread (every record hash and the head equal to phase 8's
   orchestrator run, ``logical_time`` the admission order, kernels 3
   and 4 only); and ``serve(scheduler=True)`` traced with a lineage
   walk (batch sizes [8, 8], lineage OK).
11. fleets — the serve CLI's fleets at their published widths, every
   model cut to its first 10 layers, bf16, seed-initialised, over phase
   5's stream and forced routes: (a) the default fleet (a smollm-135m probe; llama3-8b,
   deepseek-7b and recurrentgemma-2b) through the wave engine (the
   dense members from pool pages, the hybrid over contiguous ring and
   RG-LRU caches) and the stepped engine (kernel 2 at d 128, the hybrid
   on the contiguous-cache member fallback); (b) the heterogeneous fleet
   (a falcon-mamba-7b probe on recurrent-state lanes, smollm-135m with
   int8 KV, smollm-135m on 16-token ring pages, llama3-8b) through the
   stepped engine and the ``paged=False`` queued baseline: each path
   twice, every task retired, its kernels and no other, no page or lane
   leaked, the rerun's results and chain head identical; whether the
   stepped head equals the baseline's is printed (a finding); each
   fleet freed before the next is built; (d) granite-34b (2 of its 88
   layers; 48 query heads on one kv head, G 48) behind the smollm-135m
   probe and its twin, over 8 tasks, stepped and through the
   ``paged=False`` queued baseline, each twice with the same gates, the
   decodes seen at G 48; every placed model's param bytes equal
   ``launch.dryrun.account``'s, each pool printed beside the cache
   ``account`` counts for its positions; (c) the serve CLI through
   ``examples_torch/serve_acar.py``'s ``main`` for both fleets (reduced
   models trained 2 steps, 8 tasks), and for the default fleet with
   ``--step-loop`` and with ``--shards 4`` (the step loop on a
   data-sharded mesh of logical devices on the one card): equal
   reports, kernels 1, 2 and 3 launched on the mesh.
12. moe (run last) — the fleet of ``launch.serve --ensemble
   mixtral-8x22b deepseek-v2-236b`` at published widths, bf16,
   seed-initialised, over phase 5's stream and forced routes: the
   smollm-135m probe, mixtral-8x22b with the gather dispatch (4 of its
   56 layers) on ring pages, deepseek-v2-236b as published (capacity
   MoE, MLA, two shared experts, dense layer 0; 2 of its 60 layers) on
   the contiguous-cache member fallback, and the probe's twin; through
   the stepped engine and the ``paged=False`` queued baseline, each
   twice (every task retired, each path's kernels and no other, no page
   leaked, the rerun's results and chain head identical), every gather
   call's kernel-3 launches counted on prefills and on decode ticks;
   walls, launches and the peak memory printed.
13. frontend (run last) — the audio and vision families at published
   widths, bf16, seed-initialised: whisper-medium at full depth (24 +
   24 layers) through ``generate`` over 8 rows of 1500 synthetic frames
   (4-token prompts, 28 greedy tokens) and ``generate_samples`` (3
   samples of 4 prompts at 0.9), each twice bit for bit, kernel 4 once a
   decoder layer and decode step, the projection, and no other kernel;
   llava-next-mistral-7b at its first 10 of 32 layers through
   ``generate`` over 4 rows of 1152 synthetic patches and 97 text tokens
   (8 new tokens, twice bit for bit, kernel 3 once a layer on the
   prefill, the projection, no attention kernel on the ring decodes),
   then phase 5's stream through the probe, llava
   and the probe's twin, stepped (llava on the contiguous-cache member
   fallback) and the ``paged=False`` queued baseline, each twice
   (``serve_twice``'s gates); walls, launches and the peak memory
   printed.
14. mesh (run last; (a) inside phase 11) — the serving mesh on the one
   card, its cells logical devices on ``cuda:0``
   (``launch.mesh.force_device_count``), every mesh run held to the
   same fleet's single-device ``run_stepped`` (equal sigma, modes,
   answers, member answers, probe texts and chain head), every task
   retired, no page leaked on any shard, rows placed on at least two
   shards: (a) ``run_stepped(data_shards=4)`` over phase 11's default
   fleet (published widths, 10 layers; kernels 1, 2 and 3, the hybrid
   on the contiguous-cache member fallback); (b) a (data 2, model 2)
   mesh over the probe llama3-8b, deepseek-7b and the probe's twin at
   published widths, 10 layers, bf16: kernel 3 as its two stages at F/2
   (7168, 5504) around the gather and never fused, kernels 1 and 2 at
   each column's head counts (16 / 4 and 16 / 16), the peak memory
   printed, every column-split projection at a column's N / 2, and the
   probe's logits over one prefill chunk and one decode tick on a (data
   1, model 2) mesh against one device's, their largest difference 0
   (the projections run the column-invariant projection kernel on one
   device and on each column alike); (c) the reduced f32 ``mesh2d``
   fleet (a gather-MoE member
   beside a dense one) at (2, 2) and the reduced int8-KV fleet at data 4
   (kernel 5), 24 tasks each.
15. examples (run after phase 7) — the port's examples
   (``examples_torch/``): (a) ``train_model.py --size 100m``'s
   ``train_full``: smollm-arith-100m (smollm-135m's 30 x 576 stack, f32,
   the char vocabulary), its first two steps' losses equal to the same
   code's on the CPU (relative 1e-5), then 100 steps and the four greedy
   samples, the last logged loss below the first, kernel 3 in f32,
   kernel 4 and the projection launched; steps/s, tokens/s, the peak
   memory and one profiled step's busy share printed; (d) the greedy
   attribution check: the serve CLI's default fleet trained 10 steps a
   model by ``build_zoo``, the members greedy, 32 arithmetic tasks
   through ``run_queued`` traced under golds keyed to their answers
   (head equal to the untraced run's, span file and lineage verified,
   attribution spans equal to leave-one-out, some value non-zero); (c)
   ``quickstart.py`` (12 audited records, no parse error) and
   ``attribution_demo.py`` in process. Phase 11 (c) runs
   ``serve_acar.py``.

Phase 3 also holds the training path's kernels against their plain
versions at the phase-7 shapes (the selective scan and the RG-LRU scan,
forward and backward; the fused SwiGLU at recurrentgemma-2b's width
with its gradient), and phase 4 a train step of each reduced f32 family
on the card against the CPU, every gradient leaf included. For the
selective scan it also checks, in f32 and bf16, that h_final and every
checkpoint equal the plain version's states bit for bit, that batch row
1 computed alone equals its bits inside the batch (y, h_final,
checkpoints, dx, ddt, dB, dC), the wrapper's ``scan_plan`` against the
compiled tile constants, and a sweep of small shapes off the tile grid
(every state size; the element-copy path TMA cannot take); its bound
adds the exponentials on the special-function units at the SM clock
``nvidia-smi`` reads under load. For the RG-LRU scan it checks, in f32
and bf16, that hs, h_final, da and du equal the plain versions' bit for
bit, at recurrentgemma-2b's width and over a sweep of shapes at the
tile edges and off the channel grid (the element-copy path too), that
batch row 1 computed alone equals its bits inside the batch, and the
wrapper's ``rglru_plan`` against the compiled tile constants.

The build prints ptxas's registers, static shared memory and spills
for the two tensor-core kernel sources (with their f32 kernels), the
four split-KV decodes and the two scans, and the serve and train
profiles count the SwiGLU's tensor-core kernels (two for every bf16
wrapper call, and no f32 kernel under it), the decodes' and the scans'
(one for every wrapper call). The kernels' JSON line gives kernels 2
and 3 their f32 times and their f32 launches by path apart.
It prints one JSON line describing the kernels, the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import os

# cuBLAS is deterministic only with a fixed workspace; set before CUDA
# initialises
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TIMED_LAUNCHES = 50
SPIN_CYCLES = 400_000_000          # ~0.2 s at the H100's 1.98 GHz
# ~25 ms: enough to queue TIMED_LAUNCHES single-launch calls
SHORT_SPIN = SPIN_CYCLES // 8
# tolerances of the reference's kernel tests (tests/test_kernels.py,
# tests/test_paged_attention.py): f32 attention 2e-5; bf16 2e-2; the
# fused SwiGLU's relative tolerance is ten times its absolute one. In
# bf16 the SwiGLU kernel keeps the gate and up products in f32 where
# the plain version rounds them (and silu(g)) to bf16, as the Pallas
# kernel and its oracle differ.
TOL = {
    ("attention", "float32"): (2e-5, 2e-5),
    ("attention", "bfloat16"): (2e-2, 2e-2),
    ("swiglu", "float32"): (2e-5, 2e-4),
    ("swiglu", "bfloat16"): (2e-2, 2e-1),
    # the selective scan's y at 5x, its state at 1e-4 / 1e-3, the RG-LRU
    # at 1e-5, as tests/test_kernels.py holds the Pallas kernels
    ("scan_y", "float32"): (1e-4, 1e-4),
    ("scan_y", "bfloat16"): (1e-1, 1e-1),
    ("scan_h", "float32"): (1e-4, 1e-3),
    ("scan_h", "bfloat16"): (1e-4, 1e-3),
    ("rglru", "float32"): (1e-5, 1e-5),
    ("rglru", "bfloat16"): (1e-5, 1e-5),
}
# a gradient's max abs error as a share of its largest magnitude: sums
# over B*S or D in other orders (f32), and one rounding of each output
# to bf16 (2^-8 = 3.9e-3 of it) with the f32 sums' differences before it
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, n: int = TIMED_LAUNCHES, warmup: int = 5,
            flush=None, spin: int = SPIN_CYCLES) -> float:
    """Median device time of ``fn`` over ``n`` calls, by CUDA events.
    A spin kernel holds the stream while the host queues all ``n``
    calls, so each event pair brackets the device work of one call and
    not the host's launch overhead (a plain version that issues
    thousands of kernels a call may outrun the spin, and then its time
    includes the host's). ``flush``, where given, runs before each call,
    outside its events (an L2 flush: inputs read cold from HBM).
    ``spin`` shortens the spin where each call is one launch
    (``SHORT_SPIN``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(spin)
    for start, end in ev:
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_grads(name: str, got, want, dname: str) -> float:
    """Each gradient within ``GRAD_TOL`` of its largest magnitude;
    returns the largest error as a share of it."""
    import torch
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: bad gradient {i}")
        scale = float(w.abs().max())
        share = float((g - w).abs().max()) / max(scale, 1e-30)
        if share > GRAD_TOL[dname]:
            raise AssertionError(
                f"{name}: gradient {i} disagrees with the plain version's:"
                f" max abs err {share:.3e} of its max {scale:.3e} (tol "
                f"{GRAD_TOL[dname]})")
        worst = max(worst, share)
    return worst


def check_close(name: str, got, want, tol) -> float:
    import torch
    atol, rtol = tol
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs "
            f"err {err.max().item():.3e} (atol {atol}, rtol {rtol}) at "
            f"{int(bad.sum())} elements")
    return float(err.max().item())


def out_sha256(t) -> str:
    """The hash of a kernel output's bytes, to compare two versions of a
    kernel bit for bit across processes (``time_decodes.py``)."""
    import hashlib

    import torch
    raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def check_same_rows(name: str, rows, alone) -> None:
    """Bitwise: a row's output computed beside other rows equals the
    same row computed with fewer neighbours."""
    import torch
    torch.cuda.synchronize()
    if rows.shape != alone.shape or not torch.equal(rows, alone):
        diff = (rows.float() - alone.float()).abs().max().item()
        raise AssertionError(f"{name}: rows differ from the same rows "
                             f"computed alone (max abs diff {diff:.3e})")


def swiglu_stages(torch, name: str, x, ws, n: int) -> dict:
    """bf16: each of the SwiGLU's two tensor-core stages against its own
    plain version on the same inputs (stage 2 from the plain h), each
    timed alone."""
    from repro_torch.kernels import fused_swiglu as fs
    wg, wu, wd = ws
    tol = TOL[("swiglu", "bfloat16")]
    h_plain = fs.swiglu_gate_up_plain(x, wg, wu)
    err_h = check_close(f"{name} gate_up stage", fs._launch_gate_up(x, wg, wu),
                        h_plain, tol)
    err_o = check_close(f"{name} down stage", fs._launch_down(h_plain, wd),
                        fs.swiglu_down_plain(h_plain, wd), tol)
    return dict(
        gate_up_err=err_h, down_err=err_o,
        gate_up_ms=time_ms(torch, lambda: fs._launch_gate_up(x, wg, wu), n),
        down_ms=time_ms(torch, lambda: fs._launch_down(h_plain, wd), n))


# ----------------------------------------------------------------------
# phase 3: each kernel against its plain version at serving shapes
# ----------------------------------------------------------------------
H, KV, D, PAGE = 9, 3, 64, 8          # smollm-135m attention geometry
PROMPT = 97                           # BOS + 96 characters, off the grid
MAX_NEW = 8


def _pages(torch, gen, n_pages, dtype):
    shape = (n_pages, PAGE, KV, D)
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype))


def decode_case(torch, gen, dtype):
    """Decode bucket of 32 rows over 14 pages each: rows at depths
    97..104 (the prompt plus 0..7 decoded tokens), the last row a pad
    row pointing at scratch pages, as the step loop pads buckets."""
    b, nb = 32, -(-(PROMPT + MAX_NEW) // PAGE)
    n_pages = b * nb + nb
    k_pages, v_pages = _pages(torch, gen, n_pages, dtype)
    perm = torch.randperm(n_pages - nb, generator=gen, device="cuda")
    table = perm[:b * nb].reshape(b, nb).to(torch.int32)
    table[-1] = torch.arange(n_pages - nb, n_pages, device="cuda")
    depth = torch.arange(b, device="cuda") % MAX_NEW
    depth[-1] = depth[-2]
    lengths = (PROMPT + depth + 1).to(torch.int32)
    q = torch.randn((b, H, D), generator=gen, device="cuda").to(dtype)
    return q, k_pages, v_pages, table.contiguous(), lengths


def prefill_case(torch, gen, dtype, h=H, kv=KV, d=D, dv=None):
    """Prefill chunk of 32 tokens for a bucket of 8 rows at different
    depths of a 97-token prompt (13 pages), the last two rows pad rows
    on scratch pages; smollm-135m's heads by default (value width ``dv``
    where it differs from the key width ``d``)."""
    b, c, nb = 8, 32, -(-PROMPT // PAGE)
    n_pages = b * nb + nb
    shape = (n_pages, PAGE, kv, d)
    k_pages = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v_pages = torch.randn((*shape[:-1], dv or d), generator=gen,
                          device="cuda").to(dtype)
    perm = torch.randperm(n_pages - nb, generator=gen, device="cuda")
    table = perm[:b * nb].reshape(b, nb).to(torch.int32)
    starts = torch.tensor([0, 32, 64, 0, 32, 64, 64, 64], device="cuda")
    table[6:] = torch.arange(n_pages - nb, n_pages, device="cuda")
    qpos = (starts[:, None] + torch.arange(c, device="cuda")[None]).to(
        torch.int32)
    q = torch.randn((b, c, h, d), generator=gen, device="cuda").to(dtype)
    return q, k_pages, v_pages, table.contiguous(), qpos


def prefill_checks(torch, dname, q, kp, vp, table, qpos,
                   spin: int = SPIN_CYCLES, prompt_len: int = PROMPT,
                   flush=None) -> dict:
    """Kernel 2 on one case: within the attention tolerance of its
    plain version, positions 0-7 of the 32-position chunk bit-identical
    to an 8-position chunk, and timed beside its plain version and SDPA
    over the gathered K/V, with its bound (``flush``, where given, before
    each timed call: an L2 flush, so that K and V are read cold)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention_plain)
    h, d, dv = q.shape[2], q.shape[3], vp.shape[3]
    kv = kp.shape[2]
    item = q.element_size()
    width = f"d {d}" if dv == d else f"dk {d} / dv {dv}"
    label = f"chunked_prefill_attention[{dname}, H {h}/KV {kv}, {width}]"
    got = ops.chunked_prefill_attention(q, kp, vp, table, qpos,
                                        prompt_len=prompt_len)
    want = chunked_prefill_attention_plain(q, kp, vp, table, qpos,
                                           prompt_len=prompt_len)
    torch.cuda.synchronize()
    err = check_close(label, got, want, TOL[("attention", dname)])
    check_same_rows(
        f"{label} positions 0-7 of 32",
        got[:, :8], ops.chunked_prefill_attention(
            q[:, :8].contiguous(), kp, vp, table,
            qpos[:, :8].contiguous(), prompt_len=prompt_len))
    ms = time_ms(torch, lambda: ops.chunked_prefill_attention(
        q, kp, vp, table, qpos, prompt_len=prompt_len), spin=spin,
        flush=flush)
    plain = time_ms(torch, lambda: chunked_prefill_attention_plain(
        q, kp, vp, table, qpos, prompt_len=prompt_len), flush=flush)
    kc = _gather(torch, kp, table)[:, :prompt_len]
    vc = _gather(torch, vp, table)[:, :prompt_len]
    kc = kc.repeat_interleave(h // kv, 2).transpose(1, 2)
    vc = vc.repeat_interleave(h // kv, 2).transpose(1, 2)
    mask = (qpos[:, :, None] >= torch.arange(prompt_len, device="cuda")
            [None, None])[:, None]
    q4 = q.transpose(1, 2)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask), spin=spin, flush=flush)
    # keys each row needs: up to its last query position; the two pad
    # rows share their scratch pages
    keys_row = (qpos.max(dim=1).values + 1).clamp(max=prompt_len)
    n_keys = unique_keys(torch, table, keys_row)
    bytes_moved = ((q.numel() + got.numel()) * item
                   + n_keys * kv * (d + dv) * item
                   + 4 * (table.numel() + qpos.numel()))
    flops = 2.0 * h * (d + dv) * float((qpos + 1).sum())
    bnd, by = bound_ms(bytes_moved, flops, dname)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib)


# kernel 2 in bf16 at head_dim 128: llama3-8b (H 32 / KV 8, G 4) and
# deepseek-7b (H 32 / KV 32, G 1), at the serving chunk's shape
PREFILL_D128 = {"llama3-8b": (32, 8, 128), "deepseek-7b": (32, 32, 128)}


def prefill_d128_checks(torch) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    out = {}
    for model, (h, kv, d) in PREFILL_D128.items():
        r = prefill_checks(torch, "bfloat16", *prefill_case(
            torch, gen, torch.bfloat16, h=h, kv=kv, d=d))
        out[model] = dict(heads=h, kv_heads=kv, head_dim=d, **r)
        lib = r["library_ms"]
        log(f"kernel chunked_prefill_attention [bfloat16, {model}: H {h} "
            f"/ KV {kv}, d {d}]: max_abs_err {r['max_abs_err']:.3e}  "
            f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {lib:.4f} ms  bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); positions 0-7 bit-identical to an "
            "8-position chunk")
    return out


# kernels 1, 3 and 4 in bf16 at the shapes phase 11 gives the same two
# models: (H, KV, D, d_ff) at d_model 4096; decodes of 8 rows (a stepped
# bucket, a queued micro-batch) and the SwiGLU of a 32-token chunk over
# 8 rows
FLEET_SHAPES = {"llama3-8b": (32, 8, 128, 14336),
                "deepseek-7b": (32, 32, 128, 11008)}
FLEET_D_MODEL, FLEET_ROWS = 4096, 8


def _fleet_paged(torch, gen, name, h, kv, d, dv=None, dtype=None,
                 spin: int = SPIN_CYCLES) -> dict:
    """Kernel 1 over pages: 8 rows at depths 97..104 (the prompt and
    0..7 new tokens), 14 pages each; bf16 unless ``dtype``, value width
    ``dv`` where it differs from the key width ``d``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention_plain as plain)
    b, nb = FLEET_ROWS, -(-S_WAVE // PAGE)
    dtype = dtype or torch.bfloat16
    dv = dv or d
    dname = str(dtype).split(".")[-1]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, kp, vp = rnd(b, h, d), rnd(b * nb, PAGE, kv, d), rnd(
        b * nb, PAGE, kv, dv)
    table = torch.randperm(b * nb, generator=gen, device="cuda").to(
        torch.int32).reshape(b, nb).contiguous()
    lengths = (PROMPT + torch.arange(b, device="cuda")).to(torch.int32)
    got = ops.paged_decode_attention(q, kp, vp, table, lengths)
    err = check_close(name, got, plain(q, kp, vp, table, lengths),
                      TOL[("attention", dname)])
    check_same_rows(f"{name} rows 0-3 of {b} alone", got[:4],
                    ops.paged_decode_attention(
                        q[:4].contiguous(), kp, vp, table[:4].contiguous(),
                        lengths[:4].contiguous()))
    n_keys = unique_keys(torch, table, lengths)
    item = q.element_size()
    bnd, by = bound_ms((q.numel() + got.numel()) * item
                       + n_keys * kv * (d + dv) * item
                       + 4 * (table.numel() + lengths.numel()),
                       2.0 * h * (d + dv) * float(lengths.sum()), dname)
    return dict(rows=b, lengths=[int(lengths.min()), int(lengths.max())],
                max_abs_err=err, bound_ms=bnd, bound_by=by, **_measure(
                    torch, lambda: ops.paged_decode_attention(
                        q, kp, vp, table, lengths),
                    lambda: plain(q, kp, vp, table, lengths),
                    _sdpa(torch, q, _gather(torch, kp, table),
                          _gather(torch, vp, table), lengths), spin=spin))


def _fleet_dense(torch, gen, name, h, kv, d, s=None, dv=None, dtype=None,
                 spin: int = SPIN_CYCLES) -> dict:
    """Kernel 4 over contiguous caches: 8 rows of ``s`` positions (the
    wave's 105 by default), at 60 positions (or s // 2 where s is
    shorter) and at all s; bf16 unless ``dtype``, value width ``dv``
    where it differs from the key width ``d``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_plain as plain)
    b, s = FLEET_ROWS, s or S_WAVE
    dtype = dtype or torch.bfloat16
    dv = dv or d
    dname = str(dtype).split(".")[-1]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k, v = rnd(b, h, d), rnd(b, s, kv, d), rnd(b, s, kv, dv)
    err = 0.0
    for length in (min(60, s // 2), s):
        got = ops.decode_attention(q, k, v, length)
        err = max(err, check_close(f"{name} length {length}", got,
                                   plain(q, k, v, length),
                                   TOL[("attention", dname)]))
    check_same_rows(f"{name} rows 0-3 of {b} alone", got[:4],
                    ops.decode_attention(q[:4].contiguous(),
                                         k[:4].contiguous(),
                                         v[:4].contiguous(), s))
    item = q.element_size()
    bnd, by = bound_ms((q.numel() + got.numel()) * item
                       + b * s * kv * (d + dv) * item,
                       2.0 * h * (d + dv) * b * s, dname)
    return dict(rows=b, lengths=[s, s], max_abs_err=err, bound_ms=bnd,
                bound_by=by, **_measure(
                    torch, lambda: ops.decode_attention(q, k, v, s),
                    lambda: plain(q, k, v, s), _sdpa(torch, q, k, v, s),
                    spin=spin))


def _fleet_swiglu(torch, gen, name, d, f, t=FLEET_ROWS * 32) -> dict:
    """Kernel 3 on a ``t``-token prefill (a 256-token chunk by default)
    at d_model ``d``, d_ff ``f``: activations of unit scale, weights at
    1/sqrt(fan-in)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_swiglu import fused_swiglu_plain
    x = torch.randn((t, d), generator=gen, device="cuda").to(torch.bfloat16)
    wg, wu, wd = ((torch.randn(sh, generator=gen, device="cuda")
                   / sh[0] ** 0.5).to(torch.bfloat16)
                  for sh in ((d, f), (d, f), (f, d)))
    got = ops.fused_swiglu(x, wg, wu, wd)
    err = check_close(name, got, fused_swiglu_plain(x, wg, wu, wd),
                      TOL[("swiglu", "bfloat16")])
    check_same_rows(f"{name} rows 0-7 of {t}", got[:8],
                    ops.fused_swiglu(x[:8].contiguous(), wg, wu, wd))
    stages = swiglu_stages(torch, name, x, (wg, wu, wd), TIMED_LAUNCHES)
    bnd, by = bound_ms((2 * t * d + 3 * d * f) * 2, 6.0 * t * d * f,
                       "bfloat16")
    return dict(tokens=t, d_model=d, d_ff=f, max_abs_err=err, bound_ms=bnd,
                bound_by=by, **stages, **_measure(
                    torch, lambda: ops.fused_swiglu(x, wg, wu, wd),
                    lambda: fused_swiglu_plain(x, wg, wu, wd),
                    lambda: torch.matmul(F.silu(torch.matmul(x, wg))
                                         * torch.matmul(x, wu), wd)))


def fleet_shape_checks(torch) -> dict:
    """bf16, kernels 1, 4 and 3 at the shapes phase 11 gives them for
    llama3-8b (G 4) and deepseek-7b (G 1) at head_dim 128: each held
    against its plain version, a row's bits checked without its
    neighbours, and timed beside its bound and library call (SDPA;
    three matmuls and silu). Returns {kernel: {model: result}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    out = {"paged_decode_attention": {}, "decode_attention": {},
           "fused_swiglu": {}}
    for model, (h, kv, d, f) in FLEET_SHAPES.items():
        geo = f"bfloat16, {model}: H {h} / KV {kv}, d {d}"
        out["paged_decode_attention"][model] = _fleet_paged(
            torch, gen, f"paged_decode_attention[{geo}]", h, kv, d)
        out["decode_attention"][model] = _fleet_dense(
            torch, gen, f"decode_attention[{geo}]", h, kv, d)
        out["fused_swiglu"][model] = _fleet_swiglu(
            torch, gen, f"fused_swiglu[bfloat16, {model}: d {FLEET_D_MODEL}"
            f", F {f}]", FLEET_D_MODEL, f)
        for name, r in ((n, out[n][model]) for n in out):
            shape = (f"T {r['tokens']}, d {r['d_model']}, F {r['d_ff']}"
                     if name == "fused_swiglu" else
                     f"H {h} / KV {kv}, d {d}, {r['rows']} rows at "
                     f"{r['lengths'][0]}-{r['lengths'][1]} positions")
            log(f"kernel {name} [bfloat16, {model}: {shape}]: max_abs_err "
                f"{r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms"
                f"  bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
                f"{stage_note(r)}")
    log("rows: at phase 11's shapes, decode rows 0-3 of 8 and SwiGLU rows "
        "0-7 of 256 bit-identical to calls without their neighbours")
    return out


# kernels 4 and 3 in bf16 at the shapes phase 13 gives them: whisper-
# medium's decoder self-attention (MHA: H 16 / KV 16, d 64) over 8 rows
# of its 32-position cache (a 4-token prompt and 28 new tokens), and
# llava-next-mistral-7b's prefill MLP (d 4096, F 14336) over one prompt
# of 1152 patch positions and 97 text tokens
WHISPER_DECODE = (16, 16, 64, 32)          # H, KV, D, cache positions
LLAVA_SWIGLU = (1152 + PROMPT, 4096, 14336)  # T, d_model, d_ff


def frontend_shape_checks(torch) -> dict:
    """bf16, kernel 4 at whisper-medium's decode geometry and kernel 3
    at llava-next-mistral-7b's prefill: each held against its plain
    version, a row's bits checked without its neighbours (decode rows
    0-3 of 8, SwiGLU rows 0-7 of the prompt), and timed beside its bound
    and library call (SDPA; three matmuls and silu). Returns {kernel:
    result}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    h, kv, d, s = WHISPER_DECODE
    t, dm, f = LLAVA_SWIGLU
    out = {"decode_attention": _fleet_dense(
               torch, gen, f"decode_attention[bfloat16, whisper-medium: "
               f"H {h} / KV {kv}, d {d}]", h, kv, d, s=s),
           "fused_swiglu": _fleet_swiglu(
               torch, gen, f"fused_swiglu[bfloat16, llava-next-mistral-7b:"
               f" T {t}, d {dm}, F {f}]", dm, f, t=t)}
    for name, r in out.items():
        shape = (f"T {r['tokens']}, d {r['d_model']}, F {r['d_ff']}"
                 if name == "fused_swiglu" else
                 f"H {h} / KV {kv}, d {d}, {r['rows']} rows at "
                 f"{r['lengths'][1]} positions")
        model = ("llava-next-mistral-7b" if name == "fused_swiglu"
                 else "whisper-medium")
        log(f"kernel {name} [bfloat16, {model}: {shape}]: max_abs_err "
            f"{r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms"
            f"  bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
            f"{stage_note(r)}")
    log(f"rows: at phase 13's shapes, decode rows 0-3 of 8 and SwiGLU rows "
        f"0-7 of {t} bit-identical to calls without their neighbours")
    return out


# kernel 3 at the shapes phase 12 gives it, and in f32 at d_model 5120
# and 6144 (where a one-kernel f32 version took 91.42 and 135.28 ms)
# and 8192 (past that version's 6144 limit): (label, dtype, T, d_model,
# d_ff, timed launches). mixtral-8x22b's gather experts run over a
# decode tick's 8 rows and a 32-token chunk of 8 rows; deepseek-v2-236b's
# dense layer 0 over one 97-token prompt on the contiguous-cache
# fallback. The f32 calls take milliseconds on the CUDA cores, so they
# are timed over 5 launches.
MOE_SWIGLU_SHAPES = (
    ("mixtral-8x22b decode tick", "bfloat16", 8, 6144, 16384, 50),
    ("mixtral-8x22b prefill chunk", "bfloat16", 256, 6144, 16384, 50),
    ("deepseek-v2-236b layer 0", "bfloat16", PROMPT, 5120, 12288, 50),
    ("f32 d 5120", "float32", 64, 5120, 12288, 5),
    ("f32 d 6144", "float32", 256, 6144, 16384, 5),
    ("f32 d 8192", "float32", 64, 8192, 4096, 5),
)


def moe_swiglu_checks(torch) -> dict:
    """Kernel 3 at ``MOE_SWIGLU_SHAPES``: activations of unit scale,
    weights at 1/sqrt(fan-in); each held against its plain version at
    the reference's tolerance, its first rows bit-identical to a call
    without the rest (8 of T, 4 of a decode tick's 8), bf16 stages held
    and timed, and timed beside its bound and three matmuls with silu.
    Returns {label: result}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_swiglu import fused_swiglu_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    out = {}
    for label, dname, t, d, f, n in MOE_SWIGLU_SHAPES:
        dtype = getattr(torch, dname)
        x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
        wg, wu, wd = ((torch.randn(sh, generator=gen, device="cuda")
                       / sh[0] ** 0.5).to(dtype)
                      for sh in ((d, f), (d, f), (f, d)))
        name = f"fused_swiglu[{dname}, {label}: T {t}, d {d}, F {f}]"
        got = ops.fused_swiglu(x, wg, wu, wd)
        err = check_close(name, got, fused_swiglu_plain(x, wg, wu, wd),
                          TOL[("swiglu", dname)])
        m = min(8, t // 2)
        check_same_rows(f"{name} rows 0-{m - 1} of {t}", got[:m],
                        ops.fused_swiglu(x[:m].contiguous(), wg, wu, wd))
        stages = (swiglu_stages(torch, name, x, (wg, wu, wd), n)
                  if dtype == torch.bfloat16 else {})
        item = x.element_size()
        bnd, by = bound_ms((2 * t * d + 3 * d * f) * item, 6.0 * t * d * f,
                           dname)
        out[label] = dict(
            dtype=dname, tokens=t, d_model=d, d_ff=f, max_abs_err=err,
            bound_ms=bnd, bound_by=by, rows_alone=m, **stages,
            ms=time_ms(torch, lambda: ops.fused_swiglu(x, wg, wu, wd), n),
            plain_ms=time_ms(torch, lambda: fused_swiglu_plain(
                x, wg, wu, wd), n),
            library_ms=time_ms(torch, lambda: torch.matmul(
                F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu), wd), n))
        r = out[label]
        log(f"kernel {name}: max_abs_err {err:.3e}  kernel {r['ms']:.4f} "
            f"ms  plain {r['plain_ms']:.4f} ms  library "
            f"{r['library_ms']:.4f} ms  bound {bnd:.5f} ms ({by}); rows "
            f"0-{m - 1} bit-identical alone{stage_note(r)}")
        del x, wg, wu, wd, got
    out["f32 widths"] = f32_width_bits(torch, gen)
    torch.cuda.empty_cache()
    return out


def f32_width_bits(torch, gen) -> dict:
    """The f32 stage kernels give the same bits whatever path stages the
    operands: at d_model 4093 (not a multiple of 4) they copy 4 bytes at
    a time, and x, Wg and Wu zero-padded along d to 4094, 4095 and 4096
    (the last by 16-byte copies) take the same split of K
    (``swiglu_f32_plan``: 8 ranks of 512) and add exact zeros to every
    gate and up sum, and Wd's added columns are columns of their own, so
    the first 4093 output columns must equal the unpadded call's bits
    (each sum runs over K in an order fixed by K's plan)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_swiglu import swiglu_f32_plan
    t, d, f = 64, 4093, 1024
    x, wg, wu = (torch.randn(sh, generator=gen, device="cuda") / sh[0] ** 0.5
                 for sh in ((t, d), (d, f), (d, f)))
    wd = torch.randn((f, d), generator=gen, device="cuda") / f ** 0.5
    base = ops.fused_swiglu(x, wg, wu, wd)
    plan = swiglu_f32_plan(d, f).ranges
    for wide in F32_PADDED:
        p = wide - d
        if swiglu_f32_plan(wide, f).ranges[:-1] != plan[:-1]:
            raise AssertionError(f"f32 plan at d {wide} splits K apart "
                                 f"from d {d}")
        got = ops.fused_swiglu(F.pad(x, (0, p)), F.pad(wg, (0, 0, 0, p)),
                               F.pad(wu, (0, 0, 0, p)), F.pad(wd, (0, p)))
        check_same_rows(f"fused_swiglu[float32] d {d} zero-padded to "
                        f"{wide}, columns 0-{d - 1}", got[:, :d], base)
    log(f"fused_swiglu[float32]: d {d} (4-byte copies) zero-padded to "
        f"{F32_PADDED} (the last by 16-byte copies) gives the unpadded "
        "call's bits")
    return dict(tokens=t, d_model=d, d_ff=f, padded_to=list(F32_PADDED),
                bitwise=True)


F32_PADDED = (4094, 4095, 4096)


def swiglu_case(torch, gen, dtype):
    """The prefill MLP of a 32-token chunk over a bucket of 8 rows."""
    t, d, f = 256, 576, 1536
    x = (torch.randn((t, d), generator=gen, device="cuda") * 0.5).to(dtype)
    ws = [(torch.randn(s, generator=gen, device="cuda") * 0.05).to(dtype)
          for s in ((d, f), (d, f), (f, d))]
    return (x, *ws)


ROWS_WAVE = 48                        # 16 tasks x 3 probe samples
S_WAVE = PROMPT + MAX_NEW             # the wave's cache: 105 positions


def _quantize(x):
    from repro_torch.models.attention import quantize_kv
    return quantize_kv(x)


def dense_cache_case(torch, gen, dtype):
    """The probe wave's decode over contiguous caches: 48 rows of 105
    positions (prompt + new tokens, off any power-of-two tile)."""
    shape = (ROWS_WAVE, S_WAVE, KV, D)
    q = torch.randn((ROWS_WAVE, H, D), generator=gen, device="cuda")
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def quant_cache_case(torch, gen, dtype):
    """The same wave over an int8 cache: codes and scales quantised by
    the port's ``quantize_kv``."""
    shape = (ROWS_WAVE, S_WAVE, KV, D)
    q = torch.randn((ROWS_WAVE, H, D), generator=gen, device="cuda")
    kc, ks = _quantize(torch.randn(shape, generator=gen, device="cuda"))
    vc, vs = _quantize(torch.randn(shape, generator=gen, device="cuda"))
    return q.to(dtype), kc, ks, vc, vs


def quant_pages_case(torch, gen, dtype):
    """The probe wave's decode over int8 pages: each task's 12 full
    prompt pages shared by its 3 samples, 2 private pages per sample
    (the forked prompt tail and the decode page), 14 scratch pages.
    Every page starts with random (stale) codes and scales."""
    n_shared, nb = PROMPT // PAGE, -(-S_WAVE // PAGE)
    n_tail, tasks = nb - n_shared, ROWS_WAVE // 3
    n_pages = tasks * n_shared + ROWS_WAVE * n_tail + nb
    shape = (n_pages, PAGE, KV, D)
    kc, ks = _quantize(torch.randn(shape, generator=gen, device="cuda"))
    vc, vs = _quantize(torch.randn(shape, generator=gen, device="cuda"))
    prompt = torch.arange(tasks * n_shared, device="cuda").reshape(
        tasks, n_shared).repeat_interleave(3, dim=0)
    tails = tasks * n_shared + torch.arange(
        ROWS_WAVE * n_tail, device="cuda").reshape(ROWS_WAVE, n_tail)
    table = torch.cat([prompt, tails], dim=1).to(torch.int32).contiguous()
    lengths = torch.full((ROWS_WAVE,), S_WAVE, dtype=torch.int32,
                         device="cuda")
    q = torch.randn((ROWS_WAVE, H, D), generator=gen, device="cuda")
    return q.to(dtype), kc, ks, vc, vs, table, lengths


def unique_keys(torch, table, lengths) -> int:
    """Cache positions the rows must read, a page that several rows
    share counted once: distinct (page, slot) pairs below each row's
    length."""
    nb = table.shape[1]
    pos = torch.arange(nb * PAGE, device=table.device)
    slot = table.long().repeat_interleave(PAGE, dim=1) * PAGE + pos % PAGE
    return int(slot[pos[None] < lengths.long()[:, None]].unique().numel())


def _gather(torch, pages, table):
    b, nb = table.shape
    return pages[table.long()].reshape((b, nb * PAGE) + pages.shape[2:])


# ----------------------------------------------------------------------
# phase 3, the split-KV decodes (kernels 1 and 4): the serving shape, the
# long shape, bitwise row invariance, stale pages, other geometries
# ----------------------------------------------------------------------
LONG_ROWS, LONG_LEN = 32, 2048        # smollm-135m's published context
# at the long shape outputs average 2,048 random values: about 0.04 in
# size (0.15 at most), where TOL's bf16 2e-2 + 2e-2 is loose (one 16-key
# tile dropped from a row moves its outputs by ~3e-3, ~1e-2 at most); so
# there the error is also held to a share of the largest output, which
# a one-step bf16 difference keeps under (2^-7 = 7.8e-3 of a value)
LONG_ERR_SHARE = 1e-2


def check_scaled(name: str, got, want, share: float = LONG_ERR_SHARE):
    """The max abs error within ``share`` of the largest output; returns
    the error as a share of it."""
    scale = float(want.float().abs().max())
    got_share = float((got.float() - want.float()).abs().max()) / max(
        scale, 1e-30)
    if got_share > share:
        raise AssertionError(
            f"{name}: max abs err {got_share:.3e} of the largest output "
            f"{scale:.3e} (limit {share})")
    return got_share


def _l2_flush(torch):
    """A call that reads 128 MB, evicting the inputs from L2."""
    buf = torch.empty(128 << 18, device="cuda")        # 128 MB of f32
    return lambda: buf.sum()


def _sdpa(torch, q, kc, vc, lengths):
    """``scaled_dot_product_attention`` over caches kc/vc (B, S, KV, D)
    expanded to q's H heads, one query a row, masked past the length:
    the yardstick for kernels 1 and 4. ``lengths`` is a (B,) tensor
    (kernel 1: one mask row per batch row, (B, 1, 1, S)) or an int
    (kernel 4's scalar length: one mask broadcast over the batch, (1, 1,
    1, S))."""
    import torch.nn.functional as F
    s, g = kc.shape[1], q.shape[1] // kc.shape[2]
    kc = kc.repeat_interleave(g, 2).transpose(1, 2)
    vc = vc.repeat_interleave(g, 2).transpose(1, 2)
    pos = torch.arange(s, device="cuda")
    if isinstance(lengths, int):
        mask = (pos < lengths)[None, None, None]
    else:
        mask = (pos[None] < lengths[:, None])[:, None, None]
    q4 = q[:, :, None]
    return lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)


def _measure(torch, kernel, plain, library, flush=None,
             spin: int = SPIN_CYCLES) -> dict:
    """Kernel, plain version and library call (None where there is no
    such call) timed alike; ``spin`` for the kernel and the library
    call, one launch each (the plain version keeps the long spin)."""
    return dict(ms=time_ms(torch, kernel, flush=flush, spin=spin),
                plain_ms=time_ms(torch, plain, flush=flush),
                library_ms=(None if library is None
                            else time_ms(torch, library, flush=flush,
                                         spin=spin)))


def long_paged_case(torch, gen, dtype):
    """32 rows at lengths 2,041..2,048 (smollm-135m's 2,048-token
    context, as decode steps near its end), 256 pages each."""
    b, nb = LONG_ROWS, LONG_LEN // PAGE
    k_pages, v_pages = _pages(torch, gen, b * nb, dtype)
    table = torch.randperm(b * nb, generator=gen, device="cuda").reshape(
        b, nb).to(torch.int32).contiguous()
    lengths = (LONG_LEN - 7 + torch.arange(b, device="cuda") % 8).to(
        torch.int32)
    q = torch.randn((b, H, D), generator=gen, device="cuda").to(dtype)
    return q, k_pages, v_pages, table, lengths


def _stale_slots(torch, table, lengths):
    """(pages, slots) that a row's table reaches at or past its length
    and that no row reads below its length (pages may be shared)."""
    nb = table.shape[1]
    pos = torch.arange(nb * PAGE, device="cuda")
    flat = table.long().repeat_interleave(PAGE, dim=1) * PAGE + pos % PAGE
    valid = pos[None] < lengths.long()[:, None]
    stale = flat[~valid].unique()
    stale = stale[~torch.isin(stale, flat[valid])]
    return stale // PAGE, stale % PAGE


def _poison_past_lengths(torch, kp, vp, table, lengths):
    """Copies of the pages with NaN in every stale slot (``_stale_slots``)."""
    pages, slots = _stale_slots(torch, table, lengths)
    kp, vp = kp.clone(), vp.clone()
    kp[pages, slots] = float("nan")
    vp[pages, slots] = float("nan")
    return kp, vp


def paged_invariance(torch, gen, name, q, kp, vp, table, lengths, got):
    """Bitwise: rows 0-7 alone; every row with NaN in the slots past the
    lengths; every row with 4 spare table slots onto NaN pages; rows 0-7
    beside a last row stretched to LONG_LEN over pages of its own."""
    from repro_torch.kernels import ops
    b, nb = table.shape
    check_same_rows(f"{name} rows 0-7 of {b} alone", got[:8],
                    ops.paged_decode_attention(
                        q[:8].contiguous(), kp, vp, table[:8].contiguous(),
                        lengths[:8].contiguous()))
    kp, vp = _poison_past_lengths(torch, kp, vp, table, lengths)
    check_same_rows(f"{name} with NaN in every stale slot", got,
                    ops.paged_decode_attention(q, kp, vp, table, lengths))
    n_pages = kp.shape[0]
    nan = torch.full((4, PAGE, KV, D), float("nan"), dtype=kp.dtype,
                     device="cuda")
    kp, vp = torch.cat([kp, nan]), torch.cat([vp, nan])
    spare = torch.arange(n_pages, n_pages + 4, dtype=torch.int32,
                         device="cuda").expand(b, 4)
    wide = torch.cat([table, spare], dim=1).contiguous()
    check_same_rows(f"{name} with 4 spare table slots onto NaN pages", got,
                    ops.paged_decode_attention(q, kp, vp, wide, lengths))
    nb_long = LONG_LEN // PAGE
    new_k, new_v = _pages(torch, gen, nb_long, q.dtype)
    stretched = torch.cat([table, spare[:, :1].expand(b, nb_long - nb)],
                          dim=1).contiguous()
    stretched[-1] = torch.arange(n_pages + 4, n_pages + 4 + nb_long,
                                 dtype=torch.int32, device="cuda")
    longer = lengths.clone()
    longer[-1] = LONG_LEN
    out = ops.paged_decode_attention(
        q, torch.cat([kp, new_k]), torch.cat([vp, new_v]), stretched,
        longer)
    check_same_rows(f"{name} rows 0-7 beside a row of {LONG_LEN} (NaN "
                    "stale slots)", got[:8], out[:8])


def paged_decode_checks(torch, gen, dname, q, kp, vp, table,
                        lengths) -> dict:
    """Kernel 1 against its plain version at the serving shape, timed
    beside its bound and SDPA; its rows checked bit for bit; and the
    same at the long shape (timed from a cold L2)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention_plain as plain)
    tol = TOL[("attention", dname)]
    item = q.element_size()
    res = {}
    for shape in ("serve", "long"):
        if shape == "long":
            q, kp, vp, table, lengths = long_paged_case(torch, gen, q.dtype)
        name = f"paged_decode_attention[{dname}, {shape}]"
        got = ops.paged_decode_attention(q, kp, vp, table, lengths)
        want = plain(q, kp, vp, table, lengths)
        err = check_close(name, got, want, tol)
        if shape == "serve":
            res["out_sha256"] = out_sha256(got)
            paged_invariance(torch, gen, name, q, kp, vp, table, lengths,
                             got)
        else:
            share = check_scaled(name, got, want)
        n_keys = unique_keys(torch, table, lengths)
        bnd, by = bound_ms(
            2 * q.numel() * item + 2 * n_keys * KV * D * item
            + 4 * (table.numel() + lengths.numel()),
            4.0 * H * D * float(lengths.sum()), dname)
        r = dict(max_abs_err=err, bound_ms=bnd, bound_by=by, **_measure(
            torch, lambda: ops.paged_decode_attention(
                q, kp, vp, table, lengths),
            lambda: plain(q, kp, vp, table, lengths),
            _sdpa(torch, q, _gather(torch, kp, table),
                  _gather(torch, vp, table), lengths),
            _l2_flush(torch) if shape == "long" else None))
        if shape == "serve":
            res.update(r)
        else:
            res["long_shape"] = dict(
                rows=LONG_ROWS, lengths=[int(lengths.min()),
                                         int(lengths.max())],
                err_share=share, l2="flushed before each call", **r)
        del got, want
    return res


def dense_decode_checks(torch, gen, dname, q, k, v) -> dict:
    """Kernel 4 against its plain version at the wave's shape (full and
    a shorter length), timed beside its bound and SDPA; rows 0-7 alone
    and every row in a cache stretched to LONG_LEN positions with NaN
    past the length, bit for bit; and the long shape: 32 rows x 2,048
    positions, timed from a cold L2."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_plain as plain)
    tol = TOL[("attention", dname)]
    item = q.element_size()
    name = f"decode_attention[{dname}]"
    err = 0.0
    for length in (60, S_WAVE):                       # and a length < S
        got = ops.decode_attention(q, k, v, length)
        err = max(err, check_close(f"{name} length {length}", got,
                                   plain(q, k, v, length), tol))
    sha = out_sha256(got)
    check_same_rows(f"{name} rows 0-7 of {q.shape[0]} alone", got[:8],
                    ops.decode_attention(q[:8].contiguous(),
                                         k[:8].contiguous(),
                                         v[:8].contiguous(), S_WAVE))
    nan = torch.full((q.shape[0], LONG_LEN - S_WAVE, KV, D), float("nan"),
                     dtype=k.dtype, device="cuda")
    check_same_rows(f"{name} in a {LONG_LEN}-position cache, NaN past "
                    "the length", got, ops.decode_attention(
                        q, torch.cat([k, nan], 1), torch.cat([v, nan], 1),
                        S_WAVE))
    del nan
    res = {"out_sha256": sha}
    for shape in ("serve", "long"):
        if shape == "long":
            b, s = LONG_ROWS, LONG_LEN
            q = torch.randn((b, H, D), generator=gen, device="cuda").to(
                q.dtype)
            k = torch.randn((b, s, KV, D), generator=gen, device="cuda").to(
                q.dtype)
            v = torch.randn((b, s, KV, D), generator=gen, device="cuda").to(
                q.dtype)
            got, want = ops.decode_attention(q, k, v, s), plain(q, k, v, s)
            err = check_close(f"{name} long", got, want, tol)
            share = check_scaled(f"{name} long", got, want)
            del got, want
        b, s = q.shape[0], k.shape[1]
        bnd, by = bound_ms(2 * q.numel() * item + 2 * b * s * KV * D * item,
                           4.0 * H * D * b * s, dname)
        r = dict(max_abs_err=err, bound_ms=bnd, bound_by=by, **_measure(
            torch, lambda: ops.decode_attention(q, k, v, s),
            lambda: plain(q, k, v, s), _sdpa(torch, q, k, v, s),
            _l2_flush(torch) if shape == "long" else None))
        if shape == "serve":
            res.update(r)
        else:
            res["long_shape"] = dict(rows=b, lengths=[s, s],
                                     err_share=share,
                                     l2="flushed before each call", **r)
    return res


# ----------------------------------------------------------------------
# phase 3, the int8 decodes (kernels 5 and 6) on the same split-KV loop:
# the serving shape, the long shape, bitwise rows, poisoned stale slots
# ----------------------------------------------------------------------
def _quant_pages(torch, gen, n_pages):
    """int8 codes and f32 scales of n_pages random pages, quantised by
    the port's ``quantize_kv``."""
    return _quantize(torch.randn((n_pages, PAGE, KV, D), generator=gen,
                                 device="cuda"))


def long_quant_pages_case(torch, gen, dtype):
    """``long_paged_case`` over int8 pages: 32 rows at lengths
    2,041..2,048, 256 pages each."""
    b, nb = LONG_ROWS, LONG_LEN // PAGE
    kc, ks = _quant_pages(torch, gen, b * nb)
    vc, vs = _quant_pages(torch, gen, b * nb)
    table = torch.randperm(b * nb, generator=gen, device="cuda").reshape(
        b, nb).to(torch.int32).contiguous()
    lengths = (LONG_LEN - 7 + torch.arange(b, device="cuda") % 8).to(
        torch.int32)
    q = torch.randn((b, H, D), generator=gen, device="cuda").to(dtype)
    return q, kc, ks, vc, vs, table, lengths


def _poison_quant(kc, ks, vc, vs, pages, slots):
    """Copies with codes of 127 (K) and -127 (V) and NaN scales at the
    given (page, slot) pairs."""
    kc, ks, vc, vs = kc.clone(), ks.clone(), vc.clone(), vs.clone()
    kc[pages, slots], vc[pages, slots] = 127, -127
    ks[pages, slots], vs[pages, slots] = float("nan"), float("nan")
    return kc, ks, vc, vs


def paged_quant_invariance(torch, gen, name, q, kc, ks, vc, vs, table,
                           lengths, got):
    """Bitwise, against the kernel's own clean call ``got`` (the plain
    version multiplies 0 * NaN, as the Pallas kernel does): rows 0-7
    alone; every row with codes of +-127 and NaN scales in the slots
    past the lengths; every row with 4 spare table slots onto such
    pages; rows 0-7 beside a last row stretched to LONG_LEN over pages
    of its own."""
    from repro_torch.kernels import ops
    attend = ops.paged_decode_attention_quant
    b, nb = table.shape
    check_same_rows(f"{name} rows 0-7 of {b} alone", got[:8],
                    attend(q[:8].contiguous(), kc, ks, vc, vs,
                           table[:8].contiguous(), lengths[:8].contiguous()))
    kc, ks, vc, vs = _poison_quant(kc, ks, vc, vs,
                                   *_stale_slots(torch, table, lengths))
    check_same_rows(f"{name} with codes of +-127 and NaN scales in every "
                    "stale slot", got,
                    attend(q, kc, ks, vc, vs, table, lengths))
    n_pages = kc.shape[0]
    codes = torch.full((4, PAGE, KV, D), 127, dtype=torch.int8,
                       device="cuda")
    nan = torch.full((4, PAGE, KV), float("nan"), device="cuda")
    kc, vc = torch.cat([kc, codes]), torch.cat([vc, -codes])
    ks, vs = torch.cat([ks, nan]), torch.cat([vs, nan])
    spare = torch.arange(n_pages, n_pages + 4, dtype=torch.int32,
                         device="cuda").expand(b, 4)
    wide = torch.cat([table, spare], dim=1).contiguous()
    check_same_rows(f"{name} with 4 spare table slots onto pages of NaN "
                    "scales", got, attend(q, kc, ks, vc, vs, wide, lengths))
    nb_long = LONG_LEN // PAGE
    new_kc, new_ks = _quant_pages(torch, gen, nb_long)
    new_vc, new_vs = _quant_pages(torch, gen, nb_long)
    stretched = torch.cat([table, spare[:, :1].expand(b, nb_long - nb)],
                          dim=1).contiguous()
    stretched[-1] = torch.arange(n_pages + 4, n_pages + 4 + nb_long,
                                 dtype=torch.int32, device="cuda")
    longer = lengths.clone()
    longer[-1] = LONG_LEN
    out = attend(q, torch.cat([kc, new_kc]), torch.cat([ks, new_ks]),
                 torch.cat([vc, new_vc]), torch.cat([vs, new_vs]),
                 stretched, longer)
    check_same_rows(f"{name} rows 0-7 beside a row of {LONG_LEN} (poisoned "
                    "stale slots)", got[:8], out[:8])


def paged_quant_checks(torch, gen, dname, q, kc, ks, vc, vs, table,
                       lengths) -> dict:
    """Kernel 5 against its plain version at the wave's shape and at its
    first decode step (where stale codes and scales past the lengths
    must not reach the output), timed beside its bound; its rows checked
    bit for bit; and the same at the long shape (timed from a cold
    L2)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode_attention_quant import (
        paged_decode_attention_quant_plain as plain)
    tol = TOL[("attention", dname)]
    item = q.element_size()
    res = {}
    for shape in ("serve", "long"):
        if shape == "long":
            q, kc, ks, vc, vs, table, lengths = long_quant_pages_case(
                torch, gen, q.dtype)
            name = f"paged_decode_attention_quant[{dname}, long]"
        else:
            name = f"paged_decode_attention_quant[{dname}]"
        args = (q, kc, ks, vc, vs, table)
        got = ops.paged_decode_attention_quant(*args, lengths)
        want = plain(*args, lengths)
        err = check_close(name, got, want, tol)
        if shape == "serve":
            res["out_sha256"] = out_sha256(got)
            paged_quant_invariance(torch, gen, name, q, kc, ks, vc, vs,
                                   table, lengths, got)
            # the first decode step (length 98): the last table slot is a
            # whole spare page; poisoning it and every stale slot past
            # the lengths must leave the output bit-identical
            first = torch.full_like(lengths, PROMPT + 1)
            got1 = ops.paged_decode_attention_quant(*args, first)
            err = max(err, check_close(
                f"paged_decode_attention_quant[{dname}, length 98]", got1,
                plain(*args, first), tol))
            stale = table[:, -1].long()
            kp_p, ks_p = kc.clone(), ks.clone()
            kp_p[stale], ks_p[stale] = 127, 1e6
            kp_p[table[:, -2].long(), 2:], ks_p[table[:, -2].long(), 2:] = \
                -127, 1e6
            poisoned = ops.paged_decode_attention_quant(
                q, kp_p, ks_p, vc, vs, table, first)
            torch.cuda.synchronize()
            if not torch.equal(poisoned, got1):
                raise AssertionError(
                    f"paged_decode_attention_quant[{dname}]: stale bytes "
                    "past the lengths reached the output")
        else:
            share = check_scaled(name, got, want)
        # a page that several rows share is read once
        bnd, by = bound_ms(
            2 * q.numel() * item
            + 2 * unique_keys(torch, table, lengths) * KV * (D + 4)
            + 4 * (table.numel() + lengths.numel()),
            4.0 * H * D * float(lengths.sum()), dname)
        r = dict(max_abs_err=err, bound_ms=bnd, bound_by=by, **_measure(
            torch, lambda: ops.paged_decode_attention_quant(*args, lengths),
            lambda: plain(*args, lengths), None,
            _l2_flush(torch) if shape == "long" else None))
        if shape == "serve":
            res.update(r)
        else:
            res["long_shape"] = dict(
                rows=LONG_ROWS, lengths=[int(lengths.min()),
                                         int(lengths.max())],
                err_share=share, l2="flushed before each call", **r)
        del got, want
    return res


def dense_quant_checks(torch, gen, dname, q, kc, ks, vc, vs) -> dict:
    """Kernel 6 against its plain version at the wave's shape (full and a
    shorter length), timed beside its bound; rows 0-7 alone and every
    row in a cache stretched to LONG_LEN positions with codes of +-127
    and NaN scales past the length, bit for bit against the kernel's
    clean call; and the long shape: 32 rows x 2,048 positions, timed
    from a cold L2."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention_quant import (
        decode_attention_quant_plain as plain)
    attend = ops.decode_attention_quant
    tol = TOL[("attention", dname)]
    item = q.element_size()
    name = f"decode_attention_quant[{dname}]"
    err = 0.0
    for length in (60, S_WAVE):                       # and a length < S
        got = attend(q, kc, ks, vc, vs, length)
        err = max(err, check_close(f"{name} length {length}", got,
                                   plain(q, kc, ks, vc, vs, length), tol))
    sha = out_sha256(got)
    check_same_rows(f"{name} rows 0-7 of {q.shape[0]} alone", got[:8],
                    attend(q[:8].contiguous(), kc[:8].contiguous(),
                           ks[:8].contiguous(), vc[:8].contiguous(),
                           vs[:8].contiguous(), S_WAVE))
    pad = (q.shape[0], LONG_LEN - S_WAVE, KV)
    codes = torch.full((*pad, D), 127, dtype=torch.int8, device="cuda")
    nan = torch.full(pad, float("nan"), device="cuda")
    check_same_rows(f"{name} in a {LONG_LEN}-position cache, codes of "
                    "+-127 and NaN scales past the length", got, attend(
                        q, torch.cat([kc, codes], 1), torch.cat([ks, nan], 1),
                        torch.cat([vc, -codes], 1), torch.cat([vs, nan], 1),
                        S_WAVE))
    del codes, nan
    res = {"out_sha256": sha}
    for shape in ("serve", "long"):
        if shape == "long":
            b, s = LONG_ROWS, LONG_LEN
            q = torch.randn((b, H, D), generator=gen, device="cuda").to(
                q.dtype)
            kc, ks = _quantize(torch.randn((b, s, KV, D), generator=gen,
                                           device="cuda"))
            vc, vs = _quantize(torch.randn((b, s, KV, D), generator=gen,
                                           device="cuda"))
            got, want = (attend(q, kc, ks, vc, vs, s),
                         plain(q, kc, ks, vc, vs, s))
            err = check_close(f"{name} long", got, want, tol)
            share = check_scaled(f"{name} long", got, want)
            del got, want
        b, s = q.shape[0], kc.shape[1]
        bnd, by = bound_ms(2 * q.numel() * item + 2 * b * s * KV * (D + 4),
                           4.0 * H * D * b * s, dname)
        r = dict(max_abs_err=err, bound_ms=bnd, bound_by=by, **_measure(
            torch, lambda: attend(q, kc, ks, vc, vs, s),
            lambda: plain(q, kc, ks, vc, vs, s), None,
            _l2_flush(torch) if shape == "long" else None))
        if shape == "serve":
            res.update(r)
        else:
            res["long_shape"] = dict(rows=b, lengths=[s, s],
                                     err_share=share,
                                     l2="flushed before each call", **r)
    return res


def check_split_ranges() -> None:
    """``split_ranges`` (the wrappers' mirror of the split, used by the
    CPU tests) against the ranges the kernels compute: the library's
    ``range_start`` from ``decode_split.cuh``, for every length up to
    the geometry checks' longest row."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dense
    from repro_torch.kernels import decode_attention_quant as dense_q
    from repro_torch.kernels import paged_decode_attention_quant as paged_q
    from repro_torch.kernels.paged_decode_attention import split_ranges
    if not (dense.split_ranges is dense_q.split_ranges
            is paged_q.split_ranges is split_ranges):
        raise AssertionError("the decode wrappers' split_ranges differ")
    lib = build.load()
    ctas = lib.acar_decode_split_ctas()
    for length in range(4101):
        want = [(lib.acar_decode_split_start(length, r),
                 lib.acar_decode_split_start(length, r + 1))
                for r in range(ctas)]
        if split_ranges(length) != want:
            raise AssertionError(
                f"split_ranges({length}) = {split_ranges(length)}, the "
                f"kernels' ranges {want}")
    log(f"split_ranges (all four decode wrappers) matches the kernels' "
        f"{ctas} ranges a row at every length 0..4,100")


def launch_floor_ms(torch) -> float:
    """The same timing of the smallest launch there is: one fill kernel
    on a one-element tensor. Part of every kernel time above."""
    x = torch.empty(1, device="cuda")
    return time_ms(torch, lambda: x.zero_())


def log_decode_checks(results: dict) -> None:
    """The long-shape line of every decode in ``results`` and what their
    bitwise row checks covered."""
    for (name, dname), r in results.items():
        if not isinstance(r, dict) or "long_shape" not in r:
            continue
        r = r["long_shape"]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"kernel {name} [{dname}] long shape ({r['rows']} rows at "
            f"{r['lengths'][0]}-{r['lengths'][1]} positions, cold L2): "
            f"max_abs_err {r['max_abs_err']:.3e} = {r['err_share']:.3e} "
            f"of the largest output  kernel {r['ms']:.4f} "
            f"ms  plain {r['plain_ms']:.4f} ms  library {lib}  bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    names = {name for name, _ in results}
    if "paged_decode_attention" in names:
        log("rows: paged decode rows 0-7 of 32 bit-identical alone and "
            f"beside a row of {LONG_LEN}, every row with NaN stale slots and "
            "with spare table slots onto NaN pages; dense-cache decode rows "
            f"0-7 of 48 alone and every row in a {LONG_LEN}-position cache "
            "with NaN past the length (float32 and bfloat16)")
    if "paged_decode_attention_quant" in names:
        log("rows: int8 paged decode rows 0-7 of 48 bit-identical alone and "
            f"beside a row of {LONG_LEN}, every row with codes of +-127 and "
            "NaN scales in its stale slots and with spare table slots onto "
            "pages of NaN scales; int8 dense-cache decode rows 0-7 of 48 "
            f"alone and every row in a {LONG_LEN}-position cache with NaN "
            "scales past the length (float32 and bfloat16)")


# (H, KV, D): G = 8 at D 128 (the f32 tiles take more than 48 KB of
# shared memory), G = 1 at D 42 (rows not 16-byte aligned: loads element
# by element), G = 7 at D 16, G = 2 at D 80 (padded lanes); kernels 1
# and 4 also at phase 11's G 4 and G 1 at D 128 (FLEET_SHAPES)
DECODE_GEOMETRIES = ((16, 2, 128), (4, 4, 42), (14, 2, 16), (6, 3, 80))
# (H, KV, dk, dv) past 128 and with dk != dv: G 10 at 256 (tiles
# of 4, 4 and 2), dk 192 / dv 128, dk 64 / dv 136, 248 at G 3, G 2 (one
# ragged tile)
WIDE_GEOMETRIES = ((10, 1, 256, 256), (6, 2, 192, 128), (4, 4, 64, 136),
                   (6, 2, 248, 248), (4, 2, 256, 256))


def run_decode_geometry_checks(torch) -> None:
    """Kernels 1 and 4 against their plain versions at other head
    geometries, each register budget and load path of the kernels, at
    lengths across the split's edges and past one window of page ids a
    rank."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    lens = (1, 17, 129, 300, 4100)   # 4,100: three windows of page ids
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = TOL[("attention", dname)]
        for h, kv, d, dv in tuple(
                (*g[:3], g[2]) for g in DECODE_GEOMETRIES + tuple(
                    f[:3] for f in FLEET_SHAPES.values())) + WIDE_GEOMETRIES:
            b, nb = len(lens), -(-max(lens) // PAGE)

            def rnd(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype)
            q, kp, vp = rnd(b, h, d), rnd(b * nb, PAGE, kv, d), rnd(
                b * nb, PAGE, kv, dv)
            table = torch.randperm(b * nb, generator=gen, device="cuda").to(
                torch.int32).reshape(b, nb).contiguous()
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            check_close(f"paged_decode_attention[{dname}, H {h} KV {kv} "
                        f"D {d} / {dv}]",
                        ops.paged_decode_attention(q, kp, vp, table,
                                                   lengths),
                        paged_decode_attention_plain(q, kp, vp, table,
                                                     lengths), tol)
            k, v = rnd(b, max(lens), kv, d), rnd(b, max(lens), kv, dv)
            for length in lens:
                check_close(f"decode_attention[{dname}, H {h} KV {kv} D {d}"
                            f" / {dv}, length {length}]",
                            ops.decode_attention(q, k, v, length),
                            decode_attention_plain(q, k, v, length), tol)
    log(f"kernels 1 and 4 agree with their plain versions at (H, KV, D) in "
        f"{list(DECODE_GEOMETRIES)} and "
        f"{[g[:3] for g in FLEET_SHAPES.values()]}, (H, KV, dk, dv) in "
        f"{list(WIDE_GEOMETRIES)}, lengths {list(lens)} (float32 and "
        "bfloat16)")



def run_quant_decode_geometry_checks(torch) -> None:
    """Kernels 5 and 6 against their plain versions at the same
    geometries and lengths, codes and scales by the port's
    ``quantize_kv`` (D 42: codes copied element by element)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention_quant import (
        decode_attention_quant_plain)
    from repro_torch.kernels.paged_decode_attention_quant import (
        paged_decode_attention_quant_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    lens = (1, 17, 129, 300, 4100)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = TOL[("attention", dname)]
        for h, kv, d, dv in tuple((*g, g[2]) for g in DECODE_GEOMETRIES) + (
                WIDE_GEOMETRIES):
            b, nb = len(lens), -(-max(lens) // PAGE)

            def quant(*shape):
                return _quantize(torch.randn(shape, generator=gen,
                                             device="cuda"))
            q = torch.randn((b, h, d), generator=gen, device="cuda").to(
                dtype)
            (kc, ks), (vc, vs) = (quant(b * nb, PAGE, kv, d),
                                  quant(b * nb, PAGE, kv, dv))
            table = torch.randperm(b * nb, generator=gen, device="cuda").to(
                torch.int32).reshape(b, nb).contiguous()
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            check_close(f"paged_decode_attention_quant[{dname}, H {h} KV "
                        f"{kv} D {d} / {dv}]",
                        ops.paged_decode_attention_quant(
                            q, kc, ks, vc, vs, table, lengths),
                        paged_decode_attention_quant_plain(
                            q, kc, ks, vc, vs, table, lengths), tol)
            (kc, ks), (vc, vs) = (quant(b, max(lens), kv, d),
                                  quant(b, max(lens), kv, dv))
            for length in lens:
                check_close(f"decode_attention_quant[{dname}, H {h} KV {kv} "
                            f"D {d} / {dv}, length {length}]",
                            ops.decode_attention_quant(q, kc, ks, vc, vs,
                                                       length),
                            decode_attention_quant_plain(q, kc, ks, vc, vs,
                                                         length), tol)
    log(f"kernels 5 and 6 agree with their plain versions at (H, KV, D) in "
        f"{list(DECODE_GEOMETRIES)}, (H, KV, dk, dv) in "
        f"{list(WIDE_GEOMETRIES)}, lengths {list(lens)} (float32 and "
        "bfloat16)")


def audit_shape_checks(torch, gen) -> dict:
    """bf16, kernels 4 and 3 at the shapes phase 8's orchestrator gives
    them: the dense-cache decode of one row over the 105-position cache
    (the prompt and 8 new tokens) at its full length, and the SwiGLU of
    one 97-token prompt's prefill. Each is held against its plain
    version and timed beside its bound and its library call (SDPA;
    three matmuls and silu). Returns {kernel: result}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.fused_swiglu import fused_swiglu_plain

    dname, dtype, item = "bfloat16", torch.bfloat16, 2
    out = {}
    q = torch.randn((1, H, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((1, S_WAVE, KV, D), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    err = check_close("decode_attention[bfloat16] phase-8 shape",
                      ops.decode_attention(q, k, v, S_WAVE),
                      decode_attention_plain(q, k, v, S_WAVE),
                      TOL[("attention", dname)])
    bnd, by = bound_ms(2 * q.numel() * item + 2 * S_WAVE * KV * D * item,
                       4.0 * H * D * S_WAVE, dname)
    out["decode_attention"] = dict(
        rows=1, positions=S_WAVE, max_abs_err=err, bound_ms=bnd,
        bound_by=by, **_measure(
            torch, lambda: ops.decode_attention(q, k, v, S_WAVE),
            lambda: decode_attention_plain(q, k, v, S_WAVE),
            _sdpa(torch, q, k, v, S_WAVE)))
    t, d, f = PROMPT, 576, 1536
    x = (torch.randn((t, d), generator=gen, device="cuda") * 0.5).to(dtype)
    wg, wu, wd = ((torch.randn(sh, generator=gen, device="cuda")
                   * 0.05).to(dtype) for sh in ((d, f), (d, f), (f, d)))
    err = check_close("fused_swiglu[bfloat16] phase-8 shape",
                      ops.fused_swiglu(x, wg, wu, wd),
                      fused_swiglu_plain(x, wg, wu, wd),
                      TOL[("swiglu", dname)])
    bnd, by = bound_ms((2 * t * d + 3 * d * f) * item, 6.0 * t * d * f,
                       dname)
    out["fused_swiglu"] = dict(
        tokens=t, max_abs_err=err, bound_ms=bnd, bound_by=by, **_measure(
            torch, lambda: ops.fused_swiglu(x, wg, wu, wd),
            lambda: fused_swiglu_plain(x, wg, wu, wd),
            lambda: torch.matmul(F.silu(torch.matmul(x, wg))
                                 * torch.matmul(x, wu), wd)))
    for name, r in out.items():
        log(f"kernel {name} [bfloat16] at phase 8's shape "
            f"({'1 row x %d positions' % S_WAVE if name == 'decode_attention' else 'T %d' % t}): "
            f"max_abs_err {r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms"
            f"  plain {r['plain_ms']:.4f} ms  library "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    return out


def run_kernel_phase(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_swiglu import fused_swiglu_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the decode kernels' invariance and long-shape inputs: a stream of
    # their own, so the other kernels' inputs stay as they were
    gen_split = torch.Generator(device="cuda")
    gen_split.manual_seed(2)
    # and the int8 decodes', likewise
    gen_quant = torch.Generator(device="cuda")
    gen_quant.manual_seed(4)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        item = torch.tensor([], dtype=dtype).element_size()

        # -- paged decode --------------------------------------------
        q, kp, vp, table, lengths = decode_case(torch, gen, dtype)
        results[("paged_decode_attention", dname)] = paged_decode_checks(
            torch, gen_split, dname, q, kp, vp, table, lengths)

        # -- chunked prefill -----------------------------------------
        results[("chunked_prefill_attention", dname)] = prefill_checks(
            torch, dname, *prefill_case(torch, gen, dtype))

        # -- fused swiglu --------------------------------------------
        x, wg, wu, wd = swiglu_case(torch, gen, dtype)
        got = ops.fused_swiglu(x, wg, wu, wd)
        want = fused_swiglu_plain(x, wg, wu, wd)
        torch.cuda.synchronize()
        err = check_close(f"fused_swiglu[{dname}]", got, want,
                          TOL[("swiglu", dname)])
        check_same_rows(f"fused_swiglu[{dname}] rows 0-7 of 256", got[:8],
                        ops.fused_swiglu(x[:8].contiguous(), wg, wu, wd))
        stages = (swiglu_stages(torch, f"fused_swiglu[{dname}]", x,
                                (wg, wu, wd), TIMED_LAUNCHES)
                  if dtype == torch.bfloat16 else {})
        ms = time_ms(torch, lambda: ops.fused_swiglu(x, wg, wu, wd))
        plain = time_ms(torch, lambda: fused_swiglu_plain(x, wg, wu, wd))
        lib = time_ms(torch, lambda: torch.matmul(
            F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu), wd))
        t, d = x.shape
        f = wg.shape[1]
        bytes_moved = (2 * t * d + 3 * d * f) * item
        flops = 6.0 * t * d * f
        bnd, by = bound_ms(bytes_moved, flops, dname)
        results[("fused_swiglu", dname)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=lib, **stages)

        # -- decode over a contiguous cache --------------------------
        q, k, v = dense_cache_case(torch, gen, dtype)
        results[("decode_attention", dname)] = dense_decode_checks(
            torch, gen_split, dname, q, k, v)

        # -- decode over an int8 cache -------------------------------
        results[("decode_attention_quant", dname)] = dense_quant_checks(
            torch, gen_quant, dname, *quant_cache_case(torch, gen, dtype))

        # -- paged decode over int8 pages ----------------------------
        results[("paged_decode_attention_quant", dname)] = (
            paged_quant_checks(torch, gen_quant, dname,
                               *quant_pages_case(torch, gen, dtype)))

    for (name, dname), r in results.items():
        atol, rtol = TOL[("swiglu" if name == "fused_swiglu"
                          else "attention", dname)]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"kernel {name} [{dname}]: max_abs_err {r['max_abs_err']:.3e}"
            f" (atol {atol}, rtol {rtol})  kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms  library {lib}  bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}){stage_note(r)}")
    log("rows: SwiGLU rows 0-7 and prefill positions 0-7 bit-identical to "
        "calls without their neighbours (float32 and bfloat16)")
    results[("chunked_prefill_attention", "bfloat16")]["d128"] = (
        prefill_d128_checks(torch))
    for name, by_model in fleet_shape_checks(torch).items():
        results[(name, "bfloat16")]["fleet_shapes"] = by_model
    results[("fused_swiglu", "bfloat16")]["moe_shapes"] = (
        moe_swiglu_checks(torch))
    for name, r in frontend_shape_checks(torch).items():
        results[(name, "bfloat16")]["frontend_shape"] = r
    # phase 8's shapes: inputs of their own stream, so the others' stay
    gen_audit = torch.Generator(device="cuda")
    gen_audit.manual_seed(6)
    for name, r in audit_shape_checks(torch, gen_audit).items():
        results[(name, "bfloat16")]["audit_shape"] = r
    log_decode_checks(results)
    check_split_ranges()
    run_decode_geometry_checks(torch)
    run_quant_decode_geometry_checks(torch)
    results[("launch_floor", "")] = launch_floor_ms(torch)
    log(f"launch floor: a one-element fill kernel times "
        f"{results[('launch_floor', '')]:.4f} ms")
    return results


def stage_note(r: dict) -> str:
    if "gate_up_ms" not in r:
        return ""
    return (f"; stages: gate_up {r['gate_up_ms']:.4f} ms (err "
            f"{r['gate_up_err']:.3e}), down {r['down_ms']:.4f} ms (err "
            f"{r['down_err']:.3e})")


# ----------------------------------------------------------------------
# phase 3, training path: the scans and the SwiGLU at phase 7's shapes
# ----------------------------------------------------------------------
SS_SHAPE = (4, 1024, 8192, 16)        # falcon-mamba-7b: B, S, d_inner, N
RG_SHAPE = (1, 4096, 2560)            # recurrentgemma-2b: B, S, lru width
SWIGLU_TRAIN = (4096, 2560, 7680)     # recurrentgemma-2b's MLP, B*S tokens
# f32 operations per (b, t, d, n) of the selective scan: forward exp,
# 2 products for the decay and the input, decay*h, the add, h*c and the
# sum over n; backward that recomputation plus about 21 for g, dx, ddt,
# d a_log, dB, dC and the carry. Counted on the CUDA cores' f32 rate:
# all of the scans' arithmetic is f32.
SS_FWD_OPS, SS_BWD_OPS = 7, 28
# exponentials per (b, t, d, n) that the function needs, each one ex2 on
# the special-function units (16 an SM a clock): one decay in either
# direction. The backward kernel takes that exp twice (in the window's
# recomputation and again in the reverse walk, to save registers); the
# second is its design's cost, not the function's, so the bound counts one.
SS_FWD_SFU, SS_BWD_SFU = 1, 1
SFU_PER_SM_CLOCK, SMS = 16, 132
RG_FWD_OPS, RG_BWD_OPS = 2, 4
SCAN_LIBRARY_NOTE = ("no single PyTorch call computes either scan (a "
                     "linear recurrence over the sequence)")


def _scan_case(torch, gen, dtype, shape=SS_SHAPE):
    """The selective scan's inputs as ``mamba_block`` gives them in a
    model of this dtype: x, B, C in it; dt (a softplus in f32) and a_log
    (log 1..N, the model's init) in f32."""
    b, s, d, n = shape
    x = (torch.randn((b, s, d), generator=gen, device="cuda") * 0.5)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, d), generator=gen, device="cuda")) * 0.1
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device="cuda")).expand(d, n).contiguous()
    bm = torch.randn((b, s, n), generator=gen, device="cuda")
    cm = torch.randn((b, s, n), generator=gen, device="cuda")
    return x.to(dtype), dt, a_log, bm.to(dtype), cm.to(dtype)


def sm_clock_mhz(torch) -> float:
    """The SM clock (MHz) ``nvidia-smi`` reads while a spin kernel keeps
    the card busy; logged beside the card's maximum."""
    torch.cuda.synchronize()
    torch.cuda._sleep(4 * SPIN_CYCLES)
    time.sleep(0.2)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "--id=0"],
        capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    sm, top = (float(v) for v in out.splitlines()[0].split(","))
    log(f"SM clock under load {sm:.0f} MHz (maximum {top:.0f} MHz)")
    return sm


def scan_bound(bytes_moved: float, ops: float, exps: float,
               clock_mhz: float):
    """The least time of a scan: the largest of its bytes over the HBM
    rate, its f32 operations over the CUDA cores' f32 peak, and its
    exponentials over the special-function units (16 an SM a clock at
    ``clock_mhz``). Returns (ms, the term that bounds it, every term)."""
    terms = {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
             "operations": ops / PEAK_FLOPS["float32"] * 1e3,
             "sfu": exps / (SFU_PER_SM_CLOCK * SMS * clock_mhz * 1e6) * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by, terms


def check_scan_states(name: str, ss, h, ckpt, x, dt, a_log, bm, cm) -> None:
    """Bitwise: h_final and every checkpoint (the state before each
    chunk-th step) equal the plain version's states."""
    import torch
    from repro_torch.kernels import build
    chunk = build.load().acar_selective_scan_chunk()
    hs, _ = ss._states(x, dt, a_log, bm, cm, with_y=False)
    torch.cuda.synchronize()
    if not torch.equal(h, hs[-1]):
        raise AssertionError(f"{name}: h_final differs from the plain "
                             "version's last state")
    for c in range(ckpt.shape[1]):
        want = hs[c * chunk - 1] if c else torch.zeros_like(hs[0])
        if not torch.equal(ckpt[:, c], want):
            diff = (ckpt[:, c] - want).abs().max().item()
            raise AssertionError(f"{name}: checkpoint {c} differs from the "
                                 f"plain version's state (max {diff:.3e})")


def selective_scan_checks(torch, gen, dtype, clock_mhz: float) -> dict:
    """Kernels 7 and 7b at falcon-mamba-7b's width (``SS_SHAPE``)
    against their plain versions: y within TOL; h_final and every
    checkpoint bit for bit the plain version's states; batch row 1
    computed alone bit-identical to itself inside the batch (y,
    h_final, checkpoints; dx, ddt, dB, dC); gradients by
    ``check_grads``. Times, bounds (with the SFU term) and errors."""
    from repro_torch.kernels import selective_scan as ss
    dname = str(dtype).split(".")[-1]
    item = torch.tensor([], dtype=dtype).element_size()
    x, dt, a_log, bm, cm = _scan_case(torch, gen, dtype)
    b, s, d, n = SS_SHAPE
    y, h, ckpt = ss._launch_fwd(x, dt, a_log, bm, cm)
    yp, hp = ss.selective_scan_plain(x, dt, a_log, bm, cm)
    torch.cuda.synchronize()
    err = max(check_close(f"selective_scan[{dname}] y", y, yp,
                          TOL[("scan_y", dname)]),
              check_close(f"selective_scan[{dname}] h_final", h, hp,
                          TOL[("scan_h", dname)]))
    del yp, hp
    check_scan_states(f"selective_scan[{dname}]", ss, h, ckpt, x, dt, a_log,
                      bm, cm)
    torch.cuda.empty_cache()
    row = [t[1:2].contiguous() for t in (x, dt, bm, cm)]
    y1, h1, ck1 = ss._launch_fwd(row[0], row[1], a_log, row[2], row[3])
    for what, got, alone in (("y", y, y1), ("h_final", h, h1),
                             ("checkpoints", ckpt, ck1)):
        check_same_rows(f"selective_scan[{dname}] {what} of batch row 1",
                        got[1:2], alone)
    ms = time_ms(torch, lambda: ss._launch_fwd(x, dt, a_log, bm, cm), 20)
    plain = time_ms(torch, lambda: ss.selective_scan_plain(
        x, dt, a_log, bm, cm), 2, warmup=1)
    elems = float(b * s * d * n)
    bytes_fwd = (2 * b * s * d * item + 4 * b * s * d
                 + 2 * b * s * n * item + 4 * d * n + 4 * b * d * n)
    bnd, by, terms = scan_bound(bytes_fwd, SS_FWD_OPS * elems,
                                SS_FWD_SFU * elems, clock_mhz)
    out = {("selective_scan", dname): dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
        bound_terms=terms, library_ms=None, sm_clock_mhz=clock_mhz,
        out_sha256=out_sha256(y))}

    dy = torch.randn((b, s, d), generator=gen, device="cuda").to(dtype)
    dh = torch.randn((b, d, n), generator=gen, device="cuda")
    got = ss.selective_scan_bwd(x, dt, a_log, bm, cm, ckpt, dy, dh)
    want = ss.selective_scan_bwd_plain(x, dt, a_log, bm, cm, dy, dh)
    torch.cuda.synchronize()
    if [g.dtype for g in got] != [t.dtype for t in (x, dt, a_log, bm, cm)]:
        raise AssertionError("selective_scan_bwd: gradient dtypes")
    share = check_grads(f"selective_scan_bwd[{dname}]", got, want, dname)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    del want
    alone = ss.selective_scan_bwd(row[0], row[1], a_log, row[2], row[3], ck1,
                                  dy[1:2].contiguous(),
                                  dh[1:2].contiguous())
    for i, what in ((0, "dx"), (1, "ddt"), (3, "dB"), (4, "dC")):
        check_same_rows(f"selective_scan_bwd[{dname}] {what} of batch row "
                        "1", got[i][1:2], alone[i])
    sha = {k: out_sha256(g) for k, g in zip(("dx", "ddt", "da_log", "dB",
                                               "dC"), got)}
    del got, alone
    ms = time_ms(torch, lambda: ss.selective_scan_bwd(
        x, dt, a_log, bm, cm, ckpt, dy, dh), 20)
    plain = time_ms(torch, lambda: ss.selective_scan_bwd_plain(
        x, dt, a_log, bm, cm, dy, dh), 2, warmup=1)
    # reads x, dt, B, C, a_log, dy, dh_final; writes dx, ddt, dB, dC,
    # d a_log
    bytes_bwd = (3 * b * s * d * item + 2 * 4 * b * s * d
                 + 4 * b * s * n * item + 2 * 4 * d * n + 4 * b * d * n)
    bnd, by, terms = scan_bound(bytes_bwd, SS_BWD_OPS * elems,
                                SS_BWD_SFU * elems, clock_mhz)
    out[("selective_scan_bwd", dname)] = dict(
        max_abs_err=err, grad_err_share=share, ms=ms, plain_ms=plain,
        bound_ms=bnd, bound_by=by, bound_terms=terms, library_ms=None,
        sm_clock_mhz=clock_mhz, out_sha256=sha)
    del x, dt, a_log, bm, cm, ckpt, dy, dh, y, h, row, y1, h1, ck1
    torch.cuda.empty_cache()
    return out


def log_scan_checks() -> None:
    log(f"selective scan at {SS_SHAPE} (float32, bfloat16): h_final "
        "and every checkpoint bit-identical to the plain version's states; "
        "batch row 1 alone bit-identical to itself in the batch (y, "
        "h_final, checkpoints, dx, ddt, dB, dC)")


# acar_selective_scan_plan's field for each of ScanPlan's, and the fields
# only the kernels read (logged)
SCAN_PLAN_FIELDS = {"channels": 0, "steps": 1, "chunk": 2, "per_thread": 3,
                    "lanes": 4, "blocks": 7}
SCAN_PLAN_KERNEL_FIELDS = {"threads": 5, "stages": 6, "fwd_smem": 8,
                           "bwd_smem": 9}


def check_scan_plan() -> None:
    """``scan_plan`` (the tile constants the wrapper sizes its scratch
    by) against the compiled kernels' constants, the library's
    ``acar_selective_scan_plan``, at every N the kernels take and D up
    to 300 and 8,192; logs the thread count, ring depth and dynamic
    shared memory that only the kernels read."""
    from repro_torch.kernels import build
    from repro_torch.kernels.selective_scan import (
        padded_state_size, scan_plan)
    lib = build.load()
    # every N up to 32 runs at its padded size, one of the kernels' N
    sizes = sorted({padded_state_size(n) for n in range(1, 33)})
    if sizes != [1, 2, 4, 8, 16, 32]:
        raise AssertionError(f"N 1..32 pad to {sizes}")
    for n in sizes:
        for d in (*range(1, 301), 8192):
            p = scan_plan(d, n)
            want = tuple(getattr(p, k) for k in SCAN_PLAN_FIELDS)
            got = tuple(lib.acar_selective_scan_plan(d, n, f)
                        for f in SCAN_PLAN_FIELDS.values())
            if got != want:
                raise AssertionError(f"scan_plan({d}, {n}) = {p}, the "
                                     f"kernels' constants {got}")
    for n in (8, 16):
        kern = {k: lib.acar_selective_scan_plan(8192, n, f)
                for k, f in SCAN_PLAN_KERNEL_FIELDS.items()}
        log(f"scan plan at D 8,192, N {n}: {scan_plan(8192, n)}; kernels "
            f"only: {kern} (shared memory in bytes)")
    log("scan_plan matches the kernels' compiled constants at every N in "
        "1..32 padded to its power of two, D in 1..300 and 8,192")


# (B, S, D, N), each in f32 and bf16: ragged tiles and channel blocks,
# every state size, and the shapes TMA cannot take (bf16 rows of 72 or 8
# bytes), which copy element by element
SCAN_GEOMETRIES = ((2, 37, 200, 16), (1, 50, 36, 8), (2, 17, 70, 32),
                   (1, 33, 64, 4), (1, 21, 96, 2), (2, 16, 40, 1),
                   (1, 1, 64, 16))


def run_scan_geometry_checks(torch) -> None:
    """Kernels 7 and 7b against their plain versions at small shapes
    off the tile grid: y within TOL, h_final and checkpoints bitwise,
    gradients by ``check_grads``."""
    from repro_torch.kernels import selective_scan as ss
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for shape in SCAN_GEOMETRIES:
            b, s, d, n = shape
            name = f"selective_scan[{dname}, {shape}]"
            x, dt, _, bm, cm = _scan_case(torch, gen, dtype, shape)
            a_log = torch.randn((d, n), generator=gen, device="cuda") * 0.3
            y, h, ckpt = ss._launch_fwd(x, dt, a_log, bm, cm)
            yp, hp = ss.selective_scan_plain(x, dt, a_log, bm, cm)
            torch.cuda.synchronize()
            check_close(f"{name} y", y, yp, TOL[("scan_y", dname)])
            check_scan_states(name, ss, h, ckpt, x, dt, a_log, bm, cm)
            dy = torch.randn((b, s, d), generator=gen,
                             device="cuda").to(dtype)
            dh = torch.randn((b, d, n), generator=gen, device="cuda")
            got = ss.selective_scan_bwd(x, dt, a_log, bm, cm, ckpt, dy, dh)
            want = ss.selective_scan_bwd_plain(x, dt, a_log, bm, cm, dy, dh)
            torch.cuda.synchronize()
            check_grads(f"{name} gradients", got, want, dname)
    log("selective scan agrees with its plain version at (B, S, D, N) in "
        f"{list(SCAN_GEOMETRIES)}: y within TOL, states bitwise, gradients "
        "(float32 and bfloat16)")


def same_bits(got, want) -> bool:
    """Bitwise equality of two tensors' bytes (so -0 differs from +0, and
    a NaN equals a NaN of the same bits)."""
    import torch
    torch.cuda.synchronize()
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.contiguous().view(torch.uint8),
                            want.contiguous().view(torch.uint8)))


def require_bits(name: str, got, want) -> None:
    if not same_bits(got, want):
        diff = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{name}: differs from the plain version's bits"
                             f" (max abs diff {diff:.3e})")


def _rglru_case(torch, gen, dtype, shape):
    """The RG-LRU's inputs in the model's range: decays a in [0.69, 0.99),
    inputs u ~ 0.1 N(0, 1), both in ``dtype`` (the model feeds f32)."""
    b, s, w = shape
    a = (torch.rand((b, s, w), generator=gen, device="cuda") * 0.3
         + 0.69).to(dtype)
    u = (torch.randn((b, s, w), generator=gen, device="cuda")
         * 0.1).to(dtype)
    return a, u


def _rglru_bwd_checks(name: str, rg, a, u, hs, hsp, dhs, dh, exact: bool,
                      dname: str):
    """The backward kernel against the plain backward: da and du bit for
    bit (with ``exact`` false, within ``check_grads``). Returns (the
    kernel's (da, du), the plain one's, whether both are bitwise, the
    largest error as a share of each gradient's max)."""
    import torch
    got = rg.rglru_scan_bwd(a, u, hs, dhs, dh)
    want = rg.rglru_scan_bwd_plain(a, u, hsp, dhs, dh)
    torch.cuda.synchronize()
    if [g.dtype for g in got] != [a.dtype, u.dtype]:
        raise AssertionError(f"{name}: gradient dtypes")
    share = check_grads(name, got, want, dname)
    bits = all(same_bits(g, w) for g, w in zip(got, want))
    if exact:
        for what, g, w in zip(("da", "du"), got, want):
            require_bits(f"{name} {what}", g, w)
    return got, want, bits, share


def rglru_checks(torch, gen, dtype, exact: bool = True) -> dict:
    """Kernels 8 and 8b at recurrentgemma-2b's width (``RG_SHAPE``)
    against their plain versions: hs and h_final bit for bit, da and du
    bit for bit (with ``exact`` false, for a tree whose backward is not
    bitwise, within ``check_grads``, whether bitwise recorded). Times,
    bounds (bytes, or f32 operations), errors and hashes of hs, da and
    du (``out_sha256``: equal hashes, equal bits across trees)."""
    from repro_torch.kernels import rglru_scan as rg
    dname = str(dtype).split(".")[-1]
    item = torch.tensor([], dtype=dtype).element_size()
    b, s, w = RG_SHAPE
    a, u = _rglru_case(torch, gen, dtype, RG_SHAPE)
    hs, hf = rg._launch_fwd(a, u)
    hsp, hfp = rg.rglru_scan_plain(a, u)
    torch.cuda.synchronize()
    tol = TOL[("rglru", dname)]
    err = max(check_close(f"rglru_scan[{dname}] hs", hs, hsp, tol),
              check_close(f"rglru_scan[{dname}] h_final", hf, hfp, tol))
    require_bits(f"rglru_scan[{dname}] hs", hs, hsp)
    require_bits(f"rglru_scan[{dname}] h_final", hf, hfp)
    ms = time_ms(torch, lambda: rg._launch_fwd(a, u), 20)
    plain = time_ms(torch, lambda: rg.rglru_scan_plain(a, u), 3, warmup=1)
    elems = float(b * s * w)
    # reads a, u; writes hs, h_final
    bnd, by = bound_ms((2 * item + 4) * elems + 4 * b * w,
                       RG_FWD_OPS * elems, "float32")
    out = {("rglru_scan", dname): dict(
        max_abs_err=err, bitwise=True, ms=ms, plain_ms=plain, bound_ms=bnd,
        bound_by=by, library_ms=None, out_sha256=out_sha256(hs))}

    dhs = torch.randn((b, s, w), generator=gen, device="cuda")
    dhf = torch.randn((b, w), generator=gen, device="cuda")
    got, want, bits, share = _rglru_bwd_checks(
        f"rglru_scan_bwd[{dname}]", rg, a, u, hs, hsp, dhs, dhf, exact,
        dname)
    err = max(float((g.float() - wt.float()).abs().max())
              for g, wt in zip(got, want))
    sha = {k: out_sha256(g) for k, g in zip(("da", "du"), got)}
    del got, want
    ms = time_ms(torch, lambda: rg.rglru_scan_bwd(a, u, hs, dhs, dhf), 20)
    plain = time_ms(torch, lambda: rg.rglru_scan_bwd_plain(
        a, u, hsp, dhs, dhf), 3, warmup=1)
    # reads a, hs, dhs, dh_final; writes da, du
    bnd, by = bound_ms((3 * item + 8) * elems + 4 * b * w,
                       RG_BWD_OPS * elems, "float32")
    out[("rglru_scan_bwd", dname)] = dict(
        max_abs_err=err, bitwise=bits, grad_err_share=share, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
        out_sha256=sha)
    del a, u, hs, hf, hsp, hfp, dhs, dhf
    torch.cuda.empty_cache()
    return out


def log_rglru_checks() -> None:
    log(f"RG-LRU scan at {RG_SHAPE} (float32, bfloat16): hs, h_final, da "
        "and du bit-identical to the plain versions'")


# rglru_plan's fields and the library's acar_rglru_scan_plan field of
# each, and the fields only the kernels read (logged)
RGLRU_PLAN_FIELDS = {"channels": 0, "steps": 1, "blocks": 2}
RGLRU_PLAN_KERNEL_FIELDS = {"fwd_stages": 3, "bwd_stages": 4, "threads": 5,
                            "fwd_smem": 6, "bwd_smem": 7}


def check_rglru_plan() -> None:
    """``rglru_plan`` (the tile constants the CPU tests emulate) against
    the compiled kernels' constants, ``acar_rglru_scan_plan``, at W up to
    300 and recurrentgemma-2b's 2,560; logs the ring depth, threads,
    shared memory and the CTAs at ``RG_SHAPE`` against the SMs."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan import rglru_plan
    lib = build.load()
    for w in (*range(1, 301), RG_SHAPE[2]):
        p = rglru_plan(w)
        want = tuple(getattr(p, k) for k in RGLRU_PLAN_FIELDS)
        got = tuple(lib.acar_rglru_scan_plan(w, f)
                    for f in RGLRU_PLAN_FIELDS.values())
        if got != want:
            raise AssertionError(f"rglru_plan({w}) = {p}, the kernels' "
                                 f"constants {got}")
    b, _, w = RG_SHAPE
    kern = {k: lib.acar_rglru_scan_plan(w, f)
            for k, f in RGLRU_PLAN_KERNEL_FIELDS.items()}
    ctas = b * rglru_plan(w).blocks
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"rglru plan at W {w}: {rglru_plan(w)}; kernels only: {kern} "
        f"(shared memory in bytes); {ctas} CTAs at {RG_SHAPE} on {sms} SMs; "
        "rglru_plan matches the compiled constants at W in 1..300 and "
        f"{w}")


# (B, S, W), each in f32 and bf16: S at the tile edges (1, T - 1, T,
# T + 1, 2T + 3 for T = 64), W off the 32-channel grid, and rows TMA
# cannot take (W not a multiple of 4, or of 8 in bf16), which copy
# element by element
RG_GEOMETRIES = ((2, 1, 40), (2, 63, 21), (2, 64, 2568), (2, 65, 1),
                 (2, 131, 15), (2, 131, 2560), (2, 200, 36))


def run_rglru_geometry_checks(torch, exact: bool = True) -> bool:
    """Kernels 8 and 8b against their plain versions at
    ``RG_GEOMETRIES``: hs and h_final bit for bit; da and du bit for bit
    with h_final's gradient and without (with ``exact`` false, within
    ``check_grads``); batch row 1 computed alone bit-identical to itself
    in the batch, forward and backward. Returns whether every gradient
    was bitwise."""
    from repro_torch.kernels import rglru_scan as rg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    all_bits = True
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for shape in RG_GEOMETRIES:
            b, s, w = shape
            name = f"rglru_scan[{dname}, {shape}]"
            a, u = _rglru_case(torch, gen, dtype, shape)
            hs, hf = rg._launch_fwd(a, u)
            hsp, hfp = rg.rglru_scan_plain(a, u)
            require_bits(f"{name} hs", hs, hsp)
            require_bits(f"{name} h_final", hf, hfp)
            dhs = torch.randn((b, s, w), generator=gen, device="cuda")
            dhf = torch.randn((b, w), generator=gen, device="cuda")
            grads = {}
            for dh in (dhf, None):
                given = dh is not None
                grads[given], _, bits, _ = _rglru_bwd_checks(
                    f"rglru_scan_bwd[{dname}, {shape}, dh_final "
                    f"{'given' if given else 'none'}]", rg, a, u, hs, hsp,
                    dhs, dh, exact, dname)
                all_bits = all_bits and bits
            row = [t[1:2].contiguous() for t in (a, u, dhs, dhf)]
            hs1, hf1 = rg._launch_fwd(row[0], row[1])
            da1, du1 = rg.rglru_scan_bwd(row[0], row[1], hs1, row[2], row[3])
            da, du = grads[True]
            for what, x, alone in (("hs", hs, hs1), ("h_final", hf, hf1),
                                   ("da", da, da1), ("du", du, du1)):
                if not same_bits(x[1:2], alone):
                    raise AssertionError(f"{name} {what} of batch row 1 "
                                         "differs from the row computed "
                                         "alone")
    grads = ("bit for bit" if all_bits
             else "within check_grads, not all bitwise")
    log(f"RG-LRU scan agrees with its plain versions at (B, S, W) in "
        f"{list(RG_GEOMETRIES)}, float32 and bfloat16: hs and h_final bit "
        f"for bit, da and du {grads} (with and without h_final's "
        "gradient); batch row 1 alone bit-identical to itself in the "
        "batch")
    return all_bits


def run_train_kernel_phase(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_swiglu import fused_swiglu_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    results = {}
    clock = sm_clock_mhz(torch)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        item = torch.tensor([], dtype=dtype).element_size()

        # -- selective scan, forward and backward --------------------
        results.update(selective_scan_checks(torch, gen, dtype, clock))

        # -- RG-LRU scan, forward and backward -----------------------
        results.update(rglru_checks(torch, gen, dtype))

        # -- fused SwiGLU at recurrentgemma-2b's width, and its gradient
        t, d, f = SWIGLU_TRAIN
        xs = (torch.randn((t, d), generator=gen, device="cuda")
              * 0.5).to(dtype)
        ws = [(torch.randn(sh, generator=gen, device="cuda")
               * 0.02).to(dtype) for sh in ((d, f), (d, f), (f, d))]
        got = ops.fused_swiglu(xs, *ws)
        want = fused_swiglu_plain(xs, *ws)
        torch.cuda.synchronize()
        err = check_close(f"fused_swiglu[{dname}, d {d}]", got, want,
                          TOL[("swiglu", dname)])
        check_same_rows(f"fused_swiglu[{dname}, d {d}] rows 0-255 of {t}",
                        got[:256], ops.fused_swiglu(xs[:256].contiguous(),
                                                    *ws))
        del want
        stages = (swiglu_stages(torch, f"fused_swiglu[{dname}, d {d}]", xs,
                                ws, 5)
                  if dtype == torch.bfloat16 else {})
        ms = time_ms(torch, lambda: ops.fused_swiglu(xs, *ws), 5)
        plain = time_ms(torch, lambda: fused_swiglu_plain(xs, *ws), 5)
        lib = time_ms(torch, lambda: torch.matmul(
            F.silu(torch.matmul(xs, ws[0])) * torch.matmul(xs, ws[1]),
            ws[2]), 5)
        bnd, by = bound_ms((2 * t * d + 3 * d * f) * item,
                           6.0 * t * d * f, dname)
        xr = xs.clone().requires_grad_(True)
        wr = [wt.clone().requires_grad_(True) for wt in ws]
        dy = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
        got = torch.autograd.grad(ops.fused_swiglu(xr, *wr), [xr, *wr], dy)
        want = torch.autograd.grad(fused_swiglu_plain(xr, *wr), [xr, *wr],
                                   dy)
        torch.cuda.synchronize()
        share = check_grads(f"fused_swiglu gradient[{dname}, d {d}]", got,
                            want, dname)
        results[("fused_swiglu_train", dname)] = dict(
            max_abs_err=err, grad_err_share=share, ms=ms, plain_ms=plain,
            bound_ms=bnd, bound_by=by, library_ms=lib, **stages)
        del xs, ws, xr, wr, dy, got, want
        torch.cuda.empty_cache()

    for (name, dname), r in results.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        extra = (f"  gradient err {r['grad_err_share']:.3e} of max"
                 if "grad_err_share" in r else "")
        if "bitwise" in r:
            extra += f"  bitwise {r['bitwise']}"
        if "bound_terms" in r:
            extra += "  bound terms " + ", ".join(
                f"{k} {v:.5f} ms" for k, v in r["bound_terms"].items())
        log(f"kernel {name} [{dname}]: max_abs_err {r['max_abs_err']:.3e}"
            f"{extra}  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} "
            f"ms  library {lib}  bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}){stage_note(r)}")
    log(f"rows: SwiGLU rows 0-255 of the {SWIGLU_TRAIN[0]}-token call "
        "bit-identical to a 256-token call (float32 and bfloat16)")
    log_scan_checks()
    check_scan_plan()
    run_scan_geometry_checks(torch)
    log_rglru_checks()
    check_rglru_plan()
    run_rglru_geometry_checks(torch)
    return results


# ----------------------------------------------------------------------
# phase 4: the port on the card against the port on the CPU
# ----------------------------------------------------------------------
def run_reference_phase(torch):
    """A reduced float32 model: one chunked prefill and one decode step
    with the kernels on the card, against the same calls on the CPU
    (plain versions). Logits and written pages must agree."""
    from repro_torch.configs import get_config
    from repro_torch.models import params as params_lib
    from repro_torch.models import transformer as T

    cfg = get_config("smollm-135m", reduced=True).replace(
        vocab_size=19, dtype="float32", tie_embeddings=True)
    params_cpu = params_lib.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    b, s, c = 4, 21, 8
    nb = -(-(s + 2) // PAGE)
    ids = rng.integers(3, 19, size=(b, s)).astype(np.int64)
    table = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    out = {}
    for dev in ("cpu", "cuda"):
        prm = params_cpu if dev == "cpu" else _to_device(params_cpu, dev)
        shape = (cfg.num_layers, b * nb, PAGE, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        pages = {"k": torch.zeros(shape, device=dev),
                 "v": torch.zeros(shape, device=dev)}
        bt = torch.from_numpy(table).to(dev)
        for start in range(0, s, c):
            cc = min(c, s - start)
            lg, pages = T.prefill_chunk_paged(
                cfg, prm, torch.from_numpy(ids[:, start:start + cc]).to(dev),
                pages, bt, torch.full((b,), start, dtype=torch.int32,
                                      device=dev), prompt_len=s)
        pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        lg2, pages = T.decode_step_paged(
            cfg, prm, pages, bt, torch.argmax(lg, -1), pos,
            cache_len=s + 2)
        out[dev] = (lg.cpu(), lg2.cpu(), pages["k"].cpu())
    for i, what in enumerate(("prefill logits", "decode logits",
                              "K pages")):
        a, bref = out["cuda"][i], out["cpu"][i]
        if a.shape != bref.shape or not torch.isfinite(a).all():
            raise AssertionError(f"reference check: bad {what}")
        err = float((a - bref).abs().max())
        if err > 1e-4:
            raise AssertionError(
                f"reference check: {what} on the card differ from the "
                f"CPU by {err:.3e}")
        log(f"reference: {what} card vs cpu max abs diff {err:.3e}")


def run_wave_reference_phase(torch):
    """The wave path's model calls on a reduced float32 model: one-shot
    prefill and two decode steps over a dense cache (the dense-cache
    decode kernel) and over an int8 cache (the int8-cache kernel), and
    one-shot prefill into int8 pages followed by two paged decode steps
    (the int8 paged kernel), on the card against the same calls on the
    CPU. Logits must agree to 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import params as params_lib
    from repro_torch.models import transformer as T

    base = get_config("smollm-135m", reduced=True).replace(
        vocab_size=19, dtype="float32", tie_embeddings=True)
    cfg = base.replace(kv_quant=True)
    params_cpu = params_lib.init_params(base, 0, device="cpu")
    rng = np.random.default_rng(1)
    b, s, new = 4, 21, 2
    ids = rng.integers(3, 19, size=(b, s)).astype(np.int64)
    nbp, nb = -(-s // PAGE), -(-(s + new) // PAGE) + 1   # a spare slot
    table = rng.permutation(b * nb).astype(np.int32).reshape(b, nb)

    def cache_program(c, prm, dev):
        lg, cache = T.prefill(c, prm, torch.from_numpy(ids).to(dev),
                              cache_len=s + new)
        out = [lg]
        for step in range(new):
            lg, cache = T.decode_step(c, prm, cache, torch.argmax(lg, -1),
                                      s + step)
            out.append(lg)
        return out

    def pages_program(c, prm, dev):
        shape = (c.num_layers, b * nb, PAGE, c.num_kv_heads,
                 c.resolved_head_dim)
        pages = {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "k_scale": torch.zeros(shape[:-1], device=dev),
                 "v_scale": torch.zeros(shape[:-1], device=dev)}
        bt = torch.from_numpy(table).to(dev)
        lg, pages = T.prefill_paged(c, prm, torch.from_numpy(ids).to(dev),
                                    pages, bt[:, :nbp].contiguous())
        out = [lg]
        for step in range(new):
            pos = torch.full((b,), s + step, dtype=torch.int32, device=dev)
            lg, pages = T.decode_step_paged(c, prm, pages, bt,
                                            torch.argmax(lg, -1), pos,
                                            cache_len=s + new)
            out.append(lg)
        return out

    params_gpu = _to_device(params_cpu, "cuda")
    for label, c, program, kernel in (
            ("dense cache", base, cache_program, "decode_attention"),
            ("int8 cache", cfg, cache_program, "decode_attention_quant"),
            ("int8 pages", cfg, pages_program,
             "paged_decode_attention_quant")):
        want = program(c, params_cpu, "cpu")
        ops.reset_launch_counts()
        got = program(c, params_gpu, "cuda")
        torch.cuda.synchronize()
        if ops.launch_counts()[kernel] != new * c.num_layers:
            raise AssertionError(f"reference check: {label} did not run "
                                 f"{kernel} on the card")
        for i, (a, bref) in enumerate(zip(got, want)):
            a = a.cpu()
            if a.shape != bref.shape or not torch.isfinite(a).all():
                raise AssertionError(
                    f"reference check: bad {label} logits {i}")
            err = float((a - bref).abs().max())
            if err > 1e-4:
                raise AssertionError(
                    f"reference check: {label} logits {i} on the card "
                    f"differ from the CPU by {err:.3e}")
            what = "prefill" if i == 0 else f"decode step {i}"
            log(f"reference: {label} {what} logits card vs cpu max abs "
                f"diff {err:.3e}")


def _to_device(tree, dev):
    return {k: _to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def run_moe_reference_phase(torch):
    """Phase 12's model calls on reduced float32 MoE models, on the card
    against the same calls on the CPU, logits within 1e-4: deepseek-v2
    (capacity MoE, MLA, a shared expert, dense layer 0) prefilled into
    its latent cache and decoded two steps (the contiguous-cache member
    fallback: kernel 3 in layer 0's prefill only); mixtral-8x22b with
    the gather dispatch prefilled one-shot into ring pages and decoded
    two steps over them (kernel 3 for every expert of every layer, on
    the prefill and on each decode step)."""
    from repro_torch.kernels import ops
    from repro_torch.models import params as params_lib
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(3)
    b, s, new = 4, 21, 2
    ids = rng.integers(3, 500, size=(b, s)).astype(np.int64)

    def cache_program(c, prm, dev):
        lg, cache = T.prefill(c, prm, torch.from_numpy(ids).to(dev),
                              cache_len=s + new)
        out = [lg]
        for step in range(new):
            lg, cache = T.decode_step(c, prm, cache, torch.argmax(lg, -1),
                                      s + step)
            out.append(lg)
        return out

    def ring_program(c, prm, dev):
        ring = min(s + new, c.window)
        nb = -(-ring // PAGE)
        shape = (c.num_layers, b * nb, PAGE, c.num_kv_heads,
                 c.resolved_head_dim)
        pages = {"k": torch.zeros(shape, device=dev),
                 "v": torch.zeros(shape, device=dev)}
        bt = torch.arange(b * nb, dtype=torch.int32,
                          device=dev).reshape(b, nb)
        lg, pages = T.prefill_paged(c, prm, torch.from_numpy(ids).to(dev),
                                    pages, bt, cache_len=s + new)
        out = [lg]
        for step in range(new):
            pos = torch.full((b,), s + step, dtype=torch.int32, device=dev)
            lg, pages = T.decode_step_paged(c, prm, pages, bt,
                                            torch.argmax(lg, -1), pos,
                                            cache_len=s + new)
            out.append(lg)
        return out

    for label, cfg, program, swiglu_calls in (
            ("deepseek-v2-236b latent cache", reduced_variant(
                "deepseek-v2-236b"), cache_program, 1),
            ("mixtral-8x22b:gather ring pages", reduced_variant(
                "mixtral-8x22b:gather"), ring_program, None)):
        if swiglu_calls is None:
            swiglu_calls = (1 + new) * cfg.num_layers * cfg.moe.num_experts
            if T.resolve_layout(cfg) != "ring":
                raise AssertionError(f"reference check: {label} layout")
        params_cpu = params_lib.init_params(cfg, 0, device="cpu")
        with torch.no_grad():
            want = program(cfg, params_cpu, "cpu")
            ops.reset_launch_counts()
            got = program(cfg, _to_device(params_cpu, "cuda"), "cuda")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if launches["fused_swiglu"] != swiglu_calls or any(
                v for k, v in launches.items()
                if k not in ("fused_swiglu", "projection")) or (
                    launches["projection"] <= 0):
            raise AssertionError(f"reference check: {label} launched "
                                 f"{launches}, not {swiglu_calls} SwiGLU "
                                 "calls and the projection alone")
        for i, (a, bref) in enumerate(zip(got, want)):
            a = a.cpu()
            if a.shape != bref.shape or not torch.isfinite(a).all():
                raise AssertionError(f"reference check: bad {label} "
                                     f"logits {i}")
            err = float((a - bref).abs().max())
            if err > 1e-4:
                raise AssertionError(
                    f"reference check: {label} logits {i} on the card "
                    f"differ from the CPU by {err:.3e}")
            what = "prefill" if i == 0 else f"decode step {i}"
            log(f"reference: {label} {what} logits card vs cpu max abs "
                f"diff {err:.3e}")
        log(f"reference: {label}: {swiglu_calls} fused_swiglu calls, "
            f"{launches['projection']} projections, no other kernel")


def run_frontend_reference_phase(torch):
    """Phase 13's model calls on reduced float32 whisper-medium (64
    frames) and llava-next-mistral-7b (16 patches), on the card against
    the same calls on the CPU, the same frames or patches fed to both:
    ``forward``, one-shot ``prefill`` and two ``decode_step``s, logits
    within 1e-4; greedy ``generate`` tokens equal. Whisper's decode
    steps run kernel 4 once a decoder layer (its GELU MLPs, encoder and
    cross-attention no kernel); llava's prefill runs kernel 3 once a
    layer and its ring decodes no kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models import params as params_lib
    from repro_torch.models import transformer as T
    from repro_torch.sampling import sampler as S

    rng = np.random.default_rng(5)
    b, s, new = 4, 21, 2
    for arch in ("whisper-medium", "llava-next-mistral-7b"):
        cfg = reduced_variant(arch)
        n = (cfg.encoder.num_frames if cfg.frontend == "audio"
             else cfg.num_patches)
        fe_np = (rng.standard_normal((b, n, cfg.d_model))
                 * 0.02).astype(np.float32)
        ids = rng.integers(3, 500, size=(b, s)).astype(np.int64)
        params_cpu = params_lib.init_params(cfg, 0, device="cpu")

        def program(prm, dev):
            tokens = torch.from_numpy(ids).to(dev)
            fe = torch.from_numpy(fe_np).to(dev)
            out = [T.forward(cfg, prm, tokens, fe)[0]]
            lg, cache = T.prefill(cfg, prm, tokens, fe, cache_len=s + new)
            out.append(lg)
            for step in range(new):
                lg, cache = T.decode_step(cfg, prm, cache,
                                          torch.argmax(lg, -1), s + step)
                out.append(lg)
            gen = S.generate(cfg, prm, tokens, max_new_tokens=6,
                             frontend_embeds=fe)
            return out, gen.tokens

        with torch.no_grad():
            want, want_tok = program(params_cpu, "cpu")
            ops.reset_launch_counts()
            got, got_tok = program(_to_device(params_cpu, "cuda"), "cuda")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if cfg.frontend == "audio":
            # two decode steps and generate's six, kernel 4 a layer each
            need = {"decode_attention": (new + 6) * cfg.num_layers}
        else:
            # forward, prefill and generate's prefill, kernel 3 a layer
            need = {"fused_swiglu": 3 * cfg.num_layers}
        need["projection"] = launches["projection"]   # wq, wk, wv, lm_head
        if launches != dict({k: 0 for k in launches}, **need) or (
                need["projection"] <= 0):
            raise AssertionError(f"reference check: {arch} launched "
                                 f"{launches}, not {need} alone")
        for i, (a, bref) in enumerate(zip(got, want)):
            a = a.cpu()
            if a.shape != bref.shape or not torch.isfinite(a).all():
                raise AssertionError(f"reference check: bad {arch} "
                                     f"logits {i}")
            err = float((a - bref).abs().max())
            if err > 1e-4:
                raise AssertionError(
                    f"reference check: {arch} logits {i} on the card "
                    f"differ from the CPU by {err:.3e}")
            what = ("forward", "prefill")[i] if i < 2 else \
                f"decode step {i - 1}"
            log(f"reference: {arch} {what} logits card vs cpu max abs "
                f"diff {err:.3e}")
        if not torch.equal(got_tok.cpu(), want_tok):
            raise AssertionError(f"reference check: {arch} greedy tokens "
                                 "differ between the card and the CPU")
        log(f"reference: {arch}: greedy generate tokens equal on the card "
            f"and the CPU; launches {need}, no other kernel")


# the kernels each reduced family's train step must launch on the card
# ("arch:gather": the arch with MoEConfig.impl "gather"). Capacity MoE
# runs its experts as batched matmuls (as the reference, outside any
# kernel); deepseek-v2's dense layer 0 and the gather experts run kernel 3
TRAIN_REFERENCE_KERNELS = {
    "smollm-135m": ("fused_swiglu", "projection"),
    "falcon-mamba-7b": ("selective_scan", "selective_scan_bwd",
                        "projection"),
    "recurrentgemma-2b": ("fused_swiglu", "rglru_scan", "rglru_scan_bwd",
                          "projection"),
    "mixtral-8x22b": ("projection",),
    "mixtral-8x22b:gather": ("fused_swiglu", "projection"),
    "deepseek-v2-236b": ("fused_swiglu", "projection"),
}


def reduced_variant(spec: str, dtype: str = "float32"):
    """The reduced config of ``arch`` or ``arch:gather`` (its MoE with
    the capacity-free gather dispatch) in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_config
    arch, _, impl = spec.partition(":")
    cfg = get_config(arch, reduced=True).replace(dtype=dtype)
    if impl:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl=impl))
    return cfg


def run_train_reference_phase(torch):
    """One train step of each reduced f32 family (dense, ssm, hybrid,
    capacity and gather MoE, MLA) on the card against the same step on
    the CPU: the loss (with the router's aux term for MoE), every
    gradient leaf (atol 1e-6 + 1e-4 of the leaf's max, as the CPU tests
    hold the port against the reference) and the params after the step
    (atol 1e-5 where the CPU gradient exceeds 1e-6; AdamW's first update
    is about lr * sign(g), so a gradient that is rounding noise near
    zero may flip an element by 2 lr: those are counted, at most 0.1% of
    a leaf). Every leaf's gradient must be non-zero on the card: a
    kernel without a gradient would leave its weights at zero."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import params as params_lib
    from repro_torch.optim import init as opt_init
    from repro_torch.runtime import deterministic_cuda

    deterministic_cuda()
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    for arch, kernels in TRAIN_REFERENCE_KERNELS.items():
        cfg = reduced_variant(arch)
        params_cpu = params_lib.init_params(cfg, 0, device="cpu")
        b = next(synthetic_lm_batches(2, 80, cfg.vocab_size, seed=3))
        out = {}
        for dev in ("cpu", "cuda"):
            prm = params_cpu if dev == "cpu" else _to_device(params_cpu,
                                                             dev)
            batch = {"tokens": torch.from_numpy(b.tokens).to(dev),
                     "labels": torch.from_numpy(b.labels).to(dev),
                     "loss_mask": torch.from_numpy(b.loss_mask).to(dev)}
            ops.reset_launch_counts()
            loss, _, grads = loss_and_grads(cfg, prm, batch)
            new, _, met = make_train_step(cfg, tc)(prm, opt_init(prm),
                                                   batch)
            launches = ops.launch_counts()
            out[dev] = (float(loss), float(met["loss"]),
                        dict(params_lib._leaves(grads)),
                        dict(params_lib._leaves(new)), launches)
        (lc, mc, gc, pc, _), (lg, mg, gg, pg, launches) = \
            out["cpu"], out["cuda"]
        for k in kernels:
            if launches[k] <= 0:
                raise AssertionError(f"train reference: {arch} did not "
                                     f"launch {k} on the card")
        for what, a, bref in (("loss", lg, lc), ("step loss", mg, mc)):
            if not abs(a - bref) <= 1e-5 * abs(bref):
                raise AssertionError(f"train reference: {arch} {what} "
                                     f"{a} on the card, {bref} on the CPU")
        worst, flips = 0.0, 0
        for k, g_cpu in gc.items():
            g = gg[k].cpu()
            scale = float(g_cpu.abs().max())
            if not float(g.abs().max()) > 0.0:
                raise AssertionError(f"train reference: {arch} {k} has a "
                                     "zero gradient on the card")
            err = float((g - g_cpu).abs().max())
            if err > 1e-6 + 1e-4 * scale:
                raise AssertionError(
                    f"train reference: {arch} gradient {k} differs by "
                    f"{err:.3e} (max {scale:.3e})")
            worst = max(worst, err / scale)
            dp = (pg[k].cpu() - pc[k]).abs()
            sure = g_cpu.abs() > 1e-6
            if sure.any() and float(dp[sure].max()) > 1e-5:
                raise AssertionError(f"train reference: {arch} param {k} "
                                     "after the step differs")
            n_flip = int((dp > 1e-5).sum())
            if n_flip > max(1, dp.numel() // 1000):
                raise AssertionError(f"train reference: {arch} param {k}:"
                                     f" {n_flip} elements flipped")
            flips += n_flip
        ran = {k: launches[k] for k in kernels}
        log(f"reference: train step {arch}: loss card {lg:.7f} cpu "
            f"{lc:.7f}; {len(gc)} gradient leaves agree (worst "
            f"{worst:.3e} of the leaf max), all non-zero on the card; "
            f"params after the step agree ({flips} noise elements); "
            f"launches {ran}")


# ----------------------------------------------------------------------
# phase 5: serve
# ----------------------------------------------------------------------
def long_prompt_tasks(n_tasks: int, prompt_chars: int, seed: int = 0,
                      duplicate_rate: float = 0.15):
    """Uniform long arithmetic-surface prompts with duplicate
    resubmissions (the shape of the reference harness's
    ``long_prompt_workload``)."""
    from repro_torch.data.tasks import Task
    rng = np.random.default_rng(seed + 0x57E9)
    pool_size = max(16, n_tasks // 2)
    pool = []
    for i in range(pool_size):
        digits = "".join(str(rng.integers(10))
                         for _ in range(prompt_chars - 8))
        pool.append(Task(task_id=f"step-{i:05d}", benchmark="step_loop",
                         kind="math", text=f"{digits} + 1 = ", gold="0",
                         difficulty=0.0))
    stream = []
    for _ in range(n_tasks):
        if stream and rng.random() < duplicate_rate:
            stream.append(stream[int(rng.integers(len(stream)))])
        else:
            stream.append(pool[int(rng.integers(pool_size))])
    return stream


def forced_modes(n_tasks: int, seed: int = 0) -> np.ndarray:
    """Per-task modes at the paper's escalation rate (13 single, 4
    arena-lite, 7 full-arena per 24), shuffled and keyed by admission
    index: seed-initialised weights give sigma = 0 everywhere, so the
    route is forced to exercise every member path."""
    rng = np.random.default_rng(seed + 0x45A)
    modes: list = []
    while len(modes) < n_tasks:
        block = [0] * 13 + [1] * 4 + [2] * 7
        rng.shuffle(block)
        modes.extend(block)
    return np.asarray(modes[:n_tasks], np.int32)


def engine_traces(run_id: str, tasks, res, member_names, store):
    """One TraceRecord per served task from an engine result, appended
    to ``store`` (the port's ``ArtifactStore``) in admission order: the
    materialisation of the reference harness's ``_engine_traces``
    (``tests/harness/simulate.py``). Probe samples, member answers,
    sigma, mode and the final answer — the judge-visible state — are
    hashed. Returns the records."""
    from repro_torch.core.extract import extract
    from repro_torch.core.sigma import MODE_NAMES
    from repro_torch.teamllm.fingerprint import prompt_hash, render_prompt
    from repro_torch.teamllm.trace import (
        ModelResponse, ProbeSample, TraceRecord)

    traces = []
    for i, task in enumerate(tasks):
        probe_samples = tuple(
            ProbeSample(response=txt, answer=extract(txt, task.kind),
                        cost=0.0)
            for txt in res.probe_texts[i])
        responses = tuple(
            ModelResponse(model=member_names[mi], response="", answer=a,
                          cost=0.0)
            for mi, a in enumerate(res.member_answers[i]) if a is not None)
        final = res.final_answers[i]
        trace = TraceRecord(
            run_id=run_id, task_id=task.task_id, benchmark=task.benchmark,
            prompt_hash=prompt_hash(render_prompt(task.text)), seed=0,
            sigma=float(res.sigma[i]), mode=MODE_NAMES[int(res.modes[i])],
            probe_samples=probe_samples, responses=responses,
            final_answer=final, correct=final == task.gold, cost=0.0,
            logical_time=i)
        store.append(trace)
        traces.append(trace)
    return traces


def chain_head(run_id: str, tasks, res, member_names, path) -> str:
    """Chain one engine run's records into a fresh ``ArtifactStore`` at
    ``path`` and audit it; returns the chain head."""
    from repro_torch.teamllm.artifacts import ArtifactStore
    store = ArtifactStore(path)
    engine_traces(run_id, tasks, res, member_names, store)
    audit = ArtifactStore(path).audit()
    if not (audit["ok"] and audit["records"] == len(tasks)
            and audit["head"] == store.head):
        raise AssertionError(f"{path}: chain audit failed: {audit}")
    return store.head


def check_path_launches(label: str, launches: dict, needed) -> None:
    """Each of ``needed`` launched, and no other kernel."""
    missing = [k for k in needed if launches[k] <= 0]
    stray = {k: v for k, v in launches.items() if k not in needed and v}
    if missing or stray:
        raise AssertionError(f"{label}: never launched {missing}; "
                             f"launched off this path {stray}")


def check_no_leaks(engine) -> None:
    """After a run only the scratch pages and the prefix cache's pages
    may still be referenced, each exactly once, on every server (the
    step loop's ring and lanes servers keep no prefix cache)."""
    for srv in (list(engine._kv_servers.values())
                + list(engine._stepped_servers.values())
                + [sv for m in engine._mesh_servers for sv in m.shards]):
        held = {int(p) for p in srv._scratch}
        for e in srv._prefix.values():
            pages = [int(p) for p in e.shared]
            if e.tail is not None:
                pages.append(int(e.tail))
            if held & set(pages):
                raise AssertionError(f"{srv.stats.model}: cache pages "
                                     "overlap")
            held |= set(pages)
        live = {int(p) for p in np.nonzero(srv.pool._refs)[0]}
        if live != held or any(srv.pool.refcount(p) != 1 for p in live):
            raise AssertionError(
                f"{srv.stats.model}: {len(live - held)} leaked pages, "
                f"{len(held - live)} cache pages missing")


# The profiler can lose the last records of a window: a paged-wave
# profile recorded 477 of the int8 paged decode's 480 kernels, the int8
# twin decoding last in the wave, and repeated windows lost from a few
# to thousands of their last kernels, never any before those. Each
# profiled window therefore ends with TAIL_MARKERS spin kernels after
# its own work (close_profile_window), more than a window was seen to
# lose; report_profile leaves them out of every figure and counts a
# wrapper's kernels only after it has found some of them recorded,
# which shows that the window's own records are whole. A dense-wave
# window once lost all 20,000 (PR 21), so ``profiled`` runs a window
# that lost them all again, up to PROFILE_ATTEMPTS times. A window can
# lose its first records too: a 30-layer train step's profile recorded
# 177 of its 180 projection kernels with every tail marker recorded
# (the step's first projections are layer 0's q, k and v). So
# each window also opens with HEAD_MARKERS spin kernels before its own
# work (open_profile_window), and counts as whole only when more markers
# than those were recorded.
HEAD_MARKERS = 2_000
TAIL_MARKERS = 20_000
MARKER_KERNEL = "spin_kernel"
PROFILE_ATTEMPTS = 3


def _spin_markers(torch, n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def open_profile_window(torch) -> None:
    _spin_markers(torch, HEAD_MARKERS)


def close_profile_window(torch) -> None:
    _spin_markers(torch, TAIL_MARKERS)


def profiled(torch, fn):
    """Run ``fn`` under the profiler (CUDA activity), the window opened
    by the head markers and closed by the tail markers, the launch
    counts set to 0 just before.
    Returns (``fn``'s result, the window's ``kernel_totals``, the
    seconds they took to read, the launch counts). A window in which no
    tail marker was recorded runs again, up to ``PROFILE_ATTEMPTS``
    times; ``report_profile`` refuses the last one if it lost them
    too."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_profile_window(torch)
            out = fn()
            close_profile_window(torch)
        t = time.perf_counter()
        events = kernel_totals(prof)
        read = time.perf_counter() - t
        del prof
        if (attempt == PROFILE_ATTEMPTS
                or sum(e.count for e in events
                       if MARKER_KERNEL in e.key) > HEAD_MARKERS):
            return out, events, read, ops.launch_counts()
        log(f"profile: window {attempt} recorded none of its tail "
            "markers; profiling the run again")


# the port's tensor-core and split-KV kernels, reported by the profiles
# even when they fall out of the top ten
REPORTED_KERNELS = ("swiglu_gemm_kernel", "chunked_prefill_mma_kernel",
                    "swiglu_f32_gemm_kernel", "chunked_prefill_f32_kernel",
                    "projection_split_kernel",
                    "paged_decode_split_kernel", "dense_decode_split_kernel",
                    "paged_decode_quant_split_kernel",
                    "dense_decode_quant_split_kernel",
                    "scan_fwd_kernel", "scan_bwd_kernel",
                    "rglru_fwd_kernel", "rglru_bwd_kernel")
# each scan's kernels, whose share of the busy time a profile logs: the
# selective scan's forward, backward and its two summing kernels; the
# RG-LRU's forward and backward
SCAN_KERNELS = {"the selective scan's": ("scan_fwd_kernel",
                                          "scan_bwd_kernel",
                                          "sum_parts_kernel",
                                          "alog_grad_kernel"),
                "the RG-LRU's": ("rglru_fwd_kernel", "rglru_bwd_kernel")}
# wrapper -> its kernel's name: one launch per wrapper call
SPLIT_KERNELS = {"paged_decode_attention": "paged_decode_split_kernel",
                 "decode_attention": "dense_decode_split_kernel",
                 "paged_decode_attention_quant":
                     "paged_decode_quant_split_kernel",
                 "decode_attention_quant": "dense_decode_quant_split_kernel",
                 "selective_scan": "scan_fwd_kernel",
                 "selective_scan_bwd": "scan_bwd_kernel",
                 "rglru_scan": "rglru_fwd_kernel",
                 "rglru_scan_bwd": "rglru_bwd_kernel",
                 # bf16 and f32 (projection_split_f32_kernel)
                 "projection": "projection_split"}


def kernel_totals(prof) -> list:
    """Calls (``count``) and device microseconds (``dev_us``) by name
    (``key``) of every kernel, copy and fill the card ran under
    ``prof``, read from the profiler's raw events.
    ``key_averages`` gives the same sums for them but first builds a
    Python event tree over every event, host ones too: minutes for a
    serve run's million kernels."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    totals: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            continue
        calls, us = totals.get(e.name(), (0, 0.0))
        totals[e.name()] = (calls + 1, us + e.duration_ns() / 1e3)
    return [SimpleNamespace(key=name, count=calls, dev_us=us)
            for name, (calls, us) in totals.items()]


def report_profile(events, t_read: float, wall: float,
                   wall_profiled: float, swiglu_calls: int = None,
                   launches: dict = None) -> float:
    """Device time by kernel over one profiled window (``events``: its
    ``kernel_totals``, read in ``t_read`` seconds). ``wall`` is the
    unprofiled run's wall time: the device work is the same, so its
    busy share there is busy / wall. With ``swiglu_calls`` (the bf16
    fused_swiglu wrapper calls the profiled run made), check that each
    ran as the two tensor-core stages and no other kernel ran under the
    wrapper; with ``launches`` (the wrappers' counts over the profiled
    run), that each call of the split-KV decodes, of the two scans
    (forward, backward) and of the projection ran as exactly one kernel
    of its name. Returns the busy share of ``wall``."""
    def dev_us(e):
        return e.dev_us
    events = sorted(events, key=dev_us, reverse=True)
    markers = sum(e.count for e in events if MARKER_KERNEL in e.key)
    events = [e for e in events if MARKER_KERNEL not in e.key]
    if launches is not None and markers <= HEAD_MARKERS:
        raise AssertionError(
            f"profile: none of the {TAIL_MARKERS} tail markers was recorded"
            ": the profiler lost the end of the window, so its kernel "
            "counts are not whole")
    busy = sum(dev_us(e) for e in events) / 1e6
    n_kernels = sum(e.count for e in events if dev_us(e) > 0)
    log(f"profile: {n_kernels} device kernels, device busy {busy:.3f} s "
        f"= {100 * busy / wall:.1f}% of the unprofiled wall {wall:.3f} s "
        f"({100 * busy / wall_profiled:.1f}% of the profiled wall "
        f"{wall_profiled:.3f} s); {markers} of the {HEAD_MARKERS} head and "
        f"{TAIL_MARKERS} tail markers recorded around them; events read in "
        f"{t_read:.1f} s")
    for e in events[:10]:
        if dev_us(e) <= 0:
            break
        log(f"profile:   {dev_us(e) / 1e3:10.2f} ms {e.count:8d} calls  "
            f"{e.key[:90]}")
    for e in events[10:]:
        if any(k in e.key for k in REPORTED_KERNELS) and dev_us(e) > 0:
            log(f"profile:   {dev_us(e) / 1e3:10.2f} ms {e.count:8d} calls  "
                f"{e.key[:90]}")
    for label, names in SCAN_KERNELS.items():
        scan = [e for e in events
                if any(k in e.key for k in names) and dev_us(e) > 0]
        if scan:
            ms = sum(dev_us(e) for e in scan) / 1e3
            log(f"profile: {label} kernels {ms:.2f} ms of device time = "
                f"{100 * ms / 1e3 / busy:.1f}% of the busy time "
                f"({', '.join(f'{e.count} {e.key[:60]}' for e in scan)})")
    for wrapper, kernel in SPLIT_KERNELS.items():
        if launches is None:
            break
        ran = sum(e.count for e in events if kernel in e.key)
        ms = sum(dev_us(e) for e in events if kernel in e.key) / 1e3
        if ran != launches[wrapper]:
            raise AssertionError(
                f"profile: {launches[wrapper]} {wrapper} calls ran {ran} "
                f"{kernel}s")
        if ran:
            log(f"profile: {ran} {wrapper} calls = {ran} {kernel}s, "
                f"{ms:.2f} ms of device time")
    if swiglu_calls is not None:
        gemms = sum(e.count for e in events
                    if "swiglu_gemm_kernel" in e.key)
        f32 = sum(e.count for e in events if "swiglu_f32" in e.key)
        if gemms != 2 * swiglu_calls or f32:
            raise AssertionError(
                f"profile: {swiglu_calls} bf16 fused_swiglu calls ran "
                f"{gemms} tensor-core GEMM kernels and {f32} CUDA-core "
                "ones")
        log(f"profile: {swiglu_calls} fused_swiglu calls = {gemms} "
            "tensor-core GEMM kernels (gate_up + down), no other kernel "
            "under the wrapper")
    return busy / wall


def account_params(label: str, cfg, params) -> int:
    """``launch.dryrun.account``'s param bytes for ``cfg`` beside the
    bytes the placed tensors ``params`` take: equal, or raise. Returns
    the bytes."""
    from repro_torch.launch.dryrun import account, tree_bytes
    want = account(cfg, pool_shape(S_WAVE))["param_bytes"]
    placed = tree_bytes(params)
    if placed != want:
        raise AssertionError(f"{label}: the placed params take {placed} "
                             f"bytes, account() says {want}")
    log(f"{label}: {cfg.name} ({cfg.num_layers} layers) params "
        f"{placed} bytes placed = account()'s {want}")
    return placed


def pool_shape(positions: int, rows: int = 1):
    """A decode ``InputShape`` of ``rows`` rows of ``positions``: the
    cache ``account`` counts beside a KV pool's."""
    from repro_torch.configs.base import InputShape
    return InputShape("pool", int(positions), int(rows), "decode")


def account_pools(label: str, engine, models) -> None:
    """Each member server's pool bytes (pages x bytes a page) beside the
    cache ``account`` counts for the same positions of one row of its
    model (equal for dense pages; ring pages and lanes hold less than a
    contiguous cache of their positions, int8 pages their codes and
    scales). Printed, not a gate."""
    from repro_torch.launch.dryrun import account
    cfgs = {m.name: m.cfg for m in models}
    for name, st in engine.kv_stats().items():
        if name not in cfgs or not st.pool_pages:
            continue
        pos = st.pool_pages * st.page_size
        acc = account(cfgs[name], pool_shape(pos))["cache_bytes"]
        log(f"{label}: {name} pool {st.pool_pages} pages x {st.page_bytes} "
            f"bytes = {st.pool_pages * st.page_bytes} bytes; account()'s "
            f"cache for {pos} positions of one row: {acc} bytes")


def full_width_params(torch):
    """Seed-initialised full-width smollm-135m params for seeds 0, 1, 2
    (the probe and two other members) on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import count_params, init_params

    cfg = get_config("smollm-135m")
    t0 = time.perf_counter()
    params = [init_params(cfg, seed, device="cuda") for seed in range(3)]
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model}"
        f" heads {cfg.num_heads}/{cfg.num_kv_heads} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size} {cfg.dtype}: {count_params(params[0])} params "
        f"per model, 3 models initialised in "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


# the kernels the stepped engine runs over a dense fleet
STEPPED_KERNELS = ("paged_decode_attention", "chunked_prefill_attention",
                   "fused_swiglu", "projection")


def stepped_fleet(cfg, params):
    """Phase 5's fleet (the probe, two members, the probe's twin), its
    16-task stream and its forced routes. Returns (tasks, member names,
    serve): ``serve(method="run_stepped", **kw)`` serves the stream
    through a fresh stepped engine on the card with phase 5's knobs
    (``method="recover"`` resumes a journal) and returns (engine,
    result, wall seconds)."""
    import torch

    from repro_torch.configs import ACARConfig
    from repro_torch.serving import (
        BatchedACAREngine, MicroBatchPolicy, ZooModel)

    p_probe, p_m1, p_m2 = params
    probe = ZooModel("smollm-probe", cfg, p_probe)
    ensemble = [ZooModel("smollm-m1", cfg, p_m1),
                ZooModel("smollm-m2", cfg, p_m2),
                ZooModel("smollm-probe-twin", cfg, p_probe)]
    tasks = long_prompt_tasks(16, prompt_chars=PROMPT)
    modes = forced_modes(len(tasks))
    if not {1, 2} <= set(modes.tolist()):
        raise AssertionError("forced routes miss a member path")

    def route(sig, indices):
        return modes[np.asarray(indices, np.int64)]

    policy = MicroBatchPolicy(max_batch_size=8, max_batch_tokens=1 << 20)

    def serve(method="run_stepped", **kw):
        eng = BatchedACAREngine(
            ACARConfig(probe_temperature=0.9, seed=0), probe, ensemble,
            max_new_tokens=MAX_NEW, route_fn=route, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            res = getattr(eng, method)(tasks, policy, chunk_tokens=32,
                                       megastep=4, **kw)
        finally:
            torch.cuda.synchronize()
        return eng, res, time.perf_counter() - t

    return tasks, [m.name for m in ensemble], serve


def run_serve_phase(torch, gpu_name: str, cfg, params):
    """Serve phase 5's stream twice, the rerun under the profiler.
    Returns the first run's launch counts and what phase 9 holds its
    runs to: the chain head of the run's records, its loop ticks and
    its wall."""
    tasks, member_names, serve = stepped_fleet(cfg, params)
    for i, p in enumerate(params):
        account_params(f"serve[params {i}]", cfg, p)
    launches, (eng, res, wall), _, head = serve_twice(
        torch, "serve", "stepped", serve, STEPPED_KERNELS, tasks,
        member_names, rerun=profiled_rerun(torch, serve))
    account_pools("serve", eng, [eng.probe] + list(eng.ensemble))
    st = res.step
    log(f"serve: {len(tasks)} tasks on {gpu_name}: wall {wall:.3f} s, "
        f"{len(tasks) / wall:.2f} tasks/s, {st.decode_tokens} decode "
        f"tokens at {st.decode_tokens / wall:.1f} tokens/s, "
        f"{st.prefill_chunks} prefill chunks, {st.launches} launches, "
        f"{st.ticks} ticks, modes {np.bincount(res.modes, minlength=3)}")
    return launches, dict(head=head, ticks=st.ticks, wall=wall)


def _same_results(a, b) -> bool:
    return (np.array_equal(a.sigma, b.sigma)
            and np.array_equal(a.modes, b.modes)
            and a.final_answers == b.final_answers
            and a.member_answers == b.member_answers
            and a.probe_texts == b.probe_texts)


def profiled_rerun(torch, serve):
    """A ``serve_twice`` rerun: ``serve()`` under the profiler, its
    device busy time and the kernels that take it reported beside the
    first run's wall."""
    def rerun(wall):
        out, events, t_read, counts = profiled(torch, serve)
        report_profile(events, t_read, wall, out[2],
                       swiglu_calls=counts["fused_swiglu"], launches=counts)
        return out
    return rerun


def serve_twice(torch, label: str, run_id: str, serve, needed, tasks,
                member_names, rerun=None):
    """Serve a stream twice through ``serve()`` -> (engine, result, wall
    seconds), the launch counts set to 0 just before each run and read
    just after: every task answered (and retired, on the step loop),
    the kernels ``needed`` launched and no other, no page or lane
    leaked, and the rerun reproducing sigma, modes, answers, probe
    texts, the launch counts and the chain head of the run's records
    (``check_rerun_heads`` under ``run_id``). ``rerun(wall)``, where
    given, serves the second run in place of ``serve`` (``wall``: the
    first run's). Returns (launches, (engine, result, wall), the same of
    the rerun, head)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    eng, res, wall = serve()
    launches = ops.launch_counts()
    log(f"{label}: launches during the run {launches}")
    check_path_launches(label, launches, needed)
    retired = getattr(getattr(res, "step", None), "retired", len(tasks))
    if (len(res.final_answers) != len(tasks) or retired != len(tasks)
            or any(a is None for a in res.final_answers)):
        raise AssertionError(f"{label}: a task did not retire")
    check_no_leaks(eng)
    if rerun is None:
        ops.reset_launch_counts()
        again = serve()
    else:
        again = rerun(wall)
    if not _same_results(res, again[1]) or ops.launch_counts() != launches:
        raise AssertionError(f"{label}: a rerun changed sigma, modes, "
                             "answers, probe texts or launch counts")
    check_no_leaks(again[0])
    log(f"{label}: rerun identical (sigma, modes, answers, probe texts, "
        f"launch counts); rerun wall {again[2]:.3f} s")
    head = check_rerun_heads(label, run_id, tasks, res, again[1],
                             member_names)
    return launches, (eng, res, wall), again, head


def check_rerun_heads(label: str, run_id: str, tasks, res, res2,
                      member_names) -> str:
    """Chain a run's and its rerun's records (``engine_traces``) into
    fresh stores in a temporary directory; both audit OK and the heads
    must be byte-identical. Returns the head."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="acar-chain-") as d:
        head = chain_head(run_id, tasks, res, member_names,
                          Path(d) / "run1.jsonl")
        head2 = chain_head(run_id, tasks, res2, member_names,
                           Path(d) / "run2.jsonl")
    if head2 != head:
        raise AssertionError(f"{label}: the rerun's chain head {head2} is "
                             f"not the run's {head}")
    log(f"{label}: chain head {head} ({len(tasks)} records, audit OK); "
        f"rerun head {head2}: byte-identical")
    return head


# ----------------------------------------------------------------------
# phase 9: faults, the journal, recovery and span tracing (run after 5)
# ----------------------------------------------------------------------
# the reference harness's degraded-fleet plan on one device
# (``run_degraded_fleet`` less its shard loss): (site, member, tick of a
# 16-tick run), scaled to phase 5's ticks
DEGRADED_PLAN = (("member_launch", 0, 2), ("member_nan", 0, 4),
                 ("member_nan", 1, 7))


def degraded_plan(member_names, ticks: int):
    from repro_torch.serving import FaultPlan, FaultSpec
    return FaultPlan(specs=tuple(
        FaultSpec(tick=t * ticks // 16, site=site, model=member_names[m])
        for site, m, t in DEGRADED_PLAN))


def check_attribution(tasks, res, member_names,
                      label: str = "faults") -> tuple[int, int]:
    """One ``attribution`` span per full-arena row, naming the members
    that answered, its values equal to ``core.attribution.leave_one_out``
    over the row's member answers; returns the rows and how many of them
    have a non-zero value. In phase 9 seed weights never answer the
    gold, so every value is 0 there and the check holds the spans' rows
    and members, not their values. Phase 10 holds the values on the
    card: its arithmetic-trained fleet serves traced under golds keyed
    to the members' answers (``attribution_key``), and at least one
    value must be non-zero."""
    from repro_torch.core.attribution import leave_one_out
    from repro_torch.teamllm.trace import ModelResponse
    spans: dict = {}
    for sp in res.spans:
        if sp["phase"] == "attribution":
            adm = int(sp["trace"].rsplit("#", 1)[1])
            spans.setdefault(adm, []).append(sp)
    full = [i for i in range(len(tasks)) if int(res.modes[i]) == 2]
    nonzero = 0
    if sorted(spans) != full or any(len(v) != 1 for v in spans.values()):
        raise AssertionError(f"{label}: attribution spans on rows "
                             f"{sorted(spans)}, full-arena rows {full}")
    for i in full:
        want = {m: float(v) for m, v in leave_one_out(
            [ModelResponse(model=member_names[mi], response="", answer=a,
                           cost=0.0)
             for mi, a in enumerate(res.member_answers[i])
             if a is not None], tasks[i].task_id, tasks[i].gold).items()}
        if spans[i][0]["values"] != want:
            raise AssertionError(f"{label}: row {i}'s attribution span "
                                 f"{spans[i][0]['values']} is not "
                                 f"leave-one-out's {want}")
        nonzero += any(v != 0 for v in want.values())
    return len(full), nonzero


def run_fault_phase(torch, smi: str, cfg, params, served: dict) -> dict:
    """Phase 5's fleet, stream and routes under the port's fault
    tolerance and span tracing, held to phase 5's run (``served``: its
    chain head, ticks and wall):

    (a) traced (a ``SpanTracer`` with a span file) and journaled: the
        record chain head equals phase 5's; the span file verifies
        with the result's span head; the PROV lineage of all 16 tasks
        walks OK; the journal loads with 16 retired rows; every
        full-arena row has one attribution span equal to leave-one-out
        (``check_attribution``);
    (b) killed at 3/4 of phase 5's ticks with the journal and a tracer
        (``SimulatedCrash``), then ``recover`` with a tracer: rows
        restored, one restore span each, the head equal to phase 5's;
    (c) the harness's degraded plan (a launch retry and NaN quarantines
        of members 0 and 1), twice: every task answered or
        abort-traced, equal fault events and heads, a route degraded,
        two members quarantined, no page leaks.

    Prints each run's wall and the traced-and-journaled wall beside
    phase 5's (the armed overhead on the card; phase 5's walls spread
    by 1.5x, so it is a finding, not a gate). Returns the launch counts
    of all the phase's runs."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.serving import (
        FaultPlan, SimulatedCrash, SpanTracer, StepJournal)
    from repro_torch.serving.metrics import (
        MEMBER_QUARANTINED, ROUTES_DEGRADED)
    from repro_torch.teamllm.prov import lineage, verify_span_file

    tasks, names, serve = stepped_fleet(cfg, params)
    walls = {}
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="acar-faults-") as d:
        d = Path(d)
        # (a) traced and journaled
        _, res, walls["traced+journaled"] = serve(
            tracer=SpanTracer(d / "spans.jsonl"),
            journal_path=d / "journal.jsonl")
        head = chain_head("stepped", tasks, res, names, d / "a.jsonl")
        if head != served["head"]:
            raise AssertionError(f"faults: the traced, journaled run's "
                                 f"head {head} is not phase 5's")
        audit = verify_span_file(d / "spans.jsonl")
        if not (audit["ok"] and audit["head"] == res.span_head
                and audit["records"] == len(res.spans)):
            raise AssertionError(f"faults: span file audit {audit}")
        walked = [lineage(res.spans, t.task_id) for t in tasks]
        if not all(lin["ok"] and lin["verified"] > 0 for lin in walked):
            raise AssertionError("faults: a task's lineage failed")
        state = StepJournal.load(d / "journal.jsonl")
        if sorted(state.retired) != list(range(len(tasks))):
            raise AssertionError(f"faults: the journal retires "
                                 f"{sorted(state.retired)}")
        n_full, n_nonzero = check_attribution(tasks, res, names)
        log(f"faults: traced and journaled run: head {head} = phase 5's; "
            f"{len(res.spans)} spans, span file verified (head "
            f"{res.span_head}); lineage OK for {len(tasks)} tasks "
            f"({sum(lin['verified'] for lin in walked)} span hashes "
            f"verified); journal of {state.records} records, "
            f"{len(state.retired)} rows retired; {n_full} full-arena "
            f"attribution spans equal to leave-one-out (non-zero in "
            f"{n_nonzero})")

        # (b) kill at 3/4, recover
        kill = served["ticks"] * 3 // 4
        t = time.perf_counter()
        try:
            serve(tracer=SpanTracer(), journal_path=d / "crash.jsonl",
                  faults=FaultPlan.crash_at(kill))
            raise AssertionError(f"faults: no crash at tick {kill}")
        except SimulatedCrash:
            walls[f"killed@{kill}"] = time.perf_counter() - t
        _, rec, walls["recovered"] = serve(
            "recover", journal_path=d / "crash.jsonl", tracer=SpanTracer())
        restores = sum(1 for sp in rec.spans if sp["phase"] == "restore")
        head_r = chain_head("stepped", tasks, rec, names, d / "b.jsonl")
        if not (rec.restored_rows > 0 and restores == rec.restored_rows
                and head_r == served["head"]):
            raise AssertionError(
                f"faults: recovery restored {rec.restored_rows} rows "
                f"with {restores} restore spans, head {head_r}")
        log(f"faults: killed at tick {kill} of {served['ticks']}, "
            f"recovered: {rec.restored_rows} rows restored, one restore "
            f"span each, head {head_r} = phase 5's")

        # (c) the degraded fleet, twice
        plan = degraded_plan(names, served["ticks"])
        runs = []
        for k in (1, 2):
            eng, res_d, walls[f"degraded {k}"] = serve(faults=plan)
            check_no_leaks(eng)
            aborted = {f["admission"] for f in res_d.faults or []
                       if f["kind"] == "row_aborted"}
            if any(a is None and i not in aborted
                   for i, a in enumerate(res_d.final_answers)):
                raise AssertionError("faults: a degraded row neither "
                                     "answered nor abort-traced")
            runs.append((res_d, chain_head("degraded", tasks, res_d, names,
                                           d / f"c{k}.jsonl")))
        (res_d, head_d), (res_d2, head_d2) = runs
        degraded = sum(res_d.metrics.get(ROUTES_DEGRADED,
                                         **{"from": str(f), "to": str(t)})
                       for f, t in ((1, 0), (2, 0), (2, 1)))
        quarantined = [m for m in names
                       if res_d.metrics.get(MEMBER_QUARANTINED, model=m)]
        if not (res_d.faults == res_d2.faults and head_d == head_d2):
            raise AssertionError("faults: the degraded replay differs")
        if degraded < 1 or len(quarantined) != 2:
            raise AssertionError(f"faults: {degraded} routes degraded, "
                                 f"quarantined {quarantined}")
        kinds: dict = {}
        for f in res_d.faults:
            kinds[f["kind"]] = kinds.get(f["kind"], 0) + 1
        log(f"faults: degraded plan {[(sp.site, sp.model, sp.tick) for sp in plan.specs]}"
            f" twice: {len(res_d.faults)} fault events {kinds}, equal; "
            f"{int(degraded)} routes degraded, quarantined {quarantined}; "
            f"heads {head_d} equal; no page leaks")
    launches = ops.launch_counts()
    log(f"faults: launches during the phase {launches}")
    check_path_launches("faults", launches, STEPPED_KERNELS)
    log(f"faults: {len(tasks)} tasks on {smi}: walls " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()))
    log(f"faults: armed overhead: traced and journaled wall "
        f"{walls['traced+journaled']:.3f} s beside phase 5's "
        f"{served['wall']:.3f} s "
        f"({walls['traced+journaled'] / served['wall']:.3f}x)")
    return launches


# ----------------------------------------------------------------------
# phase 6: the wave engine over int8 and dense KV
# ----------------------------------------------------------------------
# the kernels each path must launch, and no other
WAVE_PATHS = {
    "wave_paged": ("paged_decode_attention", "fused_swiglu",
                   "paged_decode_attention_quant", "projection"),
    "wave_dense": ("fused_swiglu", "decode_attention",
                   "decode_attention_quant", "projection"),
    "stepped_int8": ("paged_decode_attention", "chunked_prefill_attention",
                     "fused_swiglu", "paged_decode_attention_quant",
                     "projection"),
}


def run_wave_phase(torch, gpu_name: str, cfg, params) -> dict:
    """Serve the phase-5 stream through a fleet (phase 5's models cut to
    their first ``AUDIT_LAYERS`` layers) whose probe and probe twin keep
    int8 KV: the wave engine from pool pages (int8 pages for
    the probe and twin, dense pages for the members), the wave engine
    over contiguous caches, and the stepped engine. Each path runs
    twice (``serve_twice``), the two wave paths' reruns under the
    profiler (phase 5 profiles the stepped engine already); a paged
    wave that fell back to contiguous caches (PoolExhausted) would
    launch the contiguous decodes, off its path. Returns each path's
    launch counts."""
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import (
        BatchedACAREngine, MicroBatchPolicy, ZooModel)

    qcfg = cfg.replace(kv_quant=True)
    p_probe, p_m1, p_m2 = params
    probe = ZooModel("smollm-q8-probe", qcfg, p_probe)
    ensemble = [ZooModel("smollm-m1", cfg, p_m1),
                ZooModel("smollm-m2", cfg, p_m2),
                ZooModel("smollm-q8-twin", qcfg, p_probe)]
    tasks = long_prompt_tasks(16, prompt_chars=PROMPT)
    modes = forced_modes(len(tasks))

    def route(sig, indices):
        return modes[np.asarray(indices, np.int64)]

    policy = MicroBatchPolicy(max_batch_size=8, max_batch_tokens=1 << 20)
    n = ACARConfig().n_probe_samples

    def serve(path):
        eng = BatchedACAREngine(
            ACARConfig(probe_temperature=0.9, seed=0), probe, ensemble,
            max_new_tokens=MAX_NEW, route_fn=route, device="cuda",
            paged=False if path == "wave_dense" else None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if path == "stepped_int8":
            res = eng.run_stepped(tasks, policy, chunk_tokens=32,
                                  megastep=4)
        else:
            res = eng.run_batch(tasks)
        torch.cuda.synchronize()
        return eng, res, time.perf_counter() - t

    launches_by_path = {}
    for path, needed in WAVE_PATHS.items():
        def run(path=path):
            return serve(path)
        launches_by_path[path], (_, res, wall), _, _ = serve_twice(
            torch, f"wave[{path}]", path, run, needed, tasks,
            [m.name for m in ensemble],
            rerun=None if path == "stepped_int8" else profiled_rerun(
                torch, run))
        tokens = (res.step.decode_tokens if path == "stepped_int8" else
                  len(tasks) * n * MAX_NEW
                  + res.compaction.ensemble_decode_tokens)
        log(f"wave[{path}]: {len(tasks)} tasks on {gpu_name}: wall "
            f"{wall:.3f} s, modes {np.bincount(res.modes, minlength=3)}")
        log(f"wave[{path}]: tasks/s {len(tasks) / wall:.3f}")
        log(f"wave[{path}]: decode tokens/s {tokens / wall:.1f} "
            f"({tokens} decode tokens)")
    return launches_by_path


# ----------------------------------------------------------------------
# phase 8: the audit substrate — Algorithm 1 through the orchestrator
# ----------------------------------------------------------------------
# the kernels a TorchModelBackend's generate launches: the one-shot
# prefill's MLP, the decode over its contiguous cache and the
# column-split projections (wq, wk, wv, the decode MLP's w_gate / w_up)
AUDIT_KERNELS = ("fused_swiglu", "decode_attention", "projection")


def link_chain(record_hashes) -> str:
    """The chain head over record hashes, recomputed from GENESIS as
    ``ArtifactStore`` links them: H(prev | record_hash)."""
    import hashlib

    from repro_torch.teamllm.artifacts import GENESIS
    head = GENESIS
    for rh in record_hashes:
        head = hashlib.sha256(f"{head}|{rh}".encode()).hexdigest()
    return head


# AdamW steps of arithmetic that teach phase 5's seed weights the
# tokenizer's vocabulary before phase 8 (see arithmetic_fleet)
AUDIT_TRAIN_STEPS = 20
# phases 6, 8 and 10 serve phase 5's models cut to their first 10 of 30
# layers, at full width: their walls scale with depth (host-bound, one
# task or one micro-batch at a time); at full depth phases 8 and 10
# took 258-310 s of the script's 800 s budget and phase 6 73-99 s
AUDIT_LAYERS = 10
# phases 5 and 9 serve phase 5's models cut to their first 6 of 30
# layers: host-bound by layer, at 15 layers they took 65.8 and 64.1 s of
# the script's budget on the slower host, at 10 layers 48.7 and 43.0 s
# there, which phase 15's examples (76.7 s there) now share
SERVE_LAYERS = 6


def first_layers(cfg, params, n: int):
    """``cfg`` and copies of the param sets ``params`` cut to their first
    ``n`` layers (the stacked ``"layers"`` subtree's leading axis)."""
    from repro_torch.optim.adamw import tree_map
    return cfg.replace(num_layers=n), [
        dict(p, layers=tree_map(lambda x: x[:n].clone(), p["layers"]))
        for p in params]


def arithmetic_fleet(torch, cfg, params):
    """Phase 5's three full-width param sets (cut to ``AUDIT_LAYERS``
    by the caller) after ``AUDIT_TRAIN_STEPS`` AdamW steps of ``make_train_step`` on arithmetic batches (64 x 24 tokens, lr
    3e-3 after one warmup step, a data seed per model); the inputs are
    left as they were. On the seed weights alone a sample lands in the
    tokenizer's 19 ids with probability about 4e-4 a token, so every
    probe sample decodes to the empty answer, sigma is 0 on every task
    and the route never escalates; after these steps the models answer
    in digits, and their samples disagree where they are unsure."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import arithmetic_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init as opt_init

    steps = AUDIT_TRAIN_STEPS
    step = make_train_step(cfg, TrainConfig(
        learning_rate=3e-3, warmup_steps=1, total_steps=steps))
    t = time.perf_counter()
    trained, losses = [], []
    for seed, p in enumerate(params):
        st = opt_init(p)
        it = arithmetic_batches(64, 24, seed=seed)
        for _ in range(steps):
            b = next(it)
            p, st, m = step(p, st, {
                n: torch.from_numpy(getattr(b, n)).cuda()
                for n in ("tokens", "labels", "loss_mask")})
        trained.append(p)
        losses.append(round(float(m["loss"]), 4))
        del st
    torch.cuda.synchronize()
    log(f"audit: phase 5's 3 models, first {cfg.num_layers} layers, after "
        f"{steps} arithmetic steps each "
        f"in {time.perf_counter() - t:.2f} s: losses {losses}")
    return trained


def audit_backends(cfg, params):
    """Phase 8's four ``TorchModelBackend``s over ``params`` on the card:
    the probe, and the ensemble of two members and the probe's twin."""
    from repro_torch.serving import TorchModelBackend
    p_probe, p_m1, p_m2 = params
    probe = TorchModelBackend("smollm-probe", cfg, p_probe,
                              max_new_tokens=MAX_NEW)
    ensemble = {b.name: b for b in (
        TorchModelBackend("smollm-m1", cfg, p_m1, max_new_tokens=MAX_NEW),
        TorchModelBackend("smollm-m2", cfg, p_m2, max_new_tokens=MAX_NEW),
        TorchModelBackend("smollm-probe-twin", cfg, p_probe,
                          max_new_tokens=MAX_NEW))}
    return probe, ensemble


def run_audit_phase(torch, smi: str, cfg, params) -> tuple[dict, dict]:
    """The paper's Algorithm 1 as ``core.orchestrator.ACAROrchestrator``
    runs it, task by task: 3 probe samples at temperature 0.9 -> EXTRACT
    -> sigma -> route (by sigma) -> the routed members at temperature 0
    -> judge -> one TraceRecord appended to a hash-chained
    ``ArtifactStore``. The backends are ``TorchModelBackend``s over
    ``params`` (the probe, two members and the probe's twin) on the
    card; the stream is phase 5's. Two runs, each into a fresh store:
    16 records, the audit OK with its head equal to the chain
    recomputed from the records' hashes, some task escalated, the
    backends' two kernels launched and no other, and the rerun's record
    hashes and head equal to the first run's. Then leave-one-out values
    and the three attribution proxies over the full-arena records.
    ``smi`` is the card's name and power limit. Returns the first run's
    launch counts, and its record hashes and head (phase 10 holds the
    scheduler to them)."""
    import tempfile

    from repro_torch.configs import ACARConfig
    from repro_torch.core import ACAROrchestrator, attribution
    from repro_torch.kernels import ops
    from repro_torch.teamllm import ArtifactStore

    probe, ensemble = audit_backends(cfg, params)
    tasks = long_prompt_tasks(16, prompt_chars=PROMPT)

    def run(path):
        orch = ACAROrchestrator(ACARConfig(probe_temperature=0.9, seed=0),
                                probe, ensemble, store=ArtifactStore(path),
                                run_id="audit")
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = orch.run_suite(tasks)
        torch.cuda.synchronize()
        return orch.store, outs, time.perf_counter() - t

    with tempfile.TemporaryDirectory(prefix="acar-audit-") as d:
        ops.reset_launch_counts()
        store, outs, wall = run(Path(d) / "run1.jsonl")
        launches = ops.launch_counts()
        store2, outs2, wall2 = run(Path(d) / "run2.jsonl")
        audits = [ArtifactStore(Path(d) / f"run{i}.jsonl").audit()
                  for i in (1, 2)]
    log(f"audit: launches during the run {launches}")
    check_path_launches("audit", launches, AUDIT_KERNELS)
    for st, audit in ((store, audits[0]), (store2, audits[1])):
        if not (audit["ok"] and audit["records"] == len(st) == len(tasks)
                and audit["head"] == st.head):
            raise AssertionError(f"audit: chain audit failed: {audit}")
    hashes = [o.trace.record_hash() for o in outs]
    if link_chain(hashes) != store.head:
        raise AssertionError("audit: the head is not the chain of the "
                             "records' hashes")
    modes = [o.trace.mode for o in outs]
    if all(m == "single_agent" for m in modes):
        raise AssertionError("audit: no task escalated past single_agent")
    hashes2 = [o.trace.record_hash() for o in outs2]
    differ = [t.task_id for t, a, b in zip(tasks, hashes, hashes2)
              if a != b]
    if differ or store2.head != store.head:
        raise AssertionError(f"audit: the rerun changed records {differ} "
                             "or the head")
    calls = sum(len(o.trace.probe_samples) + len(o.trace.responses)
                for o in outs)
    counts = {m: modes.count(m) for m in ("single_agent", "arena_lite",
                                          "full_arena")}
    log(f"audit: {len(tasks)} records, audit OK, head {store.head} = the "
        f"chain of the records' hashes; modes {counts}; sigma "
        f"{[o.trace.sigma for o in outs]}")
    log(f"audit: rerun into a fresh store: every record hash equal, head "
        f"{store2.head} byte-identical")
    log(f"audit: {len(tasks)} tasks on {smi}: walls {wall:.3f} s / "
        f"{wall2:.3f} s, tasks/s {len(tasks) / wall:.3f} / "
        f"{len(tasks) / wall2:.3f}; {calls} generate calls = "
        f"{calls / len(tasks):.3f} per task")

    # the paper's third finding on real outputs: proxies against
    # counterfactual leave-one-out values over the full-arena records
    full = [(t, o.trace) for t, o in zip(tasks, outs)
            if o.trace.mode == "full_arena"]
    truth = [attribution.leave_one_out(tr.responses, t.task_id, t.gold)
             for t, tr in full]
    proxies = {
        "similarity": [attribution.proxy_similarity(tr.responses,
                                                    tr.final_answer)
                       for _, tr in full],
        "entropy": [attribution.proxy_entropy(tr.responses)
                    for _, tr in full],
        "agreement": [attribution.proxy_agreement(tr.responses)
                      for _, tr in full]}
    corr = {k: attribution.proxy_vs_truth_correlation(truth, v)
            for k, v in proxies.items()}
    log(f"audit: attribution over {len(full)} full-arena records: "
        f"leave-one-out non-zero in "
        f"{sum(any(v != 0 for v in row.values()) for row in truth)}; "
        f"proxy_vs_truth_correlation {corr}")
    return launches, dict(hashes=hashes, head=store.head)


# ----------------------------------------------------------------------
# phase 10: the queued wave engine and the scheduler (run after 8)
# ----------------------------------------------------------------------
# each queued path's engine knobs and the kernels it launches, and no
# other: pool pages for the probe wave and the members; contiguous
# caches; the masked baseline (the probe's tiled (B*N) decode over
# contiguous caches beside members decoding whole waves from pages)
QUEUED_PATHS = {
    "queued_paged": ({}, ("paged_decode_attention", "fused_swiglu",
                          "projection")),
    "queued_dense": ({"paged": False}, ("fused_swiglu", "decode_attention",
                                        "projection")),
    "queued_masked": ({"compact": False, "shared_prefix": False},
                      ("paged_decode_attention", "fused_swiglu",
                       "decode_attention", "projection")),
}
# the traced leg's stream (phase 5's generator; 7 full-arena rows under
# the forced routes) and its members' sampling temperature. After
# phase 8's 20 arithmetic steps the greedy members answer "" on every
# full-arena row of these prompts (a rehearsal on the card, at 24, 48
# and 97 characters), so leave-one-out could only be 0; sampled like
# the probe, they disagree, and some value is non-zero
ATTRIBUTION_TASKS = 24
ATTRIBUTION_TEMPERATURE = 0.9
# what phase 10 prints beside every virtual-clock figure
VIRTUAL_CLOCK_NOTE = (
    "the virtual clock sums the backends' reported latencies; each "
    "TorchModelBackend call ends in a device synchronise that takes in "
    "the prefetch thread's work on the same stream, so the clock says "
    "nothing about overlap on the card")


def attribution_key(tasks, base, member_names):
    """``tasks`` with each full-arena row's gold replaced by the first of
    its member answers in ``base`` (an untraced run of the same stream)
    that ``core.attribution.leave_one_out`` credits with a non-zero
    value, as ``tests/_torch_port.py::attribution_key`` keys the CPU
    legs: the fleet never answers the stream's own gold, so every value
    would be 0. Serving does not read the gold."""
    import dataclasses

    from repro_torch.core.attribution import leave_one_out
    from repro_torch.teamllm.trace import ModelResponse
    keyed = list(tasks)
    for i, task in enumerate(tasks):
        if int(base.modes[i]) < 2:
            continue
        responses = [ModelResponse(model=member_names[mi], response="",
                                   answer=a, cost=0.0)
                     for mi, a in enumerate(base.member_answers[i])
                     if a is not None]
        for r in responses:
            if any(leave_one_out(responses, task.task_id,
                                 r.answer).values()):
                keyed[i] = dataclasses.replace(task, gold=r.answer)
                break
    return keyed


def first_mismatch(tasks, a, b):
    """The first row whose sigma, mode, answers or probe texts differ
    between two engine results, as (index, task id), or None."""
    for i, t in enumerate(tasks):
        if (a.sigma[i] != b.sigma[i] or a.modes[i] != b.modes[i]
                or a.final_answers[i] != b.final_answers[i]
                or a.member_answers[i] != b.member_answers[i]
                or a.probe_texts[i] != b.probe_texts[i]):
            return i, t.task_id
    return None


def run_queued_phase(torch, smi: str, cfg, params, audited: dict) -> dict:
    """The queued wave engine and the continuous-batching scheduler over
    phase 8's arithmetic-trained full-width fleet (``params``: the
    probe's, two members' and, as the twin, the probe's again), on the
    card:

    (a) ``run_queued`` over phase 5's 16 tasks and forced routes in
        micro-batches of 8, from pool pages, over contiguous caches and
        as the masked baseline (``compact=False, shared_prefix=False``),
        each run twice: batch sizes [8, 8], every task answered, no page
        leaks, the path's kernels and no other (``QUEUED_PATHS``), the
        rerun's results and chain head identical; the masked run's
        results and head equal to the paged run's. A finding, not a
        gate: whether ``run_stepped`` (chunk 32, megastep 4) gives the
        same head, else its first mismatching task;
    (b) ``run_queued`` traced into a span file over 24 tasks of the same
        generator with the members sampled at 0.9, golds keyed to the
        members' answers (``attribution_key``): the head equal to the
        untraced run's under the same golds, the span file verified,
        every task's lineage OK, one attribution span per full-arena
        row equal to leave-one-out, at least one value non-zero;
    (c) ``ContinuousBatchingScheduler`` (micro-batches of 8, the probe
        wave of batch k+1 prefetched on a worker thread) over phase 8's
        four ``TorchModelBackend``s and 16 tasks into an
        ``ArtifactStore``: every record hash and the head equal to phase
        8's orchestrator run in this call (``audited``), the audit OK,
        ``logical_time`` the admission order, kernels 3 and 4 only;
    (d) ``launch.serve.serve(scheduler=True)`` traced, with a lineage
        walk, over (a)'s stream: batch sizes [8, 8], lineage OK.

    ``smi`` is the card's name and power limit. Returns the launch
    counts of the phase's queued runs, and of the stepped comparison
    run apart."""
    import tempfile

    from repro_torch.configs import ACARConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.serving import (
        BatchedACAREngine, ContinuousBatchingScheduler, MicroBatchPolicy,
        SpanTracer, ZooModel)
    from repro_torch.teamllm import ArtifactStore
    from repro_torch.teamllm.prov import lineage, verify_span_file

    t_phase = time.perf_counter()
    p_probe, p_m1, p_m2 = params
    probe = ZooModel("smollm-probe", cfg, p_probe)
    ensemble = [ZooModel("smollm-m1", cfg, p_m1),
                ZooModel("smollm-m2", cfg, p_m2),
                ZooModel("smollm-probe-twin", cfg, p_probe)]
    names = [m.name for m in ensemble]
    acfg = ACARConfig(probe_temperature=0.9, seed=0)
    policy = MicroBatchPolicy(max_batch_size=8, max_batch_tokens=1 << 20)
    n = acfg.n_probe_samples
    total: dict = {}

    def measured(fn):
        """Run ``fn`` with the launch counts set to 0 just before and
        read just after; returns (its result, wall seconds, counts)."""
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = ops.launch_counts()
        return out, wall, launches

    def queued(tasks, tracer=None, config=acfg, **knobs):
        """``run_queued`` on a fresh engine with forced routes; its
        launches join the phase's."""
        modes = forced_modes(len(tasks))

        def route(sig, indices):
            return modes[np.asarray(indices, np.int64)]

        eng = BatchedACAREngine(config, probe, ensemble,
                                max_new_tokens=MAX_NEW, route_fn=route,
                                device="cuda", **knobs)
        res, wall, launches = measured(
            lambda: eng.run_queued(tasks, policy, tracer=tracer))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return eng, res, wall, launches

    tasks = long_prompt_tasks(16, prompt_chars=PROMPT)
    with tempfile.TemporaryDirectory(prefix="acar-queued-") as d:
        d = Path(d)
        # (a) compacted (paged and over contiguous caches) and masked
        heads, results = {}, {}
        for path, (knobs, needed) in QUEUED_PATHS.items():
            def run(knobs=knobs):
                return queued(tasks, **knobs)[:3]
            _, (_, res, wall), _, heads[path] = serve_twice(
                torch, f"queued[{path}]", "queued", run, needed, tasks,
                names)
            if res.batch_sizes != [8, 8]:
                raise AssertionError(f"queued[{path}]: micro-batches "
                                     f"{res.batch_sizes}")
            cs = res.compaction
            tokens = len(tasks) * n * MAX_NEW + cs.ensemble_decode_tokens
            log(f"queued[{path}]: {len(tasks)} tasks on {smi}: wall "
                f"{wall:.3f} s, tasks/s {len(tasks) / wall:.3f}, decode "
                f"tokens/s {tokens / wall:.1f} ({tokens} decode tokens); "
                f"ensemble decode-token reduction "
                f"{cs.ensemble_decode_token_reduction:.3f}x, probe prefill "
                f"reduction {cs.probe_prefill_reduction:.3f}x; modes "
                f"{np.bincount(res.modes, minlength=3)}")
            results[path] = res
        paged, masked = results["queued_paged"], results["queued_masked"]
        if heads["queued_masked"] != heads["queued_paged"]:
            raise AssertionError(
                f"queued: the masked run's head {heads['queued_masked']} "
                f"is not the compacted run's {heads['queued_paged']}; "
                f"first mismatch (row, task) "
                f"{first_mismatch(tasks, paged, masked)}")
        same = heads["queued_dense"] == heads["queued_paged"]
        log(f"queued: masked = compacted (sigma, modes, answers, member "
            f"answers, probe texts, record hashes, head "
            f"{heads['queued_paged']}); contiguous caches' head "
            f"{heads['queued_dense']} {'=' if same else '!='} the pages'")

        # the finding: the stepped engine over the same fleet and stream
        modes = forced_modes(len(tasks))
        eng_s = BatchedACAREngine(
            acfg, probe, ensemble, max_new_tokens=MAX_NEW, device="cuda",
            route_fn=lambda sig, idx: modes[np.asarray(idx, np.int64)])
        res_s, wall_s, stepped = measured(lambda: eng_s.run_stepped(
            tasks, policy, chunk_tokens=32, megastep=4))
        head_s = chain_head("queued", tasks, res_s, names, d / "step.jsonl")
        log(f"queued: finding: run_stepped (chunk 32, megastep 4, wall "
            f"{wall_s:.3f} s) head {head_s} "
            + ("= the queued head" if head_s == heads["queued_paged"] else
               f"!= the queued head; first mismatch (row, task) "
               f"{first_mismatch(tasks, paged, res_s)}"))

        # (b) traced, with attribution values
        tasks_b = long_prompt_tasks(ATTRIBUTION_TASKS, prompt_chars=PROMPT)
        sampled = ACARConfig(probe_temperature=0.9, seed=0,
                             ensemble_temperature=ATTRIBUTION_TEMPERATURE)
        _, base, wall_base, _ = queued(tasks_b, config=sampled)
        keyed = attribution_key(tasks_b, base, names)
        _, traced, wall_tr, _ = queued(
            keyed, tracer=SpanTracer(d / "spans.jsonl"), config=sampled)
        head_b = chain_head("queued-traced", keyed, base, names,
                            d / "b0.jsonl")
        head_t = chain_head("queued-traced", keyed, traced, names,
                            d / "b1.jsonl")
        if head_t != head_b:
            raise AssertionError(f"queued: the traced head {head_t} is not "
                                 f"the untraced run's {head_b}")
        audit = verify_span_file(d / "spans.jsonl")
        if not (audit["ok"] and audit["head"] == traced.span_head
                and audit["records"] == len(traced.spans)):
            raise AssertionError(f"queued: span file audit {audit}")
        walked = [lineage(traced.spans, t)
                  for t in sorted({t.task_id for t in keyed})]
        if not all(lin["ok"] and lin["verified"] > 0 for lin in walked):
            raise AssertionError("queued: a task's lineage failed")
        n_full, n_nonzero = check_attribution(keyed, traced, names,
                                              "queued")
        if n_nonzero == 0:
            raise AssertionError(f"queued: every attribution value of "
                                 f"{n_full} full-arena rows is 0")
        log(f"queued: traced {len(keyed)} tasks, members sampled at "
            f"{ATTRIBUTION_TEMPERATURE}, on {smi}: walls untraced "
            f"{wall_base:.3f} s, traced {wall_tr:.3f} s; head {head_t} = "
            f"the untraced run's; {len(traced.spans)} spans, span file "
            f"verified (head {traced.span_head}); lineage OK for "
            f"{len(walked)} tasks ({sum(lin['verified'] for lin in walked)}"
            f" span hashes verified); {n_full} full-arena attribution "
            f"spans equal to leave-one-out, non-zero in {n_nonzero}")

        # (c) the scheduler over phase 8's backends
        bprobe, bens = audit_backends(cfg, params)
        sched = ContinuousBatchingScheduler(
            acfg, bprobe, bens, store=ArtifactStore(d / "sched.jsonl"),
            run_id="audit", policy=MicroBatchPolicy(max_batch_size=8),
            overlap=True)
        outs, wall_c, launches_c = measured(lambda: sched.serve(tasks))
        for k, v in launches_c.items():
            total[k] = total.get(k, 0) + v
        log(f"queued[scheduler]: launches during the run {launches_c}")
        check_path_launches("queued[scheduler]", launches_c, AUDIT_KERNELS)
        hashes = [o.trace.record_hash() for o in outs]
        differ = [t.task_id for t, a, b in zip(tasks, hashes,
                                              audited["hashes"]) if a != b]
        audit_c = ArtifactStore(d / "sched.jsonl").audit()
        if differ or sched.store.head != audited["head"]:
            raise AssertionError(f"queued[scheduler]: records {differ} or "
                                 f"the head {sched.store.head} differ "
                                 "from phase 8's")
        if not (audit_c["ok"] and audit_c["records"] == len(tasks)
                and audit_c["head"] == sched.store.head):
            raise AssertionError(f"queued[scheduler]: audit {audit_c}")
        lt = [o.trace.logical_time for o in outs]
        if lt != list(range(len(tasks))) or lt != [
                o.trace.schedule["admitted"] for o in outs]:
            raise AssertionError(f"queued[scheduler]: logical_time {lt}")
        st = sched.stats
        calls = (st.probe_cache_misses * n
                 + sum(len(o.trace.responses) for o in outs))
        log(f"queued[scheduler]: {len(tasks)} records, audit OK, every "
            f"record hash and the head {sched.store.head} = phase 8's; "
            f"logical_time = admission order; {st.batches} micro-batches")
        log(f"queued[scheduler]: {len(tasks)} tasks on {smi}: wall "
            f"{wall_c:.3f} s, tasks/s {len(tasks) / wall_c:.3f}; {calls} "
            f"generate calls; probe cache hits {st.probe_cache_hits}")
        log(f"queued[scheduler]: virtual makespans (ms): sequential "
            f"{st.sequential_makespan_ms:.1f}, serial batches "
            f"{st.serial_batch_makespan_ms:.1f}, pipelined "
            f"{st.pipeline_makespan_ms:.1f} ({VIRTUAL_CLOCK_NOTE})")

        # (d) the entry point
        report, wall_d, launches_d = measured(lambda: serve(
            tasks, probe, ensemble, acfg, verbose=False, scheduler=True,
            batch_size=8, trace_path=str(d / "serve.jsonl"),
            lineage_task=tasks[0].task_id, device="cuda"))
        for k, v in launches_d.items():
            total[k] = total.get(k, 0) + v
        if report["batch_sizes"] != [8, 8] or not report["lineage_ok"]:
            raise AssertionError(f"queued[serve]: batch sizes "
                                 f"{report['batch_sizes']}, lineage "
                                 f"{report['lineage_ok']}")
        log(f"queued[serve]: serve(scheduler=True) traced: batch sizes "
            f"{report['batch_sizes']}, lineage of {tasks[0].task_id} OK "
            f"({report['lineage_verified']} span hashes verified), modes "
            f"{report['mode_distribution']}, wall {wall_d:.3f} s; "
            f"launches {launches_d}")
    log(f"queued: launches during the phase's queued runs {total}")
    log(f"queued: phase wall {time.perf_counter() - t_phase:.1f} s on {smi}")
    return {"queued": total, "queued_stepped": stepped}


# ----------------------------------------------------------------------
# phase 7: training at the published widths
# ----------------------------------------------------------------------
TRAIN_CELLS = {
    # path: (arch, layers kept, batch, sequence, kernels it must launch)
    "train_mamba": ("falcon-mamba-7b", 2, 4, 1024,
                    ("selective_scan", "selective_scan_bwd", "projection")),
    "train_griffin": ("recurrentgemma-2b", 3, 1, 4096,
                      ("rglru_scan", "rglru_scan_bwd", "fused_swiglu",
                       "projection")),
}
TRAIN_STEPS = 4


def run_train_phase(torch, gpu_name: str, cells=tuple(TRAIN_CELLS)) -> dict:
    """Each cell's model at its published width (depth cut to fit one
    card with AdamW's f32 moments), bf16, ``remat="layer"``: 4 steps of
    ``make_train_step`` on synthetic batches from a seed, twice from the
    same seed-initialised params. Every loss finite, every param moved,
    the rerun bit-identical in losses and params, the cell's kernels
    launched forward and backward. Then one profiled step. Returns each
    path's launch counts (the first run's). ``cells`` names the paths
    to run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import params as params_lib
    from repro_torch.optim import init as opt_init

    launches_by_path = {}
    for path in cells:
        arch, layers, bsz, seq, kernels = TRAIN_CELLS[path]
        cfg = get_config(arch).replace(num_layers=layers)
        # bf16 params take AdamW's f32 update rounded back to bf16, as
        # the reference's do: a norm scale at 1.0 moves only by a step
        # above half a bf16 spacing there (2e-3), so the peak rate is
        # 3e-3, reached at the first step
        tc = TrainConfig(learning_rate=3e-3, warmup_steps=1,
                         total_steps=TRAIN_STEPS)
        it = synthetic_lm_batches(bsz, seq, cfg.vocab_size, seed=0)
        batches = []
        for _ in range(TRAIN_STEPS):
            b = next(it)
            batches.append({
                "tokens": torch.from_numpy(b.tokens).cuda(),
                "labels": torch.from_numpy(b.labels).cuda(),
                "loss_mask": torch.from_numpy(b.loss_mask).cuda()})
        step = make_train_step(cfg, tc)

        def run():
            p0 = params_lib.init_params(cfg, 0, device="cuda")
            st = opt_init(p0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            p, losses = p0, []
            for b in batches:
                p, st, m = step(p, st, b)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            return (p0, p, st, [float(x) for x in losses], wall,
                    torch.cuda.max_memory_allocated())

        ops.reset_launch_counts()
        p0, p1, st1, losses1, wall1, peak = run()
        del st1
        launches = ops.launch_counts()
        launches_by_path[path] = launches
        log(f"train[{path}]: launches during the run {launches}")
        for k in kernels:
            if launches[k] <= 0:
                raise AssertionError(f"train[{path}]: {k} never launched")
        if not all(np.isfinite(losses1)):
            raise AssertionError(f"train[{path}]: losses {losses1}")
        l0, l1 = dict(params_lib._leaves(p0)), dict(params_lib._leaves(p1))
        still = [k for k in l0 if torch.equal(l0[k], l1[k])]
        if still:
            raise AssertionError(f"train[{path}]: params never moved: "
                                 f"{still}")
        n_params = params_lib.count_params(p0)
        del p0, l0
        _, p2, st2, losses2, wall2, _ = run()
        l2 = dict(params_lib._leaves(p2))
        if losses2 != losses1 or any(not torch.equal(l1[k], l2[k])
                                     for k in l1):
            raise AssertionError(f"train[{path}]: the rerun changed the "
                                 "losses or the params")
        del p1, l1, l2
        tokens = TRAIN_STEPS * bsz * seq
        log(f"train[{path}]: {cfg.name} d_model {cfg.d_model}, "
            f"{layers} of its layers, vocab {cfg.vocab_size}, {cfg.dtype},"
            f" remat {cfg.remat}: {n_params} params; batch {bsz} x {seq} "
            f"on {gpu_name}")
        log(f"train[{path}]: losses {losses1}; rerun identical (losses "
            f"and params bit for bit); every param moved")
        log(f"train[{path}]: walls {wall1:.3f} s / {wall2:.3f} s for "
            f"{TRAIN_STEPS} steps; steps/s {TRAIN_STEPS / wall2:.3f}; "
            f"tokens/s {tokens / wall2:.1f}; peak memory "
            f"{peak / 2**30:.2f} GiB")
        # one more step unprofiled, then the same step under the profiler
        def timed_step():
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(p2, st2, batches[0])
            torch.cuda.synchronize()
            return time.perf_counter() - t

        wall_step = timed_step()
        wall_prof, events, t_read, counts = profiled(torch, timed_step)
        report_profile(events, t_read, wall_step, wall_prof,
                       swiglu_calls=counts["fused_swiglu"], launches=counts)
        del p2, st2, batches, events
        torch.cuda.empty_cache()
    return launches_by_path


def run_train_entry_phase(torch) -> dict:
    """``train()``, the entry point, on reduced smollm-135m arithmetic
    with a checkpoint: its loss falls and the npz restores bit for bit.
    Returns the run's launch counts."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data.pipeline import arithmetic_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import reduced_for_data, train
    from repro_torch.models import params as params_lib

    # the loss train() starts from: its init params on its first batch
    b = next(arithmetic_batches(64, 24, seed=0))
    first, _, _ = loss_and_grads(
        reduced_for_data("smollm-135m", "arithmetic"),
        params_lib.init_params(reduced_for_data("smollm-135m",
                                                "arithmetic"), 0,
                               device="cuda"),
        {n: torch.from_numpy(getattr(b, n)).cuda()
         for n in ("tokens", "labels", "loss_mask")})
    ckpt = ROOT / "build" / "chip_smoke" / "smollm_arith.npz"
    ops.reset_launch_counts()
    t = time.perf_counter()
    cfg, params, metrics = train(arch="smollm-135m", steps=60, batch=64,
                                 seq=24, lr=2e-3, ckpt=str(ckpt),
                                 log_every=20, device="cuda")
    wall = time.perf_counter() - t
    launches = ops.launch_counts()
    if launches["fused_swiglu"] <= 0:
        raise AssertionError("train entry: fused_swiglu never launched")
    if not float(metrics["loss"]) < 0.75 * float(first):
        raise AssertionError(f"train entry: loss {metrics['loss']} after "
                             f"60 steps, {float(first)} at the start")
    got = dict(params_lib._leaves(restore_checkpoint(
        ckpt, params_lib.init_params(cfg, 1, device="cuda"))))
    for k, v in params_lib._leaves(params):
        if not torch.equal(got[k], v):
            raise AssertionError(f"train entry: checkpoint leaf {k} "
                                 "restored differently")
    log(f"train entry: 60 steps in {wall:.2f} s, loss {float(first):.4f}"
        f" -> {float(metrics['loss']):.4f}; checkpoint restores bit for bit; "
        f"launches {launches}")
    return launches


# the MoE family's training on the card: its published widths do not fit
# one card (deepseek-v2's smallest MoE stack is 5.3 B params: ~64 GB of
# bf16 params, gradients and f32 moments), so the reduced configs train
MOE_TRAIN_STEPS = 4


def run_moe_train_phase(torch) -> dict:
    """``train()``, the entry point, on reduced mixtral-8x22b (capacity
    MoE) and deepseek-v2-236b (capacity MoE, MLA, dense layer 0) for 4
    arithmetic steps, twice each: the loss finite, every param finite,
    the rerun's params bit for bit the run's, kernel 3 launched where the
    path has it (deepseek-v2's dense layer 0). Then ``make_train_step``
    on reduced mixtral-8x22b with the gather dispatch, 4 steps twice:
    every loss finite, the rerun bit for bit, kernel 3 launched for
    every expert and each expert's weights moved, which only kernel 3's
    backward can move. Returns each path's launch counts."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import arithmetic_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import reduced_for_data, train
    from repro_torch.models import params as params_lib
    from repro_torch.optim import init as opt_init

    by_path = {}
    # train() ties the embeddings: deepseek-v2's MLA and tied lm_head
    # reach no projection, mixtral-8x22b's GQA does
    for arch, needed in (("mixtral-8x22b", ("projection",)),
                         ("deepseek-v2-236b", ("fused_swiglu",))):
        runs = []
        for _ in range(2):
            ops.reset_launch_counts()
            t = time.perf_counter()
            _, prm, met = train(arch=arch, steps=MOE_TRAIN_STEPS, batch=64,
                                seq=24, lr=2e-3, verbose=False,
                                device="cuda")
            wall = time.perf_counter() - t
            runs.append((dict(params_lib._leaves(prm)), float(met["loss"]),
                         float(met["aux_loss"]), ops.launch_counts(), wall))
        (p1, loss, aux, launches, wall), (p2, loss2, _, launches2, _) = runs
        check_path_launches(f"train moe[{arch}]", launches, needed)
        if not (np.isfinite(loss) and aux > 0 and loss2 == loss
                and launches2 == launches):
            raise AssertionError(f"train moe[{arch}]: loss {loss} / "
                                 f"{loss2}, aux {aux}")
        bad = [k for k in p1 if not torch.isfinite(p1[k]).all()
               or not torch.equal(p1[k], p2[k])]
        if bad:
            raise AssertionError(f"train moe[{arch}]: params not finite or"
                                 f" not bit for bit on the rerun: {bad}")
        by_path[f"train_{arch}"] = launches
        log(f"train moe[{arch}] (train(), reduced): {MOE_TRAIN_STEPS} "
            f"steps in {wall:.2f} s, loss {loss:.4f}, router aux "
            f"{aux:.4f}; rerun bit for bit; launches {launches}")

    cfg = reduced_for_data("mixtral-8x22b", "arithmetic")
    cfg = cfg.replace(moe=reduced_variant("mixtral-8x22b:gather").moe)
    tc = TrainConfig(learning_rate=2e-3, warmup_steps=1,
                     total_steps=MOE_TRAIN_STEPS)
    it = arithmetic_batches(64, 24, seed=0)
    batches = [{n: torch.from_numpy(getattr(b, n)).cuda()
                for n in ("tokens", "labels", "loss_mask")}
               for b in (next(it) for _ in range(MOE_TRAIN_STEPS))]
    step = make_train_step(cfg, tc)
    runs = []
    for _ in range(2):
        p0 = params_lib.init_params(cfg, 0, device="cuda")
        p, st, losses = p0, opt_init(p0), []
        ops.reset_launch_counts()
        for b in batches:
            p, st, m = step(p, st, b)
            losses.append(float(m["loss"]))
        runs.append((dict(params_lib._leaves(p0)),
                     dict(params_lib._leaves(p)), losses,
                     ops.launch_counts()))
    (p0, p1, losses, launches), (_, p2, losses2, launches2) = runs
    per_step = cfg.num_layers * cfg.moe.num_experts
    if launches["fused_swiglu"] != MOE_TRAIN_STEPS * per_step:
        raise AssertionError(f"train moe[gather]: launches {launches}")
    check_path_launches("train moe[gather]", launches,
                        ("fused_swiglu", "projection"))
    if (not all(np.isfinite(losses)) or losses2 != losses
            or launches2 != launches
            or any(not torch.equal(p1[k], p2[k]) for k in p1)):
        raise AssertionError(f"train moe[gather]: losses {losses} / "
                             f"{losses2} or params differ on the rerun")
    still = [k for k in p1 if "mlp/w_" in k and torch.equal(p0[k], p1[k])]
    if still:
        raise AssertionError(f"train moe[gather]: experts never moved: "
                             f"{still}")
    by_path["train_mixtral_gather"] = launches
    log(f"train moe[mixtral-8x22b:gather] (make_train_step, reduced): "
        f"losses {losses}; rerun bit for bit; every expert moved; "
        f"launches {launches}")
    return by_path


def run_frontend_train_phase(torch) -> dict:
    """``train()`` on reduced whisper-medium (synthetic frames) and
    llava-next-mistral-7b (synthetic patches) for 4 arithmetic steps,
    twice each: every loss and param finite, the rerun's params bit for
    bit the run's; whisper launches only the projection (GELU MLPs),
    llava kernel 3 once a layer and step and the projection, and its
    MLP weights move, which only the kernel's backward can move.
    Returns each run's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import params as params_lib

    by_path = {}
    for arch in ("whisper-medium", "llava-next-mistral-7b"):
        runs = []
        for _ in range(2):
            ops.reset_launch_counts()
            t = time.perf_counter()
            cfg, prm, met = train(arch=arch, steps=MOE_TRAIN_STEPS,
                                  batch=64, seq=24, lr=2e-3, verbose=False,
                                  device="cuda")
            wall = time.perf_counter() - t
            runs.append((dict(params_lib._leaves(prm)), float(met["loss"]),
                         ops.launch_counts(), wall))
        (p1, loss, launches, wall), (p2, loss2, launches2, _) = runs
        vision = cfg.frontend == "vision"
        check_path_launches(f"train frontend[{arch}]", launches,
                            (("fused_swiglu",) if vision else ())
                            + ("projection",))
        if vision and launches["fused_swiglu"] != (MOE_TRAIN_STEPS
                                                   * cfg.num_layers):
            raise AssertionError(f"train frontend[{arch}]: launches "
                                 f"{launches}")
        if not (np.isfinite(loss) and loss2 == loss
                and launches2 == launches):
            raise AssertionError(f"train frontend[{arch}]: loss {loss} / "
                                 f"{loss2}")
        bad = [k for k in p1 if not torch.isfinite(p1[k]).all()
               or not torch.equal(p1[k], p2[k])]
        if bad:
            raise AssertionError(f"train frontend[{arch}]: params not "
                                 f"finite or not bit for bit on the rerun:"
                                 f" {bad}")
        p0 = dict(params_lib._leaves(params_lib.init_params(
            cfg, 0, device="cuda")))
        still = [k for k in p1 if "mlp/w_" in k and torch.equal(p0[k],
                                                                 p1[k])]
        if still:
            raise AssertionError(f"train frontend[{arch}]: MLP weights "
                                 f"never moved: {still}")
        by_path[f"train_{arch}"] = launches
        log(f"train frontend[{arch}] (train(), reduced, "
            f"{'patches' if vision else 'frames'}): {MOE_TRAIN_STEPS} "
            f"steps in {wall:.2f} s, loss {loss:.4f}; rerun bit for bit; "
            f"MLP weights moved; launches {launches}")
    return by_path


# ----------------------------------------------------------------------
# phase 15: the examples (examples_torch/; run after phase 7)
# ----------------------------------------------------------------------
# train_model's 100m leg: a third of the example's default 300 steps (a
# step takes 0.3-0.5 s on the card: ~10,000 kernels, each bound by the
# host's launch), and the steps held against the CPU
EXAMPLE_TRAIN_STEPS = 100
EXAMPLE_CHECK_STEPS = 2
TRAIN_MODEL_KERNELS = ("fused_swiglu", "decode_attention", "projection")
# the greedy attribution leg: the serve CLI's default fleet after
# build_zoo's 10 arithmetic steps (it then answers in digits, not "")
# over the CLI's default stream of 32 arithmetic tasks
GREEDY_TRAIN_STEPS = 10
GREEDY_TASKS = 32


def run_train_model_leg(torch, smi: str) -> dict:
    """(a) ``examples_torch/train_model.py --size 100m`` on the card:
    smollm-arith-100m (smollm-135m's 30 x 576 stack, f32, the char
    vocabulary) from seed-initialised params made on the card. Its first
    ``EXAMPLE_CHECK_STEPS`` steps of ``train_full`` give the losses of
    the same code on the CPU (plain kernels, the params copied there)
    within phase 4's relative 1e-5; then ``train_full`` runs
    ``EXAMPLE_TRAIN_STEPS`` steps and the four greedy samples
    (``sample_lines``) follow, the launch counts set to 0 just before
    and read just after: the last logged loss below the first, kernel 3
    in f32, kernel 4 and the projection launched. Prints steps/s,
    tokens/s, the peak memory and one profiled step's busy share beside
    ``smi``. Returns the launch counts."""
    from examples_torch import train_model as ex

    from repro_torch.data.pipeline import arithmetic_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import params as params_lib
    from repro_torch.optim import init as opt_init

    cfg = ex.arith_100m_config()
    p0 = params_lib.init_params(cfg, 0, device="cuda")
    n_params = params_lib.count_params(p0)
    first = {}
    for dev, prm in (("cpu", _to_device(p0, "cpu")), ("cuda", p0)):
        got = []
        with contextlib.redirect_stdout(io.StringIO()):
            ex.train_full(cfg, EXAMPLE_CHECK_STEPS, params=prm, device=dev,
                          on_step=lambda i, m: got.append(float(m["loss"])))
        first[dev] = got
    for i, (a, b) in enumerate(zip(first["cuda"], first["cpu"])):
        if not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"train_model: step {i} loss {a} on the "
                                 f"card, {b} on the CPU")
    log(f"train_model: {cfg.name}, {cfg.num_layers} layers x "
        f"{cfg.d_model}, {cfg.dtype}: {n_params} params; losses of steps "
        f"0-{EXAMPLE_CHECK_STEPS - 1} on the card {first['cuda']}, on the "
        f"CPU {first['cpu']}")

    logged = []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _, params, _ = ex.train_full(
        cfg, EXAMPLE_TRAIN_STEPS, params=p0, device="cuda",
        on_step=lambda i, m: i % ex.LOG_EVERY == 0 and logged.append(
            m["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    lines = ex.sample_lines(cfg, params)
    launches = ops.launch_counts()
    for line in lines:
        log(f"train_model: sample {line.strip()}")
    log(f"train_model: launches during the run {launches} (f32 "
        f"{launches.f32})")
    missing = [k for k in TRAIN_MODEL_KERNELS if launches[k] <= 0]
    if missing or launches.f32["fused_swiglu"] <= 0:
        raise AssertionError(f"train_model: never launched {missing} (f32 "
                             f"fused_swiglu {launches.f32['fused_swiglu']})")
    losses = [float(x) for x in logged]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_model: logged losses {losses}")
    tokens = EXAMPLE_TRAIN_STEPS * ex.FULL_BATCH * ex.FULL_SEQ
    log(f"train_model: {EXAMPLE_TRAIN_STEPS} steps on {smi}: wall "
        f"{wall:.3f} s, steps/s {EXAMPLE_TRAIN_STEPS / wall:.3f}, tokens/s "
        f"{tokens / wall:.1f}, peak memory {peak / 2**30:.2f} GiB; logged "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    # one more step unprofiled, then the same step under the profiler
    b = next(arithmetic_batches(ex.FULL_BATCH, ex.FULL_SEQ, seed=0))
    batch = {n: torch.from_numpy(getattr(b, n)).cuda()
             for n in ("tokens", "labels", "loss_mask")}
    step = make_train_step(cfg, ex.full_train_config(EXAMPLE_TRAIN_STEPS))
    state = opt_init(params)

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    wall_step = timed_step()
    wall_prof, events, t_read, counts = profiled(torch, timed_step)
    busy = report_profile(events, t_read, wall_step, wall_prof,
                          launches=counts)
    log(f"train_model: one step {wall_step * 1e3:.2f} ms, the card busy "
        f"{100 * busy:.1f}% of it, on {smi}")
    del params, state, p0, events
    torch.cuda.empty_cache()
    return launches


def run_greedy_attribution_leg(torch, smi: str) -> dict:
    """(d) The greedy attribution check: the serve CLI's default fleet
    (``launch.serve.build_zoo``, reduced, ``GREEDY_TRAIN_STEPS``
    arithmetic steps a model on the card), its members decoded greedily
    (``ensemble_temperature`` 0), over the CLI's default stream of
    ``GREEDY_TASKS`` arithmetic tasks with forced routes, through
    ``run_queued``: an untraced run, then a traced one under golds keyed
    to the untraced run's member answers (``attribution_key``). The
    traced head equals the untraced run's under the keyed golds, the
    span file verifies, every lineage walks, one attribution span per
    full-arena row equals leave-one-out (``check_attribution``), and at
    least one value is non-zero. Returns the two runs' launch counts."""
    import tempfile

    from repro_torch.configs import ACARConfig
    from repro_torch.data.tasks import arithmetic_suite
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serving import (
        BatchedACAREngine, MicroBatchPolicy, SpanTracer)
    from repro_torch.teamllm.prov import lineage, verify_span_file

    t0 = time.perf_counter()
    zoo = serve_mod.build_zoo(
        (serve_mod.DEFAULT_PROBE,) + serve_mod.DEFAULT_ENSEMBLE,
        GREEDY_TRAIN_STEPS, verbose=False, device="cuda")
    probe, ensemble = zoo[0], zoo[1:]
    names = [m.name for m in ensemble]
    acfg = ACARConfig(probe_model=probe.name, ensemble_models=tuple(names),
                      ensemble_temperature=0.0, seed=0)
    tasks = arithmetic_suite(GREEDY_TASKS, seed=99)
    modes = forced_modes(len(tasks))

    def run(stream, tracer=None):
        eng = BatchedACAREngine(
            acfg, probe, ensemble, device="cuda",
            route_fn=lambda sig, idx: modes[np.asarray(idx, np.int64)])
        return eng.run_queued(stream, MicroBatchPolicy(max_batch_size=8),
                              tracer=tracer)

    ops.reset_launch_counts()
    base = run(tasks)
    keyed = attribution_key(tasks, base, names)
    with tempfile.TemporaryDirectory(prefix="acar-greedy-") as d:
        d = Path(d)
        traced = run(keyed, SpanTracer(d / "spans.jsonl"))
        launches = ops.launch_counts()
        # serving does not read the gold: the untraced run's results are
        # its results under the keyed golds
        heads = [chain_head("greedy", keyed, r, names, d / f"{i}.jsonl")
                 for i, r in enumerate((base, traced))]
        audit = verify_span_file(d / "spans.jsonl")
    if heads[0] != heads[1]:
        raise AssertionError(f"greedy: the traced head {heads[1]} is not "
                             f"the untraced run's {heads[0]}")
    if not (audit["ok"] and audit["head"] == traced.span_head
            and audit["records"] == len(traced.spans)):
        raise AssertionError(f"greedy: span file audit {audit}")
    walked = [lineage(traced.spans, t)
              for t in sorted({t.task_id for t in keyed})]
    if not all(lin["ok"] and lin["verified"] > 0 for lin in walked):
        raise AssertionError("greedy: a task's lineage failed")
    n_full, n_nonzero = check_attribution(keyed, traced, names, "greedy")
    full = [i for i in range(len(tasks)) if int(traced.modes[i]) == 2]
    answered = sum(1 for i in full for a in traced.member_answers[i] if a)
    log(f"greedy: member answers on the full-arena rows "
        f"{[traced.member_answers[i] for i in full]}")
    if n_nonzero == 0:
        raise AssertionError(f"greedy: every attribution value of {n_full} "
                             f"full-arena rows is 0")
    log(f"greedy: the CLI's default fleet trained {GREEDY_TRAIN_STEPS} "
        f"steps a model, members greedy, {len(tasks)} tasks traced on "
        f"{smi}: head {heads[1]} = the untraced run's; span file verified, "
        f"lineage OK for {len(walked)} tasks; {n_full} full-arena "
        f"attribution spans equal to leave-one-out, non-zero in "
        f"{n_nonzero}; {answered} of {len(names) * n_full} member answers "
        f"not empty; {time.perf_counter() - t0:.1f} s with the training")
    del zoo, probe, ensemble
    torch.cuda.empty_cache()
    return launches


def run_host_examples() -> None:
    """(c) ``examples_torch/quickstart.py`` and ``attribution_demo.py``,
    in process (the synthetic pool: host only): the quickstart's audit
    holds 12 records and no parse error, the demo shows its 5 tasks."""
    from examples_torch import attribution_demo, quickstart
    with contextlib.redirect_stdout(io.StringIO()) as out:
        audit = quickstart.main([])
    if not (audit["ok"] and audit["records"] == 12
            and audit["parse_errors"] == 0):
        raise AssertionError(f"quickstart: audit {audit}")
    log(f"quickstart: {out.getvalue().splitlines()[-2].strip()}")
    with contextlib.redirect_stdout(io.StringIO()):
        shown = attribution_demo.main([])
    if shown != attribution_demo.SHOWN:
        raise AssertionError(f"attribution_demo: {shown} tasks shown")
    log(f"attribution_demo: {shown} full-arena tasks shown")


def run_examples_phase(torch, smi: str) -> dict:
    """Phase 15: the examples' legs (a), (d) and (c); phase 11 (c) runs
    ``serve_acar``'s. Returns each device leg's launch counts."""
    by_path = {"train_model": run_train_model_leg(torch, smi),
               "greedy_attribution": run_greedy_attribution_leg(torch, smi)}
    run_host_examples()
    return by_path


# ----------------------------------------------------------------------
# phase 11: the serve CLI's fleets at published widths
# ----------------------------------------------------------------------
# each path's kernels, and no other. The default fleet's wave decodes
# smollm-135m, llama3-8b and deepseek-7b from pool pages and
# recurrentgemma-2b over contiguous caches whose attention layers are
# all rings (window 2048), which reach no kernel; its stepped run
# prefills the dense members in chunks (kernel 2 at d 64 and d 128) and
# serves recurrentgemma-2b on the contiguous-cache member fallback. The
# heterogeneous fleet's Mamba probe runs on lanes and its
# sliding-window member on ring pages, both plain; its int8 member
# decodes through the int8 kernels, its llama3-8b through the dense
# ones.
FLEET_PATHS = {
    "fleet_wave": ("paged_decode_attention", "fused_swiglu", "projection"),
    "fleet_stepped": ("paged_decode_attention", "chunked_prefill_attention",
                      "fused_swiglu", "projection"),
    "hetero_stepped": ("paged_decode_attention",
                       "chunked_prefill_attention", "fused_swiglu",
                       "paged_decode_attention_quant", "projection"),
    "hetero_dense": ("fused_swiglu", "decode_attention",
                     "decode_attention_quant", "projection"),
    # phase 11 (d): granite-34b (G 48 on one kv head) behind the
    # smollm-135m probe, stepped and paged=False
    "granite_stepped": ("paged_decode_attention",
                        "chunked_prefill_attention", "fused_swiglu",
                        "projection"),
    "granite_dense": ("fused_swiglu", "decode_attention", "projection"),
    # phase 12: the probe's paged kernels, and kernel 3 for the gather
    # member's experts (its ring pages reach no attention kernel) and
    # deepseek-v2's dense layer 0 on the fallback; the paged=False
    # baseline decodes the probe over contiguous caches (kernel 4)
    "moe_stepped": ("paged_decode_attention", "chunked_prefill_attention",
                    "fused_swiglu", "projection"),
    "moe_dense": ("fused_swiglu", "decode_attention", "projection"),
    # phase 13: llava on the contiguous-cache member fallback (kernel 3
    # on its prefill; its ring decodes reach no kernel) beside the
    # probe's paged kernels, or beside its contiguous decodes in the
    # paged=False baseline
    "vision_stepped": ("paged_decode_attention",
                       "chunked_prefill_attention", "fused_swiglu",
                       "projection"),
    "vision_dense": ("fused_swiglu", "decode_attention", "projection"),
}
FLEET_FREED_BYTES = 1 << 30
# phase 11 serves every model at its first 10 layers, as phases 6, 8
# and 10 cut theirs (AUDIT_LAYERS): its walls are host-bound and scale
# with depth; at full depth the phase took 112 s of the script's budget,
# which phases 12 and 13 now share
FLEET_LAYERS = 10


def fleet_models(torch, specs, layers=None):
    """``ZooModel``s of the member specs (``launch.serve.parse_member``)
    at their published widths, bf16, seed-initialised on the card, spec
    i from seed i; each cut to its first ``layers[spec]`` layers where
    ``layers`` (a dict, or an int for every spec) names a cut. A spec's
    twin (``spec`` + "-twin") shares the spec's model; ``arch:gather``
    is the arch's MoE with the gather dispatch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_member
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving import ZooModel

    zoo = []
    t0 = time.perf_counter()
    for i, spec in enumerate(specs):
        if spec.endswith("-twin"):
            twin = next(m for m in zoo if m.name == spec[:-5])
            zoo.append(ZooModel(spec, twin.cfg, twin.params))
            continue
        if spec.endswith(":gather"):
            # the MoE with the capacity-free gather dispatch, which the
            # CLI's specs do not name
            cfg = get_config(spec[:-7])
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      impl="gather"))
        else:
            arch, variant = parse_member(spec)
            cfg = variant(get_config(arch))
        cut = layers.get(spec) if isinstance(layers, dict) else layers
        if cut is not None and cut < cfg.num_layers:
            cfg = cfg.replace(num_layers=cut)
        zoo.append(ZooModel(spec, cfg, init_params(cfg, i, device="cuda")))
        account_params(f"fleets[{spec}]", cfg, zoo[-1].params)
        log(f"fleets: {spec} {cfg.family} {cfg.num_layers} layers d_model "
            f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} "
            f"head_dim {cfg.resolved_head_dim} d_ff {cfg.d_ff} window "
            f"{cfg.window} vocab {cfg.vocab_size} {cfg.dtype}: "
            f"{count_params(zoo[-1].params) / 1e9:.3f} B params")
    torch.cuda.synchronize()
    log(f"fleets: {len(zoo)} models initialised in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return zoo[0], zoo[1:]


def serve_fleet(torch, label, probe, ensemble, tasks, route, path, smi):
    """One path over a fleet, twice (``serve_twice``): the wave engine
    (``fleet_wave``), the stepped engine (``*_stepped``) or the
    ``paged=False`` queued baseline (``*_dense``). Returns (launches,
    result)."""
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import BatchedACAREngine, MicroBatchPolicy

    policy = MicroBatchPolicy(max_batch_size=8, max_batch_tokens=1 << 20)

    def run():
        eng = BatchedACAREngine(
            ACARConfig(probe_temperature=0.9, seed=0), probe, ensemble,
            max_new_tokens=MAX_NEW, route_fn=route, device="cuda",
            paged=False if path.endswith("_dense") else None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if path.endswith("stepped"):
            res = eng.run_stepped(tasks, policy, chunk_tokens=32,
                                  megastep=4)
        elif path.endswith("_dense"):
            res = eng.run_queued(tasks, policy)
        else:
            res = eng.run_batch(tasks)
        torch.cuda.synchronize()
        return eng, res, time.perf_counter() - t

    launches, (eng, res, wall), _, _ = serve_twice(
        torch, f"fleets[{label} {path}]", path, run, FLEET_PATHS[path],
        tasks, [m.name for m in ensemble])
    account_pools(f"fleets[{label} {path}]", eng, [probe] + ensemble)
    hw = {m: (st.pages_highwater, st.pool_pages)
          for m, st in eng.kv_stats().items()}
    log(f"fleets[{label} {path}]: {len(tasks)} tasks on {smi}: wall "
        f"{wall:.3f} s, {len(tasks) / wall:.3f} tasks/s, modes "
        f"{np.bincount(res.modes, minlength=3)}; pages or lanes "
        f"high-water / pool {hw}")
    return launches, res


def free_fleet(torch, label) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"fleets: {label} freed, {held / 2**30:.3f} GiB still allocated, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if held > FLEET_FREED_BYTES:
        raise AssertionError(f"fleets: {held} bytes still allocated after "
                             f"the {label} fleet was freed")
    torch.cuda.reset_peak_memory_stats()


def run_fleet_phase(torch, smi: str) -> dict:
    """(a) the serve CLI's default fleet (``DEFAULT_PROBE`` and
    ``DEFAULT_ENSEMBLE``) through the wave engine and the stepped engine;
    (b) the heterogeneous fleet (``HETERO_PROBE``, ``HETERO_ENSEMBLE``)
    through the stepped engine and the ``paged=False`` queued baseline,
    with whether their heads agree (a finding); both at published
    widths, every model at its first ``FLEET_LAYERS`` layers, over phase
    5's stream and forced routes; (d) granite-34b behind the smollm-135m
    probe (``run_granite_leg``); (c) the CLI through
    ``examples_torch/serve_acar.py`` (``run_cli_legs``). Returns each
    path's launch counts."""
    from repro_torch.launch import serve as serve_mod

    tasks = long_prompt_tasks(16, prompt_chars=PROMPT)
    modes = forced_modes(len(tasks))

    def route(sig, indices):
        return modes[np.asarray(indices, np.int64)]

    by_path = {}
    t0 = time.perf_counter()
    probe, ensemble = fleet_models(
        torch, (serve_mod.DEFAULT_PROBE,) + serve_mod.DEFAULT_ENSEMBLE,
        FLEET_LAYERS)
    for path in ("fleet_wave", "fleet_stepped"):
        by_path[path], res = serve_fleet(torch, "default", probe, ensemble,
                                         tasks, route, path, smi)
    # phase 14 (a) while the default fleet is on the card
    by_path["mesh"] = run_mesh_default_fleet(torch, probe, ensemble, tasks,
                                             route, res, smi)
    del probe, ensemble, res
    free_fleet(torch, "default")
    log(f"fleets: (a) default fleet {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    probe, ensemble = fleet_models(
        torch, (serve_mod.HETERO_PROBE,) + serve_mod.HETERO_ENSEMBLE,
        FLEET_LAYERS)
    by_path["hetero_stepped"], res_s = serve_fleet(
        torch, "hetero", probe, ensemble, tasks, route, "hetero_stepped",
        smi)
    by_path["hetero_dense"], res_d = serve_fleet(
        torch, "hetero", probe, ensemble, tasks, route, "hetero_dense", smi)
    # both runs' records under one run id, so that the heads compare
    import tempfile
    names = [m.name for m in ensemble]
    with tempfile.TemporaryDirectory(prefix="acar-chain-") as d:
        head_s, head_d = (chain_head("hetero", tasks, r, names,
                                     Path(d) / f"{i}.jsonl")
                          for i, r in enumerate((res_s, res_d)))
    if head_s == head_d:
        log("fleets: finding: the heterogeneous fleet's stepped head "
            f"equals its paged=False queued head ({head_s})")
    else:
        log("fleets: finding: the heterogeneous fleet's stepped head "
            f"{head_s} differs from its paged=False queued head {head_d};"
            f" first mismatching task {first_mismatch(tasks, res_s, res_d)}")
    del probe, ensemble
    free_fleet(torch, "heterogeneous")
    log(f"fleets: (b) heterogeneous fleet {time.perf_counter() - t0:.1f} s")

    by_path.update(run_granite_leg(torch, tasks, route, smi))
    by_path.update(run_cli_legs(torch))
    return by_path


def run_cli_legs(torch) -> dict:
    """Phase 11 (c): ``examples_torch/serve_acar.py``'s ``main``, which
    hands its flags to the serve CLI (``launch.serve.main``), on the
    card for the default fleet, the heterogeneous fleet with the step
    loop, the default fleet with the step loop and on a data-sharded
    mesh of ``MESH_DEVICES`` logical devices (reduced models trained 2
    steps, 8 tasks each): every report covers the 8 tasks, the sharded
    report equals the step loop's, kernels 1, 2 and 3 launched on the
    mesh. Returns each leg's launch counts."""
    from examples_torch import serve_acar
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    by_path, reports = {}, {}
    cli = ["--tasks", "8", "--train-steps", "2"]
    for path, argv in (
            ("cli_default", cli),
            ("cli_hetero", ["--hetero-fleet", "--step-loop"] + cli),
            ("cli_stepped", ["--step-loop"] + cli),
            ("cli_shards", ["--shards", str(MESH_DEVICES)] + cli)):
        ops.reset_launch_counts()
        report = serve_acar.main(argv)
        by_path[path] = ops.launch_counts()
        if sum(report["mode_distribution"].values()) != 8:
            raise AssertionError(f"fleets[{path}]: the report covers "
                                 f"{report['mode_distribution']}")
        log(f"fleets[{path}]: examples_torch/serve_acar.py "
            f"main({' '.join(argv)}) returned accuracy "
            f"{report['accuracy']:.3f}, modes "
            f"{report['mode_distribution']}; launches {by_path[path]}")
        del report["wall_ms"]
        reports[path] = report
    # the CLI on a data-sharded mesh (logical devices on the one card)
    # reports what the unsharded step loop reports
    if reports["cli_shards"] != reports["cli_stepped"]:
        raise AssertionError(
            f"fleets[cli_shards]: report {reports['cli_shards']} is not "
            f"the unsharded step loop's {reports['cli_stepped']}")
    missing = [k for k in MESH_KERNELS + ("fused_swiglu",)
               if by_path["cli_shards"][k] <= 0]
    if missing:
        raise AssertionError(f"fleets[cli_shards]: never launched {missing}")
    log("fleets[cli_shards]: the report equals the unsharded step loop's")
    free_fleet(torch, "CLI")
    log(f"fleets: (c) CLI {time.perf_counter() - t0:.1f} s")
    return by_path


# (d) granite-34b (multi-query attention: 48 query heads on one kv head,
# so G 48, the decode kernels' G-tiles) at published widths, 2 of its 88
# layers (~2.2 GB of bf16 weights beside a 1.2 GB embedding and
# lm_head), behind the smollm-135m probe and its twin, over the first 8
# of phase 5's tasks
GRANITE_FLEET = ("smollm-135m", "granite-34b", "smollm-135m-twin")
GRANITE_LAYERS = {"smollm-135m": FLEET_LAYERS, "granite-34b": 2}
GRANITE_TASKS = 8


def run_granite_leg(torch, tasks, route, smi) -> dict:
    """Phase 11 (d): ``GRANITE_FLEET`` stepped (granite-34b on pages:
    kernels 1 and 2 at G 48, kernel 3 on its prefill MLP, the
    projection) and through the ``paged=False`` queued baseline (kernel
    4 at G 48), each twice through ``serve_twice`` (every task retired,
    each path's kernels and no other, no page leaked, the rerun's
    results and chain head identical); the decodes' head geometries
    recorded, (48, 1) among them, and their launches printed. Returns
    each path's launch counts."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    tasks = tasks[:GRANITE_TASKS]
    probe, ensemble = fleet_models(torch, GRANITE_FLEET, GRANITE_LAYERS)
    granite = ensemble[0].cfg
    g48 = (granite.num_heads, granite.num_kv_heads)
    by_path = {}
    for path, kernel in (("granite_stepped", "paged_decode_attention"),
                         ("granite_dense", "decode_attention")):
        with MeshShapes(ops) as shapes:
            by_path[path] = serve_fleet(torch, "granite", probe, ensemble,
                                        tasks, route, path, smi)[0]
        if g48 not in shapes.seen[kernel]:
            raise AssertionError(f"fleets[granite {path}]: {kernel} never "
                                 f"ran at (q, kv) heads {g48}: "
                                 f"{shapes.seen[kernel]}")
        log(f"fleets[granite {path}]: {kernel} at (q, kv) heads "
            f"{sorted(shapes.seen[kernel])} (G {g48[0] // g48[1]} in "
            f"{-(-g48[0] // g48[1] // 8)} tiles), {by_path[path][kernel]} "
            f"launches over both models; launches {by_path[path]}")
    del probe, ensemble
    free_fleet(torch, "granite-34b")
    log(f"fleets: (d) granite-34b {time.perf_counter() - t0:.1f} s")
    return by_path


# ----------------------------------------------------------------------
# phase 12: the MoE family at published widths
# ----------------------------------------------------------------------
# the fleet of ``launch.serve --ensemble mixtral-8x22b deepseek-v2-236b``
# at published widths, mixtral-8x22b with the gather dispatch (the one
# MoE a page layout serves: ring pages, its 4096-token window) and the
# probe's twin; depth cut to fit one card beside the rest: mixtral-8x22b
# 4 of 56 layers (~20.8 GB of bf16 weights), deepseek-v2-236b 2 of 60
# (its dense layer 0 and one MoE layer, ~10.6 GB)
MOE_FLEET = ("smollm-135m", "mixtral-8x22b:gather", "deepseek-v2-236b",
             "smollm-135m-twin")
MOE_FLEET_LAYERS = {"mixtral-8x22b:gather": 4, "deepseek-v2-236b": 2}


class GatherLaunches:
    """Counts, while armed, the gather MoE's calls and the kernel-3
    launches they make, split into prefill (S > 1 tokens a row) and
    decode ticks (one token a row): ``models.moe.moe_ffn_gather`` is
    wrapped, the launch counts read before and after each call."""

    def __init__(self):
        self.calls = {"prefill": 0, "decode": 0}
        self.launches = {"prefill": 0, "decode": 0}

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import moe
        self._real = real = moe.moe_ffn_gather

        def counted(cfg, p, x):
            before = ops.launch_counts()["fused_swiglu"]
            out = real(cfg, p, x)
            kind = "decode" if x.shape[1] == 1 else "prefill"
            self.calls[kind] += 1
            self.launches[kind] += (ops.launch_counts()["fused_swiglu"]
                                    - before)
            return out

        moe.moe_ffn_gather = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_ffn_gather = self._real


def moe_dispatch_specs(fleet) -> str:
    """A line of each member's page layout and MoE dispatch."""
    from repro_torch.models.transformer import resolve_layout
    return ", ".join(
        f"{m.name}={resolve_layout(m.cfg) or 'contiguous fallback'}"
        + (f"/{m.cfg.moe.impl}" if m.cfg.moe else "")
        + (f"/{m.cfg.attn_kind}" if m.cfg.attn_kind != "gqa" else "")
        for m in fleet)


def run_moe_phase(torch, smi: str) -> dict:
    """Phase 5's stream and forced routes through ``MOE_FLEET`` at
    published widths (bf16, seed-initialised; depth cut by
    ``MOE_FLEET_LAYERS``): the stepped engine (the probe on dense pages
    through kernels 1-3, mixtral-8x22b's gather experts through kernel 3
    on its ring pages' one-shot prefill and on every decode tick,
    deepseek-v2-236b on the contiguous-cache member fallback: capacity
    prefill with MLA, per-token MoE decode over the latent cache) and
    the ``paged=False`` queued baseline, each twice through
    ``serve_twice`` (every task retired, each path's kernels and no
    other, no page leaked, the rerun's results and chain head
    identical). Every gather call's kernel-3 launches are counted: one a
    routed expert, on the prefill and on each decode tick. Walls,
    launches and the peak memory are printed. Returns each path's launch
    counts."""
    tasks = long_prompt_tasks(16, prompt_chars=PROMPT)
    modes = forced_modes(len(tasks))

    def route(sig, indices):
        return modes[np.asarray(indices, np.int64)]

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    probe, ensemble = fleet_models(torch, MOE_FLEET, MOE_FLEET_LAYERS)
    log(f"moe: layouts {moe_dispatch_specs([probe] + ensemble)}")
    by_path = {}
    for path in ("moe_stepped", "moe_dense"):
        with GatherLaunches() as gl:
            by_path[path], res = serve_fleet(torch, "moe", probe, ensemble,
                                             tasks, route, path, smi)
        experts = ensemble[0].cfg.moe.num_experts
        for kind in ("prefill", "decode"):
            if not gl.calls[kind] or (gl.launches[kind]
                                      != experts * gl.calls[kind]):
                raise AssertionError(
                    f"moe[{path}]: {gl.calls[kind]} gather {kind} calls "
                    f"made {gl.launches[kind]} kernel-3 launches, not "
                    f"{experts} each")
        answered = [sum(a[j] is not None for a in res.member_answers)
                    for j in range(len(ensemble))]
        if not all(answered[:2]):
            raise AssertionError(f"moe[{path}]: a MoE member answered no "
                                 f"row: {answered}")
        log(f"moe[{path}]: gather calls {gl.calls}, kernel-3 launches "
            f"{gl.launches} (one a routed expert); rows answered by "
            f"member {answered}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del probe, ensemble
    free_fleet(torch, "MoE")
    log(f"moe: phase 12 {time.perf_counter() - t0:.1f} s")
    return by_path


# ----------------------------------------------------------------------
# phase 13: the audio and vision families at published widths
# ----------------------------------------------------------------------
# whisper-medium at full depth (24 encoder + 24 decoder layers): 8 rows
# of 1500 synthetic frames, 4-token prompts, 28 greedy new tokens; then
# 3 samples of each of 4 prompts at temperature 0.9
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_NEW = 8, 4, 28
WHISPER_SAMPLES, WHISPER_SAMPLE_PROMPTS = 3, 4
# llava-next-mistral-7b at its first 10 of 32 layers (~2.4 B params, the
# depth phases 8, 10 and 11 serve their models at): 4 rows of 1152
# patch embeddings and 97 text tokens, 8 new tokens; then phase 5's
# stream through its fleet (the probe, llava, the probe's twin)
VISION_LAYERS = 10
VISION_ROWS = 4
VISION_FLEET = ("smollm-135m", "llava-next-mistral-7b", "smollm-135m-twin")


def generate_twice(torch, label, fn, need):
    """``fn()`` -> GenerateOutput twice, the launch counts set to 0 just
    before each and read just after: tokens, lengths and logprobs
    finite and bit for bit equal, the launches exactly ``need`` (a
    count, or None: some) and no other kernel. Returns (launches,
    output, wall of the first run)."""
    from repro_torch.kernels import ops
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs.append((ops.launch_counts(), out, time.perf_counter() - t))
    (launches, out, wall), (launches2, out2, wall2) = runs
    ran = {k for k, v in launches.items() if v}
    if ran != set(need) or any(n is not None and launches[k] != n
                               for k, n in need.items()):
        raise AssertionError(f"{label}: launched {launches}, not {need} "
                             "alone")
    if not torch.isfinite(out.logprobs).all():
        raise AssertionError(f"{label}: non-finite logprobs")
    if launches2 != launches or not all(
            torch.equal(a, b) for a, b in zip(out, out2)):
        raise AssertionError(f"{label}: the rerun's tokens, lengths, "
                             "logprobs or launches differ")
    log(f"{label}: {tuple(out.tokens.shape)} tokens in {wall:.3f} s "
        f"(rerun {wall2:.3f} s), rerun bit for bit; launches "
        f"{ {k: launches[k] for k in need} }, no other kernel")
    return launches, out, wall


def run_frontend_phase(torch, smi: str) -> dict:
    """(a) whisper-medium at published widths and full depth, bf16,
    seed-initialised: ``generate`` over ``WHISPER_ROWS`` rows of 1500
    synthetic frames and ``WHISPER_PROMPT``-token prompts, greedy, then
    ``generate_samples`` (n 3, temperature 0.9) over 4 of them, each
    twice (``generate_twice``: bit for bit), kernel 4 once a decoder
    layer and decode step, the projection and no other kernel; (b)
    llava-next-mistral-7b at published widths, its first
    ``VISION_LAYERS`` layers: ``generate`` over 4 rows of 1152 synthetic
    patches and 97 text tokens, 8 new tokens, twice, kernel 3 once a
    layer on the prefill, the projection, and no attention kernel on the
    ring decodes; then phase 5's stream and forced routes through
    ``VISION_FLEET``, stepped (llava on the contiguous-cache member
    fallback) and the ``paged=False`` queued baseline, each twice through
    ``serve_twice``. Walls, launches and the peak memory are printed.
    Returns each path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import frontends
    from repro_torch.models.params import count_params, init_params
    from repro_torch.sampling import prng
    from repro_torch.sampling import sampler as S

    by_path = {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("whisper-medium")
    params = init_params(cfg, 0, device="cuda")
    frames = frontends.synthetic_frames(cfg, WHISPER_ROWS, 1,
                                        device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    prompts = torch.randint(0, cfg.vocab_size, (WHISPER_ROWS,
                                                WHISPER_PROMPT),
                            generator=gen, device="cuda")
    log(f"frontend: whisper-medium {cfg.encoder.num_layers} + "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}: "
        f"{count_params(params) / 1e9:.3f} B params; frames "
        f"{tuple(frames.shape)}")
    # kernel 4 once a decoder layer and decode step; the projection
    # for every wq, wk, wv (encoder, decoder, cross) and the lm_head
    need = {"decode_attention": WHISPER_NEW * cfg.num_layers,
            "projection": None}
    by_path["whisper_generate"], out, _ = generate_twice(
        torch, "frontend[whisper-medium generate]",
        lambda: S.generate(cfg, params, prompts,
                           max_new_tokens=WHISPER_NEW,
                           frontend_embeds=frames), need)
    if not (out.lengths == WHISPER_NEW).all():
        raise AssertionError("frontend[whisper-medium generate]: lengths "
                             f"{out.lengths.tolist()}")
    k = WHISPER_SAMPLE_PROMPTS
    by_path["whisper_samples"], out, _ = generate_twice(
        torch, "frontend[whisper-medium generate_samples]",
        lambda: S.generate_samples(
            cfg, params, prompts[:k], WHISPER_SAMPLES,
            max_new_tokens=WHISPER_NEW, temperature=0.9,
            key=prng.prng_key(7),
            frontend_embeds=frames[:k].contiguous()), need)
    if tuple(out.tokens.shape) != (k * WHISPER_SAMPLES, WHISPER_NEW):
        raise AssertionError("frontend[whisper-medium generate_samples]: "
                             f"tokens {tuple(out.tokens.shape)}")
    log(f"frontend: whisper-medium peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{time.perf_counter() - t0:.1f} s")
    del params, frames
    free_fleet(torch, "whisper-medium")

    t1 = time.perf_counter()
    probe, ensemble = fleet_models(torch, VISION_FLEET,
                                   {"llava-next-mistral-7b": VISION_LAYERS})
    llava = ensemble[0]
    vcfg = llava.cfg
    patches = frontends.synthetic_patches(vcfg, VISION_ROWS, 2,
                                          device="cuda")
    text = torch.randint(0, vcfg.vocab_size,
                         (VISION_ROWS, vcfg.num_patches + PROMPT),
                         generator=gen, device="cuda")
    by_path["vision_generate"], out, _ = generate_twice(
        torch, "frontend[llava-next-mistral-7b generate]",
        lambda: S.generate(vcfg, llava.params, text,
                           max_new_tokens=MAX_NEW,
                           frontend_embeds=patches),
        {"fused_swiglu": vcfg.num_layers, "projection": None})
    log(f"frontend: llava-next-mistral-7b prompt {tuple(text.shape)} "
        f"({vcfg.num_patches} patch positions), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    tasks = long_prompt_tasks(16, prompt_chars=PROMPT)
    modes = forced_modes(len(tasks))

    def route(sig, indices):
        return modes[np.asarray(indices, np.int64)]

    for path in ("vision_stepped", "vision_dense"):
        by_path[path], res = serve_fleet(torch, "vision", probe, ensemble,
                                         tasks, route, path, smi)
        answered = sum(a[0] is not None for a in res.member_answers)
        if not answered:
            raise AssertionError(f"frontend[{path}]: llava answered no row")
        log(f"frontend[{path}]: llava answered {answered} rows; peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del probe, ensemble, llava, patches
    free_fleet(torch, "vision")
    log(f"frontend: llava-next-mistral-7b {time.perf_counter() - t1:.1f} s;"
        f" phase 13 {time.perf_counter() - t0:.1f} s")
    return by_path


# ----------------------------------------------------------------------
# phase 3, the serving mesh's kernel-3 stages (tensor parallelism)
# ----------------------------------------------------------------------
# llama3-8b's MLP split over two model columns: gate_up on a column's
# F/2 slice, down over the gathered h (phase 14 (b)'s shapes); f32 at
# the reduced mesh2d fleet's width and at d 4096
MESH_STAGE_BF16 = (FLEET_ROWS * 32, 4096, 14336, 2)     # T, d, F, columns
MESH_STAGE_F32 = ((97, 64, 256, 2), (64, 4096, 1024, 4))


def _swiglu_inputs(torch, gen, t, d, f, dtype):
    x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    wg, wu, wd = ((torch.randn(sh, generator=gen, device="cuda")
                   / sh[0] ** 0.5).to(dtype)
                  for sh in ((d, f), (d, f), (f, d)))
    return x, wg, wu, wd


def _column_slices(w, m: int):
    c = w.shape[1] // m
    return [w[:, j * c:(j + 1) * c].contiguous() for j in range(m)]


def mesh_stage_checks(torch) -> dict:
    """Kernel 3's stages as the serving mesh calls them
    (``ops.swiglu_gate_up`` on a column's slice of Wg and Wu, then
    ``ops.swiglu_down`` over the gathered h): in bf16 and f32 the
    column slices' h concatenated in column order equal the unsliced
    call's bit for bit, and gate_up then down equals the fused wrapper
    bit for bit (which launches the same two stages); each stage
    against its plain version, and timed at the bf16 shape beside its
    bound, its plain version and a library expression (silu(x Wg) *
    (x Wu); h Wd). Returns {"swiglu_gate_up": result, "swiglu_down":
    result}, the f32 checks under "f32"."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_swiglu as fs
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    f32 = []
    for t, d, f, m in MESH_STAGE_F32:
        x, wg, wu, wd = _swiglu_inputs(torch, gen, t, d, f, torch.float32)
        name = f"swiglu stages[float32, T {t}, d {d}, F {f}]"
        h = ops.swiglu_gate_up(x, wg, wu)
        for mm in (2, 4):
            require_bits(f"{name} gate_up over {mm} column slices",
                         torch.cat([ops.swiglu_gate_up(x, a, b) for a, b in
                                    zip(_column_slices(wg, mm),
                                        _column_slices(wu, mm))], dim=-1),
                         h)
        err_h = check_close(f"{name} gate_up", h,
                            fs.swiglu_gate_up_plain(x, wg, wu),
                            TOL[("swiglu", "float32")])
        out = ops.swiglu_down(h, wd)
        require_bits(f"{name} gate_up then down against the fused kernel",
                     out, ops.fused_swiglu(x, wg, wu, wd))
        err_o = check_close(f"{name} down", out,
                            fs.swiglu_down_plain(h, wd),
                            TOL[("swiglu", "float32")])
        g0, u0 = _column_slices(wg, m)[0], _column_slices(wu, m)[0]
        fc = f // m
        times = dict(
            gate_up_ms=time_ms(torch, lambda: ops.swiglu_gate_up(x, g0, u0),
                               20),
            gate_up_plain_ms=time_ms(
                torch, lambda: fs.swiglu_gate_up_plain(x, g0, u0), 20),
            gate_up_library_ms=time_ms(
                torch, lambda: F.silu(torch.matmul(x, g0))
                * torch.matmul(x, u0), 20),
            down_ms=time_ms(torch, lambda: ops.swiglu_down(h, wd), 20),
            down_plain_ms=time_ms(
                torch, lambda: fs.swiglu_down_plain(h, wd), 20),
            down_library_ms=time_ms(torch, lambda: torch.matmul(h, wd), 20),
            fused_ms=time_ms(torch, lambda: ops.fused_swiglu(x, wg, wu, wd),
                             20))
        # each stage's bound at this run's shape: gate_up on the column's
        # F/m slice, down over the whole h
        bnd_h, by_h = bound_ms((t * d + 2 * d * fc + t * fc) * 4,
                               4.0 * t * d * fc, "float32")
        bnd_o, by_o = bound_ms((t * f + f * d + t * d) * 4,
                               2.0 * t * f * d, "float32")
        f32.append(dict(tokens=t, d_model=d, d_ff=f, columns=m,
                        gate_up_err=err_h, down_err=err_o,
                        gate_up_bound_ms=bnd_h, gate_up_bound_by=by_h,
                        down_bound_ms=bnd_o, down_bound_by=by_o,
                        bitwise_columns=True, bitwise_fused=True, **times))
        log(f"kernel {name}: 2 and 4 column slices of gate_up give the "
            "unsliced bits; gate_up then down gives the fused kernel's "
            f"bits; errors {err_h:.3e} / {err_o:.3e}; gate_up on a "
            f"column's F/{m} {times['gate_up_ms']:.4f} ms (plain "
            f"{times['gate_up_plain_ms']:.4f} ms, library "
            f"{times['gate_up_library_ms']:.4f} ms, bound {bnd_h:.5f} ms "
            f"({by_h})), down {times['down_ms']:.4f} ms (plain "
            f"{times['down_plain_ms']:.4f} ms, library "
            f"{times['down_library_ms']:.4f} ms, bound {bnd_o:.5f} ms "
            f"({by_o})), fused {times['fused_ms']:.4f} ms")
    t, d, f, m = MESH_STAGE_BF16
    x, wg, wu, wd = _swiglu_inputs(torch, gen, t, d, f, torch.bfloat16)
    name = f"swiglu stages[bfloat16, T {t}, d {d}, F {f}]"
    sg, su = _column_slices(wg, m), _column_slices(wu, m)
    h = torch.cat([ops.swiglu_gate_up(x, a, b) for a, b in zip(sg, su)],
                  dim=-1)
    require_bits(f"{name} gate_up over {m} column slices", h,
                 ops.swiglu_gate_up(x, wg, wu))
    require_bits(f"{name} gate_up then down against the fused wrapper",
                 ops.swiglu_down(h, wd), ops.fused_swiglu(x, wg, wu, wd))
    tol = TOL[("swiglu", "bfloat16")]
    x0, g0, u0 = x, sg[0], su[0]
    fc = f // m
    err_h = check_close(f"{name} gate_up (column 0)",
                        ops.swiglu_gate_up(x0, g0, u0),
                        fs.swiglu_gate_up_plain(x0, g0, u0), tol)
    h_plain = fs.swiglu_gate_up_plain(x, wg, wu)
    err_o = check_close(f"{name} down", ops.swiglu_down(h_plain, wd),
                        fs.swiglu_down_plain(h_plain, wd), tol)
    bnd_h, by_h = bound_ms((t * d + 2 * d * fc + t * fc) * 2,
                           4.0 * t * d * fc, "bfloat16")
    bnd_o, by_o = bound_ms((t * f + f * d + t * d) * 2, 2.0 * t * f * d,
                           "bfloat16")
    gate_up = dict(
        dtype="bfloat16", tokens=t, d_model=d, d_ff=fc, columns=m,
        max_abs_err=err_h, bound_ms=bnd_h, bound_by=by_h,
        ms=time_ms(torch, lambda: ops.swiglu_gate_up(x0, g0, u0)),
        plain_ms=time_ms(torch, lambda: fs.swiglu_gate_up_plain(
            x0, g0, u0)),
        library_ms=time_ms(torch, lambda: F.silu(torch.matmul(x0, g0))
                           * torch.matmul(x0, u0)),
        bitwise_columns=True, f32=f32)
    down = dict(
        dtype="bfloat16", tokens=t, d_model=d, d_ff=f, max_abs_err=err_o,
        bound_ms=bnd_o, bound_by=by_o,
        ms=time_ms(torch, lambda: ops.swiglu_down(h_plain, wd)),
        plain_ms=time_ms(torch, lambda: fs.swiglu_down_plain(h_plain, wd)),
        library_ms=time_ms(torch, lambda: torch.matmul(h_plain, wd)),
        bitwise_fused=True)
    for label, r in (("swiglu_gate_up", gate_up), ("swiglu_down", down)):
        log(f"kernel {label} [{name}]: max_abs_err {r['max_abs_err']:.3e}"
            f"  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {r['library_ms']:.4f} ms  bound {r['bound_ms']:.5f} "
            f"ms ({r['bound_by']})")
    log(f"{name}: {m} column slices of gate_up give the unsliced bits; "
        "gate_up then down gives the fused wrapper's bits")
    del x, wg, wu, wd, h, h_plain
    torch.cuda.empty_cache()
    return {"swiglu_gate_up": gate_up, "swiglu_down": down}


# ----------------------------------------------------------------------
# phase 3, the column-invariant projection and the G-tiled decodes
# ----------------------------------------------------------------------
# the column-split products (rows, K, N) unsliced: a decode block's wq,
# wk / wv, w_gate and lm_head and a prefill chunk's wq at llama3-8b's
# widths (phase 14 (b)), deepseek-7b's w_gate / w_up, and the (1, 2)
# mesh's local wq and wk / wv (N / 2); the first is the kernels line's
# shape
PROJ_MESH_SHAPES = ((8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336),
                    (8, 4096, 128256), (256, 4096, 4096), (8, 4096, 11008),
                    (8, 4096, 2048), (8, 4096, 512))
# phase 5's decode block: smollm-135m's wq, wk / wv and w_gate / w_up
PROJ_SERVE_SHAPES = ((8, 576, 576), (8, 576, 192), (8, 576, 1536))
# f32 (the reduced models): the CUDA-core kernel
PROJ_F32_SHAPES = ((8, 4096, 4096), (97, 192, 512))
PROJ_TOL = {"bfloat16": TOL[("attention", "bfloat16")],
            "float32": TOL[("swiglu", "float32")]}


def _projection_case(torch, gen, rows, k, n, dtype):
    a = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=gen, device="cuda")
         / k ** 0.5).to(dtype)
    return a, w


def projection_checks(torch) -> dict:
    """The projection kernel (``ops.projection``) at ``PROJ_MESH_SHAPES``
    (bf16) and ``PROJ_F32_SHAPES``: against its plain version
    (``torch.matmul``) at the attention tolerance (f32: the SwiGLU's);
    bit for bit, the unsliced call's columns equal the concatenated
    calls on its m column slices (m 2 and 4 where N divides), a
    non-contiguous column view's call (the wrapper's copy) and rows 0-3
    called alone; cuBLAS's column slices against its unsliced product
    logged beside (the reason for the kernel, a finding); each shape
    timed beside its bound and one ``torch.mm``, and at phase 5's decode
    shapes (``PROJ_SERVE_SHAPES``). Returns the kernels line's entry
    (the first shape) with every shape under "shapes"."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.projection import projection_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    shapes, cublas = [], {}
    for dname, cases in (("bfloat16", PROJ_MESH_SHAPES),
                         ("float32", PROJ_F32_SHAPES),
                         ("bfloat16", PROJ_SERVE_SHAPES)):
        dtype = getattr(torch, dname)
        serve = cases is PROJ_SERVE_SHAPES
        for rows, k, n in cases:
            name = f"projection[{dname}, {rows} x {k} x {n}]"
            a, w = _projection_case(torch, gen, rows, k, n, dtype)
            full = ops.projection(a, w)
            err = check_close(name, full, projection_plain(a, w),
                              PROJ_TOL[dname])
            split = [m for m in (2, 4) if n % m == 0 and not serve]
            for m in split:
                require_bits(f"{name} over {m} column slices", torch.cat(
                    [ops.projection(a, c) for c in _column_slices(w, m)],
                    dim=-1), full)
                if dname == "bfloat16":
                    c = n // m
                    cb = torch.cat([torch.matmul(a, w[:, j * c:(j + 1) * c]
                                                 .contiguous())
                                    for j in range(m)], dim=-1)
                    cublas[f"{rows}x{k}x{n}/{m}"] = float(
                        (cb.float() - torch.matmul(a, w).float()).abs()
                        .max())
            if split:
                half = w[:, :n // 2]                      # a strided view
                require_bits(f"{name} on a non-contiguous column view",
                             ops.projection(a, half), full[:, :n // 2])
            require_bits(f"{name} rows 0-3 alone",
                         ops.projection(a[:4].contiguous(), w), full[:4])
            item = a.element_size()
            bnd, by = bound_ms((rows * k + k * n + rows * n) * item,
                               2.0 * rows * k * n, dname)
            r = dict(dtype=dname, rows=rows, k=k, n=n, max_abs_err=err,
                     bound_ms=bnd, bound_by=by, column_slices=split,
                     phase5_decode=serve,
                     ms=time_ms(torch, lambda: ops.projection(a, w),
                                spin=SHORT_SPIN),
                     plain_ms=time_ms(torch, lambda: projection_plain(a, w),
                                      spin=SHORT_SPIN),
                     library_ms=time_ms(torch, lambda: torch.mm(a, w),
                                        spin=SHORT_SPIN))
            shapes.append(r)
            log(f"kernel {name}: max_abs_err {err:.3e}  kernel "
                f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library "
                f"{r['library_ms']:.4f} ms  bound {bnd:.5f} ms ({by}); "
                f"column slices {split} bit for bit, rows 0-3 alone bit "
                "for bit")
            del a, w, full
    log("finding: torch.matmul (cuBLAS, bf16) over m column slices against "
        "the unsliced product, max abs diff by (rows x K x N / m): "
        f"{cublas}")
    torch.cuda.empty_cache()
    main = dict(shapes[0])
    main.update(shapes=shapes, cublas_column_slice_max_diff=cublas)
    return main


# kernels 1, 4, 5 and 6 at more than 8 query heads per kv head (G-tiles
# of 8): granite-34b's decode (H 48 on one kv head, d 128; G 48, six
# tiles) and a ragged G 12 at d 64 (a tile of 8 and one of 4), 8 rows
# at 97-104 positions (paged) or 105 (contiguous)
GTILE_GEOMETRIES = (("granite-34b", 48, 1, 128), ("G 12", 12, 1, 64))


def _gtile_quant(torch, gen, name, h, kv, d, paged: bool, dv=None,
                 dtype=None, spin: int = SPIN_CYCLES) -> dict:
    """Kernel 5 (``paged``) or 6 over int8 codes at (h, kv, d): 8 rows,
    q in bf16 unless ``dtype``, value width ``dv`` where it differs from
    the key width ``d``, against the plain version, rows 0-3 alone bit
    for bit, timed beside the bound (the width + 4 bytes a cached vector
    and head)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention_quant import (
        decode_attention_quant_plain)
    from repro_torch.kernels.paged_decode_attention_quant import (
        paged_decode_attention_quant_plain)
    b = FLEET_ROWS
    dtype = dtype or torch.bfloat16
    dv = dv or d
    dname = str(dtype).split(".")[-1]
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    if paged:
        nb = -(-S_WAVE // PAGE)
        shape = (b * nb, PAGE, kv, d)
        table = torch.randperm(b * nb, generator=gen, device="cuda").to(
            torch.int32).reshape(b, nb).contiguous()
        lengths = (PROMPT + torch.arange(b, device="cuda")).to(torch.int32)
        extra, rows4 = (table, lengths), (table[:4].contiguous(),
                                          lengths[:4].contiguous())
        kernel, plain = (ops.paged_decode_attention_quant,
                         paged_decode_attention_quant_plain)
        n_keys = unique_keys(torch, table, lengths)
        flops_keys = float(lengths.sum())
    else:
        shape = (b, S_WAVE, kv, d)
        extra = rows4 = (S_WAVE,)
        kernel, plain = (ops.decode_attention_quant,
                         decode_attention_quant_plain)
        n_keys = flops_keys = b * S_WAVE
    kc, ks = _quantize(torch.randn(shape, generator=gen, device="cuda"))
    vc, vs = _quantize(torch.randn((*shape[:-1], dv), generator=gen,
                                   device="cuda"))
    got = kernel(q, kc, ks, vc, vs, *extra)
    err = check_close(name, got, plain(q, kc, ks, vc, vs, *extra),
                      TOL[("attention", dname)])
    cut = ((kc, ks, vc, vs) if paged else
           tuple(t[:4].contiguous() for t in (kc, ks, vc, vs)))
    check_same_rows(f"{name} rows 0-3 of {b} alone", got[:4],
                    kernel(q[:4].contiguous(), *cut, *rows4))
    item = q.element_size()
    bnd, by = bound_ms((q.numel() + got.numel()) * item
                       + n_keys * kv * (d + dv + 8)
                       + (4 * (extra[0].numel() + b) if paged else 0),
                       2.0 * h * (d + dv) * flops_keys, dname)
    lengths_r = ([int(extra[1].min()), int(extra[1].max())] if paged
                 else [S_WAVE, S_WAVE])
    return dict(rows=b, lengths=lengths_r, max_abs_err=err, bound_ms=bnd,
                bound_by=by, **_measure(
                    torch, lambda: kernel(q, kc, ks, vc, vs, *extra),
                    lambda: plain(q, kc, ks, vc, vs, *extra), None,
                    spin=spin))


def gtile_checks(torch) -> dict:
    """Kernels 1, 4, 5 and 6 in bf16 at ``GTILE_GEOMETRIES``: each
    against its plain version at the attention tolerance, rows 0-3 alone
    bit for bit, and timed beside its bound and (kernels 1 and 4) SDPA.
    Returns {kernel: {geometry: result}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(48)
    out = {k: {} for k in ("paged_decode_attention", "decode_attention",
                           "paged_decode_attention_quant",
                           "decode_attention_quant")}
    for label, h, kv, d in GTILE_GEOMETRIES:
        geo = f"bfloat16, {label}: H {h} / KV {kv}, d {d}"
        out["paged_decode_attention"][label] = _fleet_paged(
            torch, gen, f"paged_decode_attention[{geo}]", h, kv, d)
        out["decode_attention"][label] = _fleet_dense(
            torch, gen, f"decode_attention[{geo}]", h, kv, d)
        out["paged_decode_attention_quant"][label] = _gtile_quant(
            torch, gen, f"paged_decode_attention_quant[{geo}]", h, kv, d,
            paged=True)
        out["decode_attention_quant"][label] = _gtile_quant(
            torch, gen, f"decode_attention_quant[{geo}]", h, kv, d,
            paged=False)
        for name in out:
            r = out[name][label]
            lib = r["library_ms"]
            log(f"kernel {name} [{geo}, G {h // kv} in "
                f"{-(-(h // kv) // 8)} tiles, {r['rows']} rows at "
                f"{r['lengths'][0]}-{r['lengths'][1]} positions]: "
                f"max_abs_err {r['max_abs_err']:.3e}  kernel "
                f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library "
                f"{'none' if lib is None else f'{lib:.4f} ms'}  bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']}); rows 0-3 "
                "bit-identical alone")
    return out


# ----------------------------------------------------------------------
# phase 3, head widths past 128, dk != dv and padded state sizes
# ----------------------------------------------------------------------
# kernels 1, 4, 5 and 6 at (label, H, KV, dk, dv): recurrentgemma-2b's
# head_dim 256 at G 8 (one G-tile of 4 heads twice) and G 1, and
# DeepSeek's dk 192 / dv 128 at G 4; bf16, and f32 at d 256, G 8
HEAD_WIDTHS = (("d 256, G 8", 8, 1, 256, 256), ("d 256, G 1", 8, 8, 256, 256),
               ("dk 192 / dv 128", 8, 2, 192, 128))
HEAD_WIDTHS_F32 = ("d 256, G 8",)
# kernel 2: (dtype, dk, dv) at H 8 / KV 2 over phase 3's prefill chunk:
# the reference sweep's d 32, 96, recurrentgemma's 256, dk 192 / dv 128
PREFILL_WIDTHS = (("bfloat16", 32, 32), ("bfloat16", 96, 96),
                  ("bfloat16", 256, 256), ("bfloat16", 192, 128),
                  ("float32", 256, 256))
# the selective scan at a state size off the powers of two (padded to 16)
SCAN_PADDED = (2, 512, 8192, 12)
SCAN_PADDED_TIMED = 20


def head_width_checks(torch) -> dict:
    """Kernels 1, 4, 5 and 6 at ``HEAD_WIDTHS`` and kernel 2 at
    ``PREFILL_WIDTHS``: each against its plain version at the attention
    tolerance, rows 0-3 alone (prefill: positions 0-7 of 32) bit for
    bit, and timed beside its bound and the library call (SDPA where
    there is one). Returns {kernel: {label: result}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    out = {k: {} for k in ("paged_decode_attention", "decode_attention",
                           "paged_decode_attention_quant",
                           "decode_attention_quant",
                           "chunked_prefill_attention")}
    cases = [(label, h, kv, dk, dv, torch.bfloat16)
             for label, h, kv, dk, dv in HEAD_WIDTHS]
    cases += [(label, h, kv, dk, dv, torch.float32)
              for label, h, kv, dk, dv in HEAD_WIDTHS
              if label in HEAD_WIDTHS_F32]
    for label, h, kv, dk, dv, dtype in cases:
        dname = str(dtype).split(".")[-1]
        key = f"{dname}, {label}"
        geo = f"{key}: H {h} / KV {kv}"
        kw = dict(dv=dv, dtype=dtype, spin=SHORT_SPIN)
        out["paged_decode_attention"][key] = _fleet_paged(
            torch, gen, f"paged_decode_attention[{geo}]", h, kv, dk, **kw)
        out["decode_attention"][key] = _fleet_dense(
            torch, gen, f"decode_attention[{geo}]", h, kv, dk, **kw)
        out["paged_decode_attention_quant"][key] = _gtile_quant(
            torch, gen, f"paged_decode_attention_quant[{geo}]", h, kv, dk,
            paged=True, **kw)
        out["decode_attention_quant"][key] = _gtile_quant(
            torch, gen, f"decode_attention_quant[{geo}]", h, kv, dk,
            paged=False, **kw)
    for dname, dk, dv in PREFILL_WIDTHS:
        key = f"{dname}, " + (f"d {dk}" if dk == dv else
                              f"dk {dk} / dv {dv}")
        out["chunked_prefill_attention"][key] = prefill_checks(
            torch, dname, *prefill_case(torch, gen, getattr(torch, dname),
                                        h=8, kv=2, d=dk, dv=dv),
            spin=SHORT_SPIN)
    for name, by_width in out.items():
        for key, r in by_width.items():
            lib = r["library_ms"]
            log(f"kernel {name} [{key}]: max_abs_err "
                f"{r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library "
                f"{'none' if lib is None else f'{lib:.4f} ms'}  bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']}); rows 0-3 "
                "(prefill: positions 0-7) bit-identical alone")
    return out


def padded_scan_checks(torch) -> dict:
    """The selective scan (kernels 7 and 7b, through ``ops.
    selective_scan``, which pads N to ``padded_state_size``) at
    ``SCAN_PADDED``'s N 12 in bf16: y within TOL of the plain version on
    the unpadded inputs, h_final bit for bit (a state's recurrence is
    elementwise), batch row 1 alone bit for bit, every gradient by
    ``check_grads``; forward and backward timed beside their bounds."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    b, s, d, n = SCAN_PADDED
    dname = "bfloat16"
    x, dt, a_log, bm, cm = _scan_case(torch, gen, torch.bfloat16,
                                      SCAN_PADDED)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a_log, bm, cm)]
    y, h = ops.selective_scan(*leaves)
    yp, hp = ss.selective_scan_plain(x, dt, a_log, bm, cm)
    name = f"selective_scan[{dname}, {SCAN_PADDED}, N padded to " \
           f"{ss.padded_state_size(n)}]"
    err = check_close(f"{name} y", y, yp, TOL[("scan_y", dname)])
    require_bits(f"{name} h_final", h, hp)
    y1, h1 = ops.selective_scan(*(t[1:2].contiguous() for t in (
        x, dt)), a_log, *(t[1:2].contiguous() for t in (bm, cm)))
    require_bits(f"{name} batch row 1 alone, y", y1, y[1:2])
    require_bits(f"{name} batch row 1 alone, h_final", h1, h[1:2])
    dy = torch.randn((b, s, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    dh = torch.randn((b, d, n), generator=gen, device="cuda")
    got = torch.autograd.grad((y, h), leaves, (dy, dh))
    want = ss.selective_scan_bwd_plain(x, dt, a_log, bm, cm, dy, dh)
    grad = check_grads(f"{name} gradients", got, want, dname)

    def fwd():
        return ops.selective_scan(x, dt, a_log, bm, cm)

    def fwd_bwd():
        ls = [t.detach().requires_grad_() for t in (x, dt, a_log, bm, cm)]
        yy, hh = ops.selective_scan(*ls)
        return torch.autograd.grad((yy, hh), ls, (dy, dh))
    # the forward's bound at the N the data has (12), as rows 7's
    item, elems = 2, float(b * s * d * n)
    bnd, by, terms = scan_bound(
        2 * b * s * d * item + 4 * b * s * d + 2 * b * s * n * item
        + 4 * d * n + 4 * b * d * n, SS_FWD_OPS * elems, SS_FWD_SFU * elems,
        sm_clock_mhz(torch))
    r = dict(shape=list(SCAN_PADDED), padded_n=ss.padded_state_size(n),
             max_abs_err=err, grad_err_share=grad, bound_ms=bnd,
             bound_by=by, bound_terms=terms,
             ms=time_ms(torch, fwd, n=SCAN_PADDED_TIMED),
             fwd_bwd_ms=time_ms(torch, fwd_bwd, n=SCAN_PADDED_TIMED),
             plain_ms=time_ms(torch, lambda: ss.selective_scan_plain(
                 x, dt, a_log, bm, cm), n=3, warmup=1), library_ms=None)
    log(f"kernel {name}: y max_abs_err {err:.3e}, h_final and batch row 1 "
        f"alone bit for bit, gradients {grad:.2e} of their max; forward "
        f"{r['ms']:.4f} ms, forward + backward {r['fwd_bwd_ms']:.4f} ms, "
        f"plain {r['plain_ms']:.4f} ms, bound {bnd:.5f} ms ({by})")
    return r


# ----------------------------------------------------------------------
# phase 3, the f32 paths of kernels 2 and 3 (redesigned for Hopper)
# ----------------------------------------------------------------------
# kernel 2 in f32 at llama3-8b's heads (H 32 / KV 8, d 128) over phase 3's
# prefill chunk, and over a 32-query chunk at the end of a 2,048-token
# prompt (8 rows, smollm-135m's heads), timed from a cold L2
PREFILL_F32_D128 = (32, 8, 128)
PREFILL_F32_LONG = 2048


def long_prefill_case(torch, gen):
    """8 rows, each its own 256 pages of a 2,048-token prompt in a
    shuffled pool, querying its last 32 positions (2,016-2,047)."""
    b, c, nb = 8, 32, PREFILL_F32_LONG // PAGE
    shape = (b * nb, PAGE, KV, D)
    kp = torch.randn(shape, generator=gen, device="cuda")
    vp = torch.randn(shape, generator=gen, device="cuda")
    table = torch.randperm(b * nb, generator=gen, device="cuda").to(
        torch.int32).reshape(b, nb).contiguous()
    qpos = (PREFILL_F32_LONG - c + torch.arange(c, device="cuda"))[
        None].repeat(b, 1).to(torch.int32).contiguous()
    q = torch.randn((b, c, H, D), generator=gen, device="cuda")
    return q, kp, vp, table, qpos


def f32_kernel_kind(key: str) -> str:
    """The f32 kernel of kernels 2 and 3 a profiled kernel name is:
    "gate_up" or "down" (``swiglu_f32_gemm_kernel<true|false, ...>``),
    "prefill" (``chunked_prefill_f32_kernel``), else the name itself."""
    if "chunked_prefill_f32_kernel" in key:
        return "prefill"
    if "swiglu_f32_gemm_kernel" in key:
        tail = key.split("swiglu_f32_gemm_kernel", 1)[1]
        return "gate_up" if tail.startswith(("<true", "ILb1E")) else "down"
    return key


def f32_redesign_checks(torch) -> dict:
    """The f32 kernels 2 and 3: kernel 2 at ``PREFILL_F32_D128`` and over
    the long prompt (cold L2), each held, positions 0-7 checked bit for
    bit and timed by ``prefill_checks``; then one profiled window over
    an f32 ``fused_swiglu`` call, one call of each stage and one f32
    prefill call at phase 3's serving shapes: exactly one
    ``swiglu_f32_gemm_kernel`` a stage (gate_up twice, down twice), one
    ``chunked_prefill_f32_kernel``, no other kernel, and each wrapper's
    f32 count 1. Returns {"d128": result, "long": result, "profile":
    kernel counts}."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(28)
    h, kv, d = PREFILL_F32_D128
    out = {"d128": prefill_checks(
        torch, "float32", *prefill_case(torch, gen, torch.float32, h=h,
                                        kv=kv, d=d), spin=SHORT_SPIN)}
    flush = _l2_flush(torch)
    out["long"] = prefill_checks(
        torch, "float32", *long_prefill_case(torch, gen), spin=SHORT_SPIN,
        prompt_len=PREFILL_F32_LONG, flush=flush)
    for key, label in (("d128", f"H {h} / KV {kv}, d {d}, phase 3's chunk"),
                       ("long", f"H {H} / KV {KV}, d {D}, 8 rows x 32 "
                                f"queries at {PREFILL_F32_LONG - 32}-"
                                f"{PREFILL_F32_LONG - 1}, cold L2")):
        r = out[key]
        log(f"kernel chunked_prefill_attention [float32, {label}]: "
            f"max_abs_err {r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} "
            f"ms  bound {r['bound_ms']:.5f} ms ({r['bound_by']}); "
            "positions 0-7 bit-identical to an 8-position chunk")
    del flush
    x, wg, wu, wd = swiglu_case(torch, gen, torch.float32)
    hh = ops.swiglu_gate_up(x, wg, wu)
    q, kp, vp, table, qpos = prefill_case(torch, gen, torch.float32)

    def calls():
        ops.fused_swiglu(x, wg, wu, wd)
        ops.swiglu_gate_up(x, wg, wu)
        ops.swiglu_down(hh, wd)
        ops.chunked_prefill_attention(q, kp, vp, table, qpos,
                                      prompt_len=PROMPT)
    calls()
    torch.cuda.synchronize()
    _, events, _, launches = profiled(torch, calls)
    if not sum(e.count for e in events
               if MARKER_KERNEL in e.key) > HEAD_MARKERS:
        raise AssertionError("f32 profile: the profiler lost the end of "
                             "the window")
    kinds: dict = {}
    for e in events:
        if MARKER_KERNEL not in e.key and e.dev_us > 0:
            k = f32_kernel_kind(e.key)
            kinds[k] = kinds.get(k, 0) + e.count
    want = {"gate_up": 2, "down": 2, "prefill": 1}
    counted = {k: launches.f32[k] for k in (
        "fused_swiglu", "swiglu_gate_up", "swiglu_down",
        "chunked_prefill_attention")}
    if kinds != want or set(counted.values()) != {1}:
        raise AssertionError(
            f"f32 profile: an f32 fused_swiglu call, one call of each "
            f"stage and an f32 prefill call ran {kinds} (want {want}); "
            f"f32 launch counts {counted}")
    log("profile: an f32 fused_swiglu call = one swiglu_f32_gemm_kernel "
        "a stage (gate_up, down), each stage called alone = one, an f32 "
        "prefill call = one chunked_prefill_f32_kernel; no other kernel")
    out["profile"] = kinds
    return out


def check_swiglu_f32_plan() -> None:
    """``swiglu_f32_plan`` (the wrapper's mirror of the f32 stages' split)
    against the library's ``acar_swiglu_f32_plan`` at every K up to
    8,192 (every f32 d_model and d_ff phases 3-14 give the stages) and
    at 12,288-16,384."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_swiglu import swiglu_f32_plan
    lib = build.load()
    for k in (*range(1, 8193), 12288, 14336, 16384):
        for n in (1, 250, 4096):
            p = swiglu_f32_plan(k, n)
            want = (p.split, p.chunk, p.rows, p.gate_up_cols, p.down_cols,
                    p.k_step, p.gate_up_col_tiles, p.down_col_tiles) + tuple(
                        lo for lo, _ in p.ranges) + (k,)
            got = tuple(lib.acar_swiglu_f32_plan(k, n, f)
                        for f in range(9 + p.split))
            if got != want:
                raise AssertionError(f"swiglu_f32_plan({k}, {n}) = {want}, "
                                     f"the kernel's {got}")
    log("swiglu_f32_plan matches the f32 stage kernels' split at K in "
        "1..8,192 and 12,288-16,384: "
        + ", ".join(f"K {k}: {swiglu_f32_plan(k, 1).split} ranks of "
                    f"{swiglu_f32_plan(k, 1).chunk}"
                    for k in (64, 576, 1536, 4096)))


def check_projection_plan() -> None:
    """``projection_plan`` (the wrapper's mirror of the split) against
    the library's ``acar_projection_plan`` at every K up to 4,160 and
    the served widths, and the grid sizes the split promises at a
    decode's 8 rows: >= 128 CTAs at (4096, 4096), >= 64 at (4096, 1024)
    and the mesh's (4096, 512)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.projection import projection_plan
    lib = build.load()
    for k in (*range(1, 4161), 5120, 6144, 8192, 14336):
        for n in (1, 64, 513, 1024, 4096):
            p = projection_plan(k, n)
            want = (p.split, p.chunk, p.cols, p.rows_bf16, p.rows_f32,
                    p.col_tiles) + tuple(lo for lo, _ in p.ranges) + (k,)
            got = tuple(lib.acar_projection_plan(k, n, f)
                        for f in range(7 + p.split))
            if got != want:
                raise AssertionError(f"projection_plan({k}, {n}) = {want}, "
                                     f"the kernel's {got}")
    for k, n, least in ((4096, 4096, 128), (4096, 1024, 64),
                        (4096, 512, 64)):
        ctas = projection_plan(k, n).ctas(8, torch.bfloat16)
        if ctas < least:
            raise AssertionError(f"projection at (8, {k}, {n}) runs {ctas} "
                                 f"CTAs, fewer than {least}")
    log("projection_plan matches the kernel's split at K in 1..4,160 and "
        "5,120-14,336; bf16 at 8 rows: "
        f"{projection_plan(4096, 4096).ctas(8, torch.bfloat16)} CTAs at "
        f"(4096, 4096), "
        f"{projection_plan(4096, 1024).ctas(8, torch.bfloat16)} at "
        f"(4096, 1024), {projection_plan(4096, 512).ctas(8, torch.bfloat16)}"
        " at (4096, 512)")


# ----------------------------------------------------------------------
# phase 14: the serving mesh on one card
# ----------------------------------------------------------------------
# logical devices over the one card (launch.mesh.force_device_count):
# enough cells for data 4 and for (data 2, model 2)
MESH_DEVICES = 4
# (b): the probe llama3-8b, deepseek-7b and the probe's twin, 10 layers
MESH2D_FLEET = ("llama3-8b", "deepseek-7b", "llama3-8b-twin")
# (b) serves the first 8 of phase 5's 16 tasks: one controller runs
# every cell's host work in turn (a (2, 2) run spends about four times
# a single-device run's host time)
MESH2D_TASKS = 8
MESH_REDUCED_TASKS = 24
MESH_KERNELS = ("paged_decode_attention", "chunked_prefill_attention",
                "projection")
MESH_SHAPED = ("swiglu_gate_up", "paged_decode_attention",
               "chunked_prefill_attention", "paged_decode_attention_quant",
               "projection", "decode_attention")
# the kernels held to each column's local head counts
MESH_HEADED = ("paged_decode_attention", "chunked_prefill_attention")


class MeshShapes:
    """Records the shapes the model hands six wrappers while a block
    runs (the wrappers stay as they are; ``ops``' attributes are swapped
    for recorders that call them): kernel 3's gate_up stage's F, the
    projection's N, and the query and kv head counts of the decodes and
    the chunked prefill. Launch counts are untouched."""

    def __init__(self, ops):
        self.ops = ops
        self.seen = {k: set() for k in MESH_SHAPED}
        self._lock = __import__("threading").Lock()

    def _wrap(self, name, fn):
        def rec(*a, **kw):
            if name in ("swiglu_gate_up", "projection"):
                key = int(a[1].shape[1])
            elif name == "chunked_prefill_attention":
                key = (int(a[0].shape[2]), int(a[1].shape[2]))
            else:
                key = (int(a[0].shape[1]), int(a[1].shape[2]))
            with self._lock:
                self.seen[name].add(key)
            return fn(*a, **kw)
        return rec

    def __enter__(self):
        self.saved = {k: getattr(self.ops, k) for k in MESH_SHAPED}
        for k, fn in self.saved.items():
            setattr(self.ops, k, self._wrap(k, fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.ops, k, fn)


def column_widths(cfg, m: int) -> set:
    """N of each column-split projection of ``cfg`` on one of ``m``
    model columns: wq, wk / wv, w_gate / w_up, an untied lm_head."""
    hd = cfg.resolved_head_dim
    out = {cfg.num_heads * hd // m, cfg.num_kv_heads * hd // m,
           cfg.d_ff // m}
    if not cfg.tie_embeddings:
        out.add(cfg.vocab_size // m)
    return out


def mesh_serve(torch, label, probe, ensemble, tasks, route, *, shards,
               model=1, chunk=32, megastep=4, max_new=MAX_NEW):
    """``run_stepped`` over ``shards`` data shards (``model`` columns
    each), the launch counts set to 0 just before and read just after:
    every task retired and answered, no page leaked on any shard, rows
    placed on at least two shards. Returns (launches, result, wall,
    placements)."""
    from repro_torch.configs import ACARConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import BatchedACAREngine, MicroBatchPolicy
    eng = BatchedACAREngine(
        ACARConfig(probe_temperature=0.9, seed=0), probe, ensemble,
        max_new_tokens=max_new, route_fn=route, device="cuda")
    policy = MicroBatchPolicy(max_batch_size=8, max_batch_tokens=1 << 20)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res = eng.run_stepped(tasks, policy, chunk_tokens=chunk,
                          megastep=megastep, data_shards=shards,
                          model_shards=model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = ops.launch_counts()
    if (res.step.retired != len(tasks)
            or any(a is None for a in res.final_answers)):
        raise AssertionError(f"{label}: a task did not retire")
    if not eng._mesh_servers:
        raise AssertionError(f"{label}: no sharded server served the run")
    check_no_leaks(eng)
    placed = [int(res.metrics.get("acar_shard_placements_total",
                                  shard=str(k))) for k in range(shards)]
    if sum(placed) < len(tasks) or sum(1 for p in placed if p) < 2:
        raise AssertionError(f"{label}: placements {placed}")
    log(f"{label}: {len(tasks)} tasks, wall {wall:.3f} s, "
        f"{len(tasks) / wall:.3f} tasks/s, {res.step.ticks} ticks, "
        f"placements {placed}; launches {launches}")
    return launches, res, wall, placed


def mesh_single(torch, label, probe, ensemble, tasks, route, *, chunk=32,
                megastep=4, max_new=MAX_NEW):
    """The same stream on one device (``run_stepped`` without a mesh),
    the baseline a mesh run is held to."""
    from repro_torch.configs import ACARConfig
    from repro_torch.serving import BatchedACAREngine, MicroBatchPolicy
    eng = BatchedACAREngine(
        ACARConfig(probe_temperature=0.9, seed=0), probe, ensemble,
        max_new_tokens=max_new, route_fn=route, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = eng.run_stepped(tasks, MicroBatchPolicy(
        max_batch_size=8, max_batch_tokens=1 << 20), chunk_tokens=chunk,
        megastep=megastep)
    torch.cuda.synchronize()
    log(f"{label}: single device, {len(tasks)} tasks, wall "
        f"{time.perf_counter() - t:.3f} s, {res.step.ticks} ticks")
    return res


def check_mesh_heads(label, tasks, base, res, member_names) -> str:
    """The mesh run's sigma, modes, answers, member answers and probe
    texts equal the single-device run's, and so do their records' chain
    heads. Returns the head."""
    import tempfile
    if not _same_results(base, res):
        raise AssertionError(
            f"{label}: differs from the single-device run at "
            f"{first_mismatch(tasks, base, res)}")
    with tempfile.TemporaryDirectory(prefix="acar-mesh-") as d:
        heads = [chain_head("mesh", tasks, r, member_names,
                            Path(d) / f"{i}.jsonl")
                 for i, r in enumerate((base, res))]
    if heads[0] != heads[1]:
        raise AssertionError(f"{label}: chain head {heads[1]} is not the "
                             f"single-device run's {heads[0]}")
    log(f"{label}: results and chain head {heads[1]} equal the "
        "single-device run's")
    return heads[1]


def add_launches(total: dict, launches: dict) -> dict:
    """The two runs' launch counts added, their f32 counts too."""
    from repro_torch.kernels.ops import LaunchCounts
    f32 = dict(getattr(total, "f32", {}))
    for k, v in getattr(launches, "f32", {}).items():
        f32[k] = f32.get(k, 0) + v
    return LaunchCounts({k: total.get(k, 0) + v
                         for k, v in launches.items()}, f32)


def run_mesh_default_fleet(torch, probe, ensemble, tasks, route, base,
                           smi) -> dict:
    """Phase 14 (a), inside phase 11 while its default fleet (published
    widths, 10 layers) is on the card: ``run_stepped(data_shards=4)``
    over phase 5's stream and forced routes, the four shards logical
    devices on the one card, held to phase 11's single-device stepped
    run (``base``): equal results and chain head, rows on at least two
    shards, no page leaked on any shard, kernels 1, 2 and 3 launched.
    Returns the run's launch counts."""
    from repro_torch.launch.mesh import force_device_count
    force_device_count(MESH_DEVICES)
    t0 = time.perf_counter()
    launches, res, wall, placed = mesh_serve(
        torch, "mesh[(a) default fleet, data 4]", probe, ensemble, tasks,
        route, shards=4)
    check_path_launches("mesh[(a) default fleet, data 4]", launches,
                        MESH_KERNELS + ("fused_swiglu",))
    check_mesh_heads("mesh[(a) default fleet, data 4]", tasks, base, res,
                     [m.name for m in ensemble])
    log(f"mesh: (a) {time.perf_counter() - t0:.1f} s on {smi}")
    return launches


def reduced_mesh_fleets(torch):
    """The reduced f32 fleets of (c), seed-initialised on the card: the
    reference harness's ``mesh2d_zoo`` (probe, dense member, gather-MoE
    member, the probe's twin: heads, kv heads, d_ff and expert width
    divisible by 2) and ``hetero_zoo`` (an int8-KV probe, a Mamba
    member, a 16-token sliding-window member, the probe's int8 twin)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    from repro_torch.data import tokenizer as tok
    from repro_torch.models.params import init_params
    from repro_torch.serving import ZooModel

    base = get_config("smollm-135m", reduced=True).replace(
        vocab_size=tok.VOCAB_SIZE, dtype="float32", tie_embeddings=True)
    b2d = base.replace(num_heads=4, num_kv_heads=2, head_dim=16)
    moe = b2d.replace(family="moe", moe=MoEConfig(
        num_experts=4, top_k=2, d_ff_expert=256, impl="gather",
        first_moe_layer=0))
    mamba = get_config("falcon-mamba-7b", reduced=True).replace(
        vocab_size=tok.VOCAB_SIZE, dtype="float32", tie_embeddings=True)
    fleets = {}
    for name, cfgs in (
            ("mesh2d", [("m0", b2d), ("m1", b2d), ("m2-moe", moe)]),
            ("hetero", [("probe-q8", base.replace(kv_quant=True)),
                        ("m1-mamba", mamba),
                        ("m2-swa", base.replace(window=16))])):
        zoo = [ZooModel(n, c, init_params(c, i, device="cuda"))
               for i, (n, c) in enumerate(cfgs)]
        fleets[name] = (zoo[0], [zoo[1], zoo[2], ZooModel(
            "m3-probe", zoo[0].cfg, zoo[0].params)])
    return fleets


def mesh_logit_diff(torch, label, zm, rows=8, chunk=32) -> dict:
    """One prefill chunk and one decode tick of member ``zm`` on a
    (data 1, model 2) mesh against the single-device programs on the
    same inputs (the decode from the same logits and pages): the
    largest logit difference of each, which must be 0 (the
    column-parallel projections run the column-invariant projection
    kernel on one device and on each column alike, so the mesh computes
    the single-device bits), and the rows whose argmax agree."""
    from repro_torch.models.params import torch_dtype
    from repro_torch.sampling import prng
    from repro_torch.sampling import sampler as S
    from repro_torch.serving import ServingMesh
    cfg, m, page = zm.cfg, 2, 8
    nb = (chunk + MAX_NEW) // page
    kv = cfg.num_kv_heads
    rng = np.random.default_rng(14)
    tokens = rng.integers(3, cfg.vocab_size, size=(rows, chunk)).astype(
        np.int32)
    table = np.arange(rows * nb, dtype=np.int32).reshape(rows, nb)
    starts = np.zeros(rows, np.int32)
    shape = (cfg.num_layers, rows * nb, page, kv, cfg.resolved_head_dim)
    dt = torch_dtype(cfg)

    def cuda(a):
        return torch.from_numpy(a).cuda()

    pages = {k: torch.zeros(shape, dtype=dt, device="cuda")
             for k in ("k", "v")}
    lg, pages = S.prefill_chunk_paged(cfg, zm.params, cuda(tokens), pages,
                                      cuda(table), cuda(starts),
                                      prompt_len=chunk)
    smesh = ServingMesh(data=1, model=m)
    try:
        cells = smesh.place_params(cfg, zm.params)
        cpages = [{k: torch.zeros(shape[:3] + (kv // m,) + shape[4:],
                                  dtype=dt, device="cuda")
                   for k in ("k", "v")} for _ in range(m)]
        slg, _ = S.prefill_chunk_paged_sharded(
            cfg, cells, tokens[None], cpages, table[None], starts[None],
            prompt_len=chunk, mesh=smesh)
        # the decode tick from the single-device prefill's logits and
        # pages, each column holding its kv heads' slice of them
        cpages = [{k: pages[k][:, :, :, j * kv // m:(j + 1) * kv // m]
                   .contiguous() for k in ("k", "v")} for j in range(m)]
        keys = np.stack([prng.fold_in_np(prng.prng_key(0), i)
                         for i in range(rows)])
        pos = np.full(rows, chunk, np.int32)
        steps = np.zeros(rows, np.int32)
        done = np.zeros(rows, bool)
        kw = dict(n_ticks=1, cache_len=chunk + MAX_NEW, temperature=0.9,
                  eos_id=-1, pad_id=0)
        em, _, nl, _ = S.decode_megastep_rows(
            cfg, zm.params, lg, pages, cuda(table), cuda(pos),
            prng._as_keys(keys, "cuda"), cuda(steps), cuda(done), **kw)
        sem, _, snl, _ = S.decode_megastep_rows_sharded(
            cfg, cells, [lg], cpages, table[None], pos[None],
            prng._as_keys(keys).numpy()[None], steps[None], done[None],
            mesh=smesh, **kw)
        torch.cuda.synchronize()
    finally:
        smesh.close()
    out = {}
    for stage, a, b in (("prefill", slg[0], lg), ("decode", snl[0], nl)):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: bad mesh {stage} logits")
        out[f"{stage}_max_abs_diff"] = float((a.float() - b.float())
                                             .abs().max())
        out[f"{stage}_argmax_agree"] = int(
            (a.argmax(-1) == b.argmax(-1)).sum())
    if not torch.equal(sem[0].cpu(), em.cpu()):
        raise AssertionError(f"{label}: the decode tick sampled other "
                             "tokens from the same logits")
    for stage in ("prefill", "decode"):
        if out[f"{stage}_max_abs_diff"] != 0.0:
            raise AssertionError(
                f"{label}: the {stage} logits on (data 1, model 2) differ "
                f"from one device's by {out[f'{stage}_max_abs_diff']}")
    log(f"{label}: {zm.name} on (data 1, model 2) against one device, "
        f"{rows} rows: a {chunk}-token prefill chunk's logits max abs "
        f"diff {out['prefill_max_abs_diff']:.6g} (argmax agree "
        f"{out['prefill_argmax_agree']}/{rows}), one decode tick's "
        f"{out['decode_max_abs_diff']:.6g} ({out['decode_argmax_agree']}"
        f"/{rows})")
    del cells, cpages, slg, snl, pages
    return out


def run_mesh_phase(torch, smi: str, mesh_a: dict) -> dict:
    """Phase 14, the serving mesh on one card (phase 11 ran (a)): (b)
    a (data 2, model 2) mesh over ``MESH2D_FLEET`` at published widths,
    10 layers, bf16: held to the same fleet's single-device run (equal
    results and chain head), kernel 3 as its two stages at F/2 (no
    fused call), kernels 1 and 2 at each column's local head counts;
    peak memory printed; (c) the reduced f32 ``mesh2d`` fleet at (2, 2)
    and the reduced int8-KV ``hetero`` fleet at data 4, 24 tasks each,
    each held to its single-device run (kernel 3's f32 stages and
    kernel 5 on the mesh). Returns {"mesh": launch counts of (a), (b)
    and (c)}."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    tasks = long_prompt_tasks(16, prompt_chars=PROMPT)
    modes = forced_modes(len(tasks))

    def route(sig, indices):
        return modes[np.asarray(indices, np.int64)]

    total = add_launches({}, mesh_a)
    tasks = tasks[:MESH2D_TASKS]
    torch.cuda.reset_peak_memory_stats()
    probe, ensemble = fleet_models(torch, MESH2D_FLEET, FLEET_LAYERS)
    names = [m.name for m in ensemble]
    base = mesh_single(torch, "mesh[(b) 2 x 2]", probe, ensemble, tasks,
                       route)
    label = "mesh[(b) data 2 x model 2]"
    with MeshShapes(ops) as shapes:
        launches, res, wall, _ = mesh_serve(
            torch, label, probe, ensemble, tasks, route, shards=2, model=2)
    check_path_launches(label, launches, MESH_KERNELS + (
        "swiglu_gate_up", "swiglu_down"))
    widths = {m.cfg.d_ff // 2 for m in [probe] + ensemble}
    heads = {(m.cfg.num_heads // 2, m.cfg.num_kv_heads // 2)
             for m in [probe] + ensemble}
    if shapes.seen["swiglu_gate_up"] != widths:
        raise AssertionError(f"{label}: gate_up ran at F "
                             f"{shapes.seen['swiglu_gate_up']}, not {widths}")
    for k in MESH_HEADED:
        if shapes.seen[k] != heads:
            raise AssertionError(f"{label}: {k} ran at (q, kv) heads "
                                 f"{shapes.seen[k]}, not {heads}")
    # every column-split projection ran on a column's slice: wq, wk / wv,
    # the decode MLP's w_gate / w_up and the untied lm_head at N / 2
    cols = set().union(*(column_widths(zm.cfg, 2)
                         for zm in [probe] + ensemble))
    if shapes.seen["projection"] != cols:
        raise AssertionError(f"{label}: the projection ran at N "
                             f"{sorted(shapes.seen['projection'])}, not "
                             f"{sorted(cols)}")
    check_mesh_heads(label, tasks, base, res, names)
    mesh_logit_diff(torch, label, probe)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}: kernel 3 as two stages at F {sorted(widths)}, kernels "
        f"1 and 2 at (q, kv) heads {sorted(heads)}, the projection at N "
        f"{sorted(cols)}; peak {peak:.2f} GiB on {smi}")
    total = add_launches(total, launches)
    del probe, ensemble, base, res
    free_fleet(torch, "mesh (b)")
    log(f"mesh: (b) {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    red = reduced_mesh_fleets(torch)
    rtasks = long_prompt_tasks(MESH_REDUCED_TASKS, prompt_chars=24)
    rmodes = forced_modes(len(rtasks))

    def rroute(sig, indices):
        return rmodes[np.asarray(indices, np.int64)]

    for fleet, shards, model, need in (
            ("mesh2d", 2, 2, MESH_KERNELS + ("swiglu_gate_up",
                                             "swiglu_down")),
            ("hetero", 4, 1, ("paged_decode_attention_quant",
                              "fused_swiglu"))):
        probe, ensemble = red[fleet]
        label = f"mesh[(c) reduced {fleet}, data {shards} x model {model}]"
        knobs = dict(chunk=4 if fleet == "mesh2d" else 8, megastep=1,
                     max_new=6)
        base = mesh_single(torch, label, probe, ensemble, rtasks, rroute,
                           **knobs)
        launches, res, _, _ = mesh_serve(
            torch, label, probe, ensemble, rtasks, rroute, shards=shards,
            model=model, **knobs)
        missing = [k for k in need if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: never launched {missing}")
        check_mesh_heads(label, rtasks, base, res,
                         [m.name for m in ensemble])
        total = add_launches(total, launches)
    del red
    free_fleet(torch, "mesh (c)")
    log(f"mesh: (c) {time.perf_counter() - t1:.1f} s; the phase's launches "
        f"{total}")
    return {"mesh": total}


def report_ptxas(build) -> None:
    """ptxas's registers, static shared memory and spills for each
    kernel of the tensor-core sources, the four split-KV decodes and
    the two scans (the build compiles with ``-Xptxas=-v``; the scans'
    dynamic shared memory is ``check_scan_plan``'s and
    ``check_rglru_plan``'s line). A kernel's name keeps its mangled
    template arguments (``13__nv_bfloat16`` shown as ``bf16``)."""
    import re

    def kernel_name(line):
        # the mangled name's length-prefixed identifier ending in _kernel,
        # and its template arguments, where the template arguments end
        # the name (else None)
        for m in re.finditer(r"\d+", line):
            for i in range(len(m.group())):  # a hash's digits may lead
                n = int(m.group()[i:])
                name = line[m.end():m.end() + n]
                if (len(name) == n and name.endswith("_kernel")
                        and re.fullmatch(r"[a-z]\w*", name)):
                    args = re.match(r"I\w*?E(?=Ev)", line[m.end() + n:])
                    return name + (args.group() if args else "")
        return None
    for src in ("fused_swiglu.cu", "projection.cu",
                "chunked_prefill_attention.cu",
                "paged_decode_attention.cu", "decode_attention.cu",
                "paged_decode_attention_quant.cu", "decode_attention_quant.cu",
                "selective_scan.cu", "rglru_scan.cu"):
        name, spills = None, ""
        for line in build.log_path(src).read_text().splitlines():
            m = re.search(r"Compiling entry function '\w*?([a-z_]+_kernel)"
                          r"(I\w*?E(?=Ev))?", line)
            if m:
                # a name with digits (swiglu_f32_...) by its length prefix
                name = (kernel_name(line)
                        or m.group(1) + (m.group(2) or "")).replace(
                    "13__nv_bfloat16", "bf16")
            elif name and "spill" in line:
                spills = line.split(",", 1)[-1].strip()
            elif name and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                smem = re.search(r"(\d+) bytes smem", line)
                log(f"ptxas: {src} {name}: {regs} registers, "
                    f"{smem.group(1) if smem else 0} bytes static smem, "
                    f"{spills}")
                name = None


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    gpu_name = torch.cuda.get_device_name(0)
    log(f"device: {gpu_name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    report_ptxas(build)

    def phase_done(name):
        log(f"phase {name}: done {time.perf_counter() - t0:.1f} s after "
            "the build started")

    results = run_kernel_phase(torch)
    results.update(run_train_kernel_phase(torch))
    for name, r in mesh_stage_checks(torch).items():
        results[(name, "bfloat16")] = r
    results[("projection", "bfloat16")] = projection_checks(torch)
    check_projection_plan()
    f32_new = f32_redesign_checks(torch)
    check_swiglu_f32_plan()
    for name, r in gtile_checks(torch).items():
        results[(name, "bfloat16")]["g_tiles"] = r
    for name, r in head_width_checks(torch).items():
        results[(name, "bfloat16")]["head_widths"] = r
    results[("selective_scan", "bfloat16")]["padded_n"] = (
        padded_scan_checks(torch))
    phase_done("kernels")
    run_reference_phase(torch)
    run_wave_reference_phase(torch)
    run_moe_reference_phase(torch)
    run_frontend_reference_phase(torch)
    run_train_reference_phase(torch)
    phase_done("reference")
    cfg, params = full_width_params(torch)
    serve_cfg, serve_params = first_layers(cfg, params, SERVE_LAYERS)
    launches, served = run_serve_phase(torch, gpu_name, serve_cfg,
                                       serve_params)
    by_path = {"stepped": launches}
    phase_done("serve")
    by_path["faults"] = run_fault_phase(torch, smi.splitlines()[0],
                                        serve_cfg, serve_params, served)
    del serve_params
    phase_done("faults")
    cut_cfg, cut = first_layers(cfg, params, AUDIT_LAYERS)
    by_path.update(run_wave_phase(torch, gpu_name, cut_cfg, cut))
    phase_done("wave")
    trained = arithmetic_fleet(torch, cut_cfg, cut)
    by_path["audit"], audited = run_audit_phase(
        torch, smi.splitlines()[0], cut_cfg, trained)
    phase_done("audit")
    by_path.update(run_queued_phase(torch, smi.splitlines()[0], cut_cfg,
                                    trained, audited))
    phase_done("queued")
    del params, cut, trained
    torch.cuda.empty_cache()
    by_path.update(run_train_phase(torch, gpu_name))
    by_path["train_entry"] = run_train_entry_phase(torch)
    by_path.update(run_moe_train_phase(torch))
    by_path.update(run_frontend_train_phase(torch))
    phase_done("train")
    by_path.update(run_examples_phase(torch, smi.splitlines()[0]))
    phase_done("examples")
    by_path.update(run_fleet_phase(torch, smi.splitlines()[0]))
    phase_done("fleets")
    by_path.update(run_moe_phase(torch, smi.splitlines()[0]))
    phase_done("moe")
    by_path.update(run_frontend_phase(torch, smi.splitlines()[0]))
    phase_done("frontend")
    by_path.update(run_mesh_phase(torch, smi.splitlines()[0],
                                  by_path.pop("mesh")))
    phase_done("mesh")

    sources = {
        "paged_decode_attention": "src/repro/kernels/"
                                  "paged_decode_attention.py:115",
        "chunked_prefill_attention": "src/repro/kernels/"
                                     "chunked_prefill_attention.py:128",
        "fused_swiglu": "src/repro/kernels/fused_swiglu.py:61",
        "decode_attention": "src/repro/kernels/decode_attention.py:100",
        "paged_decode_attention_quant": "src/repro/kernels/"
                                        "paged_decode_attention_quant.py:135",
        "decode_attention_quant": "src/repro/kernels/"
                                  "decode_attention_quant.py:92",
        "selective_scan": "src/repro/kernels/selective_scan.py:76",
        "selective_scan_bwd": "src/repro/kernels/selective_scan.py:76",
        "rglru_scan": "src/repro/kernels/rglru_scan.py:58",
        "rglru_scan_bwd": "src/repro/kernels/rglru_scan.py:58",
        # kernel 3's two stages called on their own: the serving mesh's
        # column-parallel MLPs gather h between them
        "swiglu_gate_up": "src/repro/kernels/fused_swiglu.py:61",
        "swiglu_down": "src/repro/kernels/fused_swiglu.py:61",
        # no TPU kernel: the products against column-split weights, which
        # the reference leaves to XLA (its q projection's einsum)
        "projection": "src/repro/models/attention.py:225",
    }
    kernels = []
    for name, replaces in sources.items():
        r = results[(name, "bfloat16")]
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/" + (
                "fused_swiglu.cu" if name.startswith("swiglu_")
                else f"{name.removesuffix('_bwd')}.cu"),
            "replaces": replaces,
            "launches": sum(c.get(name, 0) for c in by_path.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": "bfloat16",
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()}}
        if name.endswith("_bwd"):
            entry["note"] = (
                "the backward of the kernel it names; no TPU counterpart: "
                "jax 0.9.0 cannot reverse-differentiate pallas_call")
            entry["grad_err_share"] = r["grad_err_share"]
        if name.startswith(("selective_scan", "rglru_scan")):
            entry["library_note"] = SCAN_LIBRARY_NOTE
        if name.startswith("rglru_scan"):
            # the model feeds the RG-LRU f32 a and u whatever its dtype
            f = results[(name, "float32")]
            entry["bitwise"] = r["bitwise"]
            entry["f32"] = {k: f[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "bitwise", "out_sha256")}
            entry["f32_note"] = "f32 is the dtype the model feeds the scan"
        elif name.endswith("_quant"):
            entry["library_note"] = (
                "no single PyTorch call computes attention over int8 "
                "codes with per-vector scales folded in")
        if "bound_terms" in r:
            entry["bound_terms_ms"] = r["bound_terms"]
            entry["sm_clock_mhz"] = r["sm_clock_mhz"]
        if name == "fused_swiglu":
            t = results[("fused_swiglu_train", "bfloat16")]
            entry["train_shape"] = dict(
                shape=list(SWIGLU_TRAIN), max_abs_err=t["max_abs_err"],
                grad_err_share=t["grad_err_share"], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"],
                gate_up_ms=t["gate_up_ms"], down_ms=t["down_ms"])
            entry["gate_up_ms"] = r["gate_up_ms"]
            entry["down_ms"] = r["down_ms"]
            entry["note"] = ("a bf16 call is two tensor-core kernels, "
                             "gate_up then down; ms is the pair's")
        if "long_shape" in r:
            entry["long_shape"] = r["long_shape"]
        if "audit_shape" in r:
            entry["audit_shape"] = r["audit_shape"]
        if "d128" in r:
            entry["head_dim_128"] = r["d128"]
        if "fleet_shapes" in r:
            entry["fleet_shapes"] = r["fleet_shapes"]
        if "moe_shapes" in r:
            entry["moe_shapes"] = r["moe_shapes"]
        if "frontend_shape" in r:
            entry["frontend_shape"] = r["frontend_shape"]
        if "g_tiles" in r:
            entry["g_tiles"] = r["g_tiles"]
        if "head_widths" in r:
            entry["head_widths"] = r["head_widths"]
        if "padded_n" in r:
            entry["padded_n"] = r["padded_n"]
        if name == "projection":
            entry["note"] = (
                "no TPU counterpart: x @ w against every column-split "
                "weight (wq, wk, wv, the decode MLP's w_gate / w_up, an "
                "untied lm_head), column-invariant so that the mesh's "
                "columns compute the single-device bits; one launch a "
                "call, split-K over a cluster of 8 CTAs")
            entry["shape"] = {k: r[k] for k in ("rows", "k", "n")}
            entry["shapes"] = r["shapes"]
            entry["cublas_column_slice_max_diff"] = r[
                "cublas_column_slice_max_diff"]
        if name in ("chunked_prefill_attention", "fused_swiglu",
                    "swiglu_gate_up", "swiglu_down"):
            # f32 calls counted apart (kernels of their own)
            f32_paths = {p: getattr(c, "f32", {}).get(name, 0)
                         for p, c in by_path.items()}
            entry["launches_f32"] = sum(f32_paths.values())
            entry["launches_f32_by_path"] = f32_paths
        if name in ("chunked_prefill_attention", "fused_swiglu"):
            f = results[(name, "float32")]
            entry["f32"] = {k: f[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}
            if name == "fused_swiglu":
                t = results[("fused_swiglu_train", "float32")]
                entry["f32"]["train_shape"] = {k: t[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err", "grad_err_share")}
            else:
                entry["f32"]["d128"] = f32_new["d128"]
                entry["f32"]["long"] = f32_new["long"]
            entry["f32"]["profile"] = f32_new["profile"]
        if name.startswith("swiglu_"):
            entry["note"] = (
                "kernel 3's stage on its own, as tensor parallelism calls "
                "it: gate_up on a column's slice of Wg and Wu, down over "
                "the gathered h")
            entry["shape"] = {k: r[k] for k in (
                "tokens", "d_model", "d_ff") if k in r}
            if "f32" in r:
                entry["f32"] = r["f32"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels,
                      "launch_floor_ms": results[("launch_floor", "")]}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
