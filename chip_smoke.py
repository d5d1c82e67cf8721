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
3. kernels — call each kernel's wrapper on the card at the shapes the
   serving path gives it, hold the result against its plain PyTorch
   version on the same inputs (float32 and bfloat16), and time kernel,
   plain version and one PyTorch library call as a yardstick;
4. reference — a reduced float32 model's chunked prefill and decode
   step on the card agree with the same call on the CPU, where every
   kernel runs its plain version;
5. serve — the stepped ACAR engine serves 16 long-prompt tasks through
   a full-width smollm-135m fleet (bf16, seed-initialised weights): every
   task retires, all three kernels launch during the run, no page leaks
   outside the prefix cache, and a second run reproduces sigma, modes
   and answers.

It prints one JSON line describing the kernels, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import os

# cuBLAS is deterministic only with a fixed workspace; set before CUDA
# initialises
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, n: int = TIMED_LAUNCHES) -> float:
    """Median device time of ``fn`` over ``n`` calls, by CUDA events.
    A spin kernel holds the stream while the host queues all ``n``
    calls, so each event pair brackets the device work of one call and
    not the host's launch overhead."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in ev:
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


def prefill_case(torch, gen, dtype):
    """Prefill chunk of 32 tokens for a bucket of 8 rows at different
    depths of a 97-token prompt (13 pages), the last two rows pad rows
    on scratch pages."""
    b, c, nb = 8, 32, -(-PROMPT // PAGE)
    n_pages = b * nb + nb
    k_pages, v_pages = _pages(torch, gen, n_pages, dtype)
    perm = torch.randperm(n_pages - nb, generator=gen, device="cuda")
    table = perm[:b * nb].reshape(b, nb).to(torch.int32)
    starts = torch.tensor([0, 32, 64, 0, 32, 64, 64, 64], device="cuda")
    table[6:] = torch.arange(n_pages - nb, n_pages, device="cuda")
    qpos = (starts[:, None] + torch.arange(c, device="cuda")[None]).to(
        torch.int32)
    q = torch.randn((b, c, H, D), generator=gen, device="cuda").to(dtype)
    return q, k_pages, v_pages, table.contiguous(), qpos


def swiglu_case(torch, gen, dtype):
    """The prefill MLP of a 32-token chunk over a bucket of 8 rows."""
    t, d, f = 256, 576, 1536
    x = (torch.randn((t, d), generator=gen, device="cuda") * 0.5).to(dtype)
    ws = [(torch.randn(s, generator=gen, device="cuda") * 0.05).to(dtype)
          for s in ((d, f), (d, f), (f, d))]
    return (x, *ws)


def _gather(torch, pages, table):
    b, nb = table.shape
    return pages[table.long()].reshape(b, nb * PAGE, KV, D)


def run_kernel_phase(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention_plain)
    from repro_torch.kernels.fused_swiglu import fused_swiglu_plain
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        item = torch.tensor([], dtype=dtype).element_size()

        # -- paged decode --------------------------------------------
        q, kp, vp, table, lengths = decode_case(torch, gen, dtype)
        got = ops.paged_decode_attention(q, kp, vp, table, lengths)
        want = paged_decode_attention_plain(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        err = check_close(f"paged_decode_attention[{dname}]", got, want,
                          TOL[("attention", dname)])
        ms = time_ms(torch, lambda: ops.paged_decode_attention(
            q, kp, vp, table, lengths))
        plain = time_ms(torch, lambda: paged_decode_attention_plain(
            q, kp, vp, table, lengths))
        s = table.shape[1] * PAGE
        kc = _gather(torch, kp, table).repeat_interleave(H // KV, 2)
        vc = _gather(torch, vp, table).repeat_interleave(H // KV, 2)
        kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
        mask = (torch.arange(s, device="cuda")[None]
                < lengths[:, None])[:, None, None]
        q4 = q[:, :, None]
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask))
        n_keys = int(lengths.sum())
        bytes_moved = (2 * q.numel() * item + 2 * n_keys * KV * D * item
                       + 4 * (table.numel() + lengths.numel()))
        flops = 4.0 * H * D * n_keys
        bnd, by = bound_ms(bytes_moved, flops, dname)
        results[("paged_decode_attention", dname)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=lib)

        # -- chunked prefill -----------------------------------------
        q, kp, vp, table, qpos = prefill_case(torch, gen, dtype)
        got = ops.chunked_prefill_attention(q, kp, vp, table, qpos,
                                            prompt_len=PROMPT)
        want = chunked_prefill_attention_plain(q, kp, vp, table, qpos,
                                               prompt_len=PROMPT)
        torch.cuda.synchronize()
        err = check_close(f"chunked_prefill_attention[{dname}]", got,
                          want, TOL[("attention", dname)])
        ms = time_ms(torch, lambda: ops.chunked_prefill_attention(
            q, kp, vp, table, qpos, prompt_len=PROMPT))
        plain = time_ms(torch, lambda: chunked_prefill_attention_plain(
            q, kp, vp, table, qpos, prompt_len=PROMPT))
        kc = _gather(torch, kp, table)[:, :PROMPT]
        vc = _gather(torch, vp, table)[:, :PROMPT]
        kc = kc.repeat_interleave(H // KV, 2).transpose(1, 2)
        vc = vc.repeat_interleave(H // KV, 2).transpose(1, 2)
        mask = (qpos[:, :, None] >= torch.arange(PROMPT, device="cuda")
                [None, None])[:, None]
        q4 = q.transpose(1, 2)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask))
        # keys each row needs: up to its last query position
        keys_row = (qpos.max(dim=1).values + 1).clamp(max=PROMPT)
        n_keys = int(keys_row.sum())
        bytes_moved = (2 * q.numel() * item + 2 * n_keys * KV * D * item
                       + 4 * (table.numel() + qpos.numel()))
        flops = 4.0 * H * D * float((qpos + 1).sum())
        bnd, by = bound_ms(bytes_moved, flops, dname)
        results[("chunked_prefill_attention", dname)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=lib)

        # -- fused swiglu --------------------------------------------
        x, wg, wu, wd = swiglu_case(torch, gen, dtype)
        got = ops.fused_swiglu(x, wg, wu, wd)
        want = fused_swiglu_plain(x, wg, wu, wd)
        torch.cuda.synchronize()
        err = check_close(f"fused_swiglu[{dname}]", got, want,
                          TOL[("swiglu", dname)])
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
            bound_by=by, library_ms=lib)

    for (name, dname), r in results.items():
        atol, rtol = TOL[("swiglu" if name == "fused_swiglu"
                          else "attention", dname)]
        log(f"kernel {name} [{dname}]: max_abs_err {r['max_abs_err']:.3e}"
            f" (atol {atol}, rtol {rtol})  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
            f"  library {r['library_ms']:.4f} ms  bound {r['bound_ms']:.5f}"
            f" ms ({r['bound_by']})")
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


def _to_device(tree, dev):
    return {k: _to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


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


def check_no_leaks(engine) -> None:
    """After a run only the scratch pages and the prefix cache's pages
    may still be referenced, each exactly once."""
    for srv in engine._kv_servers.values():
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


def report_profile(prof, wall: float, wall_profiled: float) -> None:
    """Device time by kernel over one serve run. ``wall`` is the
    unprofiled run's wall time: the device work is the same, so its
    busy share there is busy / wall."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e6
    n_kernels = sum(e.count for e in events if dev_us(e) > 0)
    log(f"profile: {n_kernels} device kernels, device busy {busy:.3f} s "
        f"= {100 * busy / wall:.1f}% of the unprofiled wall {wall:.3f} s "
        f"({100 * busy / wall_profiled:.1f}% of the profiled wall "
        f"{wall_profiled:.3f} s)")
    for e in events[:10]:
        if dev_us(e) <= 0:
            break
        log(f"profile:   {dev_us(e) / 1e3:10.2f} ms {e.count:8d} calls  "
            f"{e.key[:90]}")


def run_serve_phase(torch, gpu_name: str):
    from repro_torch.configs import ACARConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving import (
        BatchedACAREngine, MicroBatchPolicy, ZooModel)

    cfg = get_config("smollm-135m")
    t0 = time.perf_counter()
    p_probe = init_params(cfg, 0, device="cuda")
    p_m1 = init_params(cfg, 1, device="cuda")
    p_m2 = init_params(cfg, 2, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model}"
        f" heads {cfg.num_heads}/{cfg.num_kv_heads} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size} {cfg.dtype}: {count_params(p_probe)} params per "
        f"model, 3 models initialised in "
        f"{time.perf_counter() - t0:.2f} s")
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

    def serve():
        eng = BatchedACAREngine(
            ACARConfig(probe_temperature=0.9, seed=0), probe, ensemble,
            max_new_tokens=MAX_NEW, route_fn=route, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.run_stepped(tasks, policy, chunk_tokens=32, megastep=4)
        torch.cuda.synchronize()
        return eng, res, time.perf_counter() - t

    ops.reset_launch_counts()
    eng, res, wall = serve()
    launches = ops.launch_counts()
    log(f"serve: launches during the run {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"serve: {name} never launched")
    if res.step.retired != len(tasks) or any(
            a is None for a in res.final_answers):
        raise AssertionError("serve: not every task retired")
    check_no_leaks(eng)
    st = res.step
    log(f"serve: {len(tasks)} tasks on {gpu_name}: wall {wall:.3f} s, "
        f"{len(tasks) / wall:.2f} tasks/s, {st.decode_tokens} decode "
        f"tokens at {st.decode_tokens / wall:.1f} tokens/s, "
        f"{st.prefill_chunks} prefill chunks, {st.launches} launches, "
        f"{st.ticks} ticks, modes {np.bincount(res.modes, minlength=3)}")

    # the rerun, under the profiler: device busy time and the kernels
    # that take it
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng2, res2, wall2 = serve()
    report_profile(prof, wall, wall2)
    same = (np.array_equal(res.sigma, res2.sigma)
            and np.array_equal(res.modes, res2.modes)
            and res.final_answers == res2.final_answers
            and res.member_answers == res2.member_answers
            and res.probe_texts == res2.probe_texts)
    if not same:
        raise AssertionError("serve: a rerun changed sigma, modes or "
                             "answers")
    check_no_leaks(eng2)
    log(f"serve: rerun identical (sigma, modes, answers, probe texts); "
        f"rerun wall {wall2:.3f} s")
    return launches


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

    results = run_kernel_phase(torch)
    run_reference_phase(torch)
    launches = run_serve_phase(torch, gpu_name)

    sources = {
        "paged_decode_attention": "src/repro/kernels/"
                                  "paged_decode_attention.py:115",
        "chunked_prefill_attention": "src/repro/kernels/"
                                     "chunked_prefill_attention.py:128",
        "fused_swiglu": "src/repro/kernels/fused_swiglu.py:61",
    }
    kernels = []
    for name, replaces in sources.items():
        r = results[(name, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": "bfloat16"})
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
