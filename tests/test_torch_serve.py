"""The port's serving entry point (``repro_torch.launch.serve.serve``)
against the reference's (``repro.launch.serve.serve``) on the CPU: the
same 16 arithmetic tasks through the same int8-KV fleet (probe and twin
on int8 KV, two dense members), with the default sigma routing. The
report — accuracy, mode distribution, ensemble calls saved, mean sigma
and the compaction savings — must be equal, on the default wave path
(``run_batch``), through the admission queue (``scheduler=True``:
``run_queued``, with its micro-batch sizes), traced without the step
loop (``run_queued`` with a span file and a lineage walk) and on the
step-level loop."""
import pytest

from _torch_port import one_torch_thread, quant_fleets, torch_task
from repro.configs.acar import ACARConfig as JACARConfig
from repro.data.tasks import arithmetic_suite
from repro.launch import serve as jserve
from repro_torch.configs import ACARConfig
from repro_torch.launch import serve as tserve


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def fleets():
    return quant_fleets()


def _serve_both(fleets, ref_kw=None, port_kw=None, **kw):
    (jprobe, jens), (tprobe, tens), _ = fleets
    tasks = arithmetic_suite(16, seed=99)
    acfg = dict(probe_temperature=0.9, seed=0)
    want = jserve.serve(tasks, jprobe, jens, JACARConfig(**acfg),
                        verbose=False, **kw, **(ref_kw or {}))
    got = tserve.serve([torch_task(t) for t in tasks], tprobe, tens,
                       ACARConfig(**acfg), verbose=False, device="cpu",
                       **kw, **(port_kw or {}))
    for report in (want, got):
        del report["wall_ms"]
    return got, want


def test_serve_wave_report_matches_reference(fleets):
    got, want = _serve_both(fleets)
    assert got == want
    # the default path is the wave, with its compaction report
    assert "ensemble_decode_tokens" in got and "batch_sizes" not in got
    assert sum(got["mode_distribution"].values()) == 16


def test_serve_step_loop_report_matches_reference(fleets):
    got, want = _serve_both(fleets, step_loop=True, batch_size=4,
                            megastep=2)
    assert got == want
    assert "batch_sizes" in got


def test_serve_scheduler_report_matches_reference(fleets):
    got, want = _serve_both(fleets, scheduler=True, batch_size=8)
    assert got == want
    assert got["batch_sizes"] == [8, 8]


def test_serve_traced_queued_report_matches_reference(fleets, tmp_path):
    """A traced stream without the step loop goes through
    ``run_queued``: equal reports, span heads and lineage; the port's
    span file verifies."""
    from repro_torch.teamllm.prov import verify_span_file
    tasks = arithmetic_suite(16, seed=99)
    got, want = _serve_both(
        fleets, batch_size=8, lineage_task=tasks[3].task_id,
        ref_kw=dict(trace_path=str(tmp_path / "ref.jsonl")),
        port_kw=dict(trace_path=str(tmp_path / "spans.jsonl")))
    assert got == want
    assert got["batch_sizes"] == [8, 8]
    assert got["lineage_ok"] and got["lineage_verified"] > 0
    audit = verify_span_file(tmp_path / "spans.jsonl")
    assert audit["ok"] and audit["head"] == got["span_head"]


def test_serve_refuses_what_is_not_ported(fleets):
    _, (tprobe, tens), tasks = fleets
    # the sharded loop, and main's default fleet (recurrentgemma-2b)
    with pytest.raises(NotImplementedError):
        tserve.serve([torch_task(tasks[0])], tprobe, tens, ACARConfig(),
                     verbose=False, device="cpu", data_shards=2)
    with pytest.raises(NotImplementedError):
        tserve.main([])


def test_parse_member_matches_reference():
    from repro_torch.configs import get_config
    cfg = get_config("smollm-135m", reduced=True)
    for spec in ("smollm-135m", "smollm-135m:quant", "smollm-135m:swa16",
                 "smollm-135m:swa"):
        arch, variant = tserve.parse_member(spec)
        jarch, jvariant = jserve.parse_member(spec)
        assert arch == jarch
        got, want = variant(cfg), jvariant(cfg)
        assert (got.kv_quant, got.window) == (want.kv_quant, want.window)
    for bad in ("nope-1b", "smollm-135m:int4"):
        with pytest.raises(SystemExit):
            tserve.parse_member(bad)
