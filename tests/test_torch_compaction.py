"""The port's escalated-subset compaction plans and savings accounting
against the reference's (``repro/serving/compaction.py``), over random
mode vectors, fleet sizes and bucket caps."""
import dataclasses

import numpy as np
import pytest

from repro.serving import compaction as J
from repro_torch.serving import compaction as T


def _plan_dict(plan) -> dict:
    return {
        "batch": plan.batch, "escalated": plan.escalated_rows,
        "full_arena": plan.full_arena_rows,
        "members": [(m.member, m.rows.tolist(), m.bucket, m.n_rows,
                     m.occupancy, m.padded_rows().tolist())
                    for m in plan.members],
        "compacted": plan.compacted_decode_rows,
        "masked": plan.masked_decode_rows,
        "saved": plan.decode_rows_saved,
        "tokens": plan.decode_tokens(8),
        "tokens_saved": plan.decode_tokens_saved(8),
    }


@pytest.mark.parametrize("seed", range(6))
def test_plan_compaction_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        b = int(rng.integers(1, 40))
        modes = rng.choice(3, size=b, p=rng.dirichlet(np.ones(3)))
        n_members = int(rng.integers(1, 5))
        lite = int(rng.integers(0, n_members + 1))
        cap = None if rng.random() < 0.5 else int(rng.integers(1, 64))
        assert _plan_dict(T.plan_compaction(modes, n_members, lite, cap)) \
            == _plan_dict(J.plan_compaction(modes, n_members, lite, cap))


def test_bucket_size_matches_reference():
    for k in range(0, 70):
        for cap in (None, 1, 5, 8, 33):
            assert T.bucket_size(k, cap) == J.bucket_size(k, cap)


def test_compaction_stats_merge_and_reductions_match_reference():
    rng = np.random.default_rng(3)
    tot, jtot = T.CompactionStats(), J.CompactionStats()
    for _ in range(5):
        fields = dict(
            batch=int(rng.integers(1, 9)),
            escalated_rows=int(rng.integers(0, 9)),
            full_arena_rows=int(rng.integers(0, 9)),
            ensemble_decode_tokens=int(rng.integers(0, 99)),
            ensemble_decode_tokens_saved=int(rng.integers(0, 99)),
            probe_prefill_tokens=int(rng.integers(0, 99)),
            probe_prefill_tokens_saved=int(rng.integers(0, 99)),
            probe_prefill_flops_saved=float(rng.random()),
            bucket_rows=[int(rng.integers(9))],
            bucket_sizes=[int(rng.integers(9))])
        tot.merge(T.CompactionStats(**fields))
        jtot.merge(J.CompactionStats(**fields))
    assert dataclasses.asdict(tot) == dataclasses.asdict(jtot)
    assert tot.ensemble_decode_token_reduction == \
        jtot.ensemble_decode_token_reduction
    assert tot.probe_prefill_reduction == jtot.probe_prefill_reduction
    empty = T.CompactionStats()
    assert empty.ensemble_decode_token_reduction == 1.0
    assert empty.probe_prefill_reduction == 1.0


def test_dense_tile_slots_matches_reference():
    from repro.serving.kv_pool import dense_tile_slots as jslots
    from repro_torch.serving import dense_tile_slots as tslots
    for args in ((16, 3, 97, 8), (8, 1, 21, 6), (1, 5, 512, 64)):
        assert tslots(*args) == jslots(*args)
