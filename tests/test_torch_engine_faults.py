"""The serving engine's fault ladder, port against the reference, at
tolerance 0.

Every engine case of ``tests/test_faults.py`` (the multi-shard one,
``test_mark_shard_down_degrades_reads_and_defers_writes``, runs at two
shards in ``test_torch_sharded_engine.py``) and the engine cases of
``tests/test_obs.py``, each written once in ``torch_engine_scenarios.py``
and run on both packages at one shard: the reference test's own claims
hold on each, and everything recorded — every stacked state leaf, every
query and top-n answer, every ``stats_snapshot`` counter — is equal.  The
reference arms ``repro.faults``, the port ``repro_torch.faults``: the two
registries are independent.  Added: a publish fault followed by its retry,
on every third write of ten, equal to an engine that never faulted (the
port's back buffer is written before the fault and caught up by the
retry).  The LM ``Engine``'s ``engine.learn`` case is in
``test_torch_lm_engine.py``.
"""

import os

import pytest

pytest.register_assert_rewrite("torch_engine_scenarios")

import torch_engine_scenarios as es  # noqa: E402
from torch_parity import assert_same  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with es.one_torch_thread():
        yield

FAULT_CASES = [
    "wal_rotate_escalation", "wal_segment_open_transient",
    "wal_enospc_poisons", "restore_drains_poison_checkpoint",
    "wal_transient_retried", "apply_exhaustion_poisons",
    "apply_fault_without_wal", "publish_transient_retried",
    "publish_fault_then_more_batches", "checkpoint_fault_meta_write",
    "checkpoint_fault_arrays_write", "checkpoint_fault_manifest_commit",
    "async_worker_death_counted", "restore_read_fault",
    "cadence_snapshot_failure", "query_dispatch_degrades",
    "query_dispatch_transient", "topn_dispatch_degrades",
    "deferred_writes_survive_gc_and_crash", "restore_resets_health_map",
    "heal_fault_requeues_remainder", "dispatch_strikes_mark_down",
    "dispatch_success_breaks_streak", "route_overflow_prediction",
    "route_retry_requeues_and_drains", "route_retry_queue_survives_restore",
    "query_overflow_retry",
    # tests/test_obs.py's engine cases
    "telemetry_consistent_stats", "disarmed_still_serves_stats",
    "poison_incident_dump",
]


@pytest.fixture(scope="module", autouse=True)
def _reference_programs():
    undo = es.cached_reference_programs()
    yield
    undo()


@pytest.fixture(autouse=True)
def _clean_registries():
    es.reset_registries()
    yield
    es.reset_registries()


def run_both(name, tmp_path, **kw):
    """``name`` on the reference and on the port; the two records."""
    records = []
    for pkg in (es.reference(), es.port()):
        tmp = tmp_path / pkg.name
        os.makedirs(tmp)
        rec = {}
        es.SCENARIOS[name](pkg, str(tmp), rec, **kw)
        es.reset_registries()
        records.append(rec)
    return records


@pytest.mark.parametrize("name", FAULT_CASES)
def test_engine_fault_case_equals_the_reference(name, tmp_path):
    want, got = run_both(name, tmp_path)
    assert got, name
    assert_same(want, got, name)
