"""The port's fault layer (``repro_torch.faults``, ``repro_torch.runtime.
fault_tolerance``) and its WAL and snapshot failpoints, against the
reference's contracts.

Every test of ``tests/test_faults.py`` that builds no engine has a
counterpart here, on the port's modules: the registry, its triggers and env
arming, the retry ladder, the shard health map, and the WAL's failpoint
cases.  The snapshot failpoints, which the reference injects through its
engine, are injected here into the port's ``persist.snapshot`` calls.  The
catalog is the reference's, and the two registries arm independently.
"""

import errno
import json
import os

import numpy as np
import pytest

from repro import faults as jfaults
from repro_torch import faults
from repro_torch.core import mcprioq as tmc
from repro_torch.persist import snapshot as snapshot_io
from repro_torch.persist.wal import SegmentRotationError, WriteAheadLog
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.fault_tolerance import (RetryBudgetExceeded,
                                                 RetryPolicy, ShardHealth,
                                                 call_with_retry,
                                                 classify_io_error)

FAST = RetryPolicy(max_attempts=3, base_delay_s=1e-4, max_delay_s=1e-3)


@pytest.fixture(autouse=True)
def _clean_registry():
    faults.reset()
    faults.set_observer(None)
    yield
    faults.reset()
    faults.set_observer(None)
    jfaults.reset()


# ---------------------------------------------------------------------------
# the catalog and the registry's own state
# ---------------------------------------------------------------------------


def test_catalog_is_the_references():
    assert faults.FAILPOINT_CATALOG == jfaults.FAILPOINT_CATALOG
    assert list(faults.FAILPOINT_CATALOG) == list(jfaults.FAILPOINT_CATALOG)


def test_arming_one_registry_leaves_the_other_disarmed():
    faults.arm("wal.rotate", OSError(errno.EIO, "port"))
    jfaults.failpoint("wal.rotate")                  # reference: no-op
    assert jfaults.hits("wal.rotate") == 0 and jfaults.snapshot() == {}
    with pytest.raises(OSError):
        faults.failpoint("wal.rotate")
    faults.reset()
    jfaults.arm("wal.rotate", OSError(errno.EIO, "reference"))
    faults.failpoint("wal.rotate")                   # port: no-op
    assert faults.hits("wal.rotate") == 0 and faults.snapshot() == {}
    with pytest.raises(OSError):
        jfaults.failpoint("wal.rotate")


# ---------------------------------------------------------------------------
# registry semantics (tests/test_faults.py:115-193)
# ---------------------------------------------------------------------------


def test_registry_rejects_unknown_sites():
    with pytest.raises(KeyError):
        faults.arm("not.a.site", OSError())


def test_registry_triggers_nth_every_prob_count():
    log = []
    faults.arm("engine.apply", lambda ctx: log.append("nth"),
               trigger=("nth", 2))
    for _ in range(4):
        faults.failpoint("engine.apply")
    assert log == ["nth"]
    faults.reset()

    faults.arm("engine.apply", lambda ctx: log.append("every"),
               trigger=("every", 2))
    for _ in range(6):
        faults.failpoint("engine.apply")
    assert log.count("every") == 3
    faults.reset()

    faults.arm("engine.apply", lambda ctx: log.append("cap"), count=2)
    for _ in range(5):
        faults.failpoint("engine.apply")
    assert log.count("cap") == 2
    assert faults.fired("engine.apply") == 2
    assert faults.hits("engine.apply") == 5
    faults.reset()

    def fires(registry, seed):
        registry.reset()
        got = []
        registry.arm("engine.apply", lambda ctx: got.append(1),
                     trigger=("prob", 0.5, seed))
        for _ in range(32):
            registry.failpoint("engine.apply")
        registry.reset()
        return len(got)

    assert fires(faults, 7) == fires(faults, 7)
    assert 0 < fires(faults, 7) < 32
    # the same seeded stream as the reference's
    assert fires(faults, 7) == fires(jfaults, 7)


def test_registry_zero_cost_when_disarmed():
    faults.failpoint("engine.apply")
    assert faults.hits("engine.apply") == 0
    assert faults.snapshot() == {}


def test_registry_observer_sees_every_hit_before_actions():
    seen = []
    faults.set_observer(lambda name, ctx: seen.append((name, dict(ctx))))
    faults.failpoint("engine.apply", items=3)
    faults.arm("engine.apply", faults.FaultInjected("engine.apply"))
    with pytest.raises(faults.FaultInjected):
        faults.failpoint("engine.apply", items=4)
    assert [s[0] for s in seen] == ["engine.apply", "engine.apply"]
    assert seen[1][1] == {"items": 4}


def test_registry_env_arming_round_trip(monkeypatch):
    n = faults.arm_from_env(
        "wal.append.fsync=raise:28@nth:2;engine.apply=sleep:0")
    assert n == 2
    faults.failpoint("wal.append.fsync")
    with pytest.raises(faults.FaultInjected) as ei:
        faults.failpoint("wal.append.fsync")
    assert ei.value.errno == errno.ENOSPC
    faults.failpoint("engine.apply")
    with pytest.raises(ValueError):
        faults.arm_from_env("wal.rotate=explode")
    with pytest.raises(ValueError):
        faults.arm_from_env("wal.rotate")
    faults.reset()
    monkeypatch.setenv("MCQ_FAILPOINTS", "wal.rotate=raise:5@every:2")
    assert faults.arm_from_env() == 1
    faults.failpoint("wal.rotate")
    with pytest.raises(faults.FaultInjected):
        faults.failpoint("wal.rotate")


# ---------------------------------------------------------------------------
# retry ladder + health map units (tests/test_faults.py:196-296)
# ---------------------------------------------------------------------------


def test_retry_ladder_classification_and_budget():
    assert classify_io_error(OSError(errno.ENOSPC, "")) == "persistent"
    assert classify_io_error(OSError(errno.EIO, "")) == "transient"
    assert classify_io_error(RuntimeError()) == "transient"
    assert classify_io_error(ft.UnretryableIOError(errno.EIO, "")) == "persistent"

    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError(errno.EIO, "flake")
        return "ok"

    assert call_with_retry(flaky, policy=FAST, sleep=slept.append) == "ok"
    assert len(calls) == 3 and slept == list(FAST.delays())[:2]

    calls.clear()

    def full():
        calls.append(1)
        raise OSError(errno.ENOSPC, "disk full")

    with pytest.raises(OSError):
        call_with_retry(full, policy=FAST, sleep=lambda s: None)
    assert len(calls) == 1

    calls.clear()

    def always():
        calls.append(1)
        raise OSError(errno.EIO, "still broken")

    with pytest.raises(RetryBudgetExceeded) as ei:
        call_with_retry(always, policy=FAST, sleep=lambda s: None)
    assert len(calls) == FAST.max_attempts
    assert isinstance(ei.value.__cause__, OSError)

    a = list(RetryPolicy(max_attempts=5, seed=3).delays())
    b = list(RetryPolicy(max_attempts=5, seed=3).delays())
    assert a == b and len(a) == 4
    assert all(d <= RetryPolicy.max_delay_s for d in a)
    from repro.runtime.fault_tolerance import RetryPolicy as JRetryPolicy
    assert a == list(JRetryPolicy(max_attempts=5, seed=3).delays())


def test_retry_backoff_lands_in_the_metrics_histogram():
    from repro_torch.obs import metrics as obs
    reg = obs.Registry()
    with obs.armed():
        with pytest.raises(RetryBudgetExceeded):
            call_with_retry(lambda: (_ for _ in ()).throw(OSError(errno.EIO, "")),
                            policy=FAST, sleep=lambda s: None, metrics=reg)
    assert reg.snapshot()["histograms"]["retry.backoff"]["count"] == 2


def test_shard_dispatch_error_and_shard_from_exception():
    try:
        try:
            raise ft.ShardDispatchError(2)
        except ft.ShardDispatchError as exc:
            raise RetryBudgetExceeded("out") from exc
    except RetryBudgetExceeded as exc:
        assert ft.shard_from_exception(exc) == 2
    assert ft.shard_from_exception(RuntimeError("x")) is None


def test_shard_health_strikes_defer_and_heal():
    h = ShardHealth(4, strike_limit=2, deferred_cap=8)
    assert not h.record_failure(1)
    assert h.record_failure(1)
    assert h.down == frozenset({1}) and h.degraded
    assert list(h.healthy_mask()) == [True, False, True, True]
    h.record_failure(2)
    h.record_success(2)
    assert not h.record_failure(2)

    src = np.arange(5, dtype=np.int32)
    assert h.defer(1, src, src, src)
    assert not h.defer(1, src, src, src)
    assert h.stats() == {"shards_down": 1, "deferred_writes": 5}
    batches = h.heal(1)
    assert len(batches) == 1 and batches[0][0].size == 5
    assert h.stats() == {"shards_down": 0, "deferred_writes": 0}


def test_shard_health_dump_load_requeue_round_trip():
    h = ShardHealth(4, deferred_cap=64)
    h.mark_down(1)
    h.mark_down(3)
    a = np.arange(3, dtype=np.int32)
    assert h.defer(1, a, a + 1, None)
    assert h.defer(1, a + 10, a + 11, a * 0 + 2)
    assert h.defer(3, a, a, a)
    image = json.loads(json.dumps(h.dump()))

    h2 = ShardHealth(4, deferred_cap=64)
    h2.load(image)
    assert h2.down == frozenset({1, 3})
    assert h2.stats() == {"shards_down": 2, "deferred_writes": 9}
    b1 = h2.heal(1)
    assert len(b1) == 2
    np.testing.assert_array_equal(b1[0][0], a)
    assert b1[0][2] is None
    np.testing.assert_array_equal(b1[1][2], a * 0 + 2)

    h2.requeue(1, b1[1:])
    assert h2.stats()["deferred_writes"] == 6
    again = h2.heal(1)
    assert len(again) == 1
    np.testing.assert_array_equal(again[0][0], a + 10)
    # the image is the reference's: its ShardHealth loads it the same way
    from repro.runtime.fault_tolerance import ShardHealth as JShardHealth
    j = JShardHealth(4, deferred_cap=64)
    j.load(image)
    assert j.dump() == image and j.stats() == {"shards_down": 2,
                                               "deferred_writes": 9}


def test_watchdog_and_remesh_policies():
    fired = []
    dog = ft.StepWatchdog(ft.WatchdogConfig(deadline_s=1.0,
                                            max_consecutive_slow=2),
                          on_escalate=lambda: fired.append(1))
    assert [dog.observe(d) for d in (2.0, 0.5, 2.0, 2.0)] == [
        False, False, False, True]
    assert fired == [1] and [s for s, _ in dog.slow_steps] == [1, 3, 4]
    assert ft.plan_elastic_remesh(8, 3, 2) == (2, 2)
    with pytest.raises(RuntimeError):
        ft.plan_elastic_remesh(4, 3, 2)
    pol = ft.FailurePolicy()
    assert [pol.on_step_failure(n) for n in (0, 1, 2)] == [
        "retry", "retry", "restore"]


# ---------------------------------------------------------------------------
# WAL failpoints (tests/test_faults.py:299-430)
# ---------------------------------------------------------------------------


def test_wal_fsync_failure_truncates_then_same_seq(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="always")
    wal.append([1], [2])
    faults.arm("wal.append.fsync", OSError(errno.EIO, "flake"), count=1)
    with pytest.raises(OSError):
        wal.append([3], [4])
    assert wal.append([3], [4]) == 1
    recs = list(wal.replay())
    assert [r[0] for r in recs] == [0, 1]
    assert [int(r[1][0]) for r in recs] == [1, 3]
    wal.close()


def test_wal_append_torn_write_replay_stops_at_durable(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="never")
    wal.append([1], [1])

    def tear(ctx):
        ctx["fh"].write(ctx["record"][: len(ctx["record"]) // 2])
        raise OSError(errno.EIO, "died mid-write")

    faults.arm("wal.append.write", tear, count=1)
    with pytest.raises(OSError):
        wal.append([2], [2])
    ro = WriteAheadLog(str(tmp_path), fsync="never")
    assert [r[0] for r in ro.replay()] == [0]
    assert ro.next_seq == 1
    ro.append([2], [2])
    assert [r[0] for r in ro.replay()] == [0, 1]
    ro.close()
    wal.close()


def test_wal_append_enospc_abandons_segment_and_recovers(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="never")
    wal.append([1], [1])

    def nospace(ctx):
        ctx["fh"].close()
        raise OSError(errno.ENOSPC, "disk full")

    faults.arm("wal.append.write", nospace, count=1)
    with pytest.raises(OSError):
        wal.append([2], [2])
    assert wal.append([2], [2]) == 1
    segs = sorted(p for p in os.listdir(tmp_path) if p.endswith(".seg"))
    assert len(segs) == 2
    assert [r[0] for r in wal.replay()] == [0, 1]
    wal.close()


def test_wal_rotate_failure_policy_dependent(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "a"), segment_records=1,
                        fsync="always")
    faults.arm("wal.rotate", OSError(errno.EIO, "close failed"), count=1)
    assert wal.append([1], [1]) == 0
    assert wal.io_errors == 1
    assert wal.append([2], [2]) == 1
    assert [r[0] for r in wal.replay()] == [0, 1]
    wal.close()
    faults.reset()

    wal = WriteAheadLog(str(tmp_path / "r"), segment_records=1,
                        fsync="rotate")
    faults.arm("wal.rotate", OSError(errno.EIO, "fsync failed"), count=1)
    with pytest.raises(SegmentRotationError) as ei:
        wal.append([1], [1])
    assert classify_io_error(ei.value) == "persistent"
    assert wal.io_errors == 1
    assert wal.append([2], [2]) == 1
    assert [r[0] for r in wal.replay()] == [0, 1]
    wal.close()


def test_wal_close_failure_is_swallowed_and_counted(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="rotate")
    wal.append([1], [1])
    faults.arm("wal.rotate", OSError(errno.EIO, "close failed"), count=1)
    wal.close()
    assert wal.io_errors == 1
    assert [r[0] for r in WriteAheadLog(str(tmp_path)).replay()] == [0]


def test_wal_segment_open_transient_is_retried(tmp_path):
    wal = WriteAheadLog(str(tmp_path), fsync="never")
    faults.arm("wal.segment_open", OSError(errno.EIO, "transient"),
               count=1)
    with pytest.raises(OSError):
        wal.append([1], [1])
    assert wal.append([1], [1]) == 0
    assert [r[0] for r in wal.replay()] == [0]
    wal.close()


def test_wal_append_retried_by_the_ladder_logs_each_batch_once(tmp_path):
    """A transient write fault under ``call_with_retry`` (the engine's
    ladder): the scrubbed record is re-logged at the same seq, once."""
    wal = WriteAheadLog(str(tmp_path), fsync="always")
    faults.arm("wal.append.write", OSError(errno.EIO, "flake"), count=2)
    retries = []
    seq = call_with_retry(lambda: wal.append([5], [6]), policy=FAST,
                          sleep=lambda s: None,
                          on_retry=lambda k, e: retries.append(k))
    assert seq == 0 and retries == [1, 2]
    assert [(r[0], int(r[1][0])) for r in wal.replay()] == [(0, 5)]
    wal.close()


# ---------------------------------------------------------------------------
# snapshot failpoints, injected into the port's persist calls
# ---------------------------------------------------------------------------


def _chain(seed=0):
    cfg = tmc.MCConfig(num_rows=32, capacity=8)
    rng = np.random.default_rng(seed)
    state = tmc.update_batch(tmc.init(cfg, device="cpu"),
                             rng.integers(0, 40, 64), rng.integers(0, 40, 64),
                             cfg=cfg)
    return cfg, state


@pytest.mark.parametrize("site", ["snapshot.meta_write",
                                  "snapshot.arrays_write",
                                  "snapshot.manifest_commit"])
def test_snapshot_fault_is_exception_safe(tmp_path, site):
    """A sync snapshot failing at any stage raises, leaves no restorable
    half-written step, and the next snapshot commits."""
    cfg, state = _chain()
    d = str(tmp_path)
    snapshot_io.save_snapshot(state, d, 0, {"wal_seq": -1})
    faults.arm(site, OSError(errno.EIO, "io fault"))
    with pytest.raises(OSError):
        snapshot_io.save_snapshot(state, d, 7, {"wal_seq": 3})
    faults.reset()
    assert snapshot_io.latest_complete_step(d) == 0
    snapshot_io.save_snapshot(state, d, 8, {"wal_seq": 4})
    assert snapshot_io.latest_complete_step(d) == 8


@pytest.mark.parametrize("site", ["snapshot.io_thread",
                                  "snapshot.arrays_write",
                                  "snapshot.manifest_commit"])
def test_async_snapshot_worker_death_is_reported(tmp_path, site):
    """A fault on the async worker reaches ``on_error`` (never
    ``on_complete``), and no step is committed."""
    _, state = _chain()
    errors, done = [], []
    t = snapshot_io.save_snapshot_async(
        state, str(tmp_path), 3, {"wal_seq": 0},
        on_complete=lambda: done.append(1), on_error=errors.append)
    t.join(timeout=60)
    assert not t.is_alive()
    assert done == [1] and errors == []
    faults.arm(site, OSError(errno.EIO, "worker died"))
    t = snapshot_io.save_snapshot_async(
        state, str(tmp_path), 4, {"wal_seq": 1},
        on_complete=lambda: done.append(2), on_error=errors.append)
    t.join(timeout=60)
    assert not t.is_alive()
    assert done == [1] and len(errors) == 1
    assert isinstance(errors[0], OSError)
    assert snapshot_io.latest_complete_step(str(tmp_path)) == 3


def test_restore_read_fault_raises_cleanly(tmp_path):
    cfg, state = _chain()
    snapshot_io.save_snapshot(state, str(tmp_path), 0, {"wal_seq": 0})
    faults.arm("snapshot.restore_read", OSError(errno.EIO, "read fault"))
    with pytest.raises(OSError):
        snapshot_io.restore_snapshot(tmc.init(cfg, device="cpu"),
                                     str(tmp_path))
    faults.reset()
    restored, meta, step = snapshot_io.restore_snapshot(
        tmc.init(cfg, device="cpu"), str(tmp_path))
    assert step == 0 and meta == {"wal_seq": 0}
    assert bool((restored.slabs.cnt == state.slabs.cnt).all())
