"""The port's interleaving explorer (``repro_torch.analysis.explorer``)
over the port's ``ShardedEngine``: the counterpart of every test of
``tests/test_explorer.py``.

The contract: with the pre-fix bodies of the three historical races, the
explorer finds each violation and the violating schedule replays
deterministically; the current (fixed) code paths are exhaustively clean
under the same schedule space; a deadlock is a violation; the fake kernel
layer restores every seam it patched, the engine's writer included.
"""

import numpy as np
import pytest

from repro_torch.analysis import explorer as ex


RACES = sorted(s.name for s in ex.RACE_SCENARIOS)


# ---------------------------------------------------------------------------
# reverted fixes -> race re-found, deterministically
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RACES)
def test_reverted_race_is_found(name):
    result = ex.explore(ex.SCENARIOS[name], reverted=True)
    assert result.found, (
        f"{name}: no violation in {result.runs} schedules")
    first = result.violations[0]
    assert first.violations and first.trace


@pytest.mark.parametrize("name", RACES)
def test_violating_schedule_replays_deterministically(name):
    result = ex.explore(ex.SCENARIOS[name], reverted=True)
    assert result.found
    first = result.violations[0]
    replay_a = ex.replay(ex.SCENARIOS[name], reverted=True,
                         trace=first.trace)
    replay_b = ex.replay(ex.SCENARIOS[name], reverted=True,
                         trace=first.trace)
    assert replay_a.trace == first.trace, "replay diverged from the record"
    assert replay_a.violations == first.violations
    assert replay_b == replay_a, "two replays of one schedule disagreed"


def test_exploration_itself_is_deterministic():
    a = ex.explore(ex.SCENARIOS["stats_lost_update"], reverted=True)
    b = ex.explore(ex.SCENARIOS["stats_lost_update"], reverted=True)
    assert a.first_trace == b.first_trace
    assert a.runs == b.runs


def test_wal_double_replay_reproduces_the_double_apply():
    """Among the reverted recovery body's violations there is the literal
    double apply — marker 99 (the concurrent observe) replayed twice."""
    result = ex.explore(ex.SCENARIOS["wal_double_replay"], reverted=True,
                        stop_on_violation=False)
    assert result.exhausted
    doubled = [v for v in result.violations
               if any("exactly-once" in m and "99, 99" in m
                      for m in v.violations)]
    assert doubled, "the double-applied batch was never observed"


# ---------------------------------------------------------------------------
# HEAD is clean, exhaustively, under the same schedule space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RACES)
def test_head_is_clean_exhaustively(name):
    result = ex.explore(ex.SCENARIOS[name], reverted=False,
                        stop_on_violation=False)
    assert result.exhausted, (
        f"{name}: schedule space not drained ({result.runs} runs)")
    assert not result.found, "\n".join(
        "; ".join(v.violations) for v in result.violations)


def test_mixed_head_random_is_clean():
    result = ex.explore(ex.SCENARIOS["mixed_head"], reverted=False,
                        mode="random", random_runs=32, seed=7,
                        stop_on_violation=False)
    assert result.runs == 32
    assert not result.found, "\n".join(
        "; ".join(v.violations) for v in result.violations)


# ---------------------------------------------------------------------------
# scheduler mechanics
# ---------------------------------------------------------------------------


def test_deadlock_is_detected_as_a_violation():
    class DeadlockScenario(ex.Scenario):
        name = "deadlock_probe"

        def build(self, sched, reverted):
            a = ex.SchedLock(sched, "a")
            b = ex.SchedLock(sched, "b")

            def t1():
                with a:
                    with b:
                        pass

            def t2():
                with b:
                    with a:
                        pass

            from collections import OrderedDict
            threads = OrderedDict((("t1", t1), ("t2", t2)))
            return ex.ScenarioInstance(threads, lambda: [], lambda: None)

    result = ex.explore(DeadlockScenario(), reverted=False,
                        stop_on_violation=True)
    assert result.found
    assert any("deadlock" in m for m in result.violations[0].violations)


def test_sched_lock_blocks_until_released():
    """A SchedLock waiter is not runnable while the lock is held — the
    main thread never schedules it into a busy-wait."""
    events = []

    class HandoffScenario(ex.Scenario):
        name = "handoff_probe"

        def build(self, sched, reverted):
            lock = ex.SchedLock(sched, "only")

            def holder():
                with lock:
                    sched.yield_point("inside")  # offer a switch point
                    events.append("holder-critical")
                events.append("holder-exit")

            def waiter():
                with lock:
                    events.append("waiter-critical")

            from collections import OrderedDict
            threads = OrderedDict((("holder", holder), ("waiter", waiter)))
            return ex.ScenarioInstance(threads, lambda: [], lambda: None)

    result = ex.explore(HandoffScenario(), reverted=False,
                        stop_on_violation=False)
    assert result.exhausted and not result.found
    # in every explored schedule the critical sections never interleaved
    assert events.count("holder-critical") == result.runs
    assert events.count("waiter-critical") == result.runs


def test_fake_kernel_layer_restores_the_real_factories():
    from repro_torch.core import epoch
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import sharded as sh
    seams = [(sh, "init_sharded"), (sh, "make_update_fn_"),
             (sh, "make_maintain_fn_"), (sh, "make_query_fn"),
             (sh, "make_topn_fn"), (mc, "counter_stats"),
             (epoch, "BackBufferLearner")]
    real = [getattr(mod, name) for mod, name in seams]
    with ex.fake_kernel_layer():
        assert sh.make_update_fn_ is ex._fake_make_update_fn_
        assert epoch.BackBufferLearner is ex.CopyOnWriteWriter
        assert all(getattr(mod, name) is not r
                   for (mod, name), r in zip(seams, real))
    assert [getattr(mod, name) for mod, name in seams] == real


def test_instrumented_stats_update_routes_through_setitem():
    sched = ex.Scheduler()
    stats = ex.InstrumentedStats(sched, {"a": 0})
    stats.update({"a": 2, "b": 3})
    stats.update(c=4)
    assert dict(stats) == {"a": 2, "b": 3, "c": 4}


def test_smoke_cli_passes(tmp_path, capsys):
    junit = tmp_path / "explorer.xml"
    rc = ex.main(["--smoke", "--junit", str(junit)])
    assert rc == 0
    xml = junit.read_text()
    assert 'failures="0"' in xml
    for name in RACES:
        assert f"{name}:reverted" in xml
        assert f"{name}:head" in xml


def test_single_scenario_cli_exit_codes():
    assert ex.main(["--scenario", "stats_lost_update", "--reverted"]) == 1
    assert ex.main(["--scenario", "stats_lost_update"]) == 0


def test_fixed_restore_matches_engine_restore_semantics():
    """The fixed recovery body used for the HEAD variant really is the shipped
    shape: replay happens entirely inside one write-lock hold, the state
    published with a writer of its own (mirrors ShardedEngine.restore), so
    a trailing writer observes a consistent position and writes through
    the new writer."""
    sched = ex.Scheduler()
    with ex.fake_kernel_layer():
        import os
        import tempfile
        tmp = tempfile.mkdtemp(prefix="mcq-explorer-test-")
        try:
            eng = ex.build_engine(sched, wal_dir=os.path.join(tmp, "wal"))
            dst = np.array([0], np.int32)
            for marker in (4, 5):
                eng.observe(np.array([marker], np.int32), dst)
            writer = eng._writer
            replayed = ex._fixed_restore(eng)
            assert replayed == 2
            markers = [int(m) for m in eng.store._snap.state.markers]
            assert markers == [4, 5]
            assert eng._seq == 1
            assert eng._writer is not writer
            assert eng._writer.store is eng.store
            eng.observe(np.array([6], np.int32), dst)
            markers = [int(m) for m in eng.store._snap.state.markers]
            assert markers == [4, 5, 6] and eng._seq == 2
        finally:
            eng.wal.close()
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
