"""The serving engine one shard a process rank (``ShardedEngine(cfg,
ranks=group)``) against the reference's ``ShardedEngine`` on forced host
devices, tolerance 0.

One module-scoped run: the reference (``run_reference_subprocess``, 8 fake
devices) runs the scenarios of ``torch_engine_scenarios`` at S = 4 and
S = 2, beside a group of 4 ranks and a group of 2 over gloo on the CPU
(``tests/torch_engine_ranks_worker.py``), which run the same scenarios
through a third package, the port over ranks.  Rank 0 records the gathered
state, the answers and the stats; every other rank's answers and stats
equal rank 0's.  The 4-rank group also writes ``elastic_restore``'s
snapshot, which the 2-rank group and a one-card 8-shard engine here
restore; and each group runs one of the checks beside the scenarios
(observes in opposite orders; a lane reading through a reassign; a killed
rank).  Each group is killed after 120 s and the reference after 600 s,
and the test then fails naming the rank.  The ranked launcher is held to the
reference's lines at 4 shards.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.register_assert_rewrite("torch_engine_scenarios")

import torch_engine_scenarios as es  # noqa: E402
from repro_torch.core import mcprioq as tmc  # noqa: E402
from repro_torch.core.epoch import BackBufferLearner, EpochStore  # noqa: E402
from torch_parity import assert_same  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 120
# the reference compiles ~20 engines' programs: ~60 s alone, past 120 s
# beside the suite's other workers
REFERENCE_LIMIT_S = 600
TIMEOUT_S = 30          # the groups' collective timeout
SCENARIOS = ["cycle", "script", "mark_down",
             "checkpoint_restore_exact_with_replay",
             "reassign_preserves_answers", "route_retry_requeues_and_drains",
             "query_overflow_retry", "wal_enospc_poisons",
             "publish_fault_then_more_batches"]
WORLDS = (4, 2)
FAULTS = ("wal_enospc_poisons", "publish_fault_then_more_batches")
EXTRAS = {4: ["mixed_order"], 2: ["lane", "kill"]}
LANE_READS = 60


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait(procs, logs, names, deadline):
    """Wait for every process; the first that fails or outlives the
    deadline kills them all and fails the test, naming it."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [(name, c) for name, c in zip(names, codes) if c not in (None, 0)]
        if bad or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            who = (f"{bad[0][0]} exited with {bad[0][1]}" if bad else
                   f"{[n for n, c in zip(names, codes) if c is None]} ran past "
                   f"{LIMIT_S} s and were killed")
            pytest.fail(f"{who}:\n" + "\n".join(
                f"--- {n}\n{Path(log).read_text()[-3000:]}"
                for n, log in zip(names, logs)))
        if all(c == 0 for c in codes):
            return
        time.sleep(0.05)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference records, {world: [rank records]}, the one-card
    8-shard restore's record)``."""
    work = tmp_path_factory.mktemp("engine_ranks")
    items = [[name, s] for name in SCENARIOS for s in WORLDS]
    items += [["elastic_restore", 4], ["serve_lines", 4]]
    reference, failed = {}, []

    def run_reference():
        try:
            reference.update(es.run_reference_subprocess(
                work / "ref", items, timeout=REFERENCE_LIMIT_S,
                serial=FAULTS))
        except BaseException as exc:   # reported after the groups
            failed.append(exc)

    os.makedirs(work / "ref")
    thread = threading.Thread(target=run_reference)
    thread.start()
    elastic = {"dir": str(work / "elastic4"),
               "ready": str(work / "elastic.ready")}
    procs, logs, names = [], [], []
    for world in WORLDS:
        wdir = work / f"s{world}"
        os.makedirs(wdir)
        (wdir / "spec.json").write_text(json.dumps({
            "scenarios": SCENARIOS, "extras": EXTRAS[world],
            "elastic": dict(elastic, role="write" if world == 4 else "read"),
            "limit_s": LIMIT_S, "timeout_s": TIMEOUT_S}))
        for r in range(world):
            log = wdir / f"log{r}.txt"
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable,
                     str(ROOT / "tests" / "torch_engine_ranks_worker.py"),
                     str(r), str(world), str(wdir)], env=_env(), stdout=out,
                    stderr=subprocess.STDOUT, text=True))
            logs.append(log)
            names.append(f"rank {r} of the {world}-rank group")
    _wait(procs, logs, names, time.monotonic() + LIMIT_S)
    thread.join()
    if failed:
        raise failed[0]
    ranks = {world: [dict(np.load(work / f"s{world}" / f"rank{r}.npz"))
                     for r in range(world)] for world in WORLDS}
    rec8 = {}
    with es.one_torch_thread():
        es.SCENARIOS["elastic_restore"](es.port(), elastic["dir"], rec8,
                                        shards=4, targets=(8,), write=False)
    return reference, ranks, rec8


def _scenario(rec, name):
    head = f"{name}/"
    return {k[len(head):]: v for k, v in rec.items() if k.startswith(head)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_on_a_rank_group_equals_the_reference(runs, name, world):
    """Rank 0's gathered state, answers and stats equal the reference's at
    S = world; every other rank's answers and stats equal rank 0's."""
    reference, ranks, _ = runs
    got = [_scenario(rec, name) for rec in ranks[world]]
    assert_same(reference[(name, world)], got[0], f"{name} on {world} ranks")
    shared = {k: v for k, v in got[0].items() if "/state/" not in k}
    for r, rec in enumerate(got[1:], 1):
        assert_same(shared, rec, f"{name}: rank {r} vs rank 0")


def test_elastic_restore_across_groups_equals_the_reference(runs):
    """The 4-rank group's snapshot (and a WAL record after it) restored
    onto the 2-rank group and onto a one-card 8-shard engine: with the
    writer's own record, the reference's at tolerance 0."""
    reference, ranks, rec8 = runs
    want = reference[("elastic_restore", 4)]
    got = {**_scenario(ranks[4][0], "elastic_restore"),
           **_scenario(ranks[2][0], "elastic_restore"), **rec8}
    assert sorted(got) == sorted(want)
    assert_same(want, {k: got[k] for k in want}, "elastic 4 -> 2, 8")
    for world in WORLDS:
        mine = _scenario(ranks[world][0], "elastic_restore")
        for r, rec in enumerate(ranks[world][1:], 1):
            assert_same({k: v for k, v in mine.items() if "/state/" not in k},
                        _scenario(rec, "elastic_restore"),
                        f"elastic on {world} ranks: rank {r} vs rank 0")


def test_observes_in_opposite_orders_raise_the_named_error(runs):
    """Batch a then b on even ranks and b then a on odd ones: the first
    observe raises ``RankDisagreement`` naming the call on every rank and
    applies nothing; the next, the same on every rank, applies."""
    _, ranks, _ = runs
    for r, rec in enumerate(ranks[4]):
        msg = str(rec["mixed/error"])
        assert msg.startswith("RankDisagreement: ShardedEngine.observe"), msg
        assert "different calls or arguments" in msg and "rank 3" in msg
        assert int(rec["mixed/version_after"]) == 0, r
        assert int(rec["mixed/version_then"]) == 1, r


def test_a_lane_reading_through_a_reassign_never_mixes_maps(runs):
    """Every query a reader lane answered while the writer reassigned every
    bucket (rank 1's swap held back 0.3 s) equals the answers before it —
    a read routed under two maps would answer some srcs empty — and the
    ranks' disagreeing route epochs made reads run again."""
    _, ranks, _ = runs
    for r, rec in enumerate(ranks[2]):
        reads, before = rec["lane/reads"], rec["lane/before"][0]
        assert reads.shape[0] == LANE_READS, r
        for i, got in enumerate(reads):
            assert np.array_equal(got, before), (r, i)
        assert int(rec["lane/epoch"]) == 1
    assert sum(int(rec["lane/route_retries"]) for rec in ranks[2]) > 0


def test_a_killed_rank_fails_the_group_naming_the_call(runs):
    """Rank 1 of the 2-rank group ends its process: rank 0's next observe
    raises ``EngineWriteUnavailable`` naming it within the group's
    timeout plus 30 s, the engine is poisoned, and a query then raises
    ``RankGroupLost`` naming the query."""
    _, ranks, _ = runs
    rec = ranks[2][0]
    assert "ShardedEngine.observe" in str(rec["kill/observe"])
    assert "rank group is lost" in str(rec["kill/observe"])
    assert float(rec["kill/observe_s"]) < TIMEOUT_S + 30
    assert str(rec["kill/query"]).startswith("ShardedEngine.query")
    assert not bool(rec["kill/write_available"])


def test_the_ranked_launcher_prints_the_references_lines(runs):
    """``python -m repro_torch.launch.serve --num-shards 4 --ranks gloo
    --device cpu`` exits 0, and rank 0's lines equal the reference
    launcher's at 4 shards, timings masked."""
    reference, _, _ = runs
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--num-shards",
         "4", "--ranks", "gloo", "--device", "cpu"], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=LIMIT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    want = [str(x) for x in reference[("serve_lines", 4)]["lines"]]
    assert es.mask_timings(out.stdout) == want


def test_the_ranked_launcher_names_a_failing_rank(tmp_path):
    """A rank that fails (here: a snapshot directory that is a file) makes
    the launcher exit non-zero, naming the rank."""
    bad = tmp_path / "file"
    bad.write_text("")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--num-shards",
         "2", "--ranks", "gloo", "--device", "cpu", "--requests", "1",
         "--snapshot-dir", str(bad)], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=LIMIT_S)
    assert out.returncode != 0
    assert "rank 0" in out.stderr, out.stderr[-3000:]


def test_a_lane_holds_its_version_until_it_releases():
    """The host half of the learner's lane rule: a version pinned by
    ``acquire_lane`` is not written until the lane releases it (on the CPU
    there is no stream to wait on, and ``acquire_lane`` is ``acquire``)."""
    cfg = tmc.MCConfig(num_rows=16, capacity=4)
    store = EpochStore(tmc.init(cfg, device="cpu"))
    learner = BackBufferLearner(store)
    src = torch.arange(4, dtype=torch.int32)

    def step(back, *, dirty, table_dirty):
        tmc.update_batch_(back, src, src, None, None, cfg=cfg, dirty=dirty,
                          table_dirty=table_dirty)
        return back

    snap = learner.acquire_lane()
    learner.write(step)            # the back: no reader
    writer = threading.Thread(target=learner.write, args=(step,))
    writer.start()                 # into the lane's version: waits
    writer.join(0.3)
    assert writer.is_alive()
    assert int(snap.state.n_rows) == 0
    store.release(snap)
    writer.join(10)
    assert not writer.is_alive() and store.version == 2


@pytest.mark.parametrize("world", [2, 8])
def test_an_engine_on_a_group_of_another_size_raises_naming_both(world):
    """``ShardedEngine(cfg, ranks=group)`` with ``num_shards != world``
    raises ``ValueError`` naming both, before any collective (the group
    here has no process group behind it)."""
    from repro_torch.sharding.ranks import RankGroup
    group = RankGroup(None, 0, world, torch.device("cpu"), "gloo")
    cfg = es.port().config(dict(num_rows=16, capacity=4), 4, 2.0)
    with pytest.raises(ValueError, match=f"world {world}.*num_shards=4"):
        es.port().engine_mod.ShardedEngine(cfg, ranks=group)
