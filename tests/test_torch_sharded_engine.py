"""The port's serving engine (``repro_torch.serve.engine.ShardedEngine``)
against the reference's, at tolerance 0.

The counterpart of every engine test of ``tests/test_sharded_engine.py``
(the observe / query / top-n cycle, ragged query batches, the decay behind
the writer lock, concurrent observes that lose no update, the multi-shard
engine and the 8-device script with its under-provisioned buckets) and of
``test_faults.py``'s two-shard ``mark_shard_down`` case: each scenario is
written once in ``torch_engine_scenarios.py``, the reference test's claims
hold on both packages, and every stacked state leaf, query and top-n answer
and ``stats_snapshot`` counter recorded is equal.  One shard runs
in-process; the reference's 2- and 4-shard runs share ONE subprocess with
8 fake devices.  Port-only: a reader holding a snapshot across a publish
(the back buffer waits for it), the GPU default, and engines of 26 and 40
shards, more than one warp's lists in the top-n's merge.
"""

import threading
import time

import numpy as np
import pytest
import torch

pytest.register_assert_rewrite("torch_engine_scenarios")

import torch_engine_scenarios as es  # noqa: E402
from torch_parity import assert_same  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with es.one_torch_thread():
        yield

IN_PROCESS = [("cycle", 1), ("ragged", 1), ("decay", 1), ("concurrent", 1)]
SUBPROCESS = [("cycle", 2), ("cycle", 4), ("ragged", 2), ("ragged", 4),
              ("decay", 4), ("script", 2), ("script", 4), ("concurrent", 4),
              ("mark_down", 2)]


@pytest.fixture(scope="module")
def reference_records(tmp_path_factory):
    return es.run_reference_subprocess(tmp_path_factory.mktemp("ref"),
                                       SUBPROCESS)


@pytest.fixture(autouse=True)
def _clean_registries():
    es.reset_registries()
    yield
    es.reset_registries()


def _port(name, shards, tmp_path):
    rec = {}
    es.SCENARIOS[name](es.port(), str(tmp_path), rec, shards=shards)
    return rec


@pytest.mark.parametrize("name,shards", IN_PROCESS)
def test_engine_one_shard_equals_the_reference(name, shards, tmp_path):
    want = {}
    undo = es.cached_reference_programs()
    try:
        es.SCENARIOS[name](es.reference(), str(tmp_path), want, shards=shards)
    finally:
        undo()
    assert_same(want, _port(name, shards, tmp_path / "port"), name)


@pytest.mark.parametrize("name,shards", SUBPROCESS)
def test_engine_multi_shard_equals_the_reference(name, shards,
                                                 reference_records, tmp_path):
    assert_same(reference_records[(name, shards)],
                _port(name, shards, tmp_path), f"{name} at {shards} shards")


def _leaves(state):
    from repro_torch import convert
    return convert.state_to_numpy(state)


def test_reader_holds_a_snapshot_across_a_publish():
    """A reader pins version 1; the next write goes to the other state and
    publishes version 2 while the pinned state stays as it was; the write
    after it needs the pinned state back and waits for the reader's
    release.  The result equals an engine whose reader never waited."""
    pkg = es.port()
    eng = es.serve_engine(pkg, 4, decay_threshold=8)
    free = es.serve_engine(pkg, 4, decay_threshold=8)
    batches = [es.distinct_count_batch(seed=seed) for seed in range(3)]
    for e in (eng, free):
        e.observe(*batches[0])
    snap = eng._writer.acquire()
    held = _leaves(snap.state)
    eng.observe(*batches[1])
    assert eng.store.version == 2
    for k, v in _leaves(snap.state).items():
        assert np.array_equal(v, held[k]), k
    writer = threading.Thread(target=eng.observe, args=batches[2])
    writer.start()
    time.sleep(0.2)
    assert writer.is_alive() and eng.store.version == 2
    eng.store.release(snap)
    writer.join(timeout=30)
    assert not writer.is_alive() and eng.store.version == 3
    for b in batches[1:]:
        free.observe(*b)
    assert_same(pkg.state(free), pkg.state(eng), "held reader")
    assert eng.stats_snapshot() == free.stats_snapshot()


def test_engine_defaults_to_the_gpu_and_raises_without_one():
    pkg = es.port()
    cfg = pkg.config(dict(num_rows=16, capacity=4), 2, 2.0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pkg.engine_mod.ShardedEngine(cfg)


def _host_topn(state, n):
    """The global top-n by the plain definition: every shard's live edges in
    (shard, row, priority position) order, ``cnt / max(tot, 1)``, a stable
    descending sort, the first n, labelled with their src."""
    leaves = _leaves(state)
    cnt, dst, order = (leaves[f"slabs.{k}"] for k in ("cnt", "dst", "order"))
    tot = leaves["slabs.tot"]
    s, rows, _ = cnt.shape
    c_ord = np.take_along_axis(cnt, order, 2)
    d_ord = np.take_along_axis(dst, order, 2)
    prob = np.where(c_ord > 0, c_ord.astype(np.float32)
                    / np.maximum(tot, 1).astype(np.float32)[..., None], 0.0)
    keep = np.argsort(-prob.reshape(-1), kind="stable")[:n]
    shard, row = np.unravel_index(keep, prob.shape)[:2]
    src_of_row = np.full((s, rows), -1, np.int64)
    keys, vals = leaves["src_table.keys"], leaves["src_table.vals"]
    for i in range(s):
        ok = (keys[i] >= 0) & (vals[i] >= 0)
        src_of_row[i, vals[i][ok]] = keys[i][ok]
    p = prob.reshape(-1)[keep].astype(np.float32)
    live = p > 0
    return (np.where(live, src_of_row[shard, row], -1),
            np.where(live, d_ord.reshape(-1)[keep], -1), np.where(live, p, 0.0))


def test_engine_refuses_more_shards_than_one_catch_up_launch_takes():
    """The stacked catch-up once copied every shard's ten scalars with one
    block of the copy kernel, and the engine refused more than 25 shards;
    the kernel now copies them with a grid-stride loop and the top-n merges
    more than 32 lists in rounds, so nothing refuses S.  At 26 and 40
    shards the engine serves: every stacked leaf and a routed query equal
    an engine-free oracle (the same batches through ``sh.update_`` +
    ``sh.maintain_``), and ``topn(16)`` equals a stable host sort of every
    shard's live edges."""
    pkg = es.port()
    sh = pkg.sh
    base = dict(num_rows=16, capacity=4, sort_passes=4)
    rng = np.random.default_rng(26)
    for shards in (26, 40):
        cfg = pkg.config(base, shards, 4.0, decay_threshold=24)
        eng = pkg.engine(cfg)
        oracle = sh.init_sharded(cfg.sharded, device="cpu")
        for _ in range(8):
            src = rng.integers(0, 3 * shards, 16 * shards).astype(np.int32)
            dst = rng.integers(0, 12, src.size).astype(np.int32)
            eng.observe(src, dst)
            w = torch.ones(src.size, dtype=torch.int32)
            sh.update_(oracle, torch.from_numpy(src), torch.from_numpy(dst),
                       w, scfg=cfg.sharded)
            sh.maintain_(oracle, scfg=cfg.sharded, total_threshold=24)
        assert_same(_leaves(oracle), pkg.state(eng), f"{shards} shards")
        stats = pkg.mc.counter_stats(oracle)
        assert stats["decay_steps"] > 0 and stats["evictions"] > 0, stats
        q = np.arange(-1, 4 * shards - 1, dtype=np.int32)   # S | len(q)
        assert_same([pkg.host(x) for x in sh.query(
            oracle, torch.from_numpy(q), 0.9, 16, scfg=cfg.sharded)[:3]],
            [pkg.host(x) for x in eng.query(q)], f"query at {shards} shards")
        got = [pkg.host(x) for x in eng.topn(16)]
        snap = eng.store.acquire()
        try:
            assert_same(_host_topn(snap.state, 16), got, f"top-16 at {shards}")
        finally:
            eng.store.release(snap)
        assert got[2][0] > 0 and np.all(np.diff(got[2]) <= 0)
        eng.close()
