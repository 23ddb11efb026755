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
(the back buffer waits for it), the GPU default, and the learner's shard
limit.
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


def test_engine_refuses_more_shards_than_one_catch_up_launch_takes():
    """The stacked catch-up copies every shard's ten scalars in one block
    of the copy kernel: at most 25 shards."""
    pkg = es.port()
    pkg.engine(pkg.config(dict(num_rows=16, capacity=4), 25, 2.0))
    with pytest.raises(ValueError, match="at most 25 shards"):
        pkg.engine(pkg.config(dict(num_rows=16, capacity=4), 26, 2.0))
