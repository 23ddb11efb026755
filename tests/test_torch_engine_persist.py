"""The serving engine's durability, port against the reference, at
tolerance 0.

The engine cases of ``tests/test_persist.py`` (checkpoint / restore with
WAL replay, cadence snapshots, the watchdog's escalation, WAL GC, close
draining the async writers, a torn snapshot skipped, ``reassign``), each
written once in ``torch_engine_scenarios.py`` and run on both packages at
one shard: the reference test's claims hold on each, and every stacked
leaf, answer and ``stats_snapshot`` counter recorded is equal (the
multi-shard cases are in ``test_torch_engine_elastic.py``).  Added: engine snapshots and
WALs across the packages both ways (a route-retry queue, a down shard's
deferred writes and a record after the snapshot in them), and the serving
launcher's ``run_sharded`` at the reference's defaults.
"""

import os
import shutil

import pytest

pytest.register_assert_rewrite("torch_engine_scenarios")

import torch_engine_scenarios as es  # noqa: E402
from torch_parity import assert_same  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with es.one_torch_thread():
        yield

PERSIST_CASES = [
    "checkpoint_restore_exact_with_replay", "cadence_snapshots_background",
    "watchdog_escalation_checkpoints", "snapshot_truncates_wal",
    "async_gc_waits_and_close_drains", "restore_skips_torn_snapshot",
    "reassign_preserves_answers",
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


def _run(pkg, name, tmp):
    os.makedirs(tmp)
    rec = {}
    es.SCENARIOS[name](pkg, str(tmp), rec)
    return rec


@pytest.mark.parametrize("name", PERSIST_CASES)
def test_engine_persist_case_equals_the_reference(name, tmp_path):
    want = _run(es.reference(), name, tmp_path / "ref")
    got = _run(es.port(), name, tmp_path / "port")
    assert_same(want, got, name)


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_engine_snapshot_and_wal_cross_the_packages(writer, reader, tmp_path):
    """A directory one package's engine wrote (snapshot, ``meta`` with the
    health map, the retry queue and the ownership, and the WAL) restored by
    the other's engine, replayed, healed and continued, equals the writer's
    own package doing the same from a copy of it."""
    pkgs = {"reference": es.reference(), "port": es.port()}
    src = tmp_path / "written"
    os.makedirs(src)
    es.cross_write(pkgs[writer], str(src))
    records = {}
    for who in (writer, reader):
        tmp = tmp_path / who
        shutil.copytree(src, tmp)
        records[who] = {}
        es.cross_restore(pkgs[who], str(tmp), records[who])
    assert_same(records[writer], records[reader], f"{writer} -> {reader}")


def test_run_sharded_at_the_reference_defaults(capsys):
    """``launch/serve.py``'s ``run_sharded`` at ``main``'s defaults (one
    shard): the port's final stats, state and top-n equal the
    reference's."""
    recs = []
    for pkg, kw in ((es.reference(), {}), (es.port(), {"device": "cpu"})):
        eng = pkg.serve.run_sharded(1, 2.0, 4, 2048, 16, **kw)
        rec = {}
        es.top(pkg, eng, rec, "top")
        es.record(pkg, eng, rec, "end")
        recs.append(rec)
    out = capsys.readouterr().out
    assert out.count("4 requests, 8192 edges over 1 shards") == 2
    assert recs[0]["end/stats/updates"] == 5
    assert_same(*recs, "run_sharded")


def test_launcher_without_num_shards_raises_naming_the_lm_item():
    """The LM serving loop is not ported: ``main`` refuses it, naming the
    queue item, instead of falling back."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="queue A 8"):
        serve.main(["--requests", "1"])


def test_restore_keeps_the_engines_own_kernel_dispatch(tmp_path):
    """A snapshot records its writer's ``MCConfig``, the kernel dispatch
    included; an engine restoring it keeps its own dispatch (here the plain
    versions, ``impl="ref"``, after a writer on ``auto``), and the snapshot
    plus its WAL tail give the writer's state leaf for leaf."""
    import dataclasses

    import numpy as np

    from repro_torch import convert
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import sharded as sh
    from repro_torch.serve.engine import ShardedEngine, ShardedServeConfig

    def engine(impl):
        base = mc.MCConfig(num_rows=64, capacity=8, impl=impl)
        return ShardedEngine(ShardedServeConfig(
            sharded=sh.ShardedConfig(base=base, num_shards=2,
                                     bucket_factor=4.0),
            snapshot_dir=str(tmp_path / "snap"),
            wal_dir=str(tmp_path / "wal")), device="cpu")

    rng = np.random.default_rng(7)
    writer = engine("auto")
    for i in range(5):
        src = rng.integers(0, 48, 96).astype(np.int32)
        writer.observe(src, rng.integers(0, 20, 96).astype(np.int32))
        if i == 2:
            writer.checkpoint(sync=True)
    want = convert.sharded_state_to_numpy(writer.store.acquire().state)
    writer.close()
    reader = engine("ref")
    info = reader.restore()
    assert info["mode"] == "exact" and info["replayed"] == 2
    assert reader.cfg.sharded.base.impl == "ref"
    assert dataclasses.replace(reader.cfg.sharded.base, impl="auto") == \
        writer.cfg.sharded.base
    assert_same(want, convert.sharded_state_to_numpy(reader.store.acquire().state),
                "restored through the plain versions")
    reader.close()
