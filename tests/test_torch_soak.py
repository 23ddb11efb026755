"""The port's crash soak (``repro_torch.chaos.soak``) on the CPU, against
the reference's stream and engine, at tolerance 0.

Four lives (``--device cpu`` workers) die by external SIGKILLs and by
self-kills inside ``wal.append.write`` and ``wal.append.fsync``; one more
life dies inside ``snapshot.arrays_write`` at its first snapshot; each
recovery is bit-exact against the soak's own replay oracle.  The recovered
state then equals the reference's ``ShardedEngine`` fed the same
deterministic stream (``tools/chaos/soak.py``'s ``batch_for`` and
``_build_engine``, in one reference subprocess), and ``batch_for`` gives
the reference's arrays.  A short telemetry life leaves a parseable
flight-recorder incident dump.
"""

import os

import numpy as np
import pytest

pytest.register_assert_rewrite("torch_engine_scenarios")

import torch_engine_scenarios as es  # noqa: E402
from repro_torch.chaos import soak  # noqa: E402
from torch_parity import assert_same  # noqa: E402

ROWS, BATCH, EVERY = 256, 128, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with es.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def soaked(tmp_path_factory):
    """Four soak lives, then a fifth killed at its first snapshot write; the
    workdir is kept for the tests below."""
    workdir = str(tmp_path_factory.mktemp("soak"))
    result = soak.run_soak(4, rows=ROWS, batch=BATCH, snapshot_every=EVERY,
                           workdir=workdir, device="cpu")
    proc = soak._spawn_worker(workdir, ROWS, BATCH, 0, EVERY,
                              "snapshot.arrays_write", 1, device="cpu")
    life = soak._run_life(proc, soak.MAX_STEPS_PER_LIFE)
    targeted = soak._verify_recovery(workdir, ROWS, BATCH, 0, device="cpu")
    return workdir, result, life, targeted


def test_every_life_recovers_bit_exact(soaked):
    _, result, life, (t_rec, durable, replayed, bad, t_oracle) = soaked
    assert result["ok"], result["rows"]
    kills = [r for r in result["rows"] if "kill_mode" in r]
    assert [r["kill_mode"] for r in kills] == [
        "sigkill", "wal.append.write", "sigkill", "wal.append.fsync"]
    assert all(r["bitexact"] for r in kills)
    assert [r["armed_death"] for r in kills] == [False, True, False, True]
    steps = [r["steps"] for r in kills]
    assert steps == sorted(steps) and steps[0] > 0
    for r in kills:
        assert r["start_s"] > 0 and r["engine_s"] > 0 and r["oracle_s"] > 0
    assert kills[0]["restore_s"] is None   # the first life lays the base
    assert all(r["restore_s"] > 0 for r in kills[1:])
    summary = result["rows"][-1]
    assert summary["name"] == "B9_recovery_summary" and summary["kills"] == 4
    # the targeted life: killed inside its first snapshot's array write,
    # it recovers from the previous complete snapshot and its WAL
    assert life["armed_death"] and life["exit"] == -9
    assert not bad and durable > steps[-1] and replayed > 0


def test_batch_for_gives_the_references_arrays():
    from tools.chaos import soak as ref_soak
    for seed, step in [(0, 0), (0, 17), (3, 5), (12, 40)]:
        for a, b in zip(soak.batch_for(seed, step, ROWS, BATCH),
                        ref_soak.batch_for(seed, step, ROWS, BATCH)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_recovered_state_equals_the_reference_engine_on_the_stream(
        soaked, tmp_path):
    """The soak's last recovery, restored again, equals the reference
    engine fed ``batch_for(0..L)`` (every int32 leaf, a probe query and
    top-8), and so does the port's own engine-free replay."""
    workdir = soaked[0]
    eng = soak._build_engine(workdir, ROWS, device="cpu")
    eng.restore()
    steps = eng._seq + 1
    pkg = es.port()
    got = {}
    es.record(pkg, eng, got, "end")
    es.answers(pkg, eng, got, "q", np.arange(64, dtype=np.int32))
    es.top(pkg, eng, got, "top", 8)
    eng.close()
    kw = dict(steps=steps, rows=ROWS, batch=BATCH)
    want = es.run_reference_subprocess(
        tmp_path, [("soak_stream", 1, kw)])[("soak_stream", 1)]
    port = {}
    es.SCENARIOS["soak_stream"](pkg, str(tmp_path / "port"), port, **kw)
    assert_same(want, port, "the port's replay of the stream")
    stateful = {k: v for k, v in want.items() if "/stats/" not in k}
    assert_same(stateful, {k: got[k] for k in stateful},
                "the soak's recovered state")


def test_telemetry_life_leaves_a_parseable_incident_dump(tmp_path):
    workdir = str(tmp_path)
    proc = soak._spawn_worker(workdir, ROWS, BATCH, 1, EVERY,
                              "wal.append.write", 2, telemetry=True,
                              poison=True, device="cpu")
    life = soak._run_life(proc, soak.MAX_STEPS_PER_LIFE)
    assert life["armed_death"] and life["exit"] != 0
    ok, msg, count = soak._check_incidents(os.path.join(workdir, "incidents"))
    assert ok and count >= 1, msg
    _, durable, _, bad, _ = soak._verify_recovery(workdir, ROWS, BATCH, 1,
                                                  device="cpu")
    assert not bad and durable >= 1
