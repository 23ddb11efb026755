"""A restore reads each snapshot array from the disk once (the port's
``persist.snapshot.read_step``; the reference reads each three times).

Every ``NpzFile`` member read is counted by (file, member).  The state and
the step a restore lands on are those of before: the step is the one
``latest_complete_step`` of both packages chooses, torn newest steps (a
truncated npz, a torn manifest, a missing sidecar) included, and the state
is bit-equal to the saved one.  ``ShardedEngine.restore`` reads the sidecar
and then each array once, in its exact and its reshard mode.
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch

from repro.persist import snapshot as jsnap
from repro_torch.checkpoint import ckpt
from repro_torch.core import mcprioq as tmc
from repro_torch.core import sharded as tsh
from repro_torch.persist import snapshot as snap_io
from repro_torch.serve.engine import ShardedEngine, ShardedServeConfig

CFG = tmc.MCConfig(num_rows=32, capacity=8)


@pytest.fixture
def reads(monkeypatch):
    """Counter of (npz path, member) reads while the test runs."""
    seen = Counter()
    real = np.lib.npyio.NpzFile.__getitem__

    def counted(self, key):
        seen[(os.path.abspath(self.zip.filename), key)] += 1
        return real(self, key)

    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", counted)
    return seen


def _chain(seed):
    state = tmc.init(CFG, device="cpu")
    rng = np.random.default_rng(seed)
    src = torch.as_tensor(rng.integers(0, 24, 200), dtype=torch.int32)
    dst = torch.as_tensor(rng.integers(0, 12, 200), dtype=torch.int32)
    return tmc.update_batch(state, src, dst, cfg=CFG)


def _two_steps(directory):
    states = [_chain(0), _chain(1)]
    for step, state in enumerate(states):
        snap_io.save_snapshot(state, str(directory), step,
                              {"wal_seq": step - 1})
    return states


def _npz(directory, step):
    return os.path.abspath(os.path.join(snap_io.step_dir(str(directory), step),
                                        "arrays.npz"))


def _members(directory, step):
    with np.load(_npz(directory, step)) as data:
        return sorted(data.files)


def _leaves_equal(a, b):
    _, xs, _ = ckpt._paths_and_leaves(a)
    _, ys, _ = ckpt._paths_and_leaves(b)
    return len(xs) == len(ys) and all(torch.equal(x, y)
                                      for x, y in zip(xs, ys))


@pytest.mark.parametrize("given", [False, True])
def test_a_restore_reads_each_array_once(tmp_path, reads, given):
    states = _two_steps(tmp_path)
    members = _members(tmp_path, 1)
    reads.clear()
    state, meta, step = snap_io.restore_snapshot(
        tmc.init(CFG, device="cpu"), str(tmp_path), step=1 if given else None)
    assert step == 1 and meta == {"wal_seq": 0}
    assert _leaves_equal(state, states[1])
    assert dict(reads) == {(_npz(tmp_path, 1), m): 1 for m in members}
    assert len(members) > 10


def _truncate_npz(directory):
    npz = _npz(directory, 1)
    with open(npz, "rb") as f:
        data = f.read()
    with open(npz, "wb") as f:
        f.write(data[: len(data) // 2])


def _tear_manifest(directory):
    man = os.path.join(snap_io.step_dir(str(directory), 1), "manifest.json")
    with open(man) as f:
        text = f.read()
    with open(man, "w") as f:
        f.write(text[:20])


def _drop_sidecar(directory):
    os.unlink(os.path.join(snap_io.step_dir(str(directory), 1),
                           snap_io.META_NAME))


@pytest.mark.parametrize("tear", [_truncate_npz, _tear_manifest,
                                  _drop_sidecar],
                         ids=["truncated_npz", "torn_manifest",
                              "missing_sidecar"])
def test_a_torn_newest_step_is_skipped_to_the_same_step(tmp_path, reads,
                                                        tear):
    states = _two_steps(tmp_path)
    tear(tmp_path)
    members = _members(tmp_path, 0)
    want = snap_io.latest_complete_step(str(tmp_path))
    assert want == jsnap.latest_complete_step(str(tmp_path)) == 0
    reads.clear()
    state, meta, step = snap_io.restore_snapshot(
        tmc.init(CFG, device="cpu"), str(tmp_path))
    assert step == want and meta == {"wal_seq": -1}
    assert _leaves_equal(state, states[0])
    good = {k: n for k, n in reads.items() if k[0] == _npz(tmp_path, 0)}
    assert good == {(_npz(tmp_path, 0), m): 1 for m in members}
    assert all(n == 1 for n in reads.values())
    with pytest.raises(FileNotFoundError, match="step 1 .* incomplete"):
        snap_io.restore_snapshot(tmc.init(CFG, device="cpu"), str(tmp_path),
                                 step=1)


def test_no_complete_step_raises(tmp_path):
    _two_steps(tmp_path)
    for step in (0, 1):
        os.unlink(os.path.join(snap_io.step_dir(str(tmp_path), step),
                               snap_io.META_NAME))
    assert snap_io.latest_complete_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError, match="no complete snapshot"):
        snap_io.read_step(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no complete snapshot"):
        snap_io.read_step(str(tmp_path / "no-such-dir"))


def _engine(tmp_path, shards):
    scfg = tsh.ShardedConfig(base=tmc.MCConfig(num_rows=64, capacity=8),
                             num_shards=shards, bucket_factor=4.0)
    return ShardedEngine(ShardedServeConfig(
        sharded=scfg, snapshot_dir=str(tmp_path / "snap"), wal_dir=None),
        device="cpu")


@pytest.mark.parametrize("shards", [2, 4], ids=["exact", "reshard"])
def test_the_engine_reads_the_sidecar_then_each_array_once(tmp_path, reads,
                                                           shards):
    eng = _engine(tmp_path, 2)
    rng = np.random.default_rng(3)
    for _ in range(2):
        eng.observe(rng.integers(0, 40, 256).astype(np.int32),
                    rng.integers(0, 16, 256).astype(np.int32))
        eng.checkpoint()
    step = snap_io.latest_complete_step(eng.cfg.snapshot_dir)
    members = _members(eng.cfg.snapshot_dir, step)
    want = eng.query(np.arange(40, dtype=np.int32), 0.9, 8)
    eng.close()
    _truncate_npz_at(eng.cfg.snapshot_dir, step + 1)   # no such step yet
    fresh = _engine(tmp_path, shards)
    reads.clear()
    info = fresh.restore()
    assert info["step"] == step
    assert info["mode"] == ("exact" if shards == 2 else "reshard")
    assert dict(reads) == {(_npz(eng.cfg.snapshot_dir, step), m): 1
                           for m in members}
    got = fresh.query(np.arange(40, dtype=np.int32), 0.9, 8)
    if shards == 2:
        assert all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(got, want))
    fresh.close()


def _truncate_npz_at(directory, step):
    """A torn newer step beside the good one: the engine skips it too."""
    ckpt.save({"x": torch.arange(6)}, directory, step)
    with open(os.path.join(snap_io.step_dir(directory, step),
                           snap_io.META_NAME), "w") as f:
        f.write("{}")
    npz = os.path.join(snap_io.step_dir(directory, step), "arrays.npz")
    with open(npz, "rb") as f:
        data = f.read()
    with open(npz, "wb") as f:
        f.write(data[: len(data) // 2])
