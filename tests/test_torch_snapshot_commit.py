"""The port's snapshot commit is durable: every file is fsynced before its
rename, the directories after, and the engine drops the WAL segments a
snapshot supersedes only once the commit is on the disk.

``os.open`` / ``os.fsync`` / ``os.replace`` are spied, so each test sees the
sequence of flushes and renames one save makes, in the sync and the async
save, through ``persist.snapshot`` and through ``ShardedEngine.checkpoint``.
The files stay the bytes the reference writes (the reference's own save on
the same numpy arrays; ``test_torch_persist.py::test_cross_restore_both_ways``
holds the same for whole chains restored across the packages).
"""

import filecmp
import os
import threading

import numpy as np
import pytest
import torch

pytest.register_assert_rewrite("torch_engine_scenarios")

import torch_engine_scenarios as es  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.persist import snapshot as snap_io  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with es.one_torch_thread():
        yield


@pytest.fixture
def spy(monkeypatch):
    """Record ``("fsync", path)`` and ``("replace", src, dst)`` in order; the
    descriptors ``os.open`` hands out are mapped back to their paths."""
    events, names, lock = [], {}, threading.Lock()
    real_open, real_fsync, real_replace = os.open, os.fsync, os.replace

    def open_(path, flags, *a, **kw):
        fd = real_open(path, flags, *a, **kw)
        with lock:
            names[fd] = os.fspath(path)
        return fd

    def fsync_(fd):
        real_fsync(fd)
        with lock:
            events.append(("fsync", names.get(fd)))

    def replace_(src, dst, *a, **kw):
        real_replace(src, dst, *a, **kw)
        with lock:
            events.append(("replace", os.fspath(src), os.fspath(dst)))

    monkeypatch.setattr(os, "open", open_)
    monkeypatch.setattr(os, "fsync", fsync_)
    monkeypatch.setattr(os, "replace", replace_)
    return events


def _commit_events(directory, step):
    """The flushes and renames of one snapshot at ``step`` under
    ``directory``, in the order they must come."""
    path = snap_io.step_dir(directory, step)
    meta, man = os.path.join(path, "chain.json"), os.path.join(path,
                                                               "manifest.json")
    return [("fsync", meta + ".tmp"), ("replace", meta + ".tmp", meta),
            ("fsync", os.path.join(path, "arrays.npz")),
            ("fsync", directory),
            ("fsync", man + ".tmp"), ("fsync", path),
            ("replace", man + ".tmp", man), ("fsync", path)]


def _under(events, directory):
    """The events on ``directory`` and the paths below it, and the markers
    a test appended (``returned``, ``complete``, ``truncate``), in order."""
    def keep(e):
        if e[0] not in ("fsync", "replace"):
            return True
        return e[1] is not None and (e[1] == directory or
                                     e[1].startswith(directory + os.sep))
    return [e for e in events if keep(e)]


def _tree():
    rng = np.random.default_rng(5)
    return {"cnt": rng.integers(0, 99, (8, 4)).astype(np.int32),
            "p": rng.random(6).astype(np.float32),
            "tot": np.arange(8, dtype=np.int32)}


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_snapshot_files_are_fsynced_before_the_commit_and_it_after(
        tmp_path, spy, mode):
    """Sidecar fsync + rename (the caller writes it first, as the reference
    does), npz fsync, the snapshot directory's fsync, manifest temp fsync,
    step directory fsync, manifest rename, step directory fsync — then the
    save returns, or (async) ``on_complete`` runs."""
    directory = str(tmp_path / "snap")
    tree = {k: torch.from_numpy(v) for k, v in _tree().items()}
    meta = {"wal_seq": 3}
    if mode == "sync":
        snap_io.save_snapshot(tree, directory, 4, meta)
        spy.append(("returned",))
    else:
        t = snap_io.save_snapshot_async(
            tree, directory, 4, meta,
            on_complete=lambda: spy.append(("complete",)))
        t.join()
    tail = [("returned",)] if mode == "sync" else [("complete",)]
    assert _under(spy, directory) == _commit_events(directory, 4) + tail
    assert snap_io.latest_complete_step(directory) == 4


def test_snapshot_files_stay_the_references_bytes(tmp_path, spy):
    """The fsyncs change no byte: the port's manifest, sidecar and npz are
    the files the reference's save writes for the same arrays."""
    from repro.persist import snapshot as jsnap
    host = _tree()
    meta = {"wal_seq": 7, "num_shards": 1}
    jsnap.save_snapshot(host, str(tmp_path / "ref"), 2, meta)
    snap_io.save_snapshot({k: torch.from_numpy(v) for k, v in host.items()},
                          str(tmp_path / "port"), 2, meta)
    for name in ("manifest.json", "chain.json", "arrays.npz"):
        assert filecmp.cmp(tmp_path / "ref" / "step_00000002" / name,
                           tmp_path / "port" / "step_00000002" / name,
                           shallow=False), name
    assert sorted(os.listdir(tmp_path / "ref" / "step_00000002")) == \
        sorted(os.listdir(tmp_path / "port" / "step_00000002"))


def test_ckpt_save_alone_commits_the_same_way(tmp_path, spy):
    directory = str(tmp_path / "ck")
    ckpt.save({k: torch.from_numpy(v) for k, v in _tree().items()},
              directory, 1)
    want = [e for e in _commit_events(directory, 1) if "chain.json" not in e[1]]
    assert _under(spy, directory) == want


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_engine_drops_wal_segments_only_after_the_commit_is_fsynced(
        tmp_path, spy, monkeypatch, sync):
    """``checkpoint`` truncates the WAL after the step directory's fsync
    that follows the manifest's rename, in both saves."""
    pkg = es.port()
    eng = es.persist_engine(pkg, str(tmp_path))
    real = eng.wal.truncate_through

    def truncate(seq):
        spy.append(("truncate", seq))
        return real(seq)

    monkeypatch.setattr(eng.wal, "truncate_through", truncate)
    for i in range(3):
        eng.observe(*es.batch(i))
    eng.checkpoint(sync=sync)
    es.join_io(eng)
    snap = eng.cfg.snapshot_dir
    assert _under(spy, snap) == _commit_events(snap, 3) + [("truncate", 2)]
    eng.close()
