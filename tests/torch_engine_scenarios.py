"""Serving-engine scenarios written once and run on either package (a
helper of the port's engine tests, not collected).

A scenario drives a ``ShardedEngine`` through a :class:`Pkg` — the
reference's (``repro``, JAX) or the port's (``repro_torch`` on the CPU) —
checks the claims of the reference test it counterparts on that package,
and records what came out into ``rec``: every stacked state leaf, query and
top-n answers, ``stats_snapshot`` counters, as named numpy arrays.  The
tests run a scenario on both packages and hold the two records equal at
tolerance 0 (``torch_parity.assert_same``).

The reference needs one (fake) device per shard, fixed when jax starts, so
multi-shard scenarios of the reference run in a subprocess
(:func:`run_reference_subprocess`, ``--xla_force_host_platform_device_count=8``).
The reference builds new jitted programs for every engine; the subprocess
and :func:`cached_reference_programs` keep one program per configuration,
so that a file's many small engines compile once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import functools
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path
from typing import Callable, Dict

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the two packages behind one namespace
# ---------------------------------------------------------------------------


class Pkg:
    """One package's engine API: configs, engine, faults, metrics, IO."""

    def __init__(self, name, mc, sh, engine_mod, ownership, ft, faults, obs,
                 snapshot_io, serve, leaves, engine_kw):
        self.name, self.mc, self.sh = name, mc, sh
        self.engine_mod, self.Ownership, self.ft = engine_mod, ownership, ft
        self.faults, self.obs, self.snapshot_io = faults, obs, snapshot_io
        self.serve, self._leaves, self.engine_kw = serve, leaves, engine_kw
        self.FAST = ft.RetryPolicy(max_attempts=3, base_delay_s=1e-4,
                                   max_delay_s=1e-3)

    def engine(self, cfg):
        return self.engine_mod.ShardedEngine(cfg, **self.engine_kw)

    def config(self, base: dict, shards: int, factor: float, **cfg_kw):
        scfg = self.sh.ShardedConfig(base=self.mc.MCConfig(**base),
                                     num_shards=shards, bucket_factor=factor)
        return self.engine_mod.ShardedServeConfig(sharded=scfg, **cfg_kw)

    @staticmethod
    def host(x) -> np.ndarray:
        if hasattr(x, "detach"):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def state(self, eng) -> Dict[str, np.ndarray]:
        """Every leaf of the engine's published state."""
        snap = eng.store.acquire()
        try:
            return {k: np.array(v) for k, v in self._leaves(snap.state).items()}
        finally:
            eng.store.release(snap)


def _named_leaves(state) -> Dict[str, np.ndarray]:
    out = {}
    for field, leaf in zip(state._fields, state):
        if hasattr(leaf, "_fields"):
            for sub, x in zip(leaf._fields, leaf):
                out[f"{field}.{sub}"] = np.asarray(x)
        else:
            out[field] = np.asarray(leaf)
    return out


def reference() -> Pkg:
    from repro import faults
    from repro.core import mcprioq as mc
    from repro.core import sharded as sh
    from repro.launch import serve
    from repro.obs import metrics as obs
    from repro.persist import snapshot as snapshot_io
    from repro.runtime import fault_tolerance as ft
    from repro.serve import engine as engine_mod
    from repro.sharding.ownership import Ownership
    return Pkg("reference", mc, sh, engine_mod, Ownership, ft, faults, obs,
               snapshot_io, serve, _named_leaves, {})


def port() -> Pkg:
    from repro_torch import convert, faults
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import sharded as sh
    from repro_torch.launch import serve
    from repro_torch.obs import metrics as obs
    from repro_torch.persist import snapshot as snapshot_io
    from repro_torch.runtime import fault_tolerance as ft
    from repro_torch.serve import engine as engine_mod
    from repro_torch.sharding.ownership import Ownership
    return Pkg("port", mc, sh, engine_mod, Ownership, ft, faults, obs,
               snapshot_io, serve, convert.state_to_numpy, {"device": "cpu"})


_FACTORIES = ("make_update_fn", "make_maintain_fn", "make_query_fn",
              "make_topn_fn")


def cached_reference_programs():
    """Make the reference's program factories return one jitted program per
    (config, mesh, arguments) for the rest of the process (the programs are
    pure, so sharing them changes no result).  Returns the undo."""
    from repro.core import sharded as sh
    saved = {name: getattr(sh, name) for name in _FACTORIES}
    for name, real in saved.items():
        setattr(sh, name, functools.lru_cache(maxsize=None)(real))

    def undo():
        for name, real in saved.items():
            setattr(sh, name, real)
    return undo


@contextlib.contextmanager
def one_torch_thread():
    """Run the port's CPU ops on one thread: the suite runs several test
    processes at once, and each torch process would otherwise start a
    thread per core."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def reset_registries():
    """Disarm every failpoint and metric of both packages."""
    for pkg in (reference(), port()):
        pkg.faults.reset()
        pkg.faults.set_observer(None)
        pkg.obs.disarm()


# ---------------------------------------------------------------------------
# inputs and records
# ---------------------------------------------------------------------------


def distinct_count_batch(n_src=12, n_dst=5, seed=0):
    """(src, dst) where src s carries dst d exactly (d+1) times, shuffled:
    every per-row count is distinct, so answers are unique."""
    srcs, dsts = [], []
    for s in range(n_src):
        for d in range(n_dst):
            srcs += [s] * (d + 1)
            dsts += [d] * (d + 1)
    src, dst = np.array(srcs, np.int32), np.array(dsts, np.int32)
    perm = np.random.default_rng(seed).permutation(src.size)
    return src[perm], dst[perm]


def batch(seed=0, n=16, rows=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, rows, n).astype(np.int32),
            rng.integers(0, rows, n).astype(np.int32))


def answers(pkg, eng, rec, tag, src=None, **kw):
    """A query's answers into ``rec``; returns them as numpy."""
    src = np.arange(16, dtype=np.int32) if src is None else src
    out = [pkg.host(x) for x in eng.query(src, **kw)]
    rec.update({f"{tag}/{k}": v for k, v in zip(("dsts", "probs", "n"), out)})
    return out


def top(pkg, eng, rec, tag, n=None):
    out = [pkg.host(x) for x in eng.topn(n)]
    rec.update({f"{tag}/{k}": v for k, v in zip(("srcs", "dsts", "probs"),
                                                 out)})
    return out


def record(pkg, eng, rec, tag):
    """The published state's leaves and every ``stats_snapshot`` counter."""
    rec.update({f"{tag}/state/{k}": v for k, v in pkg.state(eng).items()})
    rec.update({f"{tag}/stats/{k}": np.int64(v)
                for k, v in sorted(eng.stats_snapshot().items())})


def raises(exc, fn, *args, **kw):
    try:
        fn(*args, **kw)
    except exc:
        return
    raise AssertionError(f"{fn} did not raise {exc}")


def join_io(eng):
    for t in list(eng._io_threads):
        t.join()


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, Callable] = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def fault_engine(pkg, tmp, *, wal=True, snap=True, shards=1, factor=2.0,
                 fsync="always", **kw):
    """``tests/test_faults.py``'s engine: 64 rows x 8 slots."""
    kw.setdefault("retry", pkg.FAST)
    return pkg.engine(pkg.config(
        dict(num_rows=64, capacity=8), shards, factor,
        snapshot_dir=os.path.join(tmp, "snap") if snap else None,
        wal_dir=os.path.join(tmp, "wal") if wal else None,
        wal_fsync=fsync, **kw))


def persist_engine(pkg, tmp, *, wal=True, snapshot_every=0, num_shards=1,
                   deadline_s=60.0):
    """``tests/test_persist.py``'s engine: 64 rows x 16 slots."""
    return pkg.engine(pkg.config(
        dict(num_rows=64, capacity=16, sort_passes=4), num_shards, 4.0,
        decay_threshold=1 << 20, snapshot_dir=os.path.join(tmp, "snap"),
        snapshot_every=snapshot_every,
        wal_dir=os.path.join(tmp, "wal") if wal else None,
        wal_fsync="always", observe_deadline_s=deadline_s))


def serve_engine(pkg, shards, factor=4.0, base=None, **kw):
    """``tests/test_sharded_engine.py``'s engine."""
    return pkg.engine(pkg.config(
        base or dict(num_rows=64, capacity=16, sort_passes=4), shards,
        factor, **kw))


def _local_oracle(pkg, base, batches, q, threshold=0.9, max_items=16):
    """The same batches through one unsharded chain of the same package."""
    mc = pkg.mc
    cfg = mc.MCConfig(**base)
    kw = {"device": "cpu"} if pkg.name == "port" else {}
    state = mc.init(cfg, **kw)
    for src, dst in batches:
        state = mc.update_batch(state, src, dst, cfg=cfg)
    return [pkg.host(x) for x in mc.query_threshold(
        state, q, threshold, cfg=cfg, max_items=max_items)]


# -- tests/test_sharded_engine.py ------------------------------------------


@scenario
def cycle(pkg, tmp, rec, shards=1):
    """observe -> query -> topn; at S = 1 ``test_engine_observe_query_topn_
    cycle``'s claims, at S > 1 ``test_engine_multi_shard_inprocess``'s:
    the routed answers equal one unsharded chain's."""
    base = dict(num_rows=64 if shards == 1 else 128, capacity=16,
                sort_passes=4)
    eng = serve_engine(pkg, shards, base=base, decay_threshold=1 << 20)
    n_src = 12 if shards == 1 else 20
    src, dst = distinct_count_batch(n_src=n_src)
    eng.observe(src, dst)
    assert eng.store.version == 1 and eng.stats["updates"] == 1
    assert eng.stats["route_dropped"] == 0 and eng.stats["n_rows"] == n_src
    q = np.arange(n_src, dtype=np.int32)
    got = answers(pkg, eng, rec, "q", q)
    for a, b in zip(got, _local_oracle(pkg, base, [(src, dst)], q)):
        assert np.array_equal(a, b)
    n = 6 if shards == 1 else 8
    _, _, probs = top(pkg, eng, rec, "top", n)
    assert np.all(np.diff(probs) <= 0)
    if shards == 1:
        assert abs(float(probs[0]) - 5.0 / 15.0) < 1e-6
        assert eng.stats["topn_dropped"] == 12 * 5 - 6
    record(pkg, eng, rec, "end")


@scenario
def ragged(pkg, tmp, rec, shards=1):
    """``test_engine_query_pads_ragged_batches``."""
    eng = serve_engine(pkg, shards)
    eng.observe(*distinct_count_batch(n_src=3))
    d, _, _ = answers(pkg, eng, rec, "q", np.array([0, 1, 2], np.int32))
    assert d.shape[0] == 3 and eng.stats["query_dropped"] == 0
    record(pkg, eng, rec, "end")


@scenario
def decay(pkg, tmp, rec, shards=1):
    """``test_engine_decay_runs_behind_writer_lock``, then more batches
    through the decaying writer."""
    eng = serve_engine(pkg, shards, decay_threshold=4)
    eng.observe(*distinct_count_batch())
    assert eng.stats["decay_steps"] >= 1
    for seed in (1, 2):
        eng.observe(*distinct_count_batch(seed=seed))
    answers(pkg, eng, rec, "q")
    top(pkg, eng, rec, "top", 8)
    record(pkg, eng, rec, "end")


@scenario
def script(pkg, tmp, rec, shards=2):
    """``SCRIPT_8DEV`` of ``test_sharded_engine.py`` at S shards: a ragged
    batch padded by the engine, answers equal to one chain's, the global
    top-16 against the known probabilities, and under-provisioned buckets
    whose drops are counted while reads stay sorted."""
    srcs, dsts = [], []
    for s in range(40):
        for d in range(6):
            srcs += [s] * (d + 1)
            dsts += [d] * (d + 1)
    src, dst = np.array(srcs, np.int32), np.array(dsts, np.int32)
    perm = np.random.default_rng(0).permutation(src.size)
    src, dst = src[perm], dst[perm]
    base = dict(num_rows=256, capacity=32, sort_passes=4)
    eng = serve_engine(pkg, shards, base=base, decay_threshold=1 << 20)
    eng.observe(src, dst)
    assert eng.stats["route_dropped"] == 0 and eng.stats["n_rows"] == 40
    q = np.arange(40, dtype=np.int32)
    got = answers(pkg, eng, rec, "q", q)
    for a, b in zip(got, _local_oracle(pkg, base, [(src, dst)], q)):
        assert np.array_equal(a, b)
    assert eng.stats["query_dropped"] == 0
    _, _, mp = top(pkg, eng, rec, "top", 16)
    tot = np.int32(sum(d + 1 for d in range(6)))
    flat = np.sort(np.array([np.float32(np.int32(d + 1)) / np.float32(tot)
                             for s in range(40) for d in range(6)],
                            np.float32))[::-1][:16]
    assert np.array_equal(mp, flat)
    record(pkg, eng, rec, "end")
    tiny = serve_engine(pkg, shards, factor=0.25, base=base,
                        decay_threshold=1 << 20)
    tiny.observe(src, dst)
    assert tiny.stats["route_dropped"] > 0
    _, p, _ = answers(pkg, tiny, rec, "tiny_q", q)
    assert np.all(np.diff(p, axis=1) <= 1e-9)
    record(pkg, tiny, rec, "tiny")


@scenario
def concurrent(pkg, tmp, rec, shards=1):
    """``test_engine_concurrent_observes_lose_no_updates``: two observes in
    threads serialise behind the writer lock.  Their order is the
    scheduler's, so rows may be allotted in either order: the answers and
    counters are recorded, not the row layout.  Buckets of 4·S times the
    fair share route the small batches without a drop at any S."""
    eng = serve_engine(pkg, shards, factor=4.0 * shards)
    a = (np.repeat(np.arange(0, 6, dtype=np.int32), 4),
         np.tile(np.arange(4, dtype=np.int32), 6))
    b = (np.repeat(np.arange(6, 12, dtype=np.int32), 4),
         np.tile(np.arange(4, dtype=np.int32), 6))
    ts = [threading.Thread(target=eng.observe, args=x) for x in (a, b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert eng.store.version == 2 and eng.stats["updates"] == 2
    _, _, n = answers(pkg, eng, rec, "q", np.arange(12, dtype=np.int32),
                      threshold=0.99)
    assert int(n.min()) == 4
    rec.update({f"stats/{k}": np.int64(v)
                for k, v in sorted(eng.stats_snapshot().items())})


@scenario
def mark_down(pkg, tmp, rec, shards=2):
    """``test_faults.py::test_mark_shard_down_degrades_reads_and_defers_
    writes`` (two shards): a down shard's items answer empty, the top-n
    filters its rows, its writes defer and ``heal_shard`` re-applies
    them."""
    eng = fault_engine(pkg, tmp, shards=shards)
    src = np.arange(16, dtype=np.int32)
    eng.observe(src, (src + 1) % 64)
    own = eng.cfg.sharded.resolved_ownership()
    owner = pkg.host(own.owner_of(_ids(pkg, src)))
    eng.mark_shard_down(1)
    _, _, n = answers(pkg, eng, rec, "down_q", src)
    assert (n[owner == 1] == 0).all() and (n[owner == 0] > 0).any()
    assert eng.stats["degraded_answers"] >= int((owner == 1).sum())
    ts, _, tp = top(pkg, eng, rec, "down_top", 8)
    live = ts[ts >= 0]
    assert (pkg.host(own.owner_of(_ids(pkg, live))) != 1).all()
    assert (np.diff(tp[:live.size]) <= 1e-6).all()
    eng.observe(src, (src + 2) % 64)
    assert eng.stats["deferred_writes"] > 0
    assert eng.heal_shard(1) == 1
    assert eng.stats["deferred_writes"] == 0 and eng.stats["shards_down"] == 0
    _, _, n2 = answers(pkg, eng, rec, "healed_q", src)
    assert (n2 > 0).all()
    record(pkg, eng, rec, "end")
    eng.close()


def _ids(pkg, x):
    if pkg.name == "port":
        import torch
        return torch.as_tensor(np.asarray(x, np.int32))
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(x, np.int32))


# -- tests/test_faults.py (engine cases) -----------------------------------


def _oracle_answers(pkg, tmp, batches, rec, tag="oracle", **kw):
    oracle = fault_engine(pkg, tmp + "_oracle", **kw)
    for b in batches:
        oracle.observe(*b)
    out = answers(pkg, oracle, rec, tag)
    record(pkg, oracle, rec, tag)
    oracle.close()
    return out


def _same(a, b):
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


@scenario
def wal_rotate_escalation(pkg, tmp, rec):
    """A failed rotation under ``rotate`` poisons; restore re-aligns."""
    b0 = batch(0)
    eng = fault_engine(pkg, tmp, fsync="rotate")
    eng.wal.segment_records = 1
    pkg.faults.arm("wal.rotate", OSError(errno.EIO, "fsync failed"), count=1)
    raises(pkg.ft.EngineWriteUnavailable, eng.observe, *b0)
    pkg.faults.reset()
    assert not eng.write_available and eng._seq == -1
    assert eng.stats["updates"] == 0
    join_io(eng)
    eng.restore()
    assert eng.write_available and eng._seq == 0
    healed = answers(pkg, eng, rec, "healed")
    record(pkg, eng, rec, "end")
    eng.close()
    _same(healed, _oracle_answers(pkg, tmp, [b0], rec))


@scenario
def wal_segment_open_transient(pkg, tmp, rec):
    """``wal.segment_open`` surfaces to the appender; a bare retry works."""
    wal = pkg.engine_mod.WriteAheadLog(tmp, fsync="never")
    pkg.faults.arm("wal.segment_open", OSError(errno.EIO, "transient"),
                   count=1)
    raises(OSError, wal.append, [1], [1])
    assert wal.append([1], [1]) == 0
    rec["seqs"] = np.array([r[0] for r in wal.replay()])
    wal.close()


@scenario
def wal_enospc_poisons(pkg, tmp, rec):
    """A persistent WAL fault mid-observe poisons without publishing."""
    eng = fault_engine(pkg, tmp)
    eng.observe(*batch(0))
    before_q = answers(pkg, eng, rec, "before")
    before_stats = dict(eng.stats)
    pkg.faults.arm("wal.append.write", OSError(errno.ENOSPC, "disk full"))
    raises(pkg.ft.EngineWriteUnavailable, eng.observe, *batch(1))
    pkg.faults.reset()
    assert not eng.write_available and eng._seq == 0
    _same(before_q, answers(pkg, eng, rec, "after"))
    for key, val in before_stats.items():
        if key == "queries":
            continue
        if key == "write_errors":
            assert eng.stats[key] == val + 1
        elif key == "snapshots":
            assert eng.stats[key] >= val
        else:
            assert eng.stats[key] == val, key
    raises(pkg.ft.EngineWriteUnavailable, eng.observe, *batch(2))
    join_io(eng)
    record(pkg, eng, rec, "poisoned")
    eng.restore()
    assert eng.write_available
    eng.observe(*batch(3))
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def restore_drains_poison_checkpoint(pkg, tmp, rec):
    """restore() joins the poison's in-flight checkpoint-now."""
    eng = fault_engine(pkg, tmp)
    eng.observe(*batch(0))
    pkg.faults.arm("wal.append.write", OSError(errno.ENOSPC, "disk full"))
    pkg.faults.arm("snapshot.io_thread", 0.3)
    raises(pkg.ft.EngineWriteUnavailable, eng.observe, *batch(1))
    pkg.faults.reset()
    eng.restore()
    assert eng.write_available
    eng.observe(*batch(2))
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def wal_transient_retried(pkg, tmp, rec):
    """One EIO flake on the append: retried, applied once, counted."""
    eng = fault_engine(pkg, tmp)
    pkg.faults.arm("wal.append.write", OSError(errno.EIO, "flake"), count=1)
    eng.observe(*batch(0))
    assert eng.stats["wal_retries"] == 1 and eng.stats["updates"] == 1
    assert eng._seq == 0 and eng.write_available
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def apply_exhaustion_poisons(pkg, tmp, rec):
    """Apply faulting past the budget after a durable append: poisoned;
    restore replays the ghost record and equals a fault-free engine."""
    b0, b1 = batch(0), batch(1)
    eng = fault_engine(pkg, tmp)
    eng.observe(*b0)
    eng.checkpoint()
    pkg.faults.arm("engine.apply", RuntimeError("device lost"))
    raises(pkg.ft.EngineWriteUnavailable, eng.observe, *b1)
    pkg.faults.reset()
    assert not eng.write_available
    assert eng.stats["apply_retries"] == pkg.FAST.max_attempts - 1
    assert eng._seq == 0 and eng.wal.last_seq == 1
    result = eng.restore()
    assert result["replayed"] >= 1 and eng._seq == 1
    healed = answers(pkg, eng, rec, "healed")
    record(pkg, eng, rec, "end")
    eng.close()
    _same(healed, _oracle_answers(pkg, tmp, [b0, b1], rec))
    assert np.array_equal(rec["end/state/slabs.cnt"],
                          rec["oracle/state/slabs.cnt"])


@scenario
def apply_fault_without_wal(pkg, tmp, rec):
    """No WAL: an exhausted apply re-raises and changes nothing."""
    eng = fault_engine(pkg, tmp, wal=False, snap=False)
    eng.observe(*batch(0))
    before = answers(pkg, eng, rec, "before")
    state_before = pkg.state(eng)
    pkg.faults.arm("engine.apply", RuntimeError("device lost"))
    raises(pkg.ft.RetryBudgetExceeded, eng.observe, *batch(1))
    pkg.faults.reset()
    assert eng.write_available
    _same(before, answers(pkg, eng, rec, "after"))
    for k, v in pkg.state(eng).items():
        assert np.array_equal(v, state_before[k]), k
    eng.observe(*batch(1))
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def publish_transient_retried(pkg, tmp, rec):
    """``engine.publish`` cuts before the swap: a one-shot fault there is
    retried, the batch lands once, and every leaf equals a fault-free
    engine's (in the port the fault hits after the back state was written:
    the retry's catch-up restores it)."""
    eng = fault_engine(pkg, tmp)
    eng.observe(*batch(5))
    pkg.faults.arm("engine.publish", RuntimeError("flake"), count=1)
    eng.observe(*batch(0))
    assert eng.stats["apply_retries"] == 1 and eng.stats["updates"] == 2
    faulted = answers(pkg, eng, rec, "faulted")
    record(pkg, eng, rec, "end")
    eng.close()
    _same(faulted, _oracle_answers(pkg, tmp, [batch(5), batch(0)], rec))
    for k in rec:
        if k.startswith("end/state/"):
            assert np.array_equal(rec[k], rec["oracle" + k[3:]]), k


@scenario
def publish_fault_then_more_batches(pkg, tmp, rec):
    """The back-buffer trap: a publish fault on every third write (each
    retried), interleaved with reads, over ten batches; every leaf equals
    an engine that never faulted."""
    eng = fault_engine(pkg, tmp, snap=False, decay_threshold=6)
    batches = [batch(seed, n=48) for seed in range(10)]
    pkg.faults.arm("engine.publish", RuntimeError("flake"),
                   trigger=lambda hit: hit % 3 == 1)
    for i, b in enumerate(batches):
        eng.observe(*b)
        answers(pkg, eng, rec, f"q{i}")
    pkg.faults.reset()
    assert eng.stats["apply_retries"] == 5 and eng.stats["updates"] == 10
    assert eng.stats["decay_steps"] > 0
    record(pkg, eng, rec, "end")
    eng.close()
    _oracle_answers(pkg, tmp, batches, rec, snap=False, decay_threshold=6)
    for k in rec:
        if k.startswith("end/state/"):
            assert np.array_equal(rec[k], rec["oracle" + k[3:]]), k


@scenario
def checkpoint_fault_meta_write(pkg, tmp, rec):
    _checkpoint_fault(pkg, tmp, rec, "snapshot.meta_write")


@scenario
def checkpoint_fault_arrays_write(pkg, tmp, rec):
    _checkpoint_fault(pkg, tmp, rec, "snapshot.arrays_write")


@scenario
def checkpoint_fault_manifest_commit(pkg, tmp, rec):
    _checkpoint_fault(pkg, tmp, rec, "snapshot.manifest_commit")


def _checkpoint_fault(pkg, tmp, rec, site):
    """A sync checkpoint failing at ``site``: exception-safe."""
    eng = fault_engine(pkg, tmp)
    eng.observe(*batch(0))
    path0 = eng.checkpoint()
    snaps = eng.stats["snapshots"]
    pkg.faults.arm(site, OSError(errno.EIO, "io fault"))
    raises(OSError, eng.checkpoint, step=7)
    pkg.faults.reset()
    assert eng.stats["snapshots"] == snaps
    assert pkg.snapshot_io.latest_complete_step(eng.cfg.snapshot_dir) == \
        int(os.path.basename(path0).split("_")[1])
    eng.observe(*batch(1))
    eng.checkpoint()
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def async_worker_death_counted(pkg, tmp, rec):
    eng = fault_engine(pkg, tmp)
    eng.observe(*batch(0))
    pkg.faults.arm("snapshot.io_thread", OSError(errno.EIO, "worker died"))
    eng.checkpoint(sync=False)
    join_io(eng)
    pkg.faults.reset()
    assert eng.stats["snapshot_failures"] == 1
    assert pkg.snapshot_io.latest_complete_step(eng.cfg.snapshot_dir) is None
    eng.observe(*batch(1))
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def restore_read_fault(pkg, tmp, rec):
    eng = fault_engine(pkg, tmp)
    eng.observe(*batch(0))
    eng.checkpoint()
    before = answers(pkg, eng, rec, "before")
    pkg.faults.arm("snapshot.restore_read", OSError(errno.EIO, "read fault"))
    raises(OSError, eng.restore)
    pkg.faults.reset()
    _same(before, answers(pkg, eng, rec, "after"))
    eng.restore()
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def cadence_snapshot_failure(pkg, tmp, rec):
    eng = fault_engine(pkg, tmp, snapshot_every=2)
    pkg.faults.arm("snapshot.io_thread", OSError(errno.EIO, "cadence fault"))
    for i in range(4):
        eng.observe(*batch(i))
    join_io(eng)
    pkg.faults.reset()
    assert eng.stats["updates"] == 4 and eng.stats["snapshot_failures"] == 2
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def query_dispatch_degrades(pkg, tmp, rec):
    eng = fault_engine(pkg, tmp, wal=False, snap=False)
    eng.observe(*batch(0))
    pkg.faults.arm("engine.query_dispatch", RuntimeError("device lost"))
    d, _, n = answers(pkg, eng, rec, "degraded", np.arange(8))
    pkg.faults.reset()
    assert (n == 0).all() and (d == -1).all()
    assert eng.stats["degraded_answers"] == 8
    assert eng.stats["dispatch_retries"] == pkg.FAST.max_attempts - 1
    _, _, n2 = answers(pkg, eng, rec, "healthy", np.arange(8))
    assert int(n2.sum()) > 0
    record(pkg, eng, rec, "end")


@scenario
def query_dispatch_transient(pkg, tmp, rec):
    eng = fault_engine(pkg, tmp, wal=False, snap=False)
    eng.observe(*batch(0))
    clean = answers(pkg, eng, rec, "clean")
    pkg.faults.arm("engine.query_dispatch", RuntimeError("flake"), count=1)
    flaky = answers(pkg, eng, rec, "flaky")
    pkg.faults.reset()
    _same(clean, flaky)
    assert eng.stats["degraded_answers"] == 0
    record(pkg, eng, rec, "end")


@scenario
def topn_dispatch_degrades(pkg, tmp, rec):
    eng = fault_engine(pkg, tmp, wal=False, snap=False)
    eng.observe(*batch(0))
    pkg.faults.arm("engine.topn_dispatch", RuntimeError("device lost"))
    srcs, _, _ = top(pkg, eng, rec, "degraded", 4)
    pkg.faults.reset()
    assert (srcs == -1).all() and eng.stats["degraded_answers"] == 4
    srcs2, _, _ = top(pkg, eng, rec, "healthy", 4)
    assert int(srcs2.max()) >= 0
    record(pkg, eng, rec, "end")


@scenario
def deferred_writes_survive_gc_and_crash(pkg, tmp, rec):
    b0, b1 = batch(0), batch(1)
    eng = fault_engine(pkg, tmp)
    eng.wal.segment_records = 1
    eng.observe(*b0)
    eng.mark_shard_down(0)
    eng.observe(*b1)
    assert eng.stats["deferred_writes"] == b1[0].size
    eng.checkpoint()
    assert not os.listdir(eng.cfg.wal_dir)
    eng.close()
    eng2 = fault_engine(pkg, tmp)
    eng2.restore()
    assert eng2.stats["shards_down"] == 1
    assert eng2.stats["deferred_writes"] == b1[0].size
    assert eng2.heal_shard(0) == 1
    healed = answers(pkg, eng2, rec, "healed")
    eng2.observe(*batch(2))
    assert eng2.wal.last_seq == 2
    record(pkg, eng2, rec, "end")
    eng2.close()
    _same(healed, _oracle_answers(pkg, tmp, [b0, b1], rec))


@scenario
def restore_resets_health_map(pkg, tmp, rec):
    b0, b1 = batch(0), batch(1)
    eng = fault_engine(pkg, tmp)
    eng.observe(*b0)
    eng.checkpoint()
    eng.mark_shard_down(0)
    eng.observe(*b1)
    assert eng.stats["deferred_writes"] == b1[0].size
    result = eng.restore()
    assert result["replayed"] == 1
    assert eng.stats["shards_down"] == 0 and eng.stats["deferred_writes"] == 0
    assert eng.heal_shard(0) == 0
    healed = answers(pkg, eng, rec, "healed")
    record(pkg, eng, rec, "end")
    eng.close()
    _same(healed, _oracle_answers(pkg, tmp, [b0, b1], rec))


@scenario
def heal_fault_requeues_remainder(pkg, tmp, rec):
    b0, b1 = batch(0), batch(1)
    eng = fault_engine(pkg, tmp, wal=False, snap=False)
    eng.mark_shard_down(0)
    eng.observe(*b0)
    eng.observe(*b1)
    assert eng.stats["deferred_writes"] == b0[0].size + b1[0].size
    pkg.faults.arm("engine.apply", RuntimeError("device lost"),
                   trigger=lambda hit: hit > 1)
    raises(pkg.ft.RetryBudgetExceeded, eng.heal_shard, 0)
    pkg.faults.reset()
    assert eng.stats["shards_down"] == 1
    assert eng.stats["deferred_writes"] == b1[0].size
    assert eng.heal_shard(0) == 1
    assert eng.stats["shards_down"] == 0 and eng.stats["deferred_writes"] == 0
    healed = answers(pkg, eng, rec, "healed")
    record(pkg, eng, rec, "end")
    eng.close()
    _same(healed, _oracle_answers(pkg, tmp, [b0, b1], rec, wal=False,
                                  snap=False))


@scenario
def dispatch_strikes_mark_down(pkg, tmp, rec):
    eng = fault_engine(pkg, tmp, wal=False, snap=False, health_strikes=2)
    eng.observe(*batch(0))
    assert pkg.ft.shard_from_exception(None) is None
    pkg.faults.arm("engine.query_dispatch",
                   pkg.ft.ShardDispatchError(0, "rpc lost"))
    eng.query(np.arange(8))
    assert eng.stats["shards_down"] == 0
    eng.query(np.arange(8))
    pkg.faults.reset()
    assert eng.stats["shards_down"] == 1 and eng.health.down == frozenset({0})
    _, _, n = answers(pkg, eng, rec, "masked", np.arange(8))
    assert (n == 0).all()
    eng.observe(*batch(1))
    assert eng.stats["deferred_writes"] > 0
    assert eng.heal_shard(0) == 1
    _, _, n2 = answers(pkg, eng, rec, "healed", np.arange(8))
    assert (n2 > 0).any()
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def dispatch_success_breaks_streak(pkg, tmp, rec):
    eng = fault_engine(pkg, tmp, wal=False, snap=False, health_strikes=2)
    eng.observe(*batch(0))
    for _ in range(2):
        pkg.faults.arm("engine.query_dispatch",
                       pkg.ft.ShardDispatchError(0, "flap"),
                       count=pkg.FAST.max_attempts)
        eng.query(np.arange(8))
        pkg.faults.reset()
        eng.query(np.arange(8))
    assert eng.stats["shards_down"] == 0 and not eng.health.down
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def route_overflow_prediction(pkg, tmp, rec):
    """The host-side drop predictor agrees with the device routing."""
    eng = pkg.engine(pkg.config(dict(num_rows=64, capacity=8), 1, 0.5))
    rng = np.random.default_rng(5)
    for trial in range(5):
        src = rng.choice([0, 1, 2, 63], size=24,
                         p=[0.6, 0.2, 0.1, 0.1]).astype(np.int32)
        dst = rng.integers(0, 64, 24).astype(np.int32)
        predicted = int(pkg.sh.predict_route_overflow(
            eng.cfg.sharded, src).sum())
        before = eng.stats.get("route_dropped", 0)
        eng.observe(src, dst)
        assert predicted == eng.stats["route_dropped"] - before, trial
        rec[f"predicted{trial}"] = np.int64(predicted)
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def route_retry_requeues_and_drains(pkg, tmp, rec):
    def mk(budget):
        return fault_engine(pkg, tmp + f"_{budget}", snap=False, factor=0.5,
                            route_retry_budget=budget, route_retry_slice=8)
    src, dst = np.zeros(24, np.int32), np.arange(24, dtype=np.int32)
    eng0 = mk(0)
    eng0.observe(src, dst)
    assert eng0.stats["route_dropped"] > 0
    record(pkg, eng0, rec, "off")
    eng0.close()
    eng = mk(8)
    eng.observe(src, dst)
    assert eng.stats["route_dropped"] == 0 and eng.stats["route_retried"] > 0
    assert sum(int(c[0].size) for c in eng._retry_queue) > 0
    steps = 0
    while eng._retry_queue and steps < 64:
        eng.observe(np.full(1, -1, np.int32), np.zeros(1, np.int32))
        steps += 1
    assert not eng._retry_queue and eng.stats["route_dropped"] == 0
    rec["steps"] = np.int64(steps)
    record(pkg, eng, rec, "end")
    eng.close()


@scenario
def route_retry_queue_survives_restore(pkg, tmp, rec):
    kw = dict(factor=0.5, route_retry_budget=8, route_retry_slice=8)
    eng = fault_engine(pkg, tmp, **kw)
    eng.observe(np.zeros(24, np.int32), np.arange(24, dtype=np.int32))
    queued = sum(int(c[0].size) for c in eng._retry_queue)
    assert queued > 0
    eng.checkpoint()
    eng.close()
    eng2 = fault_engine(pkg, tmp, **kw)
    eng2.restore()
    assert sum(int(c[0].size) for c in eng2._retry_queue) == queued
    for i, chunk in enumerate(eng2._retry_queue):
        for j, a in enumerate(chunk):
            rec[f"queue{i}/{j}"] = np.asarray(a)
    eng2.observe(*batch(3))
    record(pkg, eng2, rec, "end")
    eng2.close()


@scenario
def query_overflow_retry(pkg, tmp, rec):
    cfg0 = dict(num_rows=64, capacity=8)
    src_w = np.arange(32, dtype=np.int32) % 64
    eng0 = pkg.engine(pkg.config(cfg0, 1, 0.5))
    eng0.observe(src_w, (src_w + 1) % 64)
    _, _, n0 = answers(pkg, eng0, rec, "off", np.zeros(32, np.int32))
    eng0.close()
    eng = pkg.engine(pkg.config(cfg0, 1, 0.5, query_retry_budget=4,
                                retry=pkg.FAST))
    eng.observe(src_w, (src_w + 1) % 64)
    _, _, n1 = answers(pkg, eng, rec, "on", np.zeros(32, np.int32))
    assert eng.stats["query_dropped"] > 0 and eng.stats["query_retried"] > 0
    answered0, answered1 = int((n0 > 0).sum()), int((n1 > 0).sum())
    assert answered1 == 32 - eng.stats["query_lost"]
    assert answered1 > answered0
    record(pkg, eng, rec, "end")
    eng.close()


# -- tests/test_obs.py (engine cases) --------------------------------------


@scenario
def telemetry_consistent_stats(pkg, tmp, rec):
    with pkg.obs.armed():
        eng = fault_engine(pkg, tmp, snap=False)
        s, d = batch()
        eng.observe(s, d)
        eng.query(np.arange(8).astype(np.int32))
        eng.topn()
        snap = eng.metrics.snapshot()
        st = eng.stats_snapshot()
    assert st["updates"] == 1 and st["queries"] == 1
    assert st["shards_down"] == 0 and st["n_rows"] > 0
    hists = snap["histograms"]
    for name in ("engine.observe", "engine.apply", "engine.query",
                 "engine.topn", "wal.append"):
        assert hists[name]["count"] == 1, name
    assert hists["wal.fsync"]["count"] >= 1
    assert sum(snap["vectors"]["bucket_traffic"]) == len(s)
    assert sum(snap["vectors"]["shard_traffic"]) == len(s)
    assert snap["gauges"]["store_version"] == eng.store.version
    assert snap["gauges"]["read_epoch_lag"] == 0
    assert snap["provided"]["updates"] == 1
    for k in ("bucket_traffic", "shard_traffic"):
        rec[k] = np.asarray(snap["vectors"][k])
    record(pkg, eng, rec, "end")


@scenario
def disarmed_still_serves_stats(pkg, tmp, rec):
    eng = fault_engine(pkg, tmp, wal=False, snap=False)
    eng.observe(*batch())
    assert eng.stats_snapshot()["updates"] == 1
    snap = eng.metrics.snapshot()
    assert snap["histograms"]["engine.observe"]["count"] == 0
    assert sum(snap["vectors"]["bucket_traffic"]) == 0
    record(pkg, eng, rec, "end")


@scenario
def poison_incident_dump(pkg, tmp, rec):
    inc = os.path.join(tmp, "inc")
    with pkg.obs.armed():
        eng = fault_engine(pkg, tmp, snap=False, incident_dir=inc)
        eng.observe(*batch())
        pkg.faults.arm("wal.append.write", OSError(errno.ENOSPC, "disk full"))
        raises(pkg.ft.EngineWriteUnavailable, eng.observe, *batch(1))
    files = sorted(os.listdir(inc))
    assert files
    with open(os.path.join(inc, files[0])) as f:
        doc = json.load(f)
    assert doc["schema"] == "mcq-incident-v1" and doc["reason"] == "poison"
    assert any(sp["name"] == "engine.observe" for sp in doc["spans"])
    assert doc["deltas"]
    record(pkg, eng, rec, "end")


# -- tests/test_persist.py (engine cases) ----------------------------------


def _states_equal(pkg, a, b):
    sa, sb = pkg.state(a), pkg.state(b)
    assert list(sa) == list(sb)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k


@scenario
def checkpoint_restore_exact_with_replay(pkg, tmp, rec):
    eng = persist_engine(pkg, tmp)
    eng.observe(*distinct_count_batch())
    eng.checkpoint()
    eng.observe(*distinct_count_batch(seed=1))
    ref_q = answers(pkg, eng, rec, "live", np.arange(12, dtype=np.int32))
    ref_stats = dict(eng.stats)
    eng2 = persist_engine(pkg, tmp)
    info = eng2.restore()
    assert info["mode"] == "exact" and info["replayed"] == 1
    _same(ref_q, answers(pkg, eng2, rec, "restored",
                         np.arange(12, dtype=np.int32)))
    for k in ("n_rows", "evictions", "deferred_new", "route_dropped",
              "decay_steps"):
        assert eng2.stats[k] == ref_stats[k], k
    _states_equal(pkg, eng, eng2)
    record(pkg, eng2, rec, "end")


@scenario
def cadence_snapshots_background(pkg, tmp, rec):
    eng = persist_engine(pkg, tmp, snapshot_every=2)
    for _ in range(4):
        eng.observe(*distinct_count_batch(n_src=4))
    eng.close()
    assert eng.stats["snapshots"] == 2
    assert pkg.snapshot_io.latest_complete_step(os.path.join(tmp, "snap")) == 4
    record(pkg, eng, rec, "end")


@scenario
def watchdog_escalation_checkpoints(pkg, tmp, rec):
    eng = persist_engine(pkg, tmp, deadline_s=0.0)
    eng.watchdog.cfg = dataclasses.replace(eng.watchdog.cfg,
                                           max_consecutive_slow=2)
    src, dst = distinct_count_batch(n_src=4)
    eng.observe(src, dst)
    assert eng.stats["snapshots"] == 0
    eng.observe(src, dst)
    assert eng.stats["snapshots"] == 1
    assert pkg.snapshot_io.latest_complete_step(
        os.path.join(tmp, "snap")) is not None
    record(pkg, eng, rec, "end")


@scenario
def snapshot_truncates_wal(pkg, tmp, rec):
    eng = persist_engine(pkg, tmp)
    eng.wal.segment_records = 1
    src, dst = distinct_count_batch(n_src=4)
    for _ in range(3):
        eng.observe(src, dst)
    segs = lambda: len([f for f in os.listdir(os.path.join(tmp, "wal"))  # noqa: E731
                        if f.startswith("wal_") and f.endswith(".seg")])
    assert segs() == 3
    eng.checkpoint()
    assert segs() == 0
    eng.observe(*distinct_count_batch(n_src=4, seed=1))
    assert segs() == 1
    eng2 = persist_engine(pkg, tmp)
    info = eng2.restore()
    assert info["mode"] == "exact" and info["replayed"] == 1
    _states_equal(pkg, eng, eng2)
    record(pkg, eng2, rec, "end")


@scenario
def async_gc_waits_and_close_drains(pkg, tmp, rec):
    with persist_engine(pkg, tmp, snapshot_every=2) as eng:
        eng.wal.segment_records = 1
        src, dst = distinct_count_batch(n_src=4)
        for _ in range(4):
            eng.observe(src, dst)
    assert eng._io_threads == []
    assert pkg.snapshot_io.latest_complete_step(os.path.join(tmp, "snap")) == 4
    assert not [f for f in os.listdir(os.path.join(tmp, "wal"))
                if f.endswith(".seg")]
    eng.close()
    eng2 = persist_engine(pkg, tmp)
    info = eng2.restore()
    assert info["mode"] == "exact" and info["replayed"] == 0
    _states_equal(pkg, eng, eng2)
    record(pkg, eng2, rec, "end")


@scenario
def restore_skips_torn_snapshot(pkg, tmp, rec):
    eng = persist_engine(pkg, tmp)
    src, dst = distinct_count_batch()
    eng.observe(src, dst)
    eng.checkpoint()
    eng.observe(src, dst)
    eng.checkpoint()
    snap_dir = os.path.join(tmp, "snap")
    steps = sorted(os.listdir(snap_dir))
    npz = os.path.join(snap_dir, steps[-1], "arrays.npz")
    with open(npz, "rb") as f:
        head = f.read(100)
    with open(npz, "wb") as f:
        f.write(head)
    eng2 = persist_engine(pkg, tmp)
    info = eng2.restore()
    assert f"step_{info['step']:08d}" == steps[0]
    q = np.arange(12, dtype=np.int32)
    _same(answers(pkg, eng, rec, "live", q),
          answers(pkg, eng2, rec, "restored", q))
    record(pkg, eng2, rec, "end")


@scenario
def reassign_preserves_answers(pkg, tmp, rec, shards=1):
    """``test_engine_reassign_preserves_answers`` (at S shards, the new map
    moves every bucket one shard on)."""
    eng = persist_engine(pkg, tmp, wal=False, num_shards=shards)
    src, dst = distinct_count_batch()
    eng.observe(src, dst)
    q = np.arange(12, dtype=np.int32)
    ref = answers(pkg, eng, rec, "before", q)
    before_top = top(pkg, eng, rec, "before_top", 16)
    if shards == 1:
        own = pkg.Ownership(num_shards=1, num_buckets=32)
    else:
        own = pkg.Ownership(num_shards=shards, num_buckets=64, assignment=tuple(
            (b + 1) % shards for b in range(64)))
    info = eng.reassign(own)
    assert eng.cfg.sharded.resolved_ownership() == own
    rec["version"] = np.int64(info["version"])
    _same(ref, answers(pkg, eng, rec, "after", q))
    after_top = top(pkg, eng, rec, "after_top", 16)
    # the merge breaks ties by shard: with rows on other shards only the
    # probabilities are kept (every top-16 probability here is tied)
    _same(before_top[2:] if shards > 1 else before_top,
          after_top[2:] if shards > 1 else after_top)
    raises(ValueError, eng.reassign, pkg.Ownership(num_shards=shards + 2))
    eng.observe(*distinct_count_batch(seed=3))
    record(pkg, eng, rec, "end")


@scenario
def elastic_restore(pkg, tmp, rec, shards=4):
    """``test_elastic_reshard_restore_8dev``: a 4-shard engine's snapshot
    (+ one WAL record after it) restored onto 2 and 8 shards (elastic, the
    answers and top-16 of one chain) and onto 4 (exact, every leaf)."""
    srcs, dsts = [], []
    for s in range(40):
        for d in range(6):
            srcs += [s] * (d + 1)
            dsts += [d] * (d + 1)
    src, dst = np.array(srcs, np.int32), np.array(dsts, np.int32)
    perm = np.random.default_rng(0).permutation(src.size)
    src, dst = src[perm], dst[perm]
    base = dict(num_rows=256, capacity=32, sort_passes=4)

    def engine_at(n):
        return pkg.engine(pkg.config(
            base, n, 4.0, decay_threshold=1 << 20,
            snapshot_dir=os.path.join(tmp, "snap"),
            wal_dir=os.path.join(tmp, "wal"), wal_fsync="always"))

    e4 = engine_at(shards)
    e4.observe(src, dst)
    e4.checkpoint()
    src2, dst2 = np.arange(40, dtype=np.int32), np.full(40, 17, np.int32)
    e4.observe(src2, dst2)
    q = np.arange(40, dtype=np.int32)
    oracle = _local_oracle(pkg, base, [(src, dst), (src2, dst2)], q)
    _, d4, p4 = top(pkg, e4, rec, "top4", 16)
    record(pkg, e4, rec, "e4")
    for m in (2, 8):
        em = engine_at(m)
        info = em.restore()
        assert info["mode"] == "reshard" and info["replayed"] == 1, info
        assert em.stats["route_dropped"] == 0
        assert em.stats["deferred_new"] == 0
        _same(oracle, answers(pkg, em, rec, f"q{m}", q))
        _, md, mp = top(pkg, em, rec, f"top{m}", 16)
        assert np.array_equal(mp, p4) and np.array_equal(md, d4)
        record(pkg, em, rec, f"e{m}")
    e4b = engine_at(shards)
    info = e4b.restore()
    assert info["mode"] == "exact"
    _states_equal(pkg, e4, e4b)


# ---------------------------------------------------------------------------
# the reference's multi-shard side, in one subprocess
# ---------------------------------------------------------------------------

_SUBPROCESS = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    sys.path.insert(0, sys.argv[3])
    import torch_engine_scenarios as es
    es.cached_reference_programs()
    pkg = es.reference()
    out_dir, items = sys.argv[1], json.loads(sys.argv[2])

    def run(item):
        name, shards = item
        rec, tmp = {}, os.path.join(out_dir, f"{name}_s{shards}")
        os.makedirs(tmp)
        es.SCENARIOS[name](pkg, tmp, rec, shards=shards)
        np.savez(os.path.join(out_dir, f"{name}_s{shards}.npz"), **rec)

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(run, items))
    print("JAX-ENGINE-OK")
    """)


def run_reference_subprocess(out_dir, items, timeout=600):
    """Run ``[(scenario, shards), ...]`` through the reference with 8 fake
    devices; returns ``{(scenario, shards): record}``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS, str(out_dir), json.dumps(items),
         str(ROOT / "tests")],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-ENGINE-OK" in out.stdout
    return {(name, s): dict(np.load(Path(out_dir) / f"{name}_s{s}.npz"))
            for name, s in items}


# -- snapshots and WALs across the packages ---------------------------------


def cross_write(pkg, tmp):
    """Leave a snapshot directory and a WAL whose meta carries every kind of
    recovery state: a non-empty route-retry queue, a down shard with
    deferred writes, and one record after the snapshot."""
    eng = fault_engine(pkg, tmp, factor=0.5, route_retry_budget=8,
                       route_retry_slice=8)
    eng.observe(np.zeros(24, np.int32), np.arange(24, dtype=np.int32))
    eng.observe(*batch(1, n=24))
    eng.mark_shard_down(0)
    eng.observe(*batch(2, n=24))
    assert eng._retry_queue and eng.stats["deferred_writes"] > 0
    eng.checkpoint()
    eng.observe(*batch(3, n=24))
    eng.close()


def cross_restore(pkg, tmp, rec):
    """Restore what :func:`cross_write` left, replay, heal, go on."""
    eng = fault_engine(pkg, tmp, factor=0.5, route_retry_budget=8,
                       route_retry_slice=8)
    info = eng.restore()
    assert info["mode"] == "exact" and info["replayed"] == 1
    rec.update({f"restore/{k}": np.asarray(v) for k, v in info.items()
                if k != "mode"})
    record(pkg, eng, rec, "restored")
    assert eng.heal_shard(0) == 2
    eng.observe(*batch(4, n=24))
    answers(pkg, eng, rec, "q")
    record(pkg, eng, rec, "end")
    eng.close()
