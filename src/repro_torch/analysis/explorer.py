"""Deterministic interleaving explorer for the port's lock-free engine.

Counterpart of ``repro.analysis.explorer``, over the port's
:class:`repro_torch.serve.engine.ShardedEngine`.  ``tools/mcqlint`` proves
the *declared* concurrency contract statically; this module checks the
*behaviour*: it runs real :class:`ShardedEngine` host-side
control flow (locks, EpochStore publish/acquire, WAL append/replay, stats
accounting) under a cooperative scheduler that owns every thread switch, and
explores the interleavings of ``observe``/``query``/``topn``/``checkpoint``/
``reassign``/recovery either exhaustively (DFS with CHESS-style preemption
bounding — most real races need one or two preemptions) or randomly (seeded).

Only the *device* compute is faked: ``sh.init_sharded``, the
``sh.make_*_fn`` factories the engine resolves (the owner programs
``make_update_fn_``/``make_maintain_fn_`` and the readers
``make_query_fn``/``make_topn_fn``), ``mc.counter_stats`` and the engine's
writer ``epoch.BackBufferLearner`` are patched with host-side stand-ins over
a tiny :class:`FakeState` (numpy leaves, so the real snapshot writer still
works).  The writer's stand-in is a trivial copy-on-write writer: acquire,
the owner programs on the snapshot's state, release, publish — the
reference's publish cycle; a back buffer cannot catch up a ``FakeState``.
Each fake routing program bakes in the routing generation it was built for —
``resolved_ownership().num_buckets`` — and raises :class:`GenMismatch` when
dispatched against a snapshot of a different generation, which is exactly
the (program, snapshot) mispairing invariant I8.  Everything the invariants
actually live in — lock protocol, epoch store, WAL files — is the real code.

Regression contract (checked by ``tests/test_torch_explorer.py`` and
``--smoke``): with the *pre-fix* bodies of three historical races
(stats-dict lost update, route/snapshot mispairing, double WAL replay
during restore), the explorer finds each violation and the violating
schedule replays deterministically; on the current (fixed) code paths every
schedule is clean.

Determinism: a schedule is the sequence of thread choices at yield points;
scenario code is yield-deterministic (no wall clock, no host RNG), so a
recorded trace replays bit-identically — the explorer is its own minimiser
and reproducer.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import random
import shutil
import sys
import tempfile
import threading
from collections import OrderedDict
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np

import torch

from repro_torch import faults
from repro_torch.core import epoch
from repro_torch.core import mcprioq as mc
from repro_torch.core import sharded as sh
from repro_torch.runtime.fault_tolerance import (EngineWriteUnavailable,
                                                 RetryPolicy)
from repro_torch.serve import engine as engine_mod
from repro_torch.sharding.ownership import Ownership


# ---------------------------------------------------------------------------
# cooperative scheduler
# ---------------------------------------------------------------------------


class _Aborted(BaseException):
    """Raised inside a scheduled thread to unwind it after a deadlock."""


class _ThreadState:
    def __init__(self, name: str):
        self.name = name
        self.event = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.done = False
        self.error: Optional[BaseException] = None
        self.pred: Optional[Callable[[], bool]] = None
        self.tag = "start"
        self.abort = False


class Scheduler:
    """Cooperative scheduler, controlled from the main thread.

    Exactly one scenario thread runs at a time; at every ``yield_point`` the
    running thread parks and the main thread (the test's) picks the
    next one, so the interleaving IS the recorded ``trace``.  Threads never
    registered with the scheduler (setup/check code on the main thread) pass
    through ``yield_point`` untouched — setup is atomic by construction.

    ``yield_tags`` optionally restricts instrumentation to yield points whose
    tag starts with one of the given prefixes: scenarios use it to bound the
    decision-point count for exhaustive exploration (the same filter applies
    to the buggy and the fixed variant, so the comparison stays honest).
    """

    def __init__(self, yield_tags: Optional[Sequence[str]] = None):
        self._threads: "OrderedDict[str, _ThreadState]" = OrderedDict()
        self._ready = threading.Event()
        self._local = threading.local()
        self._yield_tags = (tuple(yield_tags)
                            if yield_tags is not None else None)
        self.trace: List[str] = []
        self.runnables: List[Tuple[str, ...]] = []
        self.deadlock = False

    # -- thread side ----------------------------------------------------
    def current(self) -> Optional[str]:
        return getattr(self._local, "name", None)

    def yield_point(self, tag: str,
                    pred: Optional[Callable[[], bool]] = None) -> None:
        name = self.current()
        if name is None:
            return  # unregistered (main) thread: setup/check is atomic
        if (self._yield_tags is not None
                and not any(tag.startswith(p) for p in self._yield_tags)):
            # Filtered out — no decision point here.  But blocking must
            # never be skipped: when the pred is currently false the thread
            # has to park or it would break mutual exclusion.  When it is
            # true, proceeding without a yield is atomic (no other thread
            # runs concurrently in the cooperative model).
            if pred is None or pred():
                return
        ts = self._threads[name]
        if ts.abort:
            raise _Aborted()
        ts.tag, ts.pred = tag, pred
        self._ready.set()
        ts.event.wait()
        ts.event.clear()
        if ts.abort:
            raise _Aborted()

    def spawn(self, name: str, fn: Callable[[], Any]) -> None:
        ts = _ThreadState(name)

        def body():
            self._local.name = name
            ts.event.wait()       # parked at "start" until first scheduled
            ts.event.clear()
            try:
                if ts.abort:      # deadlock teardown before we ever ran
                    raise _Aborted()
                fn()
            except _Aborted:
                pass
            except BaseException as exc:  # captured, surfaced as violation
                ts.error = exc
            finally:
                ts.done = True
                self._ready.set()

        ts.thread = threading.Thread(target=body, daemon=True,
                                     name=f"explorer:{name}")
        self._threads[name] = ts
        ts.thread.start()

    # -- main-thread side -----------------------------------------------
    def run(self, controller) -> None:
        """Drive all spawned threads to completion (or deadlock)."""
        current: Optional[str] = None
        while True:
            alive = [ts for ts in self._threads.values() if not ts.done]
            if not alive:
                return
            runnable = tuple(ts.name for ts in alive
                             if ts.pred is None or ts.pred())
            if not runnable:
                self.deadlock = True
                self._abort_all(alive)
                return
            choice = controller.choose(list(runnable), current)
            self.runnables.append(runnable)
            self.trace.append(choice)
            current = choice
            ts = self._threads[choice]
            ts.pred = None
            self._ready.clear()
            ts.event.set()
            self._ready.wait()

    def _abort_all(self, alive: List[_ThreadState]) -> None:
        for ts in alive:
            ts.abort = True
            ts.event.set()
        for ts in alive:
            ts.thread.join(timeout=5.0)


# -- schedule controllers -------------------------------------------------


class _PrefixController:
    """Replays a recorded choice prefix, then continues with the default
    policy (stay on the current thread while it is runnable — zero added
    preemptions, so a prefix's preemption count is the whole trace's)."""

    def __init__(self, prefix: Sequence[str]):
        self.prefix = list(prefix)
        self.i = 0
        self.diverged = False

    def choose(self, runnable: List[str], current: Optional[str]) -> str:
        runnable = sorted(runnable)
        if self.i < len(self.prefix):
            want = self.prefix[self.i]
            self.i += 1
            if want in runnable:
                return want
            self.diverged = True  # scenario was not schedule-deterministic
        else:
            self.i += 1
        if current is not None and current in runnable:
            return current
        return runnable[0]


class _RandomController:
    def __init__(self, rng: random.Random):
        self.rng = rng

    def choose(self, runnable: List[str], current: Optional[str]) -> str:
        return self.rng.choice(sorted(runnable))


# ---------------------------------------------------------------------------
# instrumentation: scheduler-aware locks, stats, store
# ---------------------------------------------------------------------------


class SchedLock:
    """Drop-in ``threading.Lock`` replacement whose acquire is a yield point.

    Blocking is expressed as a predicate (*runnable once the owner clears*)
    rather than an OS wait, so the main thread always knows which threads
    can make progress — a schedule where no predicate holds is a detected
    deadlock, not a hang.
    """

    def __init__(self, sched: Scheduler, name: str):
        self._sched = sched
        self._name = name
        self._owner: Optional[str] = None

    def acquire(self) -> bool:
        me = self._sched.current()
        if me is None:  # main-thread setup: no contention by construction
            if self._owner is not None:
                raise RuntimeError(
                    f"setup acquired {self._name} while a scenario thread "
                    f"holds it")
            self._owner = "<main>"
            return True
        self._sched.yield_point(f"lock:{self._name}",
                                pred=lambda: self._owner is None)
        assert self._owner is None
        self._owner = me
        return True

    def release(self) -> None:
        self._owner = None

    def locked(self) -> bool:
        return self._owner is not None

    def __enter__(self) -> "SchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class InstrumentedStats(dict):
    """The engine's ``stats`` dict with a yield point before every write.

    A counter bump is ``read -> add -> write``; parking the writer right
    before the write is what lets the explorer interleave a full second
    read-modify-write in between — the schedule that turns an unguarded
    ``stats[k] += 1`` into a lost update.  Reads stay yield-free (the read
    half of the race needs no extra schedule control, and it keeps the
    decision-point count down).
    """

    def __init__(self, sched: Scheduler, data: Dict[str, Any]):
        super().__init__(data)
        self._sched = sched

    def __setitem__(self, key, value):
        self._sched.yield_point(f"stats:set:{key}")
        super().__setitem__(key, value)

    def update(self, other=(), **kw):  # route through __setitem__
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v
        for k, v in kw.items():
            self[k] = v


def _instrument_store(sched: Scheduler, store) -> None:
    """Yield before snapshot pin and before publish: the two moments the
    RCU-analogue hand-off can interleave with a routing swap."""
    orig_acquire, orig_publish = store.acquire, store.publish

    def acquire():
        sched.yield_point("store:acquire")
        return orig_acquire()

    def publish(state):
        sched.yield_point("store:publish")
        return orig_publish(state)

    store.acquire, store.publish = acquire, publish


# ---------------------------------------------------------------------------
# fake kernel layer (host-side stand-ins for the sharded device programs)
# ---------------------------------------------------------------------------


class GenMismatch(AssertionError):
    """A routed program was dispatched against a snapshot of a different
    routing generation — the I8 (program, snapshot) pairing violation."""


class FakeState(NamedTuple):
    total: np.ndarray      # int64 scalar: sum of applied weights
    markers: np.ndarray    # int32 [n]: src[0] of each applied batch, ordered
    n_applied: np.ndarray  # int64 scalar: batches applied
    gen: np.ndarray        # int32 scalar: routing generation (num_buckets)


def _gen_of(scfg: sh.ShardedConfig) -> int:
    return int(scfg.resolved_ownership().num_buckets)


def _fake_init(scfg, device=None) -> FakeState:
    return FakeState(np.int64(0), np.zeros((0,), np.int32), np.int64(0),
                     np.int32(_gen_of(scfg)))


def _check_gen(state: FakeState, my_gen: int, what: str) -> None:
    if int(state.gen) != my_gen:
        raise GenMismatch(
            f"{what} program built for routing generation {my_gen} "
            f"dispatched against snapshot generation {int(state.gen)}")


def _fake_make_update_fn_(scfg):
    my_gen = _gen_of(scfg)

    def fn(state, src, dst, w, *, dirty=None, table_dirty=None):
        _check_gen(state, my_gen, "update")
        marker = np.int32([int(np.asarray(src)[0])])
        return FakeState(
            np.int64(int(state.total) + int(np.asarray(w).sum())),
            np.concatenate([state.markers, marker]),
            np.int64(int(state.n_applied) + 1),
            state.gen)

    return fn


def _fake_make_maintain_fn_(scfg, total_threshold=0):
    my_gen = _gen_of(scfg)

    def fn(state, *, dirty=None):
        _check_gen(state, my_gen, "maintain")
        return state

    return fn


def _fake_make_query_fn(scfg, *, threshold, max_items):
    my_gen = _gen_of(scfg)

    def fn(state, src):
        _check_gen(state, my_gen, "query")
        b = int(np.asarray(src).shape[0])
        return (np.zeros((b, max_items), np.int32),
                np.zeros((b, max_items), np.float32),
                np.zeros((b,), np.int32),
                np.zeros((b,), np.int32))

    return fn


def _fake_make_topn_fn(scfg, n):
    my_gen = _gen_of(scfg)

    def fn(state):
        _check_gen(state, my_gen, "topn")
        return (np.zeros((n,), np.int32), np.zeros((n,), np.int32),
                np.zeros((n,), np.float32), np.int32(0))

    return fn


def _fake_counter_stats(state) -> Dict[str, int]:
    return {"fake_total": int(state.total),
            "fake_batches": int(state.n_applied)}


class CopyOnWriteWriter:
    """The engine's write seam under the fakes (a ``FakeState`` has no rows
    to catch up): ``write(fn)`` pins the published state, runs the owner
    programs on it (they return a new ``FakeState``), releases it and
    publishes the result — the reference's acquire -> update -> maintain ->
    publish cycle, through the same store calls."""

    def __init__(self, store):
        self.store = store

    def acquire(self):
        return self.store.acquire()

    def write(self, fn):
        snap = self.store.acquire()
        try:
            new = fn(snap.state, dirty=None, table_dirty=None)
        finally:
            self.store.release(snap)
        self.store.publish(new)
        return new


#: (module, attribute, stand-in) of every seam the fake layer patches
_SEAMS = ((sh, "init_sharded", _fake_init),
          (sh, "make_update_fn_", _fake_make_update_fn_),
          (sh, "make_maintain_fn_", _fake_make_maintain_fn_),
          (sh, "make_query_fn", _fake_make_query_fn),
          (sh, "make_topn_fn", _fake_make_topn_fn),
          (mc, "counter_stats", _fake_counter_stats),
          (epoch, "BackBufferLearner", CopyOnWriteWriter))


@contextlib.contextmanager
def fake_kernel_layer():
    """Patch the kernel layer the engine resolves at call time (the state
    constructor, the ``sh.make_*`` factories, ``mc.counter_stats``) and its
    writer, leaving every host-side code path real."""
    saved = [getattr(mod, name) for mod, name, _ in _SEAMS]
    for mod, name, fake in _SEAMS:
        setattr(mod, name, fake)
    try:
        yield
    finally:
        for (mod, name, _), real in zip(_SEAMS, saved):
            setattr(mod, name, real)


def build_engine(sched: Scheduler, *, wal_dir: Optional[str] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0,
                 **cfg_kw) -> engine_mod.ShardedEngine:
    """A real ShardedEngine over the fake kernel layer, with every lock,
    the stats dict, and the EpochStore hand-offs under schedule control."""
    base = mc.MCConfig(num_rows=8, capacity=4)
    scfg = sh.ShardedConfig(base=base, num_shards=1,
                            ownership=Ownership(num_shards=1))
    cfg = engine_mod.ShardedServeConfig(
        sharded=scfg, snapshot_dir=snapshot_dir,
        snapshot_every=snapshot_every, wal_dir=wal_dir, wal_fsync="never",
        **cfg_kw)
    eng = engine_mod.ShardedEngine(cfg, device="cpu")
    for name in eng._MCQ_LOCK_ORDER:
        setattr(eng, name, SchedLock(sched, name))
    eng.stats = InstrumentedStats(sched, dict(eng.stats))
    _instrument_store(sched, eng.store)
    # identity padding: num_shards == 1 and the fakes ignore routing shapes
    eng._pad = lambda *arrays: (*arrays, int(np.asarray(arrays[0]).shape[0]))
    eng._reingest = lambda old_state, scfg2: FakeState(
        old_state.total, old_state.markers, old_state.n_applied,
        np.int32(_gen_of(scfg2)))
    return eng


# ---------------------------------------------------------------------------
# the pre-fix bodies (three historical races of the engine)
# ---------------------------------------------------------------------------
# These are mechanical reverts of the fixed code paths of the port's engine,
# kept so the explorer provably re-finds each historical race — the
# regression contract for the explorer itself.


def _reverted_query_stats(eng, src) -> None:
    """Pre-fix ``query``: the counter read-modify-write runs outside
    ``_stats_lock`` — two concurrent queries can lose an increment."""
    t = float(eng.cfg.threshold)
    k = int(eng.cfg.max_items)
    with eng._route_lock:
        fn = eng._cached_fn(
            eng._query_fns, (t, k),
            lambda: sh.make_query_fn(eng.cfg.sharded,
                                     threshold=t, max_items=k))
        snap = eng._writer.acquire()
    src, b = eng._pad(torch.as_tensor(src, dtype=torch.int32))
    try:
        d, p, n, dropped = fn(snap.state, src)
    finally:
        eng.store.release(snap)
    # THE BUG: unguarded RMW on the shared stats dict
    eng.stats["queries"] = eng.stats["queries"] + 1
    eng.stats["query_dropped"] = (eng.stats["query_dropped"]
                                  + int(np.sum(np.asarray(dropped))))


def _reverted_query_unpaired(eng, src) -> None:
    """Pre-fix ``query``: program fetch and snapshot pin are not under
    ``_route_lock`` — a concurrent reassign can slip its swap between them
    and the reader pairs mismatched routing generations."""
    t = float(eng.cfg.threshold)
    k = int(eng.cfg.max_items)
    # THE BUG: no route lock around the (program, snapshot) pairing
    fn = eng._cached_fn(
        eng._query_fns, (t, k),
        lambda: sh.make_query_fn(eng.cfg.sharded,
                                 threshold=t, max_items=k))
    snap = eng._writer.acquire()
    src, b = eng._pad(torch.as_tensor(src, dtype=torch.int32))
    try:
        d, p, n, dropped = fn(snap.state, src)
    finally:
        eng.store.release(snap)
    with eng._stats_lock:
        eng.stats["queries"] = eng.stats["queries"] + 1


def _fresh_state(eng) -> FakeState:
    return FakeState(np.int64(0), np.zeros((0,), np.int32), np.int64(0),
                     np.int32(_gen_of(eng.cfg.sharded)))


def _reverted_restore(eng) -> int:
    """Pre-fix recovery body: the snapshot reset and each replayed record
    take the write lock *separately*.  A live ``observe`` slipping in
    mid-replay WAL-appends its batch AND the still-open replay generator
    re-reads it — applied twice."""
    with eng._write_lock:
        with eng._route_lock:
            eng.store.publish(_fresh_state(eng))
            eng._writer = epoch.BackBufferLearner(eng.store)
        eng._seq = -1
    replayed = 0
    # THE BUG: lock released between records; the generator stays open across
    # the gaps and re-reads concurrent appends when it reaches their segment
    for seq, src, dst, w in eng.wal.replay(after_seq=-1):
        with eng._write_lock:
            eng._seq = seq
            eng._apply_locked(src, dst, w)
        replayed += 1
    return replayed


def _fixed_restore(eng) -> int:
    """The shipped recovery shape (mirrors ``ShardedEngine.restore``): one
    write-lock hold end to end, reset inside, the published state swapped
    together with a writer of its own under ``_route_lock`` — a concurrent
    observe either fully precedes the recovery (its record replays once,
    its in-memory apply is reset away) or fully follows it."""
    replayed = 0
    with eng._write_lock:
        with eng._route_lock:
            eng.store.publish(_fresh_state(eng))
            eng._writer = epoch.BackBufferLearner(eng.store)
        eng._seq = -1
        for seq, src, dst, w in eng.wal.replay(after_seq=-1):
            eng._seq = seq
            eng._apply_locked(src, dst, w)
            replayed += 1
    return replayed


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


class ScenarioInstance(NamedTuple):
    threads: "OrderedDict[str, Callable[[], Any]]"
    check: Callable[[], List[str]]
    cleanup: Callable[[], None]


class Scenario:
    """A named concurrency scenario with a buggy (``reverted=True``) and a
    fixed variant sharing the same schedule space."""

    name: str = ""
    yield_tags: Optional[Tuple[str, ...]] = None

    def build(self, sched: Scheduler, reverted: bool) -> ScenarioInstance:
        raise NotImplementedError


class StatsLostUpdate(Scenario):
    """Two concurrent queries bump ``stats['queries']``; invariant: the
    count conserves (== 2).  Dynamic side of invariant I1."""

    name = "stats_lost_update"

    def build(self, sched, reverted):
        eng = build_engine(sched)
        src = np.array([3], np.int32)
        if reverted:
            body = lambda: _reverted_query_stats(eng, src)  # noqa: E731
        else:
            body = lambda: eng.query(src)                   # noqa: E731

        def check():
            out = []
            if eng.stats["queries"] != 2:
                out.append(
                    f"counter conservation: stats['queries'] == "
                    f"{eng.stats['queries']} after 2 queries (lost update)")
            if any(n != 0 for n in eng.store._readers.values()):
                out.append(f"leaked epoch readers: {eng.store._readers}")
            return out

        threads = OrderedDict((("q1", body), ("q2", body)))
        return ScenarioInstance(threads, check, lambda: None)


class RouteSnapshotMispairing(Scenario):
    """A reader races a live ``reassign``; invariant: every dispatched
    (program, snapshot) pair is generation-consistent (I8).  The fake
    programs raise :class:`GenMismatch` on a mispairing, which the explorer
    surfaces as the violation."""

    name = "route_snapshot_mispairing"

    def build(self, sched, reverted):
        eng = build_engine(sched)
        src = np.array([5], np.int32)
        eng.query(src)  # pre-warm the routed-program cache (main thread)
        new_own = Ownership(num_shards=1, num_buckets=512)
        if reverted:
            reader = lambda: _reverted_query_unpaired(eng, src)  # noqa: E731
        else:
            reader = lambda: eng.query(src)                      # noqa: E731

        def check():
            out = []
            if any(n != 0 for n in eng.store._readers.values()):
                out.append(f"leaked epoch readers: {eng.store._readers}")
            if _gen_of(eng.cfg.sharded) != int(
                    eng.store._snap.state.gen):
                out.append("installed routing and published snapshot "
                           "disagree on generation after the swap")
            return out

        threads = OrderedDict((
            ("reader", reader),
            ("rebalance", lambda: eng.reassign(new_own)),
        ))
        return ScenarioInstance(threads, check, lambda: None)


class WalDoubleReplay(Scenario):
    """Recovery races a live writer; invariant: after both finish, every
    observed batch is applied exactly once (WAL exactly-once replay, the
    dynamic side of invariant I3).

    Layout matters: 3 pre-seeded batches at ``segment_records=2`` leave a
    closed segment (seq 0, 1) and an open one (seq 2).  The replay generator
    snapshots the segment list once and reads each segment when REACHED, so
    a concurrent append (seq 3) into the open segment is re-read by a replay
    that has not reached it yet — if the recovery lets the writer in."""

    name = "wal_double_replay"
    yield_tags = ("lock:_write_lock", "store:")

    def build(self, sched, reverted):
        tmp = tempfile.mkdtemp(prefix="mcq-explorer-")
        eng = build_engine(sched, wal_dir=os.path.join(tmp, "wal"))
        eng.wal.segment_records = 2
        dst = np.array([0], np.int32)
        for marker in (0, 1, 2):   # main thread: atomic pre-seed
            eng.observe(np.array([marker], np.int32), dst)
        expected = [0, 1, 2, 99]
        restore_fn = _reverted_restore if reverted else _fixed_restore

        def check():
            out = []
            markers = sorted(int(m)
                             for m in eng.store._snap.state.markers)
            if markers != expected:
                out.append(
                    f"exactly-once replay: applied markers {markers}, "
                    f"expected {expected} (each batch exactly once)")
            if eng._seq != 3:
                out.append(f"wal position: _seq == {eng._seq}, expected 3")
            return out

        def cleanup():
            eng.wal.close()
            shutil.rmtree(tmp, ignore_errors=True)

        threads = OrderedDict((
            ("recover", lambda: restore_fn(eng)),
            ("writer", lambda: eng.observe(np.array([99], np.int32), dst)),
        ))
        return ScenarioInstance(threads, check, cleanup)


class MixedHeadScenario(Scenario):
    """HEAD-only smoke: observe / query / topn / checkpoint interleave
    freely; invariants: every counter conserves, the WAL position matches
    the applied batches, no reader leaks, no deadlock.  No reverted variant
    — this is the 'current code is clean under schedule stress' probe."""

    name = "mixed_head"

    def build(self, sched, reverted):
        assert not reverted, "mixed_head has no reverted variant"
        tmp = tempfile.mkdtemp(prefix="mcq-explorer-")
        eng = build_engine(sched, wal_dir=os.path.join(tmp, "wal"),
                          snapshot_dir=os.path.join(tmp, "snap"))
        dst = np.array([0], np.int32)
        eng.observe(np.array([1], np.int32), dst)  # seed state (atomic)

        def check():
            out = []
            stats = dict(eng.stats)
            for key, want in (("updates", 2), ("queries", 1),
                              ("topn_calls", 1), ("snapshots", 1)):
                if stats[key] != want:
                    out.append(f"counter conservation: stats[{key!r}] == "
                               f"{stats[key]}, expected {want}")
            if any(n != 0 for n in eng.store._readers.values()):
                out.append(f"leaked epoch readers: {eng.store._readers}")
            markers = sorted(int(m)
                             for m in eng.store._snap.state.markers)
            if markers != [1, 7]:
                out.append(f"applied markers {markers}, expected [1, 7]")
            return out

        def cleanup():
            eng.wal.close()
            shutil.rmtree(tmp, ignore_errors=True)

        threads = OrderedDict((
            ("writer", lambda: eng.observe(np.array([7], np.int32), dst)),
            ("query", lambda: eng.query(np.array([1], np.int32))),
            ("topn", lambda: eng.topn(4)),
            ("ckpt", lambda: eng.checkpoint(sync=True)),
        ))
        return ScenarioInstance(threads, check, cleanup)


def _bridge_failpoints(sched: Scheduler) -> None:
    """Make every failpoint site a schedule decision point: the registry
    observer fires on each hit (DESIGN.md §12 — failpoints double as the
    explorer's IO-edge yield points), so a fault can be interleaved with
    readers at exactly the instant the IO edge runs."""
    faults.set_observer(
        lambda name, ctx: sched.yield_point(f"fault:{name}"))


#: zero-delay ladder: retries are schedule steps, not wall-clock waits
_NO_BACKOFF = RetryPolicy(max_attempts=2, base_delay_s=0.0, max_delay_s=0.0)


class FaultTransientWrite(Scenario):
    """A one-shot injected WAL fault races a concurrent query; invariants:
    the retry ladder absorbs the fault invisibly (the batch lands exactly
    once, ``wal_retries`` counts one round), the reader completes cleanly
    whatever instant the fault fires, and no epoch reader leaks.  HEAD-only
    — the dynamic side of the A14 retry contract."""

    name = "fault_transient_write"
    yield_tags = ("fault:", "lock:_write_lock", "store:")

    def build(self, sched, reverted):
        assert not reverted, "fault scenarios have no reverted variant"
        tmp = tempfile.mkdtemp(prefix="mcq-explorer-")
        eng = build_engine(sched, wal_dir=os.path.join(tmp, "wal"),
                          retry=_NO_BACKOFF)
        _bridge_failpoints(sched)
        dst = np.array([0], np.int32)
        eng.observe(np.array([1], np.int32), dst)   # seed state (atomic)
        faults.arm("wal.append.write",
                   faults.FaultInjected("wal.append.write"), count=1)

        def check():
            out = []
            stats = dict(eng.stats)
            for key, want in (("updates", 2), ("queries", 1),
                              ("wal_retries", 1)):
                if stats[key] != want:
                    out.append(f"counter conservation: stats[{key!r}] == "
                               f"{stats[key]}, expected {want}")
            markers = sorted(int(m) for m in eng.store._snap.state.markers)
            if markers != [1, 7]:
                out.append(f"applied markers {markers}, expected [1, 7] "
                           f"(retried batch must land exactly once)")
            if eng._seq != 1:
                out.append(f"wal position: _seq == {eng._seq}, expected 1")
            if not eng.write_available:
                out.append("transient fault escalated to poison")
            if any(n != 0 for n in eng.store._readers.values()):
                out.append(f"leaked epoch readers: {eng.store._readers}")
            return out

        def cleanup():
            faults.reset()
            faults.set_observer(None)
            eng.wal.close()
            shutil.rmtree(tmp, ignore_errors=True)

        threads = OrderedDict((
            ("writer", lambda: eng.observe(np.array([7], np.int32), dst)),
            ("query", lambda: eng.query(np.array([1], np.int32))),
        ))
        return ScenarioInstance(threads, check, cleanup)


class FaultPoisonedWrite(Scenario):
    """A persistent injected WAL fault (ENOSPC) races a concurrent query;
    invariants: the writer escalates to ``EngineWriteUnavailable`` without
    publishing anything (markers unchanged, ``_seq`` parked), the write
    lock is released (poison is a state, not a held lock), and the reader
    serves the last published epoch cleanly at every interleaving — the
    dynamic side of the A13 escalation contract."""

    name = "fault_poisoned_write"
    yield_tags = ("fault:", "lock:_write_lock", "store:")

    def build(self, sched, reverted):
        assert not reverted, "fault scenarios have no reverted variant"
        tmp = tempfile.mkdtemp(prefix="mcq-explorer-")
        eng = build_engine(sched, wal_dir=os.path.join(tmp, "wal"),
                          retry=_NO_BACKOFF)
        _bridge_failpoints(sched)
        dst = np.array([0], np.int32)
        eng.observe(np.array([1], np.int32), dst)   # seed state (atomic)
        import errno as _errno
        faults.arm("wal.append.write",
                   faults.FaultInjected("wal.append.write", _errno.ENOSPC))
        seen = {}

        def writer():
            try:
                eng.observe(np.array([7], np.int32), dst)
            except EngineWriteUnavailable:
                seen["escalated"] = True

        def check():
            out = []
            if not seen.get("escalated"):
                out.append("persistent fault did not raise "
                           "EngineWriteUnavailable")
            if eng.write_available:
                out.append("write path not poisoned after persistent fault")
            markers = sorted(int(m) for m in eng.store._snap.state.markers)
            if markers != [1]:
                out.append(f"applied markers {markers}, expected [1] "
                           f"(faulted batch must never publish)")
            if eng._seq != 0:
                out.append(f"wal position: _seq == {eng._seq}, expected 0")
            if eng._write_lock.locked():
                out.append("write lock still held after escalation")
            if eng.stats["queries"] != 1:
                out.append(f"reader did not complete: queries == "
                           f"{eng.stats['queries']}")
            if any(n != 0 for n in eng.store._readers.values()):
                out.append(f"leaked epoch readers: {eng.store._readers}")
            return out

        def cleanup():
            faults.reset()
            faults.set_observer(None)
            eng.wal.close()
            shutil.rmtree(tmp, ignore_errors=True)

        threads = OrderedDict((
            ("writer", writer),
            ("query", lambda: eng.query(np.array([1], np.int32))),
        ))
        return ScenarioInstance(threads, check, cleanup)


RACE_SCENARIOS: Tuple[Scenario, ...] = (
    StatsLostUpdate(), RouteSnapshotMispairing(), WalDoubleReplay())

SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in RACE_SCENARIOS + (MixedHeadScenario(),
                                         FaultTransientWrite(),
                                         FaultPoisonedWrite())}


# ---------------------------------------------------------------------------
# exploration
# ---------------------------------------------------------------------------


class RunResult(NamedTuple):
    trace: Tuple[str, ...]
    runnables: Tuple[Tuple[str, ...], ...]
    violations: Tuple[str, ...]
    deadlock: bool


class Exploration(NamedTuple):
    scenario: str
    reverted: bool
    mode: str
    runs: int
    exhausted: bool          # DFS drained its frontier within max_runs
    violations: Tuple[RunResult, ...]

    @property
    def found(self) -> bool:
        return bool(self.violations)

    @property
    def first_trace(self) -> Optional[Tuple[str, ...]]:
        return self.violations[0].trace if self.violations else None


def _run_once(scenario: Scenario, reverted: bool,
              controller) -> RunResult:
    sched = Scheduler(scenario.yield_tags)
    with fake_kernel_layer():
        inst = scenario.build(sched, reverted)
        try:
            for name, fn in inst.threads.items():
                sched.spawn(name, fn)
            sched.run(controller)
            violations: List[str] = []
            if sched.deadlock:
                held = {name: ts.tag
                        for name, ts in sched._threads.items()
                        if not ts.done}
                violations.append(f"deadlock: no runnable thread, "
                                  f"blocked at {held}")
            for name, ts in sched._threads.items():
                if ts.error is not None:
                    violations.append(
                        f"{name}: {type(ts.error).__name__}: {ts.error}")
            if not sched.deadlock:
                violations.extend(inst.check())
        finally:
            inst.cleanup()
    if getattr(controller, "diverged", False):
        violations.append("schedule replay diverged (scenario is not "
                          "yield-deterministic)")
    return RunResult(tuple(sched.trace), tuple(sched.runnables),
                     tuple(violations), sched.deadlock)


def _preemptions(trace: Sequence[str],
                 runnables: Sequence[Tuple[str, ...]]) -> int:
    n = 0
    for i in range(1, len(trace)):
        if trace[i] != trace[i - 1] and trace[i - 1] in runnables[i]:
            n += 1
    return n


def explore(scenario: Scenario, *, reverted: bool, mode: str = "dfs",
            preemption_bound: int = 2, max_runs: int = 4000,
            random_runs: int = 64, seed: int = 0,
            stop_on_violation: bool = True) -> Exploration:
    """Explore the scenario's schedule space.

    ``dfs``: exhaustive over schedules with at most ``preemption_bound``
    preemptions (a context switch away from a still-runnable thread), the
    CHESS result that most concurrency bugs need very few.  ``random``:
    ``random_runs`` seeded uniform schedules.  Both are deterministic.
    """
    violations: List[RunResult] = []
    runs = 0
    exhausted = False
    if mode == "dfs":
        stack: List[List[str]] = [[]]
        while stack and runs < max_runs:
            prefix = stack.pop()
            res = _run_once(scenario, reverted, _PrefixController(prefix))
            runs += 1
            if res.violations:
                violations.append(res)
                if stop_on_violation:
                    break
            # branch: alternatives at every decision at/after the prefix
            # (earlier points were branched when this prefix was created)
            for i in range(len(prefix), len(res.trace)):
                for alt in res.runnables[i]:
                    if alt == res.trace[i]:
                        continue
                    cand = list(res.trace[:i]) + [alt]
                    if _preemptions(cand, res.runnables) <= preemption_bound:
                        stack.append(cand)
        exhausted = not stack
    elif mode == "random":
        rng = random.Random(seed)
        for _ in range(random_runs):
            if runs >= max_runs:
                break
            res = _run_once(scenario, reverted, _RandomController(rng))
            runs += 1
            if res.violations:
                violations.append(res)
                if stop_on_violation:
                    break
        exhausted = False
    else:
        raise ValueError(f"unknown mode {mode!r} (dfs | random)")
    return Exploration(scenario.name, reverted, mode, runs, exhausted,
                       tuple(violations))


def replay(scenario: Scenario, *, reverted: bool,
           trace: Sequence[str]) -> RunResult:
    """Re-run one recorded schedule; bit-identical by construction."""
    return _run_once(scenario, reverted, _PrefixController(trace))


# ---------------------------------------------------------------------------
# CLI: the smoke gate
# ---------------------------------------------------------------------------


def _xml_escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def _write_junit(path: str, cases: List[Tuple[str, Optional[str]]]) -> None:
    failures = sum(1 for _, msg in cases if msg is not None)
    lines = ['<?xml version="1.0" encoding="utf-8"?>',
             f'<testsuite name="explorer" tests="{len(cases)}" '
             f'failures="{failures}">']
    for name, msg in cases:
        lines.append(f'  <testcase classname="repro_torch.analysis.explorer" '
                     f'name="{_xml_escape(name)}">')
        if msg is not None:
            lines.append(f'    <failure message="violation">'
                         f'{_xml_escape(msg)}</failure>')
        lines.append('  </testcase>')
    lines.append('</testsuite>')
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _smoke(junit: Optional[str], seed: int) -> int:
    """The gate: every historical race is re-found when its fix is
    reverted, every scenario is clean on the current code."""
    cases: List[Tuple[str, Optional[str]]] = []
    ok = True
    for scenario in RACE_SCENARIOS:
        rev = explore(scenario, reverted=True)
        msg = None
        if not rev.found:
            msg = (f"explorer failed to re-find the reverted race "
                   f"({rev.runs} schedules explored)")
        else:
            seen = replay(scenario, reverted=True, trace=rev.first_trace)
            if not seen.violations:
                msg = "violating schedule did not replay deterministically"
        cases.append((f"{scenario.name}:reverted", msg))
        ok &= msg is None
        status = "ok" if msg is None else "FAIL"
        detail = (f"violation in {rev.runs} schedules, trace length "
                  f"{len(rev.first_trace or ())}" if rev.found
                  else "no violation")
        print(f"[explorer] {scenario.name:28s} reverted: {status} "
              f"({detail})")
    for scenario in SCENARIOS.values():
        head = explore(scenario, reverted=False, stop_on_violation=True)
        msg = None
        if head.found:
            first = head.violations[0]
            msg = (f"violation on HEAD: {'; '.join(first.violations)} "
                   f"(trace {' '.join(first.trace)})")
        cases.append((f"{scenario.name}:head", msg))
        ok &= msg is None
        status = "ok" if msg is None else "FAIL"
        print(f"[explorer] {scenario.name:28s} head:     {status} "
              f"({head.runs} schedules, "
              f"{'exhausted' if head.exhausted else 'capped'})")
    # seeded random stress on the mixed scenario rides on top of its DFS
    mixed = SCENARIOS["mixed_head"]
    rnd = explore(mixed, reverted=False, mode="random", random_runs=64,
                  seed=seed)
    msg = None
    if rnd.found:
        first = rnd.violations[0]
        msg = f"violation on HEAD (random): {'; '.join(first.violations)}"
    cases.append(("mixed_head:random", msg))
    ok &= msg is None
    print(f"[explorer] mixed_head random ({rnd.runs} schedules, seed "
          f"{seed}): {'ok' if msg is None else 'FAIL'}")
    if junit:
        _write_junit(junit, cases)
    return 0 if ok else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.explorer",
        description="deterministic interleaving explorer for the engine")
    ap.add_argument("--smoke", action="store_true",
                    help="run the gate: reverted races re-found, HEAD "
                         "clean")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS),
                    help="explore one scenario")
    ap.add_argument("--reverted", action="store_true",
                    help="use the pre-fix body (race scenarios only)")
    ap.add_argument("--mode", choices=("dfs", "random"), default="dfs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=64,
                    help="random-mode schedule count")
    ap.add_argument("--junit", help="write a junit XML report here")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.junit, args.seed)
    if not args.scenario:
        ap.error("need --smoke or --scenario")
    result = explore(SCENARIOS[args.scenario], reverted=args.reverted,
                     mode=args.mode, seed=args.seed,
                     random_runs=args.runs, stop_on_violation=True)
    print(f"{result.scenario}: {result.runs} schedules explored "
          f"({'exhausted' if result.exhausted else 'capped'})")
    for res in result.violations:
        print(f"  violation: {'; '.join(res.violations)}")
        print(f"  schedule:  {' '.join(res.trace)}")
    return 1 if result.found else 0


if __name__ == "__main__":
    sys.exit(main())
