"""Epoch snapshots: the RCU grace-period analogue.

Counterpart of ``repro.core.epoch``.  In the paper, readers run inside RCU
read-side critical sections; writers mutate concurrently and reclamation
waits for a grace period.  Here a *published snapshot* — an immutable state
such as an ``MCState`` of torch tensors — plays the role of the
RCU-protected structure, and the "grace period" is the moment no consumer
can reference version ``v-1`` any more.

``EpochStore`` is the host-side coordinator: serving threads ``acquire()`` a
snapshot (read-side critical section enter), while the learner thread
``publish()``-es new versions.  Python reference assignment is atomic under
the GIL, so readers never observe a torn snapshot — the lock-free property.
``retired_versions`` mirrors RCU's deferred reclamation: a version is retired
once its reader count drops to zero AND a newer version exists.

Torch tensors are mutable, so the store is only as good as the states it
holds: the functional calls of ``repro_torch.core`` return new tensors and
never write into a tensor of the state they were given, which is what lets
a reader go on using a snapshot while the learner builds the next one from
it.  ``BackBufferLearner`` makes the copy of read-copy-update a copy of
what changed: it writes in place (the owner calls) into a second state that
no reader holds any more, after catching that state up with the published
one by the rows and src-table slots the last write flagged.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.analysis.invariants import requires_lock
from repro_torch.core import hashtable as ht
from repro_torch.core import mcprioq as mc
from repro_torch.kernels import ops


class Snapshot(NamedTuple):
    version: int
    state: Any  # immutable state (e.g. MCState)


class EpochStore:
    """Single-writer / many-reader snapshot store with reader accounting."""

    # Concurrency contract (checked by tools/mcqlint): ``_lock`` guards the
    # reader accounting only.  ``_snap`` is deliberately NOT declared
    # protected — the single atomic reference swap under the GIL is the
    # lock-free read path the whole design rests on; ``acquire`` reads it
    # under the lock only so that the read and the reader's registration
    # cannot straddle a ``publish`` that retires the version.  Globally,
    # ``_lock`` ranks below every engine lock (it is only ever taken inside
    # store calls and never holds while calling out).
    _MCQ_LOCK_ORDER = ("_lock",)
    _MCQ_LOCK_PROTECTS = {
        "_lock": ("_readers", "retired_versions"),
    }

    def __init__(self, state: Any):
        self._snap = Snapshot(0, state)
        self._readers: dict[int, int] = {}
        self._lock = threading.Lock()  # protects the reader accounting
        self.retired_versions: list[int] = []

    # -- read side -------------------------------------------------------
    def acquire(self) -> Snapshot:
        """Enter a read-side critical section: pin the current snapshot.

        The snapshot is read under the lock: read before it, a ``publish``
        could retire the version in between, and the reader would pin a
        retired version (whose buffers a back-buffer learner reuses)."""
        with self._lock:
            snap = self._snap
            self._readers[snap.version] = self._readers.get(snap.version, 0) + 1
        return snap

    def release(self, snap: Snapshot) -> None:
        """Leave the read-side critical section; may trigger reclamation."""
        with self._lock:
            self._readers[snap.version] -= 1
            self._maybe_retire_locked()

    # -- write side ------------------------------------------------------
    def publish(self, state: Any) -> int:
        """Publish a new version. Readers acquired before this keep seeing the
        old snapshot until they release — never a torn state."""
        new = Snapshot(self._snap.version + 1, state)
        old = self._snap
        self._snap = new  # the single atomic "pointer swap"
        with self._lock:
            self._readers.setdefault(old.version, self._readers.get(old.version, 0))
            self._maybe_retire_locked()
        return new.version

    def synchronize(self, poll_interval: float = 1e-4) -> None:
        """Block until every reader of pre-current versions has released —
        the literal ``synchronize_rcu()``.  Polls with a short exponential
        backoff: a tight loop re-acquiring ``self._lock`` would starve the
        very readers it waits on under the GIL (they need the lock to
        release).
        """
        cur = self._snap.version
        delay = poll_interval
        while True:
            with self._lock:
                if all(n == 0 for v, n in self._readers.items() if v < cur):
                    return
            time.sleep(delay)
            delay = min(delay * 2, 0.01)

    # -- reclamation -----------------------------------------------------
    @requires_lock("_lock")
    def _maybe_retire_locked(self) -> None:
        cur = self._snap.version
        for v in sorted(self._readers):
            if v < cur and self._readers[v] == 0:
                del self._readers[v]
                self.retired_versions.append(v)

    @property
    def version(self) -> int:
        return self._snap.version


def _chain(state) -> mc.MCState:
    """The chain of a published state: an ``MCState``, or a state that
    holds one as ``.chain`` (``speculative.DrafterState``)."""
    return getattr(state, "chain", state)


def _scalars(chain: mc.MCState) -> torch.Tensor:
    """The scalar leaves of a chain as one flat int32 view: ``[10]`` of a
    chain, ``[S·10]`` of a stacked state (``core.sharded``: the scalars are
    the columns of one contiguous ``[S, 10]`` tensor).  Raises when they
    are not packed so."""
    if chain.n_rows.dim() == 0:
        return mc.scalars_of(chain)
    k = len(mc.SCALAR_FIELDS)
    mc.scalars_of(mc.map_leaves(lambda x: x[0], chain))   # shard 0 packed
    if chain.n_rows.dim() != 1 or chain.n_rows.stride() != (k,):
        raise ValueError("the stacked scalar leaves are not the columns of "
                         "one contiguous [S, 10] int32 tensor")
    return chain.n_rows.as_strided((chain.n_rows.shape[0] * k,), (1,))


def _copied(chain: mc.MCState):
    """What ``ops.copy_dirty_rows`` takes of a chain: the slab rows, the src
    table, the scalars and the row hashes (their rows are written under the
    same flags as the slab's).  A stacked state's leaves are contiguous, so
    its ``S·N`` rows, ``S·T`` table slots and ``S·10`` scalars are flat
    views of them: one catch-up for every shard."""
    slabs = chain.slabs
    c, h = slabs.cnt.shape[-1], chain.dh_keys.shape[-1]
    return (slabs.cnt.view(-1, c), slabs.dst.view(-1, c),
            slabs.order.view(-1, c), slabs.tot.view(-1),
            *(x.view(-1) for x in chain.src_table), _scalars(chain),
            chain.dh_keys.view(-1, h), chain.dh_vals.view(-1, h))


def _leaves(chain: mc.MCState):
    return (*chain.slabs, *chain.src_table, chain.dh_keys, chain.dh_vals,
            *(getattr(chain, f) for f in mc.SCALAR_FIELDS))


class BackBufferLearner:
    """The single writer of an ``EpochStore``, writing in place.

    It keeps two states: the *front*, the version it published last, which
    readers may hold, and a private *back*, a version no reader holds any
    more.  :meth:`write` waits for the back's readers to leave (the store's
    reader accounting: ``synchronize``), catches the back up with the front
    (the catch-up kernel: the rows the last write changed, flagged in
    ``dirty``, their row hashes included, the src-table slot groups it
    wrote, flagged in ``table_dirty``, and the scalars), applies the
    owner's in-place write to the back with the flags tracking it,
    publishes the back and swaps the roles.  Two states' memory, and per
    write what the last write changed instead of a copy of the state.
    The catch-up's tensors are checked once, here: it is bound for both
    directions (``ops.bind_copy_dirty_rows``), and a write launches the
    bound one (``ops.copy_bound_rows``).

    The store's current state must be one the learner owns from now on
    (built by ``init``: its scalar leaves are views of one tensor); the back
    starts as a ``mcprioq.private_copy`` of it.  A state is an ``MCState``
    or holds one as ``.chain``, or a stacked state of S shards
    (``core.sharded``, any S): its flags are ``[S, N]`` and ``[S, G]``
    (``G = hashtable.flag_count(T)``), and one catch-up launch covers every
    shard.

    Stream rule: a host ``release`` does not mean the device has finished
    reading.  Readers must launch on the learner's stream (the current
    stream when the learner was made), so that their kernels run before
    the learner's next writes into the version they read; :meth:`acquire`
    and :meth:`write` check it.  Nothing here synchronises the host with
    the device.

    Lane rule (a rank group's reader lanes, ``ShardedEngine(ranks=)``): a
    reader whose collectives run on a communicator of their own must not
    queue them on the learner's stream — two ranks could queue the
    writer's and a lane's collectives there in different orders, and an
    NCCL collective holds its stream until every peer joins.  Such a
    reader launches on a stream of its own and pins with
    :meth:`acquire_lane`: its stream waits on the event the learner
    recorded after its writes into the version acquired (before the
    publish), and the reader releases the version only after a host read
    that follows every kernel of the read (the engine synchronises the
    lane's stream before it releases).  So the learner's next write into
    that version still comes after the read.
    ``tests/test_torch_engine_ranks.py::test_a_lane_holds_its_version_
    until_it_releases`` pins the host half; the card half runs in
    ``chip_smoke.py``'s phase ranks.
    """

    def __init__(self, store: EpochStore):
        self.store = store
        snap = store.acquire()
        store.release(snap)
        self._front = snap.state
        chain = _chain(snap.state)
        _scalars(chain)   # raises unless packed (the learner writes in place)
        back = mc.private_copy(chain)
        self._back = (snap.state._replace(chain=back)
                      if hasattr(snap.state, "chain") else back)
        device = chain.slabs.tot.device
        self._dirty = torch.zeros(chain.slabs.tot.shape, dtype=torch.uint8,
                                  device=device)
        keys = chain.src_table.keys
        self._table_dirty = torch.zeros(
            keys.shape[:-1] + (ht.flag_count(keys.shape[-1]),),
            dtype=torch.uint8, device=device)
        flags = (self._dirty.view(-1), self._table_dirty.view(-1))
        a, b = _copied(chain), _copied(_chain(self._back))
        # the catch-up before a write into the back: front -> back, and
        # after the swap the other way
        self._catch_up = (ops.bind_copy_dirty_rows(a, b, *flags),
                          ops.bind_copy_dirty_rows(b, a, *flags))
        self._turn = 0
        self._stream = (torch.cuda.current_stream(device)
                        if self._dirty.is_cuda else None)
        # the event after the writes into each version (by its first
        # leaf's storage): what a lane's stream waits on
        self._ready = {}
        self._mark_ready(self._front)

    def _mark_ready(self, state) -> None:
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
            self._ready[_chain(state).slabs.cnt.data_ptr()] = event

    def _check_stream(self, who: str) -> None:
        if self._stream is not None and \
                torch.cuda.current_stream(self._dirty.device) != self._stream:
            raise RuntimeError(
                f"{who} is not on the learner's stream: its kernels could "
                f"still read a version the learner writes into next")

    def acquire(self) -> Snapshot:
        """A reader's ``store.acquire``, on the learner's stream (checked).
        Leave with ``store.release``."""
        self._check_stream("a reader")
        return self.store.acquire()

    def acquire_lane(self, stream=None) -> Snapshot:
        """A lane reader's ``store.acquire`` (the lane rule above):
        ``stream`` (a CUDA state's; current, checked) waits on the writes
        into the version acquired.  Leave with ``store.release`` once the
        host has read the read's last result."""
        if self._stream is None:
            return self.store.acquire()
        if stream is None or stream == self._stream or \
                torch.cuda.current_stream(self._dirty.device) != stream:
            raise RuntimeError("a lane reader runs on a stream of its own, "
                               "current while it reads")
        snap = self.store.acquire()
        stream.wait_event(self._ready[_chain(snap.state).slabs.cnt.data_ptr()])
        return snap

    def write(self, fn: Callable, *args, **kwargs):
        """Publish ``fn(back, *args, dirty=flags, table_dirty=table_flags,
        **kwargs)``: an owner call (``update_batch_``,
        ``speculative.observe_``, ``sharded.update_`` ..., or a function of
        several) that writes into the state it is given, flags the rows it
        changes and the src-table slots it writes, and returns that state.
        Returns the state published."""
        self._check_stream("the learner")
        self.store.synchronize()     # the back's version has no reader left
        ops.copy_bound_rows(self._catch_up[self._turn])
        back = _chain(self._back)
        new = fn(self._back, *args, dirty=self._dirty,
                 table_dirty=self._table_dirty, **kwargs)
        if [x.data_ptr() for x in _leaves(_chain(new))] != \
                [x.data_ptr() for x in _leaves(back)]:
            raise RuntimeError("the learner's write returned other tensors "
                               "than the back state's: it must write in place")
        self._mark_ready(new)
        self.store.publish(new)
        self._front, self._back = new, self._front
        self._turn ^= 1
        return new
