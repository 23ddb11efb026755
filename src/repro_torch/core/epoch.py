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
holds: every function of ``repro_torch.core`` returns new tensors and never
writes into a tensor of the state it was given, which is what lets a reader
go on using a snapshot while the learner builds the next one from it.
"""

from __future__ import annotations

import threading
import time
from typing import Any, NamedTuple

from repro_torch.analysis.invariants import requires_lock


class Snapshot(NamedTuple):
    version: int
    state: Any  # immutable state (e.g. MCState)


class EpochStore:
    """Single-writer / many-reader snapshot store with reader accounting."""

    # Concurrency contract (checked by tools/mcqlint): ``_lock`` guards the
    # reader accounting only.  ``_snap`` is deliberately NOT declared
    # protected — the single atomic reference swap under the GIL is the
    # lock-free read path the whole design rests on.  Globally, ``_lock``
    # ranks below every engine lock (it is only ever taken inside store calls
    # and never holds while calling out).
    _MCQ_LOCK_ORDER = ("_lock",)
    _MCQ_LOCK_PROTECTS = {
        "_lock": ("_readers", "retired_versions"),
    }

    def __init__(self, state: Any):
        self._snap = Snapshot(0, state)
        self._readers: dict[int, int] = {}
        self._lock = threading.Lock()  # protects accounting only, never reads
        self.retired_versions: list[int] = []

    # -- read side -------------------------------------------------------
    def acquire(self) -> Snapshot:
        """Enter a read-side critical section: pin the current snapshot."""
        snap = self._snap  # atomic ref read (GIL)
        with self._lock:
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
