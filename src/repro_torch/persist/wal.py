"""Append-only write-ahead log of observed transition batches (DESIGN.md §10).

Counterpart of ``repro.persist.wal``, host-only Python kept line for line:
the same record format, so either package replays the other's log.

The learner's input is a stream of ``(src, dst, w)`` int32 batches; every
state transition of the chain is a pure function of (previous state, batch),
so logging the *batches* — not the state deltas — makes recovery a replay:
``restore(latest snapshot)`` then re-apply every record with
``seq > snapshot.wal_seq`` through the same update pipeline.  Determinism of
``update_batch`` / ``maybe_decay`` (pre-aggregation sorts are stable, the
slow path is a sequential scan, kernels are bit-exact across impls) makes
the replay reproduce the pre-crash state *bit-exactly* on the unsharded
path — tested, not assumed.

Format: segments ``wal_<first_seq:016d>.seg`` of length-framed records::

    header  = <4s I q i>  magic 'MCWL', crc32(payload), seq, n_items
    payload = src[n] int32le + dst[n] int32le + w[n] int32le

A record is valid iff the header is whole, the magic matches, the payload is
whole and the CRC agrees.  An invalid record ends its *segment* — the torn
tail a crash mid-append leaves is as if the record never happened (its batch
was also never applied: append happens *before* apply, hence write-AHEAD).
Later segments are still replayed, but only while sequence numbers stay
contiguous: after a crash the writer resumes exactly at the torn record's
seq in a fresh segment (so the chain continues through the tear), whereas a
genuine mid-log gap (bit rot swallowing whole records with valid data
after) breaks contiguity and replay refuses to resurrect anything past it.

fsync policy (assumption A11): ``always`` fsyncs file data after every
append (strongest; one fsync per batch), ``rotate`` (default) fsyncs on
segment close and relies on the OS for the open segment (bounded loss: at
most one segment of batches), ``never`` leaves it all to the OS.  Directory
entries are fsynced on segment create/close under ``always``/``rotate``.
Because rotation is the durability point under ``rotate``, a failed
rotation fsync there raises :class:`SegmentRotationError` (persistent, no
retry) so the caller escalates instead of trusting a segment that may not
survive power loss; under ``always`` the same failure is swallowed and
counted (``io_errors``) — every record is already individually durable.
``close()`` always swallows (counted): it must not mask the caller's
shutdown path, so under ``rotate`` the final segment's durability after a
failing close is best-effort — an engine that needs better runs
``checkpoint()`` before ``close()``.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.faults import failpoint
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime.fault_tolerance import UnretryableIOError

_MAGIC = b"MCWL"
_HEADER = struct.Struct("<4sIqi")

FSYNC_POLICIES = ("always", "rotate", "never")


class SegmentRotationError(UnretryableIOError):
    """Rotation failed under policy ``rotate`` — the rotation fsync IS the
    segment's durability point there, so every acknowledged record of the
    segment may be lost on power failure.  Classified persistent (no
    retry: the failed append-side retry would re-log the just-written
    record under a new seq and double-apply it on replay); the engine's
    escalation ladder poisons the write path instead and ``restore()``
    re-aligns state with whatever actually survived."""


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _valid_prefix(data: bytes) -> int:
    """Byte length of the structurally-valid record prefix of a segment
    (whole header, magic, whole payload, CRC agrees).  Everything past it
    is a torn tail or garbage from an aborted append."""
    off = 0
    while off + _HEADER.size <= len(data):
        magic, crc, _, n = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + 3 * 4 * n
        if magic != _MAGIC or n < 0 or end > len(data):
            break
        if zlib.crc32(data[off + _HEADER.size:end]) != crc:
            break
        off = end
    return off


class WriteAheadLog:
    """Segmented, CRC-framed, fsync-policied append log of int32 batches."""

    def __init__(self, directory: str, *, segment_records: int = 256,
                 fsync: str = "rotate",
                 metrics: Optional[obs_metrics.Registry] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync must be one of {FSYNC_POLICIES}")
        # telemetry (DESIGN.md §13): append/fsync/rotate latency
        # histograms; armed-only, standalone WALs record to the global
        # registry
        self.metrics = metrics if metrics is not None else obs_metrics.GLOBAL
        if segment_records < 1:
            raise ValueError("segment_records must be >= 1")
        self.directory = directory
        self.segment_records = segment_records
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._fh = None
        self._fh_records = 0
        # guards the writer file handle vs truncate_through: snapshot GC
        # runs on async snapshot completion threads while the engine's
        # writer keeps appending (appends themselves stay serialised by the
        # engine's write lock; this mutex only makes GC safe against them)
        self._mu = threading.Lock()
        #: swallowed IO faults (rotate/close failures after the record was
        #: already durable) — surfaced into engine stats, never raised
        self.io_errors = 0
        self._next_seq = self._scan_next_seq()

    # -- discovery ------------------------------------------------------
    def _segments(self):
        if not os.path.isdir(self.directory):
            return []
        names = sorted(n for n in os.listdir(self.directory)
                       if n.startswith("wal_") and n.endswith(".seg"))
        return [os.path.join(self.directory, n) for n in names]

    def _scan_next_seq(self) -> int:
        last = -1
        for _, seq, *_ in self._iter_records():
            last = max(last, seq)
        return last + 1

    # -- write side -----------------------------------------------------
    def append(self, src, dst, w=None) -> int:
        """Durably log one batch; returns its sequence number.  Call BEFORE
        applying the batch to the chain (write-ahead ordering)."""
        src = np.asarray(src, dtype="<i4").reshape(-1)
        dst = np.asarray(dst, dtype="<i4").reshape(-1)
        w = (np.ones_like(src) if w is None
             else np.asarray(w, dtype="<i4").reshape(-1))
        if not (src.size == dst.size == w.size):
            raise ValueError(
                f"ragged batch: {src.size}/{dst.size}/{w.size} items")
        with self._mu:
            t_append = time.monotonic()
            seq = self._next_seq
            payload = src.tobytes() + dst.tobytes() + w.tobytes()
            record = _HEADER.pack(_MAGIC, zlib.crc32(payload), seq,
                                  src.size) + payload
            if self._fh is None:
                self._open_segment_locked(seq)
            start = self._fh.tell()
            try:
                failpoint("wal.append.write", fh=self._fh, record=record,
                          seq=seq)
                self._fh.write(record)
                self._fh.flush()
                if self.fsync == "always":
                    failpoint("wal.append.fsync", fh=self._fh, seq=seq)
                    t_fsync = time.monotonic()
                    os.fsync(self._fh.fileno())
                    self.metrics.hist_record(
                        "wal.fsync", time.monotonic() - t_fsync)
            except Exception:
                # the record was NOT acknowledged: scrub whatever partial
                # bytes landed so a retry (same seq) or a later append
                # never writes after garbage mid-segment.  If even the
                # truncate fails, abandon the handle — the next append
                # opens a fresh segment at this seq, which replay accepts
                # (same contiguity rule as crash-resume).
                try:
                    self._fh.truncate(start)
                    self._fh.seek(start)
                except Exception:
                    self._abandon_segment_locked()
                raise
            self._fh_records += 1
            self._next_seq = seq + 1
            if self._fh_records >= self.segment_records:
                # Rotation failure handling depends on where durability
                # lives (A11).  Under 'always' every record is already
                # fsynced, so a failed close costs nothing durable:
                # swallow, count, abandon the segment (raising would make
                # the caller retry an acknowledged record under a new seq
                # — double apply on replay).  Under 'rotate' the rotation
                # fsync IS the durability point of the whole segment:
                # swallowing would acknowledge records that may vanish on
                # power loss, so escalate with an unretryable error — the
                # engine poisons its write path and restore() re-aligns.
                # Under 'never' durability is best-effort by contract.
                try:
                    self._rotate_locked()
                except Exception as exc:
                    self.io_errors += 1
                    self._abandon_segment_locked()
                    if self.fsync == "rotate":
                        raise SegmentRotationError(
                            0, f"segment rotation failed under policy "
                               f"'rotate': {exc!r}") from exc
            self.metrics.hist_record(
                "wal.append", time.monotonic() - t_append)
        return seq

    def _open_segment_locked(self, seq: int) -> None:
        path = os.path.join(self.directory, f"wal_{seq:016d}.seg")
        failpoint("wal.segment_open", path=path)
        if os.path.exists(path) and os.path.getsize(path):
            # crash-resume collision: a previous run tore this segment's
            # FIRST record (otherwise our resume seq would be past it).
            # Appending after the torn bytes would hide every new record
            # from replay, so cut the file back to its valid prefix.
            with open(path, "rb") as f:
                data = f.read()
            keep = _valid_prefix(data)
            if keep < len(data):
                with open(path, "r+b") as f:
                    f.truncate(keep)
        self._fh = open(path, "ab")
        self._fh_records = 0
        if self.fsync != "never":
            _fsync_dir(self.directory)

    def _abandon_segment_locked(self) -> None:
        fh, self._fh, self._fh_records = self._fh, None, 0
        if fh is not None:
            try:
                fh.close()
            except Exception:
                self.io_errors += 1

    def _rotate_locked(self) -> None:
        if self._fh is None:
            return
        t_rotate = time.monotonic()
        failpoint("wal.rotate", fh=self._fh)
        if self.fsync in ("always", "rotate"):
            os.fsync(self._fh.fileno())
        self._fh.close()
        self._fh = None
        self._fh_records = 0
        self.metrics.hist_record("wal.rotate", time.monotonic() - t_rotate)

    def close(self) -> None:
        with self._mu:
            try:
                self._rotate_locked()
            except Exception:
                # every acknowledged record is already as durable as the
                # fsync policy promises; a failing close must not mask
                # the caller's shutdown path
                self.io_errors += 1
                self._abandon_segment_locked()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- read side ------------------------------------------------------
    def _iter_records(self):
        """Yield ``(path, seq, src, dst, w)`` in strictly contiguous
        sequence order.

        An invalid record (bad magic/length/CRC, or a trailing partial —
        the torn tail of a crash mid-append) ends its segment; scanning
        continues with the next segment, because a post-crash writer
        resumes at the torn seq in a fresh segment (the tear hides no
        acknowledged record).  Contiguity is enforced across everything
        yielded: a segment whose first record does not follow the previous
        yielded seq means records were *lost* mid-log, and everything past
        that gap is untrusted — stop."""
        expected = None
        for path in self._segments():
            with open(path, "rb") as f:
                data = f.read()
            off = 0
            while off + _HEADER.size <= len(data):
                magic, crc, seq, n = _HEADER.unpack_from(data, off)
                end = off + _HEADER.size + 3 * 4 * n
                if magic != _MAGIC or n < 0 or end > len(data):
                    break  # torn/corrupt: ends this segment only
                payload = data[off + _HEADER.size:end]
                if zlib.crc32(payload) != crc:
                    break
                if expected is not None and seq < expected:
                    # duplicate from a retried append whose first write
                    # was durable but unacknowledged (fsync raised after
                    # the data landed): same seq, same payload — skip it
                    off = end
                    continue
                if expected is not None and seq > expected:
                    return  # gap: records lost, stop trusting the log
                src = np.frombuffer(payload, dtype="<i4", count=n)
                dst = np.frombuffer(payload, dtype="<i4", count=n,
                                    offset=4 * n)
                w = np.frombuffer(payload, dtype="<i4", count=n,
                                  offset=8 * n)
                yield path, seq, src, dst, w
                expected = seq + 1
                off = end

    def replay(self, after_seq: int = -1
               ) -> Iterator[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
        """Yield ``(seq, src, dst, w)`` for every durable record with
        ``seq > after_seq``, in sequence order."""
        for _, seq, src, dst, w in self._iter_records():
            if seq > after_seq:
                yield seq, src, dst, w

    # -- maintenance ----------------------------------------------------
    def truncate_through(self, seq: int) -> int:
        """Delete segments made redundant by a snapshot at ``seq`` (every
        record of the segment has ``seq' <= seq``).  Returns the number of
        segments removed.  Conservative: a segment containing any newer
        record is kept whole.  Safe against a concurrent appender (the
        engine's snapshot-cadence GC runs this from async snapshot
        completion threads): the writer mutex pins the open segment while
        the unlink decisions are made."""
        removed = 0
        with self._mu:
            keep_from: Optional[str] = None
            last_by_path: dict = {}
            for path, rec_seq, *_ in self._iter_records():
                last_by_path[path] = rec_seq
            for path in self._segments():
                if path == (self._fh and self._fh.name):
                    continue  # never unlink the open segment
                if (last_by_path.get(path, seq + 1) <= seq
                        and keep_from is None):
                    os.unlink(path)
                    removed += 1
                else:
                    keep_from = keep_from or path
        return removed

    def resume_at(self, next_seq: int) -> None:
        """Fast-forward the writer's sequence counter (restore path).
        After :meth:`truncate_through` unlinked every segment, a fresh
        process's scan finds an empty directory and would restart at 0 —
        colliding with records the snapshot already covers.  The snapshot
        meta's ``wal_seq`` is the durable authority; never rewinds."""
        with self._mu:
            self._next_seq = max(self._next_seq, int(next_seq))

    @property
    def next_seq(self) -> int:
        return self._next_seq

    @property
    def last_seq(self) -> int:
        return self._next_seq - 1
