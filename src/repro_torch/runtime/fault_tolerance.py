"""Fault-tolerance runtime: straggler watchdog, failure policy, elastic mesh.

Counterpart of ``repro.runtime.fault_tolerance``: numpy-only, kept line
for line.

On a real pod these hooks wire into the launcher (SIGTERM from the resource
manager, ICI heartbeat failures, per-step deadlines).  The policies are pure
and unit-testable here; the container can only simulate events.

Flow (train.py): every step runs under ``StepWatchdog``; a missed deadline
increments the straggler count and (policy) triggers a checkpoint-now; a
device failure raises, the launcher calls ``plan_elastic_remesh`` to get the
largest healthy mesh, and ``ckpt.restore`` re-shards onto it — training
resumes within one checkpoint interval (DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import random
import threading
import time
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class WatchdogConfig:
    deadline_s: float = 60.0          # per-step wall-clock budget
    max_consecutive_slow: int = 3     # then escalate
    checkpoint_on_escalate: bool = True


class StepWatchdog:
    """Per-step deadline monitor (straggler mitigation, host side).

    On TPU pods, a straggling step usually means a flaky host or a
    pre-empted neighbour; the mitigation at this layer is (1) record, (2)
    escalate to checkpoint-now so a kill loses nothing, (3) let the launcher
    decide on re-mesh.  Detection must be host-side wall clock — device-side
    collectives just hang.
    """

    def __init__(self, cfg: WatchdogConfig,
                 on_escalate: Optional[Callable[[], None]] = None):
        self.cfg = cfg
        self.on_escalate = on_escalate
        self.slow_steps: List[Tuple[int, float]] = []
        self._consecutive = 0
        self._step = 0

    def observe(self, duration_s: float) -> bool:
        """Record one step duration. Returns True if escalation fired."""
        self._step += 1
        if duration_s > self.cfg.deadline_s:
            self.slow_steps.append((self._step, duration_s))
            self._consecutive += 1
        else:
            self._consecutive = 0
        if self._consecutive >= self.cfg.max_consecutive_slow:
            self._consecutive = 0
            if self.on_escalate is not None:
                self.on_escalate()
            return True
        return False

    def timed(self, fn, *args, **kw):
        t0 = time.monotonic()
        out = fn(*args, **kw)
        self.observe(time.monotonic() - t0)
        return out


def plan_elastic_remesh(total_devices: int, failed_devices: int,
                        model_axis: int) -> Tuple[int, int]:
    """Largest (data, model) mesh on the healthy devices.

    Keeps the model axis fixed (weight shards must still fit) and shrinks the
    data axis — batch is re-balanced, optimizer state re-sharded on restore.
    Returns (data_axis, model_axis); raises if nothing fits.
    """
    healthy = total_devices - failed_devices
    if healthy < model_axis:
        raise RuntimeError(
            f"{healthy} healthy devices cannot host model axis {model_axis}")
    data_axis = healthy // model_axis
    return data_axis, model_axis


@dataclasses.dataclass
class FailurePolicy:
    """What the launcher does per event class."""

    checkpoint_interval_steps: int = 200

    def on_step_failure(self, consecutive_failures: int) -> str:
        # transient XLA/ICI error: retry once, then restart from checkpoint
        return "retry" if consecutive_failures < 2 else "restore"

    def on_device_loss(self) -> str:
        return "remesh_restore"

    def on_preemption_notice(self) -> str:
        return "checkpoint_now"


# ---------------------------------------------------------------------------
# retry / escalation layer (DESIGN.md §12)
# ---------------------------------------------------------------------------


class RetryBudgetExceeded(RuntimeError):
    """A transient fault survived every retry attempt; escalate."""


class EngineWriteUnavailable(RuntimeError):
    """The engine's write path is poisoned after an escalated persistent
    fault; reads keep serving the last published epoch, writes raise this
    until ``restore()`` heals the WAL position (DESIGN.md §12, A13)."""


class UnretryableIOError(OSError):
    """An IO fault that must escalate WITHOUT retry even though its errno
    looks transient — the operation is not idempotent from where it
    failed.  Canonical case: a rotation fsync failing under WAL policy
    ``rotate`` (the durability point of the whole segment); retrying the
    *append* there would re-log an already-written record under a new
    seq and double-apply it on replay."""


class ShardDispatchError(RuntimeError):
    """A dispatch failure attributable to ONE shard (a per-shard RPC
    timing out, a device owned by that shard lost).  Carries ``.shard``
    so the engine's strike path can take that shard down automatically
    after ``health_strikes`` consecutive escalations; unattributable
    dispatch faults degrade the call but strike nobody."""

    def __init__(self, shard: int, message: str = ""):
        super().__init__(
            message or f"dispatch failed against shard {shard}")
        self.shard = int(shard)


def shard_from_exception(exc: Optional[BaseException]) -> Optional[int]:
    """Extract the striking shard id from an exception's cause/context
    chain (``RetryBudgetExceeded`` chains the last fault as its cause);
    None when no link carries a ``.shard``."""
    hops = 0
    while exc is not None and hops < 8:
        shard = getattr(exc, "shard", None)
        if isinstance(shard, int):
            return shard
        exc = exc.__cause__ or exc.__context__
        hops += 1
    return None


#: errnos that retrying cannot fix: the disk is full/read-only/over quota
#: or the file is unreachable — escalate immediately (checkpoint-now /
#: degraded mode), never spin (A13).
PERSISTENT_ERRNOS = frozenset({
    _errno.ENOSPC, _errno.EROFS, _errno.EDQUOT, _errno.EACCES,
    _errno.EPERM, _errno.ENAMETOOLONG,
})


def classify_io_error(exc: BaseException) -> str:
    """``"persistent"`` (retry cannot help) or ``"transient"``.

    OSErrors are classified by errno; anything non-OSError coming out of
    an IO edge (a dead thread, a device dispatch failure) is treated as
    transient — one retry round is cheap and device hiccups recover.
    :class:`UnretryableIOError` is persistent whatever its errno: the
    raiser is telling us the operation cannot be retried from where it
    failed (see the class docstring).
    """
    if isinstance(exc, UnretryableIOError):
        return "persistent"
    if isinstance(exc, OSError) and exc.errno in PERSISTENT_ERRNOS:
        return "persistent"
    return "transient"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic jitter.

    ``max_attempts`` counts total tries (first call included).  The delay
    before retry ``k`` (1-based) is ``base * 2**(k-1)`` capped at
    ``max_delay_s``, scaled by a jitter factor drawn uniformly from
    ``[1 - jitter, 1]`` out of a stream seeded by ``seed`` — two engines
    retrying the same fault decorrelate, one engine replays exactly.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.005
    max_delay_s: float = 0.5
    jitter: float = 0.5
    seed: int = 0

    def delays(self):
        rng = random.Random(self.seed)
        for k in range(1, self.max_attempts):
            raw = min(self.base_delay_s * (2.0 ** (k - 1)),
                      self.max_delay_s)
            yield raw * (1.0 - self.jitter * rng.random())


def call_with_retry(fn: Callable[[], object], *,
                    policy: Optional[RetryPolicy] = None,
                    classify: Callable[[BaseException], str]
                    = classify_io_error,
                    retry_on: Tuple[type, ...] = (Exception,),
                    on_retry: Optional[Callable[[int, BaseException],
                                                None]] = None,
                    sleep: Callable[[float], None] = time.sleep,
                    metrics=None):
    """Run ``fn`` under the retry ladder.

    Transient faults back off and retry up to ``policy.max_attempts``
    total tries; a persistent fault re-raises immediately (escalation is
    the caller's job); an exhausted budget raises
    :class:`RetryBudgetExceeded` from the last fault.  ``on_retry`` is
    called with ``(attempt_index, exc)`` before each backoff sleep —
    the engine counts these into ``stats``.  ``metrics`` (an
    ``obs.Registry``) records each backoff delay into the
    ``retry.backoff`` histogram (DESIGN.md §13), so the ladder's actual
    sleep distribution is observable, not just its retry counts.
    """
    policy = policy or RetryPolicy()
    last: Optional[BaseException] = None
    delays = policy.delays()
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except retry_on as exc:
            if classify(exc) == "persistent":
                raise
            last = exc
            try:
                delay = next(delays)
            except StopIteration:
                break
            if on_retry is not None:
                on_retry(attempt + 1, exc)
            if metrics is not None:
                metrics.hist_record("retry.backoff", delay)
            sleep(delay)
    raise RetryBudgetExceeded(
        f"{policy.max_attempts} attempts exhausted: {last!r}") from last


class ShardHealth:
    """Per-shard health map for graceful degradation (DESIGN.md §12).

    Writers mark a shard down after ``strike_limit`` consecutive
    dispatch failures; routed reads exclude down shards via
    :meth:`healthy_mask` (answers stay sorted-descending from the
    survivors, ``degraded_answers`` counted by the engine); writes bound
    for a down shard queue here (bounded by ``deferred_cap`` items
    total) and drain on :meth:`heal`.  Readers never take the mutex: the
    down-set is an immutable frozenset swapped atomically, so a query
    thread observes either the old or the new set, never a torn one —
    the same publish idiom as the epoch store.

    The down-set and deferred queue are recovery state (A15): they ride
    snapshot meta via :meth:`dump`/:meth:`load` because snapshot-cadence
    WAL GC may unlink the deferred batches' original log records.
    Strikes are transient and never persisted.
    """

    _MCQ_LOCK_ORDER = ("_mu",)
    _MCQ_LOCK_PROTECTS = {
        "_mu": ("_down", "_strikes", "_deferred", "_deferred_items"),
    }

    def __init__(self, num_shards: int, *, strike_limit: int = 3,
                 deferred_cap: int = 4096):
        self.num_shards = int(num_shards)
        self.strike_limit = int(strike_limit)
        self.deferred_cap = int(deferred_cap)
        self._mu = threading.Lock()
        self._down: FrozenSet[int] = frozenset()
        self._strikes: Dict[int, int] = {}
        self._deferred: Dict[int, list] = {}
        self._deferred_items = 0

    # -- read side (lock-free) -----------------------------------------
    @property
    def down(self) -> FrozenSet[int]:
        return self._down

    @property
    def degraded(self) -> bool:
        return bool(self._down)

    def healthy_mask(self) -> np.ndarray:
        """bool[num_shards], True where the shard serves reads."""
        mask = np.ones(self.num_shards, dtype=bool)
        for s in self._down:
            mask[s] = False
        return mask

    # -- write side ----------------------------------------------------
    def record_failure(self, shard: int) -> bool:
        """One dispatch failure against ``shard``; returns True when this
        strike marks it down (caller escalates to degraded mode)."""
        with self._mu:
            if shard in self._down:
                return False
            n = self._strikes.get(shard, 0) + 1
            self._strikes[shard] = n
            if n < self.strike_limit:
                return False
            self._down = self._down | {shard}
            self._strikes.pop(shard, None)
            return True

    def record_success(self, shard: int) -> None:
        with self._mu:
            self._strikes.pop(shard, None)

    def record_success_all(self) -> None:
        """A whole-mesh dispatch succeeded: every shard answered, so all
        strike streaks break (the down-set is untouched).  Cheap racy
        emptiness peek first — the common healthy path takes no lock."""
        if not self._strikes:
            return
        with self._mu:
            self._strikes.clear()

    def mark_down(self, shard: int) -> None:
        with self._mu:
            self._down = self._down | {shard}
            self._strikes.pop(shard, None)

    def defer(self, shard: int, src, dst, w) -> bool:
        """Queue one write batch for a down shard; False = cap reached
        and the batch is dropped (counted by the caller)."""
        with self._mu:
            n = int(np.asarray(src).size)
            if self._deferred_items + n > self.deferred_cap:
                return False
            self._deferred.setdefault(shard, []).append(
                (np.asarray(src).copy(), np.asarray(dst).copy(),
                 np.asarray(w).copy() if w is not None else None))
            self._deferred_items += n
            return True

    def heal(self, shard: int) -> List[tuple]:
        """Re-admit ``shard``; returns its deferred write batches in
        arrival order for the caller to re-apply."""
        with self._mu:
            self._down = self._down - {shard}
            self._strikes.pop(shard, None)
            batches = self._deferred.pop(shard, [])
            self._deferred_items -= sum(int(b[0].size) for b in batches)
            return batches

    def requeue(self, shard: int, batches: List[tuple]) -> None:
        """Push back batches :meth:`heal` popped but the caller could not
        apply, at the FRONT of the shard's queue (arrival order holds) and
        cap-exempt — they were admitted under the cap once already, so a
        failed heal must not convert them into drops."""
        if not batches:
            return
        with self._mu:
            self._deferred[shard] = (list(batches)
                                     + self._deferred.get(shard, []))
            self._deferred_items += sum(int(b[0].size) for b in batches)

    def dump(self) -> dict:
        """JSON-serialisable image of the recovery-relevant state (the
        down-set and the deferred queue; strikes are transient and omitted)
        for snapshot meta.  ``deferred`` is a flat ``[shard, src, dst, w]``
        list in per-shard arrival order."""
        with self._mu:
            return {
                "down": sorted(self._down),
                "deferred": [
                    [shard, b[0].tolist(), b[1].tolist(),
                     None if b[2] is None else b[2].tolist()]
                    for shard in sorted(self._deferred)
                    for b in self._deferred[shard]],
            }

    def load(self, image: dict) -> None:
        """Replace the health state with a :meth:`dump` image (restore
        path): the live down-set, strikes and deferred queue are discarded
        — recovery state comes from the snapshot, never from the
        pre-restore process (A15)."""
        with self._mu:
            self._down = frozenset(int(s) for s in image.get("down", ()))
            self._strikes = {}
            self._deferred = {}
            self._deferred_items = 0
            for shard, src, dst, w in image.get("deferred", ()):
                src = np.asarray(src, np.int32)
                self._deferred.setdefault(int(shard), []).append(
                    (src, np.asarray(dst, np.int32),
                     None if w is None else np.asarray(w, np.int32)))
                self._deferred_items += int(src.size)

    def stats(self) -> Dict[str, int]:
        with self._mu:
            return {"shards_down": len(self._down),
                    "deferred_writes": self._deferred_items}
