"""Failpoint registry: named fault-injection sites (DESIGN.md §12).

Counterpart of ``repro.faults.registry``, host-only Python kept line for
line.  The port keeps its own arming state: arming a site here leaves the
reference's registry as it was, and the reverse.

A *failpoint* is a named call site threaded through an IO or cross-shard
edge — ``failpoint("wal.append.fsync", fh=self._fh)`` — that does nothing
in production and becomes a fault when *armed*.  Arming attaches an
**action** (raise an exception, SIGKILL the process, sleep, or call an
arbitrary hook with the site's keyword context) behind a **trigger**
(always / only the Nth hit / every Nth hit / iid with probability p), via
the API here or the ``MCQ_FAILPOINTS`` environment variable, so a
subprocess under test can be detonated from outside.

Design constraints, in order:

* **Zero-cost when disarmed.**  The hot path of ``failpoint`` is one read
  of a module-level bool; no dict lookup, no lock, no string work.  The
  serving engine calls failpoints on every observe/query, so anything
  more would tax the fast path the paper is about.
* **Closed catalog.**  Every site name must be a key of
  :data:`FAILPOINT_CATALOG`; ``arm`` rejects unknown names at runtime and
  mcqlint rule MCQ-R001 rejects unregistered/untested sites statically
  (invariant I10) — an injection site that exists but is never exercised
  by the fault matrix is a hole in the robustness story.
* **Deterministic.**  Probabilistic triggers take an explicit seed;
  nth-hit triggers count per-site hits.  A chaos run is reproducible from
  its env string.

Failpoints double as *schedule points* for the interleaving explorer:
:func:`set_observer` installs a callback invoked on every hit (arming not
required), which the explorer uses to yield control at IO edges exactly
like its lock/store instrumentation.
"""

from __future__ import annotations

import contextlib
import os
import random
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

#: The closed catalog of injection sites: name -> where it cuts.  mcqlint
#: rule MCQ-R001 parses this dict *statically* (literal keys only) and
#: cross-checks every ``failpoint("...")`` call site in src/ against it,
#: and every entry against the fault-matrix table in tests/test_faults.py.
FAILPOINT_CATALOG = {
    "wal.segment_open": "opening/creating a WAL segment file",
    "wal.append.write": "writing+flushing one framed record into a segment",
    "wal.append.fsync": "fsync of the open segment (policy: always)",
    "wal.rotate": "segment close/fsync at rotation or WAL close",
    "snapshot.meta_write": "writing the chain.json sidecar of a snapshot",
    "snapshot.arrays_write": "np.savez of a snapshot's array payload",
    "snapshot.manifest_commit": "the atomic os.replace manifest commit",
    "snapshot.io_thread": "body of an async checkpoint IO thread",
    "snapshot.restore_read": "reading manifest/arrays during restore",
    "engine.apply": "device dispatch of acquire->update->maintain",
    "engine.publish": "epoch-store publish of the applied state",
    "engine.query_dispatch": "routed threshold-query device dispatch",
    "engine.topn_dispatch": "routed global top-n device dispatch",
    "engine.learn": "the unsharded Engine's per-token n-gram learn step",
}


class FaultInjected(OSError):
    """Default exception an armed ``raise`` action throws.

    An ``OSError`` subclass so the retry/escalation ladder classifies it
    by ``errno`` exactly like a genuine IO failure.
    """

    def __init__(self, site: str, err: Optional[int] = None):
        super().__init__(err or 0, f"fault injected at {site}")
        self.site = site


class _Arming:
    __slots__ = ("action", "trigger", "count", "fired")

    def __init__(self, action, trigger, count):
        self.action = action
        self.trigger = trigger
        self.count = count          # max fires; None = unlimited
        self.fired = 0


_mu = threading.Lock()
_armed: Dict[str, _Arming] = {}
_hits: Dict[str, int] = {}
_observer: Optional[Callable[[str, dict], None]] = None

#: fast-path gate: True iff any site is armed or an observer is installed.
_ACTIVE = False


def _recompute_active() -> None:
    global _ACTIVE
    _ACTIVE = bool(_armed) or _observer is not None


# ---------------------------------------------------------------------------
# the injection site
# ---------------------------------------------------------------------------


def failpoint(name: str, **ctx: Any) -> None:
    """The injection site.  No-op unless armed or observed.

    ``ctx`` carries site-local objects (file handles, seq numbers) to
    hook actions, so a test can e.g. tear a write half-way before
    raising.  Keep call sites cheap: ctx values must already exist.
    """
    if not _ACTIVE:
        return
    _slow_hit(name, ctx)


def _slow_hit(name: str, ctx: dict) -> None:
    obs = _observer
    if obs is not None:
        obs(name, ctx)
    with _mu:
        hit = _hits.get(name, 0) + 1
        _hits[name] = hit
        arming = _armed.get(name)
        if arming is None:
            return
        if arming.count is not None and arming.fired >= arming.count:
            return
        if not arming.trigger(hit):
            return
        arming.fired += 1
        action = arming.action
    action(ctx)  # outside the lock: may raise, sleep, or never return


# ---------------------------------------------------------------------------
# triggers and actions
# ---------------------------------------------------------------------------


def _make_trigger(spec) -> Callable[[int], bool]:
    """Normalise a trigger spec to ``hit_index -> bool`` (1-based hits).

    Specs: ``"always"`` | ``("nth", n)`` fires on exactly the nth hit |
    ``("every", n)`` fires on every nth | ``("prob", p, seed)`` iid
    Bernoulli from a dedicated seeded stream | a callable, passed through.
    """
    if callable(spec):
        return spec
    if spec == "always":
        return lambda hit: True
    kind = spec[0]
    if kind == "nth":
        n = int(spec[1])
        return lambda hit: hit == n
    if kind == "every":
        n = int(spec[1])
        return lambda hit: hit % n == 0
    if kind == "prob":
        p = float(spec[1])
        rng = random.Random(int(spec[2]) if len(spec) > 2 else 0)
        return lambda hit: rng.random() < p
    raise ValueError(f"unknown trigger spec {spec!r}")


def _make_action(spec, name: str) -> Callable[[dict], None]:
    """Normalise an action spec to ``ctx -> None``.

    Specs: an exception instance or class (raised); ``"kill"`` (SIGKILL
    self — the crash-soak hammer); a float/int (sleep that many seconds);
    a callable, called with the site's ctx dict.
    """
    if isinstance(spec, BaseException):
        def act(ctx, exc=spec):
            raise exc
        return act
    if isinstance(spec, type) and issubclass(spec, BaseException):
        def act(ctx, cls=spec):
            raise cls(f"fault injected at {name}")
        return act
    if spec == "kill":
        def act(ctx):
            os.kill(os.getpid(), signal.SIGKILL)
        return act
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        def act(ctx, secs=float(spec)):
            time.sleep(secs)
        return act
    if callable(spec):
        return spec
    raise ValueError(f"unknown action spec {spec!r}")


# ---------------------------------------------------------------------------
# arming API
# ---------------------------------------------------------------------------


def arm(name: str, action, *, trigger="always",
        count: Optional[int] = None) -> None:
    """Arm one site.  Re-arming replaces the previous arming and resets
    its fire count (hit counts persist until :func:`reset`)."""
    if name not in FAILPOINT_CATALOG:
        raise KeyError(
            f"unknown failpoint {name!r}; register it in FAILPOINT_CATALOG")
    a = _Arming(_make_action(action, name), _make_trigger(trigger), count)
    with _mu:
        _armed[name] = a
        _recompute_active()


def disarm(name: str) -> None:
    with _mu:
        _armed.pop(name, None)
        _recompute_active()


def reset() -> None:
    """Disarm everything and zero all hit/fire counters (test teardown)."""
    with _mu:
        _armed.clear()
        _hits.clear()
        _recompute_active()


@contextlib.contextmanager
def armed(name: str, action, *, trigger="always",
          count: Optional[int] = None):
    """``with armed("wal.append.fsync", OSError(...)):`` scoped arming."""
    arm(name, action, trigger=trigger, count=count)
    try:
        yield
    finally:
        disarm(name)


def hits(name: str) -> int:
    """Site passes observed while the registry was active (armed sites
    count every pass, fired or not)."""
    with _mu:
        return _hits.get(name, 0)


def fired(name: str) -> int:
    with _mu:
        a = _armed.get(name)
        return a.fired if a is not None else 0


def snapshot() -> Dict[str, Dict[str, int]]:
    """Per-site {hits, fired} for stats surfacing and test asserts."""
    with _mu:
        return {n: {"hits": _hits.get(n, 0),
                    "fired": a.fired}
                for n, a in _armed.items()} | {
                    n: {"hits": h, "fired": 0}
                    for n, h in _hits.items() if n not in _armed}


# ---------------------------------------------------------------------------
# explorer bridge
# ---------------------------------------------------------------------------


def set_observer(fn: Optional[Callable[[str, dict], None]]) -> None:
    """Install (or clear, with None) a callback invoked on *every* site
    hit.  The interleaving explorer uses this to make failpoints schedule
    yield points; the callback runs before any armed action fires."""
    global _observer
    with _mu:
        _observer = fn
        _recompute_active()


# ---------------------------------------------------------------------------
# environment arming: MCQ_FAILPOINTS="site=action[@trigger][;site=...]"
# ---------------------------------------------------------------------------


def _parse_env_entry(entry: str):
    site, _, rest = entry.partition("=")
    site = site.strip()
    if not rest:
        raise ValueError(f"MCQ_FAILPOINTS entry {entry!r}: missing action")
    action_s, _, trigger_s = rest.partition("@")
    parts = action_s.split(":")
    kind = parts[0]
    if kind == "raise":
        err = int(parts[1]) if len(parts) > 1 else 0
        action = FaultInjected(site, err)
    elif kind == "kill":
        action = "kill"
    elif kind == "sleep":
        action = float(parts[1])
    else:
        raise ValueError(
            f"MCQ_FAILPOINTS entry {entry!r}: unknown action {kind!r}")
    trigger = "always"
    if trigger_s:
        tp = trigger_s.split(":")
        if tp[0] == "always":
            trigger = "always"
        elif tp[0] in ("nth", "every"):
            trigger = (tp[0], int(tp[1]))
        elif tp[0] == "prob":
            trigger = ("prob", float(tp[1]),
                       int(tp[2]) if len(tp) > 2 else 0)
        else:
            raise ValueError(
                f"MCQ_FAILPOINTS entry {entry!r}: unknown trigger {tp[0]!r}")
    return site, action, trigger


def arm_from_env(spec: Optional[str] = None) -> int:
    """Arm sites from ``MCQ_FAILPOINTS`` (or an explicit spec string).

    Format: ``site=action[@trigger]`` entries joined by ``;``, with
    action ``raise[:errno]`` | ``kill`` | ``sleep:secs`` and trigger
    ``always`` | ``nth:N`` | ``every:N`` | ``prob:P[:SEED]``.  Example::

        MCQ_FAILPOINTS="wal.append.fsync=raise:28@nth:3;engine.apply=kill@prob:0.1:7"

    Returns the number of sites armed.  Called once at engine startup
    (``ShardedEngine.__init__``) so subprocess chaos runs arm themselves.
    """
    spec = os.environ.get("MCQ_FAILPOINTS", "") if spec is None else spec
    n = 0
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        site, action, trigger = _parse_env_entry(entry)
        arm(site, action, trigger=trigger)
        n += 1
    return n
