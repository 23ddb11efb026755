"""Lock-free telemetry registry (DESIGN.md §13).

Counterpart of ``repro.obs.metrics``: host-only Python kept line for
line, ``METRIC_CATALOG`` a literal copy of the reference's.

The measurement layer is built in the same spirit as the data structure it
observes: the hot-path record is a single numpy array increment into a
*per-thread shard* — no lock, no CAS, no allocation — and the shards are
merged only at scrape time, where p50/p90/p99/max fall out of log-bucketed
histogram counts.  A thread only ever writes its own shard (registered once
under ``_mu`` at first use), so increments cannot be lost to each other;
a concurrent scrape may miss an in-flight increment (eventually consistent,
exact once the writer quiesces — the same "approximately correct during
concurrent updates" contract as the chain itself).

Armed/disarmed follows the ``faults/registry.py`` pattern: a module-level
bool gate.  Counters and gauges are ALWAYS recorded (they implement the
engines' pre-existing stats contract); histograms, spans, traffic vectors
and incident dumps only record while armed (``arm()`` /
``MCQ_METRICS=1``), so the disarmed overhead on the serving hot paths is
one global-bool read (bounded by benchmark B10).

Metric *names* are a closed catalog (``METRIC_CATALOG``): every name
recorded anywhere in ``src/`` must be declared here with a kind and help
text, and every declared name must be recorded somewhere — the MCQ-M001
diagonal, statically enforced by mcqlint.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: metric kinds a catalog entry may declare
KINDS = ("counter", "gauge", "histogram", "vector")

#: the closed metric catalog: name -> (kind, help).  Counters are
#: monotonically accumulated; gauges are last-value-wins absolute reads;
#: histograms are log-bucketed latency distributions in SECONDS; vectors
#: are fixed-size integer arrays (per-bucket / per-shard traffic).
#: Values surfaced through a registry *provider* (the engines' stats
#: snapshots, device counter sums) are typed here too so the exposition
#: layer can render them with the right TYPE/HELP.
METRIC_CATALOG: Dict[str, Tuple[str, str]] = {
    # -- sharded serving host counters (provided via stats_snapshot) ----
    "updates": ("counter", "observe() batches applied and published"),
    "queries": ("counter", "threshold-query calls served"),
    "topn_calls": ("counter", "global top-n merge reads served"),
    "query_dropped": ("counter", "query items dropped for routing skew"),
    "snapshots": ("counter", "snapshots captured (sync + async)"),
    "route_retried": ("counter",
                      "skew-dropped update items re-queued for retry"),
    "route_lost": ("counter",
                   "update items lost after the route-retry budget"),
    "query_retried": ("counter", "query items re-dispatched for skew"),
    "query_lost": ("counter",
                   "query items still dropped after the retry budget"),
    "degraded_answers": ("counter",
                         "read items answered empty by degradation"),
    "wal_errors": ("counter", "WAL io_errors absorbed (swallow-and-count)"),
    "wal_retries": ("counter", "WAL append retry rounds"),
    "apply_retries": ("counter", "device-apply retry rounds"),
    "dispatch_retries": ("counter", "routed-read dispatch retry rounds"),
    "write_errors": ("counter", "write-path poison escalations"),
    "snapshot_failures": ("counter", "snapshot attempts that failed"),
    # -- unsharded Engine counters (recorded via counter_add) -----------
    "model_calls": ("counter", "target-model decode/extend forwards"),
    "accepted": ("counter", "draft tokens accepted by verification"),
    "drafted": ("counter", "draft tokens proposed"),
    "rounds": ("counter", "speculative draft-verify rounds"),
    "draft_calls": ("counter", "fused draft-walk dispatches"),
    # -- telemetry self-accounting --------------------------------------
    "incidents": ("counter", "flight-recorder incidents fired"),
    # -- device counter sums (provided; cumulative since init) ----------
    "dropped_rows": ("counter", "row-table insertions dropped (capacity)"),
    "dropped_probes": ("counter", "hash probes dropped (window overflow)"),
    "evictions": ("counter", "Space-Saving slab evictions"),
    "deferred_new": ("counter", "new edges deferred past the slow-path cap"),
    "route_dropped": ("counter", "routed items dropped at bucket capacity"),
    "decay_steps": ("counter", "decay maintenance steps applied"),
    "dh_rebuilds": ("counter", "full dst-hash rebuilds"),
    "dh_tombstones": ("counter", "dst-hash tombstones created"),
    # -- gauges ---------------------------------------------------------
    "n_rows": ("gauge", "live rows in the chain"),
    "topn_dropped": ("gauge", "unexposed top-n candidates (last read)"),
    "deferred_writes": ("gauge", "write items deferred for down shards"),
    "shards_down": ("gauge", "shards currently marked down"),
    "read_epoch_lag": ("gauge",
                       "publish-to-read epoch lag seen by the last query"),
    "store_version": ("gauge", "current published epoch version"),
    # -- latency histograms (seconds) -----------------------------------
    "engine.observe": ("histogram", "observe() wall time (write cycle)"),
    "engine.apply": ("histogram", "device apply+publish inside observe"),
    "engine.query": ("histogram", "threshold-query wall time"),
    "engine.topn": ("histogram", "global top-n read wall time"),
    "engine.learn": ("histogram", "unsharded learner step wall time"),
    "wal.append": ("histogram", "WAL append (frame+write+flush) time"),
    "wal.fsync": ("histogram", "per-append WAL fsync time"),
    "wal.rotate": ("histogram", "WAL segment rotation time"),
    "snapshot.save": ("histogram", "snapshot save (arrays+meta+commit)"),
    "snapshot.restore": ("histogram", "snapshot restore read time"),
    "retry.backoff": ("histogram", "retry-ladder backoff sleeps"),
    # -- traffic vectors (the ROADMAP rebalancer's input) ---------------
    "bucket_traffic": ("vector", "update items per virtual bucket"),
    "shard_traffic": ("vector", "update items per owner shard"),
}

_COUNTER_NAMES: Tuple[str, ...] = tuple(
    n for n, (k, _) in METRIC_CATALOG.items() if k == "counter")
_COUNTER_IDX: Dict[str, int] = {n: i for i, n in enumerate(_COUNTER_NAMES)}
_HIST_NAMES: Tuple[str, ...] = tuple(
    n for n, (k, _) in METRIC_CATALOG.items() if k == "histogram")
_HIST_IDX: Dict[str, int] = {n: i for i, n in enumerate(_HIST_NAMES)}

# log-bucketed histogram layout: value v = m * 2**e (math.frexp,
# 0.5 <= m < 1) lands in octave e, sub-bucket floor((m - 0.5) * 2 * B)
# of B per octave.  E_MIN..E_MAX octaves cover ~0.5ns .. ~1024s; values
# outside clamp to the edge buckets.  The estimate a scrape reports is
# the bucket's UPPER edge, so est/true is within [1, (B+1)/B].
E_MIN = -30
E_MAX = 10
DEFAULT_BUCKETS_PER_OCTAVE = 4

_ARMED = False


def arm() -> None:
    """Enable histograms, spans, traffic vectors and incident dumps."""
    global _ARMED
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


def is_armed() -> bool:
    return _ARMED


@contextlib.contextmanager
def armed():
    """Scoped arming for tests."""
    prev = _ARMED
    arm()
    try:
        yield
    finally:
        if not prev:
            disarm()


def arm_from_env(env: Optional[Dict[str, str]] = None) -> Optional[str]:
    """Arm telemetry from the environment (the subprocess analogue of
    ``faults.arm_from_env``): ``MCQ_METRICS`` truthy arms the gate,
    ``MCQ_TRACE_KERNELS`` truthy enables kernel trace annotations, and the
    returned ``MCQ_METRICS_INCIDENT_DIR`` (or None) is where an arming
    engine should dump incident files."""
    env = os.environ if env is None else env
    if env.get("MCQ_METRICS", "") not in ("", "0", "false", "no"):
        arm()
    if env.get("MCQ_TRACE_KERNELS", "") not in ("", "0", "false", "no"):
        from repro_torch.obs import tracing
        tracing.enable_kernel_annotations()
    return env.get("MCQ_METRICS_INCIDENT_DIR") or None


def bucket_index(value: float, buckets_per_octave: int) -> int:
    """Histogram bucket for ``value`` (seconds); <=0 clamps to bucket 0."""
    if value <= 0.0:
        return 0
    m, e = math.frexp(value)
    if e < E_MIN:
        return 0
    if e > E_MAX:
        return (E_MAX - E_MIN + 1) * buckets_per_octave - 1
    sub = int((m - 0.5) * 2.0 * buckets_per_octave)
    if sub >= buckets_per_octave:
        sub = buckets_per_octave - 1
    return (e - E_MIN) * buckets_per_octave + sub


def bucket_edges(buckets_per_octave: int) -> np.ndarray:
    """Upper edge of every bucket (monotonically increasing)."""
    n = (E_MAX - E_MIN + 1) * buckets_per_octave
    idx = np.arange(n)
    e = E_MIN + idx // buckets_per_octave
    sub = idx % buckets_per_octave
    return np.exp2(e - 1.0) * (1.0 + (sub + 1.0) / buckets_per_octave)


class _NoopSpan:
    """Shared do-nothing context manager returned while disarmed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Shard:
    """One thread's private recording arrays (single writer, no lock)."""

    __slots__ = ("counters", "hist_counts", "hist_sums", "hist_maxes",
                 "vectors")

    def __init__(self, n_buckets: int, vector_sizes: Dict[str, int]):
        self.counters = np.zeros(len(_COUNTER_NAMES), np.int64)
        self.hist_counts = np.zeros((len(_HIST_NAMES), n_buckets), np.int64)
        self.hist_sums = np.zeros(len(_HIST_NAMES), np.float64)
        self.hist_maxes = np.zeros(len(_HIST_NAMES), np.float64)
        self.vectors = {name: np.zeros(size, np.int64)
                        for name, size in vector_sizes.items()}


class Registry:
    """A set of named metrics with lock-free recording.

    ``_mu`` guards only the registry's bookkeeping (the shard list, the
    provider list, incident sequencing) — never the record path, and it is
    never held while calling out (providers run after it is released), so
    it cannot participate in a lock cycle with engine locks.
    """

    _MCQ_LOCK_ORDER = ("_mu",)
    _MCQ_LOCK_PROTECTS = {
        "_mu": ("_shards_all", "_providers", "_incident_seq", "_baseline"),
    }

    def __init__(self, *, vectors: Optional[Dict[str, int]] = None,
                 buckets_per_octave: int = DEFAULT_BUCKETS_PER_OCTAVE,
                 flight_spans: int = 64,
                 incident_dir: Optional[str] = None,
                 max_incidents: int = 32):
        self._bpo = int(buckets_per_octave)
        self._n_buckets = (E_MAX - E_MIN + 1) * self._bpo
        self._edges = bucket_edges(self._bpo)
        self._vector_sizes = dict(vectors or {})
        self._local = threading.local()
        self._mu = threading.Lock()
        self._shards_all: List[_Shard] = []
        self._providers: List[Callable[[], Dict[str, int]]] = []
        self._gauges: Dict[str, float] = {}   # GIL-atomic stores, no lock
        # flight recorder: bounded deque appends are thread-safe; the ring
        # holds the last N completed spans for incident dumps
        import collections
        self._spans = collections.deque(maxlen=int(flight_spans))
        self.incident_dir = incident_dir
        self.max_incidents = int(max_incidents)
        self._incident_seq = 0
        self._baseline: Dict[str, float] = {}

    # -- hot path (lock-free) -------------------------------------------
    def _shard(self) -> _Shard:
        s = getattr(self._local, "shard", None)
        if s is None:
            s = _Shard(self._n_buckets, self._vector_sizes)
            self._local.shard = s
            with self._mu:
                self._shards_all.append(s)
        return s

    def counter_add(self, name: str, n: int = 1) -> None:
        """Always recorded (counters implement the stats contract)."""
        self._shard().counters[_COUNTER_IDX[name]] += n

    def gauge_set(self, name: str, value) -> None:
        """Always recorded: one dict store (atomic under the GIL)."""
        self._gauges[name] = value

    def hist_record(self, name: str, value: float) -> None:
        """Record a latency sample (seconds); no-op while disarmed."""
        if not _ARMED:
            return
        i = _HIST_IDX[name]
        s = self._shard()
        s.hist_counts[i, bucket_index(value, self._bpo)] += 1
        s.hist_sums[i] += value
        if value > s.hist_maxes[i]:
            s.hist_maxes[i] = value

    def vector_add(self, name: str, counts: np.ndarray) -> None:
        """Accumulate a traffic count vector; no-op while disarmed.
        Mismatched lengths merge over the common prefix (a rebind may
        change the bucket count mid-flight)."""
        if not _ARMED:
            return
        vec = self._shard().vectors.get(name)
        if vec is None:
            return
        m = min(vec.size, len(counts))
        vec[:m] += np.asarray(counts[:m], np.int64)

    def span(self, name: str, **attrs):
        """A nestable monotonic-clock span context manager; records its
        duration into the histogram ``name`` and pushes a record into the
        flight recorder on exit.  Disarmed: a shared no-op."""
        if not _ARMED:
            return NOOP_SPAN
        from repro_torch.obs.tracing import Span
        return Span(self, name, attrs)

    def incident(self, reason: str, **ctx) -> Optional[str]:
        """Dump a flight-recorder incident file (see tracing.py); returns
        the path (None while disarmed, with no incident dir, or past
        ``max_incidents``)."""
        if not _ARMED:
            return None
        from repro_torch.obs import tracing
        return tracing.dump_incident(self, reason, ctx)

    # -- read side --------------------------------------------------------
    def register_provider(self, fn: Callable[[], Dict[str, int]]) -> None:
        """``fn`` is called at every scrape (AFTER ``_mu`` is released, so
        it may take its own locks) and its dict merges into the snapshot's
        ``provided`` section — how the engines' consistent stats snapshots
        become the one exposition source of truth."""
        with self._mu:
            self._providers.append(fn)

    def spans(self) -> List[dict]:
        """The flight recorder's current contents, oldest first."""
        return list(self._spans)

    def _next_incident(self) -> int:
        with self._mu:
            self._incident_seq += 1
            return self._incident_seq

    def incident_delta(self, scalars: Dict[str, float]) -> Dict[str, float]:
        """Scalar deltas since the previous incident (or since birth),
        then advance the baseline — consecutive incidents show what moved
        *between* them."""
        with self._mu:
            base = self._baseline
            self._baseline = dict(scalars)
        return {k: v - base.get(k, 0)
                for k, v in scalars.items() if v != base.get(k, 0)}

    def quantiles(self, counts: np.ndarray, qs: Sequence[float],
                  vmax: float = 0.0) -> List[float]:
        """Nearest-rank quantile estimates from merged bucket counts; each
        estimate is the containing bucket's upper edge, capped at the
        tracked exact max."""
        total = int(counts.sum())
        out = []
        cum = np.cumsum(counts)
        for q in qs:
            if total == 0:
                out.append(0.0)
                continue
            k = max(1, int(math.ceil(q * total)))
            idx = int(np.searchsorted(cum, k, side="left"))
            est = float(self._edges[min(idx, self._edges.size - 1)])
            if vmax > 0.0:
                est = min(est, float(vmax))
            out.append(est)
        return out

    def snapshot(self) -> dict:
        """Merge every thread shard and call every provider; returns the
        full metrics image ``{counters, gauges, provided, histograms,
        vectors}``."""
        with self._mu:
            shards = list(self._shards_all)
            providers = list(self._providers)
        counters = np.zeros(len(_COUNTER_NAMES), np.int64)
        hist_counts = np.zeros((len(_HIST_NAMES), self._n_buckets), np.int64)
        hist_sums = np.zeros(len(_HIST_NAMES), np.float64)
        hist_maxes = np.zeros(len(_HIST_NAMES), np.float64)
        vectors = {name: np.zeros(size, np.int64)
                   for name, size in self._vector_sizes.items()}
        for s in shards:
            counters += s.counters
            hist_counts += s.hist_counts
            hist_sums += s.hist_sums
            np.maximum(hist_maxes, s.hist_maxes, out=hist_maxes)
            for name, v in s.vectors.items():
                m = min(vectors[name].size, v.size)
                vectors[name][:m] += v[:m]
        provided: Dict[str, float] = {}
        for fn in providers:   # outside _mu: providers may take locks
            provided.update(fn())
        hists = {}
        for i, name in enumerate(_HIST_NAMES):
            row = hist_counts[i]
            count = int(row.sum())
            vmax = float(hist_maxes[i])
            p50, p90, p99 = self.quantiles(row, (0.5, 0.9, 0.99), vmax)
            hists[name] = {"count": count, "sum": float(hist_sums[i]),
                           "max": vmax, "p50": p50, "p90": p90, "p99": p99}
        return {
            "counters": {n: int(counters[i])
                         for i, n in enumerate(_COUNTER_NAMES)},
            "gauges": dict(self._gauges),
            "provided": provided,
            "histograms": hists,
            "vectors": {n: v.tolist() for n, v in vectors.items()},
        }

    def scalars(self) -> Dict[str, float]:
        """Flat scalar view: counters + gauges + provided merged (provided
        wins — the engines' consistent snapshot is authoritative for the
        names both carry)."""
        snap = self.snapshot()
        out: Dict[str, float] = dict(snap["counters"])
        out.update(snap["gauges"])
        out.update(snap["provided"])
        return out


#: the process-global default registry — standalone persist/runtime call
#: sites record here unless handed an engine-owned registry
GLOBAL = Registry()
