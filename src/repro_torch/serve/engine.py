"""Serving engines: the LM ``Engine`` with the MCPrioQ speculative drafter,
and the sharded chain's ``ShardedEngine``.

**The LM engine** (``ServeConfig``, ``Engine``) is the counterpart of
``repro.serve.engine``'s: prefill, then draft-verify rounds — one
``draft_walk`` launch proposes a draft, one ``extend_step`` verifies it,
acceptance is the batch-wide longest prefix, and a partial acceptance
re-extends from the kept pre-extend caches (the model never writes a cache
it is given, so keeping them is the rollback) — and the emitted tokens are
learned by the chain after every request (``_learn``, under
``_learn_lock``, with the ``engine.learn`` failpoint).  Greedy speculation
emits plain greedy decoding's tokens bit for bit (the model runs decode and
extension calls at one shape: ``models.model.STEP_ROWS``).  One thing
differs: the drafter's chain lives behind an ``EpochStore`` whose writer is
a :class:`repro_torch.core.epoch.BackBufferLearner` over the owner calls
``speculative.observe_`` + ``maintain_``, so a learner step catches a back
state up by rows and writes into it instead of copying the chain.  Drafts
pin the published front through the learner (the stream rule below).

**The sharded engine** is the counterpart of ``ShardedServeConfig`` and
``ShardedEngine``.  The host-side contract is the reference's, method by
method:
one writer under ``_write_lock`` (WAL append -> update -> maintain ->
publish -> cadence snapshot), lock-free readers on ``EpochStore``
snapshots, the fault ladder (retries, poison / heal, degraded reads, down
shards), cadence snapshots, crash recovery, elastic restore and live
``reassign``.  Three things differ, each because torch tensors are mutable
and the S shards are logical shards of one device:

  * **the write goes through a back buffer.**  The reference publishes
    functional copies; here the writer is a
    :class:`repro_torch.core.epoch.BackBufferLearner` over the stacked
    state: each ``observe`` catches the private back state up with the
    published one (one ``copy_dirty_rows`` launch over every shard's
    flagged rows), runs the owner programs ``sh.update_`` and
    ``sh.maintain_`` into it, and publishes it.  No state is copied.  A
    fault inside the write (the ``engine.publish`` failpoint fires after
    ``maintain_``, before the publish) leaves the back written and its
    rows flagged; the next write copies them back from the front, so a
    retry re-runs the same plan on the same state.  ``restore`` and
    ``reassign`` publish a new state and build a new learner around it;
  * **``mesh`` became ``device``**: ``ShardedEngine(cfg, device=None)``
    puts the stacked state on the GPU (``None``; an error without one) or
    on the device given; there is no device-count check;
  * ``reassign`` and the elastic restore list the live edges on the
    device (``persist.reshard.extract_edges``) instead of copying the whole
    state to the host, and re-ingest them through the owner ``sh.update_``
    into the fresh state, which no reader holds yet.

**One shard a process rank** (``ShardedEngine(cfg, device=None, *,
ranks=group)``, ``group`` a :class:`repro_torch.sharding.ranks.RankGroup`
of world ``num_shards``): this process holds shard ``ranks.rank`` only
(``sh.init_sharded(scfg, ranks=...)``) behind its own learner, on
``ranks.device`` unless ``device`` says otherwise; ``ranks=None`` is the
one-card engine above, unchanged.  The calls are SPMD: every rank calls
the same methods in the same order with the same *global* arguments, as
each process of a multi-controller program does; ``query`` and ``topn``
return the reference's whole answer on every rank, and the
``stats_snapshot`` counters are the same on every rank (the device
counters summed over the group after each publish; ``stats_snapshot``
itself makes no collective).  The rules:

  * **a write is agreed before any rank applies it.**  Rank 0 owns the
    WAL and the snapshot directory.  Every writer's call (``observe``,
    ``checkpoint``, ``restore``, ``reassign``, ``mark_shard_down``,
    ``heal_shard``) starts with one small exchange on the writer's group
    (``RankGroup.agree``) carrying the call, a digest of its global
    arguments and, for ``observe``, rank 0's WAL outcome, its ``seq`` and
    rank 0's IO counters; ranks that disagree raise
    :class:`RankDisagreement` (named) on every rank, poisoned when rank 0
    had logged the batch.  A step that can fail on one rank alone (the
    ``engine.apply`` and ``engine.publish`` failpoints, the watchdog's
    timing, a snapshot written by rank 0) is agreed too: every rank raises
    (:class:`RankPeerFault` where it failed elsewhere, classified as the
    failing rank's), so the retry ladder and the health map move in step;
  * **readers do not share a communicator** with the writer or with each
    other: ``read_lanes`` groups (``RankGroup.lanes``), ``lane=`` on
    ``query`` and ``topn``; a lane's calls come in the same order on every
    rank.  On a card each lane reads on a stream of its own (the learner's
    lane rule, ``core/epoch.py``);
  * **a read never combines two ownership maps.**  Each read's first
    exchange carries the rank's route epoch (bumped by every ``restore``
    and ``reassign`` swap); ranks that disagree each wait until their own
    epoch reaches the highest seen, then read again;
  * ``checkpoint`` goes through the group save (rank 0 writes the one-card
    engine's files); ``restore`` reads on rank 0, scatters the shards and
    broadcasts each WAL record; ``reassign`` and the elastic restore gather
    the live edge lists in rank order (``persist.reshard.gather_edges``);
  * **a lost rank fails the group**: a collective that fails raises
    ``RankGroupLost``; the call then raises ``EngineWriteUnavailable``
    naming it and the engine is poisoned on every rank that survives
    (recovery is a new group and ``restore()``).

The kernel layer is resolved through module attributes at call time
(``sh.init_sharded``, ``sh.make_update_fn_``, ``sh.make_maintain_fn_``,
``sh.make_query_fn``, ``sh.make_topn_fn``, ``mc.counter_stats`` and the
writer ``epoch.BackBufferLearner``), so the interleaving explorer
(``repro_torch.analysis.explorer``) can swap in host-side stand-ins.

Readers on other threads must launch on the writer's stream (the default
stream unless something set another): the learner checks it.  Host syncs
are the reference's: ``observe`` reads ``counter_stats`` after each
publish, ``query`` the sum of its drop vector, ``topn`` its drop count.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.analysis.invariants import requires_lock
from repro_torch.checkpoint import ckpt
from repro_torch.core import epoch
from repro_torch.core import mcprioq as mc
from repro_torch.core import sharded as sh
from repro_torch.core import speculative as spec
from repro_torch.core.device import resolve_device
from repro_torch.core.epoch import EpochStore
from repro_torch.core.hashtable import HashTable
from repro_torch.core.slab import Slabs
from repro_torch.faults import arm_from_env, failpoint
from repro_torch.obs import metrics as obs_metrics
from repro_torch.persist import reshard as rs
from repro_torch.persist import snapshot as snapshot_io
from repro_torch.persist.wal import WriteAheadLog
from repro_torch.runtime.fault_tolerance import (EngineWriteUnavailable,
                                                 RetryPolicy, ShardHealth,
                                                 StepWatchdog,
                                                 UnretryableIOError,
                                                 WatchdogConfig,
                                                 call_with_retry,
                                                 classify_io_error,
                                                 shard_from_exception)
from repro_torch.serve import sampling
from repro_torch.sharding.ownership import Ownership
from repro_torch.sharding.ranks import RankGroupLost

__all__ = ["ServeConfig", "Engine", "ShardedServeConfig", "ShardedEngine",
           "RankDisagreement", "RankPeerFault"]


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 64
    max_cache_len: int = 512
    draft_len: int = 4            # speculation depth (0 = disabled)
    ngram: spec.NGramConfig = spec.NGramConfig()
    greedy: bool = True
    temperature: float = 1.0


class Engine:
    """Host-side orchestration of a model and its drafter on one device
    (default: the GPU; an error without one)."""

    # normative lock order + protection map (DESIGN.md §11, checked by
    # tools/mcqlint): the learner lock serialises the learner's write (and
    # so the publish inside it) AND the maintenance-gauge view derived from
    # the published state
    _MCQ_LOCK_ORDER = ("_learn_lock",)
    _MCQ_LOCK_PROTECTS = {
        "_learn_lock": ("drafter_store.publish", "_learner.write", "_maint"),
    }

    def __init__(self, model, params, cfg: ServeConfig, device=None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.drafter_store = EpochStore(spec.init(cfg.ngram, self.device))
        # the single writer of the drafter: a back buffer behind the store
        # (two chains, one catch-up launch per learner step).  Two
        # overlapping generate() calls must not write the back at once, so
        # _learn holds _learn_lock; drafting stays lock-free.
        self._learner = epoch.BackBufferLearner(self.drafter_store)
        self._learn_lock = threading.Lock()
        # telemetry (DESIGN.md §13): lock-free obs registry counters.
        # model_calls counts decode+extend forwards (the latency metric);
        # plain greedy needs exactly max_new_tokens-1 of them.
        self.metrics = obs_metrics.Registry()
        # maintenance gauges are absolute values read off the freshly
        # published chain (not increments); surfaced through a provider so
        # scrapes and the stats view share one source of truth
        self._maint = {"decay_steps": 0, "dh_rebuilds": 0,
                       "dh_tombstones": 0}
        self.metrics.register_provider(lambda: dict(self._maint))
        self._caches = None

    # ------------------------------------------------------------------
    def generate(self, batch: Dict, generator: Optional[torch.Generator]
                 = None) -> np.ndarray:
        """Generate max_new_tokens per sequence. Returns int32 [B, N].
        ``generator`` (on the engine's device) draws the samples when
        ``cfg.greedy`` is off."""
        cfg = self.cfg
        tokens = _host(batch["tokens"]).astype(np.int32)
        b, s = tokens.shape
        logits, caches = self.model.prefill(
            self.params, dict(batch, tokens=torch.as_tensor(
                tokens, device=self.device)), cfg.max_cache_len)
        out = np.zeros((b, cfg.max_new_tokens), np.int32)
        cur = self._sample(logits, generator)          # first new token
        pos = torch.full((b,), s, dtype=torch.int32,
                         device=self.device)           # cache position of cur
        n_done = 0
        history = tokens.copy()

        while n_done < cfg.max_new_tokens:
            cur_host = _host(cur)
            out[:, n_done] = cur_host
            history = np.concatenate([history, cur_host[:, None]], 1)
            n_done += 1
            if n_done >= cfg.max_new_tokens:
                break
            budget = cfg.max_new_tokens - n_done
            if cfg.draft_len > 0 and budget > 1 and cfg.greedy:
                cur, pos, emitted = self._speculative_round(
                    caches, cur, pos, history, min(cfg.draft_len, budget - 1))
                caches = self._caches  # updated by the round
                for t in emitted:
                    out[:, n_done] = t
                    history = np.concatenate([history, t[:, None]], 1)
                    n_done += 1
                    if n_done >= cfg.max_new_tokens:
                        break
            else:
                logits, caches = self.model.decode_step(
                    self.params, caches, cur[:, None], pos)
                self.metrics.counter_add("model_calls")
                cur = self._sample(logits, generator)
                pos = pos + 1

        # online learning: feed emitted tokens back into the chain and
        # publish a new snapshot for subsequent requests
        self._learn(history)
        return out

    # ------------------------------------------------------------------
    def _learn_step(self, state, toks, dirty=None, table_dirty=None):
        spec.observe_(state, toks, cfg=self.cfg.ngram, dirty=dirty,
                      table_dirty=table_dirty)
        return spec.maintain_(state, cfg=self.cfg.ngram, dirty=dirty)

    def _learn(self, history) -> None:
        """Serialised learner step: observe emitted tokens, run §II.C
        maintenance (rolling decay, decided on the device) in the back
        state, publish it, and surface the maintenance counters in
        ``stats``."""
        toks = torch.as_tensor(_host(history).astype(np.int32))
        with self._learn_lock, self.metrics.span("engine.learn"):
            failpoint("engine.learn", tokens=int(toks.shape[-1]))
            new_state = self._learner.write(self._learn_step, toks)
            # inside the learn lock: a stale state's counters must not
            # overwrite a newer learner's view
            self._maint = {k: int(v) for k, v
                           in mc.maintenance_stats(new_state.chain).items()
                           if k in self._maint}

    # ------------------------------------------------------------------
    def _speculative_round(self, caches, cur, pos, history, k
                           ) -> Tuple[torch.Tensor, torch.Tensor, list]:
        """One draft-verify round.

        Feeds [cur, draft_0..draft_{k-2}] (k tokens) through extend_step;
        logits[i] is the model's choice after consuming token i.  Batch-wide
        longest-prefix acceptance; on partial acceptance the pre-extend
        caches are kept (free rollback) and re-extended with the accepted
        tokens only.  Returns (next cur, next pos, [emitted token arrays]).
        """
        ngram = self.cfg.ngram
        snap = self._learner.acquire()
        try:
            ctx = np.ascontiguousarray(history[:, -max(ngram.order, 2):])
            draft, ok = spec.draft(snap.state, ctx, cfg=ngram,
                                   k=max(self.cfg.draft_len, 1))
            self.metrics.counter_add("draft_calls")  # one kernel launch
        finally:
            self.drafter_store.release(snap)
        b = cur.shape[0]
        draft = (_host(draft)[:, : k - 1] if k > 1
                 else np.zeros((b, 0), np.int32))
        ok = (_host(ok)[:, : k - 1] if k > 1 else np.zeros((b, 0), bool))
        n_drafted = int(ok.all(axis=0).cumprod().sum()) if ok.size else 0
        draft = draft[:, :n_drafted]

        if n_drafted == 0:  # nothing usable: plain decode step
            logits, self._caches = self.model.decode_step(
                self.params, caches, cur[:, None], pos)
            self.metrics.counter_add("model_calls")
            return self._sample(logits, None), pos + 1, []

        self.metrics.counter_add("rounds")
        self.metrics.counter_add("drafted", int(draft.size))
        feed = torch.cat([cur[:, None], torch.as_tensor(
            draft, device=self.device)], dim=1)          # [B, 1+n]
        logits, ext_caches = self.model.extend_step(self.params, caches,
                                                    feed, pos)
        self.metrics.counter_add("model_calls")
        model_toks = _host(sampling.greedy(logits))      # [B, 1+n]

        # longest batch-wide prefix where model agrees with the draft
        agree = (model_toks[:, :-1] == draft).all(axis=0)
        n_acc = int(np.cumprod(agree).sum())
        self.metrics.counter_add("accepted", n_acc * draft.shape[0])

        emitted = [model_toks[:, j] for j in range(n_acc)]
        nxt = torch.as_tensor(model_toks[:, n_acc], device=self.device)
        if n_acc == draft.shape[1]:
            # fully accepted: keep the extended caches; bonus token is the
            # model's continuation after the last draft token
            self._caches = ext_caches
            return nxt, pos + n_acc + 1, emitted
        # partial: roll back (keep pre-extend caches) and re-extend with the
        # accepted prefix only; the correction token came from the verify
        _, self._caches = self.model.extend_step(self.params, caches,
                                                 feed[:, : n_acc + 1], pos)
        self.metrics.counter_add("model_calls")
        return nxt, pos + n_acc + 1, emitted

    # ------------------------------------------------------------------
    def _sample(self, logits, generator):
        if self.cfg.greedy:
            return sampling.greedy(logits)
        if generator is None:
            raise ValueError("sampling (greedy=False) needs a torch.Generator "
                             "on the engine's device")
        return sampling.temperature(generator, logits, self.cfg.temperature)

    @property
    def stats(self) -> Dict[str, int]:
        """Dict view over the obs registry (the registry is the one source
        of truth; this is a point-in-time copy, so mutate metrics through
        ``self.metrics``, not this dict)."""
        scalars = self.metrics.scalars()
        keys = ("model_calls", "accepted", "drafted", "rounds",
                "draft_calls", "decay_steps", "dh_rebuilds",
                "dh_tombstones")
        return {k: int(scalars.get(k, 0)) for k in keys}

    @property
    def acceptance_rate(self) -> float:
        st = self.stats
        return st["accepted"] / max(1, st["drafted"])


@dataclasses.dataclass
class ShardedServeConfig:
    """Serving-side knobs around a :class:`repro.core.sharded.ShardedConfig`."""

    sharded: sh.ShardedConfig
    decay_threshold: int = 1 << 18   # row-total that triggers §II.C decay
    threshold: float = 0.9           # default cumulative-probability target
    max_items: int = 16              # per-query emission window
    topn: int = 16                   # global top-n read size
    # durability & elasticity (DESIGN.md §10): a snapshot dir arms
    # checkpoint()/restore(); snapshot_every > 0 snapshots in the background
    # every that many observe() calls; a WAL dir makes recovery exact
    # (snapshot + deterministic replay of the batches logged after it)
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 0
    wal_dir: Optional[str] = None
    wal_fsync: str = "rotate"        # always | rotate | never (A11)
    observe_deadline_s: float = 60.0  # StepWatchdog budget per observe()
    reingest_slice_len: int = 256    # per-shard batch slice during reshard
    # fault model (DESIGN.md §12): retry ladder for transient IO/dispatch
    # faults, bounded re-route of skew-dropped routed items, degradation
    # knobs.  The retry budgets default to 0 (tier off) so the fault-free
    # pipeline — and WAL-replay determinism against logs written without
    # the tier — is unchanged unless explicitly enabled.
    retry: RetryPolicy = RetryPolicy()
    route_retry_budget: int = 0      # re-route attempts per dropped update
    route_retry_slice: int = 128     # retry items drained per observe()
    query_retry_budget: int = 0      # in-call re-dispatch rounds per query
    health_strikes: int = 3          # consecutive failures -> shard down
    deferred_cap: int = 4096         # max deferred write items (total)
    # telemetry (DESIGN.md §13): where armed flight-recorder incidents
    # dump; MCQ_METRICS_INCIDENT_DIR overrides when set in the process env
    incident_dir: Optional[str] = None
    # reader lanes of a rank group (``ShardedEngine(ranks=)``): each its
    # own communicator (and, on a card, stream); ``lane=`` picks one
    read_lanes: int = 1


class RankDisagreement(RuntimeError):
    """The ranks of a group called the engine's writer with different calls
    or arguments (two threads' ``observe`` calls taken in different orders
    on two ranks, say); raised on every rank, before any rank applies
    anything.  ``table`` holds each rank's side of the exchange."""

    def __init__(self, message: str, table: np.ndarray):
        super().__init__(message)
        self.table = table


class RankPeerFault(RuntimeError):
    """A step failed on another rank of the group, and this rank raises
    too, so that none goes on alone; ``rank`` is the rank where it failed,
    ``shard`` the shard its fault named (if any)."""

    def __init__(self, rank: int, shard: Optional[int] = None):
        super().__init__(f"the step failed on rank {rank}")
        self.rank = rank
        if shard is not None:
            self.shard = shard


class _RankPeerIOFault(UnretryableIOError):
    """:class:`RankPeerFault` of a fault the failing rank's ladder would
    not retry (``classify_io_error``: persistent)."""

    def __init__(self, rank: int, shard: Optional[int] = None):
        super().__init__(f"the step failed on rank {rank} (not retried)")
        self.rank = rank
        if shard is not None:
            self.shard = shard


class _RouteMoved(BaseException):
    """A lane's ranks read under different route epochs: every rank drops
    the read, waits for ``epoch`` and reads again.  A ``BaseException``,
    so that neither the retry ladder nor a degraded read takes it."""

    def __init__(self, epoch: int):
        super().__init__(epoch)
        self.epoch = epoch


class _Lane(NamedTuple):
    """A reader lane of a rank group: its group and, on a card, its
    stream."""
    index: int
    group: object
    stream: Optional[object]


#: the writer's calls, as the first exchange of each names them
_WRITER_CALLS = ("observe", "checkpoint", "restore", "reassign",
                 "mark_shard_down", "heal_shard")
_AGREE_WIDTH = 8


def _digest(*arrays) -> int:
    """A signed 64-bit digest of arrays (dtype, shape and bytes)."""
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(repr((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return int.from_bytes(h.digest(), "little", signed=True)


def _agreed(group, fn, epoch: Optional[int] = None):
    """Run ``fn`` (this rank's part of a step that can fail on one rank
    alone) and agree on the outcome over ``group``: when it failed on any
    rank, every rank raises — the lowest failing rank its own exception,
    every other a :class:`RankPeerFault` classified and attributed as that
    one — so that the retry ladder, the poison and the health map move in
    step.  A read passes its route ``epoch``: ranks that disagree raise
    :class:`_RouteMoved` with the highest."""
    failed = None
    try:
        out = fn()
    except Exception as exc:   # agreed below, raised on every rank
        failed = exc
    shard = shard_from_exception(failed) if failed is not None else None
    table = group.agree([
        0 if epoch is None else epoch, failed is not None,
        failed is not None and classify_io_error(failed) == "persistent",
        -1 if shard is None else shard])
    if epoch is not None and (table[:, 0] != table[0, 0]).any():
        raise _RouteMoved(int(table[:, 0].max()))
    bad = np.flatnonzero(table[:, 1])
    if bad.size == 0:
        return out
    first = int(bad[0])
    if first == group.rank:
        raise failed
    cls = _RankPeerIOFault if table[first, 2] else RankPeerFault
    raise cls(first, None if table[first, 3] < 0 else int(table[first, 3]))


def _hash_u32_np(x: np.ndarray) -> np.ndarray:
    """Vectorised numpy mirror of ``core.hashtable.hash_u32`` (splitmix32)
    so the telemetry traffic tally can bucket a batch host-side without a
    device dispatch."""
    x = x.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _bucket_of_np(src: np.ndarray, num_buckets: int) -> np.ndarray:
    """Host-side twin of ``Ownership.bucket_of``."""
    h = _hash_u32_np(np.asarray(src))
    return ((h >> np.uint32(8)) % np.uint32(num_buckets)).astype(np.int64)


class ShardedEngine:
    """Shard-parallel MCPrioQ behind the serving boundary.

    Node-space shards (logical shards of one device) with fixed-capacity
    bucket routing, every per-shard body dispatching the kernel layer.
    ``observe`` runs the single-writer catch-up -> update -> maintain ->
    publish cycle of a back-buffer learner behind the ``EpochStore`` under
    a writer lock (rolling per-shard decay keeps the maintain step O(block)
    on every shard), while ``query``/``topn`` readers stay lock-free on
    their snapshots.  Routing/overflow counters are
    surfaced in ``stats`` — drops are the measurable price of static shapes,
    the paper's "approximately correct" contract.

    Batches are padded host-side to a multiple of ``num_shards`` with
    inactive (-1) items, which consume no bucket capacity.
    """

    # Normative lock order + protection map (DESIGN.md §11; enforced by
    # tools/mcqlint).  Outermost first; EpochStore._lock is a global leaf
    # below all of these (it is only ever taken inside store calls).  The
    # WAL append rides under the write lock so append-then-apply is atomic
    # with respect to other writers (write-ahead ordering, invariant I3).
    _MCQ_LOCK_ORDER = ("_write_lock", "_route_lock", "_compile_lock",
                       "_stats_lock")
    _MCQ_LOCK_PROTECTS = {
        "_write_lock": ("store.publish", "wal.append", "_seq", "_io_threads",
                        "_retry_queue", "_poisoned"),
        # the (program, snapshot) pairing: _rebind swaps all three together
        "_route_lock": ("cfg", "_update", "_maintain"),
        "_compile_lock": ("_query_fns", "_topn_fns"),
        "_stats_lock": ("stats",),
    }

    def __init__(self, cfg: ShardedServeConfig, device=None, *, ranks=None):
        scfg = cfg.sharded
        self.cfg = cfg
        # the S shards are logical shards of this one device (default: the
        # GPU; an error without one); with ``ranks`` this process holds
        # shard ``ranks.rank`` on the group's device
        self.ranks = ranks
        if ranks is not None and device is None:
            device = ranks.device
        self.device = resolve_device(device)
        self.store = EpochStore(sh.init_sharded(scfg, self.device,
                                                ranks=ranks))
        # the single writer: a back buffer behind the store (two stacked
        # states, one catch-up launch per write); rebuilt around the new
        # state by restore() and reassign()
        self._writer = epoch.BackBufferLearner(self.store)
        self._update = sh.make_update_fn_(scfg, ranks=ranks)
        self._maintain = sh.make_maintain_fn_(
            scfg, total_threshold=cfg.decay_threshold, ranks=ranks)
        # a rank group's reader lanes (made in the same order on every
        # rank) and the route epoch their reads agree on
        self._lanes = [] if ranks is None else [
            _Lane(i, g, torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
            for i, g in enumerate(ranks.lanes(cfg.read_lanes))]
        self._route_epoch = 0
        # reads a rank group ran again because its ranks had pinned states
        # of two route epochs (not a metric of the reference's catalog)
        self.read_route_retries = 0
        # set when the rank group is lost: every later call raises
        self._lost: Optional[str] = None
        # bounded, insertion-ordered caches of routed read programs keyed by
        # their static args; guarded by a lock so concurrent first-time
        # readers build one program, and capped so per-request float
        # thresholds cannot grow the caches without bound
        self._query_fns: Dict[Tuple[float, int], object] = {}
        self._topn_fns: Dict[int, object] = {}
        self._fn_cache_max = 8
        self._compile_lock = threading.Lock()
        # single-writer invariant: two overlapping observe() calls must not
        # write the one back state at once
        self._write_lock = threading.Lock()
        # routing-consistency lock: readers hold it only while pairing a
        # routed program with a snapshot (microseconds — never during the
        # device compute), and rebalance/restore hold it while swapping
        # (rebind + publish) so a reader can never combine the NEW
        # ownership's routing with the OLD state's row placement (or vice
        # versa).  Reads stay lock-free with respect to the learner; they
        # briefly serialise only against a rebalance swap.
        self._route_lock = threading.Lock()
        # a rank group's reader waits on it for its route epoch to move
        self._route_moved = threading.Condition(self._route_lock)
        # readers are lock-free on their snapshots, but the stats dict is
        # shared by all of them — unguarded read-modify-write of the drop
        # counters would silently undercount, defeating the observability
        # contract the counters exist for
        self._stats_lock = threading.Lock()
        self.stats = {"updates": 0, "queries": 0, "topn_calls": 0,
                      "query_dropped": 0, "topn_dropped": 0, "snapshots": 0,
                      # fault-model counters (DESIGN.md §12): the retry
                      # ladder, the overflow-retry tier and degraded reads
                      # are only observable through these
                      "route_retried": 0, "route_lost": 0,
                      "query_retried": 0, "query_lost": 0,
                      "degraded_answers": 0, "deferred_writes": 0,
                      "shards_down": 0, "wal_errors": 0, "wal_retries": 0,
                      "apply_retries": 0, "dispatch_retries": 0,
                      "write_errors": 0, "snapshot_failures": 0}
        snap = self._writer.acquire()
        try:
            self.stats.update(mc.counter_stats(snap.state, ranks=ranks))
        finally:
            self.store.release(snap)
        # telemetry (DESIGN.md §13): a per-engine lock-free registry; the
        # stats dict stays the collector (the explorer instruments it) and
        # feeds the registry through a provider, so scrapes, serve.py and
        # tests read one consistent source of truth.  MCQ_METRICS in the
        # env arms histograms/spans/incidents for subprocess harnesses
        # (tools/chaos), same contract as the failpoint arming below.
        own0 = scfg.resolved_ownership()
        env_incident_dir = obs_metrics.arm_from_env()
        self.metrics = obs_metrics.Registry(
            vectors={"bucket_traffic": own0.num_buckets,
                     "shard_traffic": scfg.num_shards},
            incident_dir=(env_incident_dir or cfg.incident_dir)
            if self._rank0 else None)
        self.metrics.register_provider(self.stats_snapshot)
        # durability (DESIGN.md §10): WAL position of the published state;
        # -1 = nothing applied.  The WAL resumes its sequence from disk, so
        # an engine pointed at an existing log must restore() before
        # observing or the snapshot/WAL positions drift apart.
        self._seq = -1
        # on a rank group rank 0 alone logs; ``_wal_errors`` is rank 0's
        # IO error count as the last write agreed it, on every rank
        self.wal = (WriteAheadLog(cfg.wal_dir, fsync=cfg.wal_fsync,
                                  metrics=self.metrics)
                    if cfg.wal_dir and self._rank0 else None)
        self._wal_errors = 0
        # outstanding background snapshot IO threads (non-daemon: a
        # "committed" snapshot must never be torn by process exit); joined
        # by close() and pruned as they finish
        self._io_threads: list = []
        # straggler escalation -> checkpoint-now, so a kill after a stall
        # loses nothing (runtime/fault_tolerance.py contract)
        self.watchdog = (StepWatchdog(
            WatchdogConfig(deadline_s=cfg.observe_deadline_s),
            on_escalate=self._escalate_snapshot if ranks is None
            else self._escalate_ranks)
            if cfg.snapshot_dir else None)
        self._escalated = False
        # graceful degradation (DESIGN.md §12): per-shard health map — down
        # shards are excluded from routed reads, their writes defer bounded
        self.health = ShardHealth(scfg.num_shards,
                                  strike_limit=cfg.health_strikes,
                                  deferred_cap=cfg.deferred_cap)
        # write-path poisoning (A13): set when an escalated WAL/apply fault
        # leaves durability and applied state out of agreement; observe()
        # raises EngineWriteUnavailable until restore() heals
        self._poisoned: Optional[str] = None
        # carry-over of skew-dropped update items (route_retry_budget > 0):
        # chunks of (src, dst, w, tries) arrays drained at the head of
        # later observe() calls, bounded by the per-item retry budget
        self._retry_queue: list = []
        # failpoints armed via MCQ_FAILPOINTS follow the process, not the
        # engine: arming here makes subprocess harnesses (tools/chaos) work
        # without an API call into the serving process
        arm_from_env()

    @property
    def _logs(self) -> bool:
        """True where a WAL logs every batch (on a rank group, rank 0's)."""
        return self.wal is not None if self.ranks is None \
            else bool(self.cfg.wal_dir)

    @property
    def _rank0(self) -> bool:
        """True on one card and on rank 0 of a group (the WAL's and the
        snapshots' owner)."""
        return self.ranks is None or self.ranks.rank == 0

    # ------------------------------------------------------------------
    def _cached_fn(self, cache: Dict, key, build):
        """Bounded get-or-build of a routed read program (FIFO eviction —
        an evicted key is built again if it returns)."""
        with self._compile_lock:
            fn = cache.get(key)
            if fn is None:
                if len(cache) >= self._fn_cache_max:
                    cache.pop(next(iter(cache)))
                fn = build()
                cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    def _pad(self, *arrays):
        """Pad 1-D arrays to a multiple of num_shards with inactive items
        (src = -1 never routes), as tensors on the engine's device.  Returns
        (padded..., original_len)."""
        n = self.cfg.sharded.num_shards
        b = arrays[0].shape[0]
        pad = (-b) % n
        out = []
        for i, a in enumerate(arrays):
            a = torch.as_tensor(a, device=self.device)
            fill = -1 if i == 0 else 0   # first array is always src
            if pad:
                a = torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                             device=self.device)])
            out.append(a)
        return (*out, b)

    # ------------------------------------------------------------------
    def observe(self, src, dst, weights=None) -> None:
        """Route one transition batch to its owner shards and learn from it.

        Serialised writer: WAL append (write-AHEAD: the batch is durable
        before it is applied) -> the learner's write: catch-up -> update
        (bucket-routed, kernel per shard) -> maintain (rolling per-shard
        decay) -> publish -> cadence snapshot.  The watchdog observes the step
        duration outside the lock; escalation checkpoints immediately.

        Fault ladder (DESIGN.md §12): transient IO/dispatch faults retry
        under ``cfg.retry`` (capped exponential backoff + jitter);
        persistent faults and exhausted budgets escalate — the write path
        poisons (readers keep serving the last published epoch, writes
        raise :class:`EngineWriteUnavailable` until ``restore()`` heals)
        and a best-effort checkpoint-now captures what is already
        consistent.  ``_seq`` only advances once the batch is both durable
        AND applied, so a mid-step fault can never leave the WAL position
        pointing past unapplied state.  Cadence-snapshot failures are
        counted, never raised: a lost snapshot costs replay time, not
        correctness.
        """
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        w = (np.ones(src.shape, np.int32) if weights is None
             else np.asarray(weights, np.int32))
        t0 = time.monotonic()
        if self.ranks is not None:
            with self.metrics.span("engine.observe", items=int(src.size)):
                with self._write_lock:
                    try:
                        self._observe_ranks_locked(src, dst, w, t0)
                    except RankGroupLost as exc:
                        raise self._lost_locked("observe", exc) from exc
            return
        with self.metrics.span("engine.observe", items=int(src.size)):
            with self._write_lock:
                if self._poisoned is not None:
                    raise EngineWriteUnavailable(self._poisoned)
                if self.wal is not None:
                    seq = self._append_wal_locked(src, dst, w)
                    if self.wal.io_errors:
                        with self._stats_lock:
                            self.stats["wal_errors"] = self.wal.io_errors
                else:
                    seq = self._seq + 1
                self._apply_with_retry_locked(src, dst, w)
                self._seq = seq
                every = self.cfg.snapshot_every
                if (every and self.cfg.snapshot_dir
                        and (self._seq + 1) % every == 0):
                    try:
                        self._snapshot_locked(sync=False)
                    except Exception:
                        with self._stats_lock:
                            self.stats["snapshot_failures"] += 1
        if self.watchdog is not None:
            self.watchdog.observe(time.monotonic() - t0)

    @requires_lock("_write_lock")
    def _observe_ranks_locked(self, src, dst, w, t0) -> None:
        """:meth:`observe` on a rank group.  Rank 0 logs the batch; one
        exchange then settles, on every rank, that every rank is in the
        same call on the same batch, rank 0's WAL outcome and ``seq``, and
        rank 0's IO counters (retries, errors, snapshot failures).  Then
        every rank applies its slice, and the cadence snapshot and the
        watchdog (timed by rank 0) decide alike."""
        if self._poisoned is not None:
            raise EngineWriteUnavailable(self._poisoned)
        seq, logged, wal_exc = self._seq + 1, 0, None
        if self.wal is not None:
            try:
                seq = call_with_retry(
                    lambda: self.wal.append(src, dst, w),
                    policy=self.cfg.retry,
                    on_retry=self._count_retry("wal_retries"),
                    metrics=self.metrics)
                logged = 1
            except Exception as exc:   # agreed below, raised on every rank
                wal_exc, logged = exc, -1
        with self._stats_lock:
            io = [self.stats[k] for k in ("wal_retries", "snapshot_failures",
                                          "snapshots")]
        try:
            table = self._agree_locked(
                "observe", _digest(src, dst, w), logged, seq,
                self.wal.io_errors if self.wal is not None else 0, *io)
        except RankDisagreement as exc:
            if exc.table[0, 0] == _WRITER_CALLS.index("observe") and \
                    exc.table[0, 2] == 1:
                # rank 0 logged a batch no rank applies: as an apply fault
                # after a durable append, restore() replays it
                self._poison_locked(f"ranks disagree after rank 0 logged "
                                    f"seq {exc.table[0, 3]}: {exc}",
                                    checkpoint=False)
            raise
        logged, seq, wal_errors = (int(x) for x in table[0, 2:5])
        with self._stats_lock:
            for key, val in zip(("wal_retries", "snapshot_failures",
                                 "snapshots"), table[0, 5:8]):
                self.stats[key] = int(val)
            if logged == 1 and wal_errors:
                self.stats["wal_errors"] = wal_errors
        self._wal_errors = wal_errors
        if logged == -1:
            why = repr(wal_exc) if wal_exc is not None else "on rank 0"
            self._poison_locked(f"WAL append failed: {why}")
            raise EngineWriteUnavailable(
                f"write path poisoned: WAL append failed: {why}") from wal_exc
        self._apply_with_retry_locked(src, dst, w)
        self._seq = seq
        every = self.cfg.snapshot_every
        if every and self.cfg.snapshot_dir and (self._seq + 1) % every == 0:
            try:
                self._snapshot_locked(sync=False)
            except RankGroupLost:
                raise
            except Exception:
                with self._stats_lock:
                    self.stats["snapshot_failures"] += 1
        if self.watchdog is not None:
            # rank 0's clock decides for every rank
            took = self.ranks.agree([int((time.monotonic() - t0) * 1e6)])
            self.watchdog.observe(int(took[0, 0]) / 1e6)
            if self._escalated:
                self._escalated = False
                self._snapshot_locked()

    def _escalate_ranks(self) -> None:
        # on a rank group the escalation checkpoints inside the observe
        # that timed it, still under the write lock (every rank at once)
        self._escalated = True

    @requires_lock("_write_lock")
    def _agree_locked(self, call: str, digest: int, *values) -> np.ndarray:
        """The first exchange of a writer's call on a rank group: every
        rank's ``(call, digest, *values)`` on every rank (``[world,
        8]``).  Raises :class:`RankDisagreement` on every rank unless every
        rank is in the same call with the same digest."""
        row = [_WRITER_CALLS.index(call), digest, *values]
        table = self.ranks.agree(row + [0] * (_AGREE_WIDTH - len(row)))
        if (table[:, :2] != table[0, :2]).any():
            said = ", ".join(
                f"rank {r}: {_WRITER_CALLS[int(c)]} {d:#018x}"
                for r, (c, d) in enumerate(table[:, :2].tolist()))
            raise RankDisagreement(
                f"ShardedEngine.{call} on rank {self.ranks.rank}: the ranks "
                f"called the writer with different calls or arguments "
                f"({said}); nothing was applied", table)
        return table

    @requires_lock("_write_lock")
    def _agree_or_lose_locked(self, call: str, *args) -> np.ndarray:
        """:meth:`_agree_locked` of a writer's call other than ``observe``
        over a digest of ``args``; a lost group poisons."""
        if self._lost is not None:
            raise EngineWriteUnavailable(self._lost)
        try:
            return self._agree_locked(call, _digest(*args))
        except RankGroupLost as exc:
            raise self._lost_locked(call, exc) from exc

    @requires_lock("_write_lock")
    def _lost_locked(self, call: str, exc: BaseException
                     ) -> EngineWriteUnavailable:
        """The rank group failed under a writer's call: poison (no
        checkpoint: it needs the group) and name the call."""
        self._lost = (f"ShardedEngine.{call}: the rank group is lost ({exc}); "
                      f"recover with a new group and restore()")
        self._poisoned = self._lost
        with self._stats_lock:
            self.stats["write_errors"] += 1
        return EngineWriteUnavailable(self._lost)

    def _count_retry(self, key: str):
        """An ``on_retry`` hook that tallies backoff rounds into stats."""
        def bump(attempt, exc):
            with self._stats_lock:
                self.stats[key] += 1
        return bump

    def stats_snapshot(self) -> Dict[str, int]:
        """One consistent image of every stats surface (satellite of
        DESIGN.md §13): the host counters AND the device ``counter_stats``
        sums are copied under a single ``_stats_lock`` hold (they commit
        together in ``_apply_locked``, so the copy can never capture a
        half-applied batch — no ``route_retried > route_dropped``-style
        impossible states), then the health map's and WAL's own counters
        overlay.  This is the registry provider — the metrics endpoint,
        ``serve.py``'s stats line and tests all read this one method."""
        # health/WAL counters are read OUTSIDE _stats_lock: _apply_locked
        # nests health._mu inside _stats_lock, so nesting them here in the
        # opposite order would be a lock cycle
        health = self.health.stats()
        if self.ranks is not None:
            # rank 0's WAL count as the last write agreed it: the same on
            # every rank
            wal_errors = self._wal_errors if self.cfg.wal_dir else None
        else:
            wal_errors = self.wal.io_errors if self.wal is not None else None
        with self._stats_lock:
            out = dict(self.stats)
        out.update(health)
        if wal_errors is not None:
            out["wal_errors"] = wal_errors
        return out

    def _record_traffic(self, src: np.ndarray) -> None:
        """Armed-only per-bucket/per-shard tally of a dispatched batch.
        Mirrors the routing hash host-side; inactive (-1) padding never
        counts."""
        active = np.asarray(src)
        active = active[active >= 0]
        if active.size == 0:
            return
        own = self.cfg.sharded.resolved_ownership()
        buckets = _bucket_of_np(active, own.num_buckets)
        counts = np.bincount(buckets, minlength=own.num_buckets)
        self.metrics.vector_add("bucket_traffic", counts)
        assign = np.asarray(own.resolved_assignment(), np.int64)
        self.metrics.vector_add(
            "shard_traffic",
            np.bincount(assign[buckets],
                        minlength=self.cfg.sharded.num_shards))

    def _record_dispatch_failure(self, exc: BaseException) -> None:
        """Strike the owning shard when an escalated dispatch fault names
        one (a :class:`ShardDispatchError` anywhere in the cause chain —
        per-shard RPC timeout, lost device).  After ``health_strikes``
        consecutive escalations the shard goes down automatically: reads
        mask it, writes defer — the same state ``mark_shard_down``
        reaches administratively.  Unattributable faults strike nobody
        (one bad dispatch says nothing about WHICH shard is sick)."""
        shard = shard_from_exception(exc)
        if shard is None or not 0 <= shard < self.cfg.sharded.num_shards:
            return
        if self.health.record_failure(shard):
            with self._stats_lock:
                self.stats["shards_down"] = \
                    self.health.stats()["shards_down"]
            # flight-recorder incident (armed-only): a shard just struck
            # out — snapshot the spans + metric deltas that led here
            self.metrics.incident("strike_out", shard=shard,
                                  error=repr(exc))

    @requires_lock("_write_lock")
    def _append_wal_locked(self, src, dst, w) -> int:
        """Durably log one batch under the retry ladder.

        On escalation (persistent errno or exhausted budget) nothing is
        durable and nothing was applied — the engine state is still
        consistent, so poison the write path (checkpoint-now inside) and
        surface :class:`EngineWriteUnavailable` to the caller."""
        try:
            return call_with_retry(
                lambda: self.wal.append(src, dst, w),
                policy=self.cfg.retry,
                on_retry=self._count_retry("wal_retries"),
                metrics=self.metrics)
        except Exception as exc:
            self._poison_locked(f"WAL append failed: {exc!r}")
            raise EngineWriteUnavailable(
                f"write path poisoned: WAL append failed: {exc!r}") from exc

    @requires_lock("_write_lock")
    def _apply_with_retry_locked(self, src, dst, w) -> None:
        """Dispatch one batch under the retry ladder.

        ``_apply_locked`` commits nothing host-side until its publish
        succeeds, so re-invoking it after a fault re-runs an identical
        plan.  Exhausted WITH a WAL, the batch is durable but unapplied —
        letting callers continue would fork the chain from its own log,
        so poison; ``restore()`` replays the ghost record and heals.
        Without a WAL the state is simply unchanged: re-raise."""
        try:
            call_with_retry(
                lambda: self._apply_locked(src, dst, w),
                policy=self.cfg.retry,
                on_retry=self._count_retry("apply_retries"),
                metrics=self.metrics)
            self.health.record_success_all()
        except Exception as exc:
            if isinstance(exc, (RankGroupLost, RankDisagreement)):
                raise
            self._record_dispatch_failure(exc)
            if self._logs:
                self._poison_locked(
                    f"apply failed after durable append: {exc!r}")
                raise EngineWriteUnavailable(
                    f"write path poisoned: apply failed: {exc!r}") from exc
            raise

    @requires_lock("_write_lock")
    def _poison_locked(self, reason: str, checkpoint: bool = True) -> None:
        """Escalation terminus for write-path faults (A13): writes raise
        until ``restore()`` heals, readers keep serving the last published
        epoch, and a best-effort checkpoint-now preserves everything that
        is already consistent (its failure is counted, not raised — the
        disk that poisoned us is likely still broken; ``checkpoint=False``
        skips it)."""
        self._poisoned = reason
        with self._stats_lock:
            self.stats["write_errors"] += 1
        # flight-recorder incident (armed-only): the write path just died;
        # dump the spans + metric deltas leading up to the poison BEFORE
        # the best-effort checkpoint below touches the broken disk
        self.metrics.incident("poison", why=reason)
        if self.cfg.snapshot_dir and checkpoint:
            try:
                self._snapshot_locked(sync=False)
            except RankGroupLost:
                raise
            except Exception:
                with self._stats_lock:
                    self.stats["snapshot_failures"] += 1

    @property
    def write_available(self) -> bool:
        """False while the write path is poisoned (reads still serve) or
        the rank group is lost."""
        return self._poisoned is None and self._lost is None

    def _drain_plan(self, queue):
        """FIFO split of the retry queue into ``(drained, remaining)``
        chunk lists, taking at most ``route_retry_slice`` items.  Pure —
        the caller commits the remainder only after its dispatch succeeds,
        so a retried dispatch re-plans identically."""
        take, rest = [], []
        room = max(1, self.cfg.route_retry_slice)
        for chunk in queue:
            size = int(chunk[0].size)
            if room >= size:
                take.append(chunk)
                room -= size
            elif room > 0:
                take.append(tuple(a[:room] for a in chunk))
                rest.append(tuple(a[room:] for a in chunk))
                room = 0
            else:
                rest.append(chunk)
        return take, rest

    @requires_lock("_write_lock")
    def _apply_locked(self, src, dst, w) -> None:
        """One learner cycle against the published state (caller holds the
        write lock).  Shared verbatim by observe(), WAL replay and
        heal_shard() — the recovery determinism contract is 'same batches
        through the same pipeline', so there must only be one pipeline.

        Failure atomicity: every host-side plan (retry-queue drain,
        down-shard deferral, overflow prediction) is computed into locals
        and committed only after the publish succeeds, so a raising
        dispatch leaves the queue, the health map and the published state
        exactly as they were — the caller's retry re-runs an identical
        plan, and a non-retried fault changes nothing.  A fault inside the
        learner's write may leave its private back state written; the
        rows it wrote are flagged, and the next write's catch-up copies
        them back from the published state first.
        """
        scfg = self.cfg.sharded
        n_shards = scfg.num_shards
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        w = np.asarray(w, np.int32).reshape(-1)
        tries = np.zeros(src.shape, np.int32)
        budget = self.cfg.route_retry_budget
        remaining = self._retry_queue
        if budget > 0 and remaining:
            drained, remaining = self._drain_plan(remaining)
            src = np.concatenate([src] + [c[0] for c in drained])
            dst = np.concatenate([dst] + [c[1] for c in drained])
            w = np.concatenate([w] + [c[2] for c in drained])
            tries = np.concatenate([tries] + [c[3] for c in drained])
        defer_plan, lost_down = [], 0
        down = self.health.down
        if down:
            owner = scfg.resolved_ownership().owner_of(
                torch.from_numpy(src)).numpy()
            hit = np.isin(owner, list(down)) & (src >= 0)
            if hit.any():
                for s_id in sorted(int(x) for x in set(owner[hit])):
                    sel = hit & (owner == s_id)
                    defer_plan.append((s_id, src[sel].copy(),
                                       dst[sel].copy(), w[sel].copy()))
                src = np.where(hit, -1, src).astype(np.int32)
                dst = np.where(hit, 0, dst).astype(np.int32)
                w = np.where(hit, 0, w).astype(np.int32)
        pad = (-src.size) % n_shards
        if pad:
            src = np.concatenate([src, np.full(pad, -1, np.int32)])
            dst = np.concatenate([dst, np.zeros(pad, np.int32)])
            w = np.concatenate([w, np.zeros(pad, np.int32)])
            tries = np.concatenate([tries, np.zeros(pad, np.int32)])
        requeue, retried, lost_skew = None, 0, 0
        if budget > 0:
            drop = sh.predict_route_overflow(scfg, src)
            if drop.any():
                again = drop & (tries < budget)
                dead = drop & ~again
                retried = int(again.sum())
                lost_skew = int(dead.sum())
                if retried:
                    requeue = (src[again].copy(), dst[again].copy(),
                               w[again].copy(), tries[again] + 1)
                src = np.where(drop, -1, src).astype(np.int32)
                dst = np.where(drop, 0, dst).astype(np.int32)
                w = np.where(drop, 0, w).astype(np.int32)
        items = int(src.size)
        if self.ranks is None:
            failpoint("engine.apply", items=items)
            rows = (src, dst, w)
        else:
            # a fault on one rank is every rank's, before the exchange
            _agreed(self.ranks,
                    lambda: failpoint("engine.apply", items=items))
            local = src.size // n_shards
            part = slice(self.ranks.rank * local,
                         (self.ranks.rank + 1) * local)
            rows = (src[part], dst[part], w[part])
        with self.metrics.span("engine.apply"):
            update, maintain = self._update, self._maintain
            batch = [torch.tensor(x, device=self.device) for x in rows]

            def step(back, *, dirty, table_dirty):
                # the owner programs write the learner's back state; a fault
                # here publishes nothing, and the next write's catch-up
                # copies the flagged rows and table slots back from the
                # published front
                state = update(back, *batch, dirty=dirty,
                               table_dirty=table_dirty)
                state = maintain(state, dirty=dirty)
                if self.ranks is None:
                    failpoint("engine.publish")
                else:   # no rank publishes unless every rank does
                    _agreed(self.ranks, lambda: failpoint("engine.publish"))
                return state

            state = self._writer.write(step)
        self.metrics.gauge_set("store_version", self.store.version)
        if obs_metrics.is_armed():
            # per-virtual-bucket / per-shard traffic tally of the batch
            # that actually dispatched (the ROADMAP rebalancer's input)
            self._record_traffic(src)
        # the dispatch succeeded: commit the host-side plans
        if budget > 0:
            self._retry_queue = remaining + (
                [requeue] if requeue is not None else [])
        deferred = 0
        for s_id, qsrc, qdst, qw in defer_plan:
            if self.health.defer(s_id, qsrc, qdst, qw):
                deferred += int(qsrc.size)
            else:
                lost_down += int(qsrc.size)
        counters = mc.counter_stats(state, ranks=self.ranks)
        with self._stats_lock:
            self.stats["updates"] += 1
            self.stats.update(counters)
            if retried:
                self.stats["route_retried"] += retried
            if lost_skew or lost_down:
                self.stats["route_lost"] += lost_skew + lost_down
            if deferred or down:
                health = self.health.stats()
                self.stats["deferred_writes"] = health["deferred_writes"]
                self.stats["shards_down"] = health["shards_down"]

    # ------------------------------------------------------------------
    def query(self, src, threshold: Optional[float] = None,
              max_items: Optional[int] = None, lane: int = 0):
        """Per-src cumulative-threshold read (the paper's §II.B query),
        answered by the owner shards.  Returns ``(dsts[B, k], probs[B, k],
        n_needed[B])``; routing drops land in ``stats['query_dropped']``.

        Degraded reads (DESIGN.md §12): items owned by a down shard are
        masked out before dispatch and answered empty (counted in
        ``degraded_answers``); a faulting dispatch retries under
        ``cfg.retry`` and, exhausted, the whole call degrades to empty
        answers instead of failing the read path.  With
        ``query_retry_budget > 0``, items the router would drop for skew
        re-dispatch against the same snapshot (spread round-robin across
        sender slices, so each round shrinks the per-slice owner groups);
        items still dropped after the budget count into ``query_lost``.
        On a rank group the read runs on reader lane ``lane``.
        """
        t = float(self.cfg.threshold if threshold is None else threshold)
        k = int(self.cfg.max_items if max_items is None else max_items)
        span = self.metrics.span("engine.query")
        with span:
            return self._read(lane, "query",
                              lambda ln: self._query_once(src, t, k, ln))

    def _read(self, lane: int, call: str, body):
        """``body(None)`` on one card.  On a rank group ``body(lane)`` on
        reader lane ``lane`` (on a card: on the lane's stream, which waits
        for the caller's, its answers handed back to the caller's stream);
        a read whose ranks disagree on the route epoch runs again once this
        rank's epoch reaches the highest seen, and a lost group raises
        ``RankGroupLost`` naming the call."""
        if self.ranks is None:
            return body(None)
        if not 0 <= lane < len(self._lanes):
            raise ValueError(f"lane {lane}: the engine has "
                             f"{len(self._lanes)} read lanes")
        if self._lost is not None:
            raise RankGroupLost(f"ShardedEngine.{call}: {self._lost}")
        ln = self._lanes[lane]
        while True:
            try:
                if ln.stream is None:
                    return body(ln)
                caller = torch.cuda.current_stream(self.device)
                ln.stream.wait_stream(caller)
                with torch.cuda.stream(ln.stream):
                    out = body(ln)
                for x in out:
                    x.record_stream(caller)
                return out
            except _RouteMoved as moved:
                with self._route_moved:
                    self.read_route_retries += 1
                    if not self._route_moved.wait_for(
                            lambda: self._route_epoch >= moved.epoch,
                            timeout=self.ranks.timeout):
                        raise RankGroupLost(
                            f"ShardedEngine.{call} on lane {lane}: route "
                            f"epoch {moved.epoch} not reached here in "
                            f"{self.ranks.timeout} s") from None
            except RankGroupLost as exc:
                self._lost = (f"ShardedEngine.{call} on lane {lane}: the rank "
                              f"group is lost ({exc}); recover with a new "
                              f"group and restore()")
                raise RankGroupLost(self._lost) from exc

    def _pin(self, cache: Dict, key, build, ln):
        """The (program, snapshot) pair of a read, under the route lock:
        on a rank group the lane's program and snapshot (the lane rule)
        and the route epoch the read agrees on."""
        with self._route_lock:
            if ln is None:
                return self._cached_fn(cache, key, build), \
                    self._writer.acquire(), 0
            fn = self._cached_fn(cache, (*key, ln.index), build)
            return fn, self._writer.acquire_lane(ln.stream), self._route_epoch

    def _release(self, snap, ln) -> None:
        """Leave a read: a lane's stream first finishes what it queued."""
        if ln is not None and ln.stream is not None:
            ln.stream.synchronize()
        self.store.release(snap)

    def _query_once(self, src, t: float, k: int, ln):
        group = None if ln is None else ln.group
        fn, snap, route = self._pin(
            self._query_fns, (t, k),
            lambda: sh.make_query_fn(self.cfg.sharded, threshold=t,
                                     max_items=k, ranks=group,
                                     whole=True), ln)
        # freshness gauge: how many epochs this read's snapshot lags
        # the latest publish — the quantitative handle on the paper's
        # "approximately correct during concurrent updates" semantics
        self.metrics.gauge_set("read_epoch_lag",
                               self.store.version - snap.version)
        src = torch.as_tensor(src, device=self.device).to(torch.int32)
        src, b = self._pad(src)
        degraded = retried = lost = 0
        down = self.health.down
        if down:
            src_np = _host(src)
            owner = self.cfg.sharded.resolved_ownership().owner_of(
                torch.from_numpy(src_np)).numpy()
            hit = np.isin(owner, list(down)) & (src_np >= 0)
            if hit.any():
                degraded = int(hit[:b].sum())
                src = torch.from_numpy(
                    np.where(hit, -1, src_np).astype(np.int32)).to(
                        self.device)
        try:
            try:
                d, p, n, dropped = call_with_retry(
                    lambda: self._dispatch_query(fn, snap, src, ln,
                                                 route),
                    policy=self.cfg.retry,
                    on_retry=self._count_retry("dispatch_retries"),
                    metrics=self.metrics)
                n_dropped = int(dropped.sum())
                self.health.record_success_all()
            except Exception as exc:
                if isinstance(exc, RankGroupLost):
                    raise
                # the read path never raises for dispatch faults: the
                # whole call degrades to empty answers from zero shards
                # (counted) — still sorted-descending, trivially.  A
                # shard-attributable fault strikes its shard: after
                # health_strikes consecutive escalations it goes down
                # and later reads degrade without paying the dispatch.
                self._record_dispatch_failure(exc)
                bpad = int(src.shape[0])
                d = torch.full((bpad, k), -1, dtype=torch.int32,
                               device=self.device)
                p = torch.zeros((bpad, k), dtype=torch.float32,
                                device=self.device)
                n = torch.zeros((bpad,), dtype=torch.int32,
                                device=self.device)
                n_dropped = 0
                degraded = b
                self.metrics.incident("degraded_read", op="query",
                                      error=repr(exc))
            if self.cfg.query_retry_budget > 0 and n_dropped:
                d, p, n, retried, lost = self._query_overflow_retry(
                    fn, snap, src, b, d, p, n, ln, route)
        finally:
            self._release(snap, ln)
        with self._stats_lock:
            self.stats["queries"] += 1
            self.stats["query_dropped"] += n_dropped
            if degraded:
                self.stats["degraded_answers"] += degraded
            if retried:
                self.stats["query_retried"] += retried
            if lost:
                self.stats["query_lost"] += lost
        return d[:b], p[:b], n[:b]

    def _dispatch_query(self, fn, snap, src, ln=None, route=0):
        """Single routed query dispatch; the failpoint sits inside so a
        retry round re-traverses it (nth-hit triggers model transients).
        On a rank group the read's first exchange agrees on the failpoint's
        outcome and the route epoch."""
        items = int(src.shape[0])
        if ln is None:
            failpoint("engine.query_dispatch", items=items)
        else:
            _agreed(ln.group,
                    lambda: failpoint("engine.query_dispatch", items=items),
                    epoch=route)
        return fn(snap.state, src)

    def _query_overflow_retry(self, fn, snap, src, b, d, p, n, ln=None,
                              route=0):
        """In-call overflow retry: re-dispatch the items the router would
        drop for skew against the SAME snapshot.  Retry item j lands at
        slice ``j % S``, slot ``j // S`` — round-robin across sender
        slices, so every round splits the over-capacity owner groups.
        Returns merged ``(d, p, n, retried, lost)``."""
        scfg = self.cfg.sharded
        n_shards = scfg.num_shards
        src_np = _host(src)
        total = src_np.size
        local = total // n_shards
        d_np, p_np, n_np = (_host(d).copy(), _host(p).copy(),
                            _host(n).copy())
        drop = sh.predict_route_overflow(scfg, src_np)
        drop[b:] = False
        retried = 0
        rounds = self.cfg.query_retry_budget
        while rounds > 0 and drop.any():
            idx = np.flatnonzero(drop)
            j = np.arange(idx.size)
            pos = (j % n_shards) * local + (j // n_shards)
            retry_src = np.full(total, -1, np.int32)
            retry_src[pos] = src_np[idx]
            try:
                rd, rp, rn, _ = call_with_retry(
                    lambda: self._dispatch_query(
                        fn, snap, torch.from_numpy(retry_src).to(self.device),
                        ln, route),
                    policy=self.cfg.retry,
                    on_retry=self._count_retry("dispatch_retries"),
                    metrics=self.metrics)
            except Exception as exc:
                if isinstance(exc, RankGroupLost):
                    raise
                self._record_dispatch_failure(exc)
                break   # keep what we have; the rest counts as lost
            retried += int(idx.size)
            rdrop = sh.predict_route_overflow(scfg, retry_src)
            ok = ~rdrop[pos]
            d_np[idx[ok]] = _host(rd)[pos[ok]]
            p_np[idx[ok]] = _host(rp)[pos[ok]]
            n_np[idx[ok]] = _host(rn)[pos[ok]]
            drop = np.zeros_like(drop)
            drop[idx[~ok]] = True
            rounds -= 1
        return (*(torch.from_numpy(x).to(self.device)
                  for x in (d_np, p_np, n_np)), retried, int(drop.sum()))

    # ------------------------------------------------------------------
    def topn(self, n: Optional[int] = None, lane: int = 0):
        """Globally descending top-n edges across every shard (the
        cross-shard merge read).  Returns ``(srcs[n], dsts[n], probs[n])``;
        candidates the shards could not expose are counted in
        ``stats['topn_dropped']`` (last call's value is kept — it is a
        property of the current state, not a running total).  Rows owned
        by down shards are filtered from the merge (degraded reads,
        DESIGN.md §12); a dispatch fault retries and, exhausted, the call
        degrades to an empty merge rather than raising.  On a rank group
        the read runs on reader lane ``lane``."""
        n = int(self.cfg.topn if n is None else n)
        with self.metrics.span("engine.topn"):
            return self._read(lane, "topn", lambda ln: self._topn_inner(n, ln))

    def _topn_inner(self, n: int, ln=None):
        group = None if ln is None else ln.group
        # pair the program with its snapshot
        fn, snap, route = self._pin(
            self._topn_fns, (n,),
            lambda: sh.make_topn_fn(self.cfg.sharded, n, ranks=group), ln)
        self.metrics.gauge_set("read_epoch_lag",
                               self.store.version - snap.version)
        degraded = 0
        try:
            try:
                srcs, dsts, probs, dropped = call_with_retry(
                    lambda: self._dispatch_topn(fn, snap, ln, route),
                    policy=self.cfg.retry,
                    on_retry=self._count_retry("dispatch_retries"),
                    metrics=self.metrics)
                n_dropped = int(dropped)
                self.health.record_success_all()
            except Exception as exc:
                if isinstance(exc, RankGroupLost):
                    raise
                # read path never raises for dispatch faults: empty merge
                self._record_dispatch_failure(exc)
                srcs = torch.full((n,), -1, dtype=torch.int32,
                                  device=self.device)
                dsts = torch.full((n,), -1, dtype=torch.int32,
                                  device=self.device)
                probs = torch.zeros((n,), dtype=torch.float32,
                                    device=self.device)
                n_dropped = 0
                degraded = n
                self.metrics.incident("degraded_read", op="topn",
                                      error=repr(exc))
        finally:
            self._release(snap, ln)
        down = self.health.down
        if down and not degraded:
            # degraded merge: filter rows owned by down shards out of the
            # answer (order among survivors preserved — still globally
            # descending), pad the tail with empties and count the holes
            s_np, d_np, p_np = _host(srcs), _host(dsts), _host(probs)
            owner = self.cfg.sharded.resolved_ownership().owner_of(
                torch.from_numpy(s_np)).numpy()
            hit = np.isin(owner, list(down)) & (s_np >= 0)
            if hit.any():
                degraded = int(hit.sum())
                keep = ~hit
                kept = int(keep.sum())
                out_s = np.full_like(s_np, -1)
                out_d = np.full_like(d_np, -1)
                out_p = np.zeros_like(p_np)
                out_s[:kept] = s_np[keep]
                out_d[:kept] = d_np[keep]
                out_p[:kept] = p_np[keep]
                srcs, dsts, probs = (torch.from_numpy(x).to(self.device)
                                     for x in (out_s, out_d, out_p))
        with self._stats_lock:
            self.stats["topn_calls"] += 1
            self.stats["topn_dropped"] = n_dropped
            if degraded:
                self.stats["degraded_answers"] += degraded
        return srcs, dsts, probs

    def _dispatch_topn(self, fn, snap, ln=None, route=0):
        """Single cross-shard merge dispatch (failpoint inside: retries
        re-traverse it; agreed with the route epoch on a rank group)."""
        if ln is None:
            failpoint("engine.topn_dispatch")
        else:
            _agreed(ln.group, lambda: failpoint("engine.topn_dispatch"),
                    epoch=route)
        return fn(snap.state)

    # ------------------------------------------------------------------
    # durability & elasticity (DESIGN.md §10)
    # ------------------------------------------------------------------

    def checkpoint(self, step: Optional[int] = None, sync: bool = True) -> str:
        """Snapshot the published chain inside the writer-lock publish cycle.

        The captured state is always a published epoch, held as a reader
        while it is copied to the host (no write can reach it: the writer
        lock is held), and ``wal_seq`` is captured under the same lock, so
        snapshot and log position can never disagree.  ``sync=False`` runs
        the file IO on a worker thread (the device->host gather still
        happens here).
        """
        if not self.cfg.snapshot_dir:
            raise ValueError("ShardedServeConfig.snapshot_dir not set")
        with self._write_lock:
            if self.ranks is None:
                return self._snapshot_locked(step=step, sync=sync)
            self._agree_or_lose_locked(
                "checkpoint", np.int64(-1 if step is None else step),
                np.int64(sync))
            try:
                return self._snapshot_locked(step=step, sync=sync)
            except RankGroupLost as exc:
                raise self._lost_locked("checkpoint", exc) from exc

    @requires_lock("_write_lock")
    def _snapshot_locked(self, step: Optional[int] = None,
                         sync: bool = True) -> str:
        scfg = self.cfg.sharded
        own = scfg.resolved_ownership()
        wal_seq = self._seq
        step = wal_seq + 1 if step is None else step
        meta = {
            "wal_seq": wal_seq,
            "num_shards": scfg.num_shards,
            "bucket_factor": scfg.bucket_factor,
            "ownership": {"num_buckets": own.num_buckets,
                          "assignment": list(own.resolved_assignment())},
            "base_cfg": dataclasses.asdict(scfg.base),
            "store_version": self.store.version,
            # the overflow-retry carry-over is part of the recovery state:
            # replay determinism is 'same batches through the same
            # pipeline', and the pipeline's plan depends on the queue
            "retry_queue": [[c[0].tolist(), c[1].tolist(), c[2].tolist(),
                             c[3].tolist()] for c in self._retry_queue],
            # so is the health map (A15): the down-set and deferred queue
            # must survive the crash, because WAL GC below may unlink the
            # deferred batches' original records — after this commit the
            # snapshot meta is their only durable copy
            "health": self.health.dump(),
        }
        # WAL GC rides the snapshot cadence: once a snapshot at wal_seq is
        # COMMITTED (manifest renamed, and the rename fsynced by
        # ckpt._write, so the commit outlives a power loss), every record
        # with seq <= wal_seq is redundant for recovery, so closed segments
        # up to it are unlinked (truncate_through is conservative and
        # internally locked).  For the
        # async path the truncation must wait for the commit, not the
        # capture — it runs as the worker's completion callback.
        gc = (functools.partial(self.wal.truncate_through, wal_seq)
              if self.wal is not None else None)
        snap = self._writer.acquire()
        try:
            if self.ranks is not None:
                path = self._snapshot_ranks_locked(snap.state, step, meta,
                                                   gc, sync)
            elif sync:
                path = snapshot_io.save_snapshot(
                    snap.state, self.cfg.snapshot_dir, step, meta,
                    metrics=self.metrics)
                if gc is not None:
                    gc()
            else:
                self._io_threads = [t for t in self._io_threads
                                    if t.is_alive()]
                self._io_threads.append(snapshot_io.save_snapshot_async(
                    snap.state, self.cfg.snapshot_dir, step, meta,
                    on_complete=gc, on_error=self._snapshot_io_error,
                    metrics=self.metrics))
                path = snapshot_io.step_dir(self.cfg.snapshot_dir, step)
        finally:
            self.store.release(snap)
        with self._stats_lock:
            self.stats["snapshots"] += 1
        return path

    @requires_lock("_write_lock")
    def _snapshot_ranks_locked(self, state, step: int, meta: dict, gc,
                               sync: bool) -> str:
        """:meth:`_snapshot_locked` on a rank group (every rank): the
        shards gathered to rank 0, which writes the one-card engine's files
        (``sync``) or hands them to its worker thread; a failure of rank
        0's raises on every rank."""
        if sync:
            path = snapshot_io.save_snapshot(state, self.cfg.snapshot_dir,
                                             step, meta, metrics=self.metrics,
                                             ranks=self.ranks)
            if gc is not None:
                gc()
            return path
        # the gather here, under the write lock; the file IO on rank 0's
        # worker thread
        stacked = convert.gather_sharded(state, self.ranks, 0)

        def start():
            if stacked is None:
                return
            self._io_threads = [t for t in self._io_threads if t.is_alive()]
            self._io_threads.append(snapshot_io.save_snapshot_async(
                stacked, self.cfg.snapshot_dir, step, meta, on_complete=gc,
                on_error=self._snapshot_io_error, metrics=self.metrics))
        _agreed(self.ranks, start)
        return snapshot_io.step_dir(self.cfg.snapshot_dir, step)

    def _snapshot_io_error(self, exc) -> None:
        """Worker-thread snapshot IO fault: count it and move on — the
        cadence retries at the next interval, and an aborted step directory
        is invisible to ``latest_complete_step``.  Without this hook the
        worker would die with only a stderr traceback (a silently dead IO
        thread that looks like progress)."""
        with self._stats_lock:
            self.stats["snapshot_failures"] += 1

    def _escalate_snapshot(self) -> None:
        # watchdog escalation fires outside the write lock (observe() calls
        # watchdog.observe after releasing it), so taking it here is safe
        self.checkpoint()

    # ------------------------------------------------------------------
    # graceful degradation (DESIGN.md §12)
    # ------------------------------------------------------------------

    def mark_shard_down(self, shard: int) -> None:
        """Administratively exclude ``shard``: routed reads mask its items
        (counted in ``degraded_answers``), its share of the top-n merge is
        filtered, and its writes defer (bounded by ``deferred_cap``) until
        :meth:`heal_shard` re-admits it.  The strike path
        (``health.record_failure``) reaches the same state automatically
        after ``health_strikes`` consecutive dispatch failures."""
        if not 0 <= shard < self.cfg.sharded.num_shards:
            raise ValueError(
                f"shard {shard} out of range for "
                f"{self.cfg.sharded.num_shards} shards")
        if self.ranks is not None:
            # a collective call: the health map moves on every rank at once
            with self._write_lock:
                self._agree_or_lose_locked("mark_shard_down", np.int64(shard))
                self._mark_down(shard)
            return
        self._mark_down(shard)

    def _mark_down(self, shard: int) -> None:
        self.health.mark_down(shard)
        with self._stats_lock:
            self.stats["shards_down"] = self.health.stats()["shards_down"]

    def heal_shard(self, shard: int) -> int:
        """Re-admit ``shard`` and re-apply its deferred writes through the
        one observe pipeline.  Deferred batches are NOT re-logged: they
        are recovery state already — their original WAL records exist
        until snapshot GC, and every snapshot persists the health map
        (down-set + deferred queue) in its meta, which ``restore()``
        reinstates before replay — so heal-vs-crash never double-counts a
        batch (A15).  Each batch re-applies under the ``cfg.retry``
        ladder; if one still fails, the shard is re-marked down and the
        unapplied remainder (failed batch included) is requeued before
        the fault propagates — a mid-heal fault never drops writes.
        Returns the number of re-applied batches."""
        with self._write_lock:
            if self.ranks is not None:
                self._agree_or_lose_locked("heal_shard", np.int64(shard))
            batches = self.health.heal(shard)
            done = 0
            try:
                for bsrc, bdst, bw in batches:
                    call_with_retry(
                        functools.partial(
                            self._apply_locked, bsrc, bdst,
                            bw if bw is not None else np.ones_like(bsrc)),
                        policy=self.cfg.retry,
                        on_retry=self._count_retry("apply_retries"),
                        metrics=self.metrics)
                    done += 1
            except Exception as exc:
                self.health.mark_down(shard)
                self.health.requeue(shard, batches[done:])
                if isinstance(exc, RankGroupLost):
                    raise self._lost_locked("heal_shard", exc) from exc
                raise
            finally:
                health = self.health.stats()
                with self._stats_lock:
                    self.stats["shards_down"] = health["shards_down"]
                    self.stats["deferred_writes"] = health["deferred_writes"]
        return len(batches)

    def close(self) -> None:
        """Shutdown path: drain outstanding snapshot IO and close the WAL.

        Background snapshot workers are non-daemon threads, so even an
        unclosed engine cannot tear a committed snapshot at interpreter
        exit — but ``close()`` makes the drain explicit and bounded: it
        joins every outstanding worker (their completion callbacks, e.g.
        WAL truncation, included) and then flushes/fsyncs the open WAL
        segment.  Idempotent; the engine object must not be used after.
        """
        with self._write_lock:
            threads, self._io_threads = self._io_threads, []
        for t in threads:
            t.join()
        if self.wal is not None:
            self.wal.close()

    def __enter__(self) -> "ShardedEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def restore(self, step: Optional[int] = None, replay: bool = True) -> dict:
        """Recover from the newest complete snapshot (+ WAL replay).

        Same shard count: exact array restore — bit-identical state,
        including the ownership map (the engine rebinds its routing
        programs if the snapshot's assignment differs).  Different shard
        count: elastic reshard — the snapshot's live edges re-route
        through the pre-aggregated update path under this engine's
        ownership map (``persist/reshard.py``), then the order settles
        exactly.  Either way, WAL records with ``seq > wal_seq`` replay
        through the one observe pipeline.  A successful restore also
        heals a poisoned write path (DESIGN.md §12): durable-but-unapplied
        ghost records are replayed here, re-aligning log and state.
        """
        directory = self.cfg.snapshot_dir
        if not directory:
            raise ValueError("ShardedServeConfig.snapshot_dir not set")
        # drain in-flight cadence/poison checkpoints first: the newest
        # snapshot may still be committing on a worker thread (a poison's
        # best-effort checkpoint-now races an immediate restore), and
        # the read below must not scan past it
        with self._write_lock:
            pending, self._io_threads = self._io_threads, []
        for t in pending:
            t.join()
        # one write-lock hold end to end: a concurrent observe() slipping
        # between publish and replay would be WAL-appended AND re-read by
        # the replay generator — applied twice
        with self._write_lock:
            if self.ranks is None:
                return self._restore_locked(directory, step, replay)
            self._agree_or_lose_locked(
                "restore", np.int64(-1 if step is None else step),
                np.int64(replay))
            try:
                return self._restore_locked(directory, step, replay)
            except RankGroupLost as exc:
                raise self._lost_locked("restore", exc) from exc

    @requires_lock("_write_lock")
    def _restore_locked(self, directory: str, step: Optional[int],
                        replay: bool) -> dict:
        replayed, edges = 0, None
        # the sidecar, then each array once (the newest complete step when
        # ``step`` is None), placed into a template built from the sidecar:
        # the snapshot's own config and shard count (on a rank group: read
        # on rank 0, and this rank's shard scattered, or the edges of a
        # snapshot at another shard count broadcast)
        with self.metrics.span("snapshot.restore", step=step):
            if self.ranks is None:
                step, meta, arrays = snapshot_io.read_step(directory, step)
                state = ckpt.place(
                    self._stacked_like(self._base_of(meta),
                                       int(meta["num_shards"])),
                    arrays, device=self.device)
                del arrays   # the host copy, before a reshard's re-ingest
            else:
                step, meta, state, edges = self._read_ranks(directory, step)
        base_old = self._base_of(meta)
        n_old = int(meta["num_shards"])
        scfg = self.cfg.sharded
        new_scfg = None
        if n_old == scfg.num_shards:
            mode = "exact"
            snap_own = Ownership(
                num_shards=n_old,
                num_buckets=int(meta["ownership"]["num_buckets"]),
                assignment=tuple(meta["ownership"]["assignment"]))
            own_now = scfg.resolved_ownership()
            if (snap_own.resolved_assignment()
                    != own_now.resolved_assignment()
                    or dataclasses.asdict(base_old)
                    != dataclasses.asdict(scfg.base)):
                # rows live where the snapshot's map routed them; the
                # engine must route future traffic the same way
                new_scfg = dataclasses.replace(
                    scfg, base=base_old, ownership=snap_own)
        else:
            mode = "reshard"
            state = (self._reingest(state, scfg) if edges is None
                     else self._ingest(*edges, scfg))
        # swap: readers must never pair the new routing with the old
        # snapshot (or vice versa), so rebind + publish are atomic
        # with respect to their (program, snapshot) pairing; the new
        # state gets a writer of its own (readers that still hold the
        # old state keep it alive)
        with self._route_lock:
            if new_scfg is not None:
                self._rebind(new_scfg)
            self.store.publish(state)
            self._writer = epoch.BackBufferLearner(self.store)
            self._moved()
        self._seq = int(meta["wal_seq"])
        # the overflow-retry carry-over is recovery state: the replay
        # below re-plans each step from the same queue the pre-crash
        # pipeline saw (snapshots from older builds simply have none)
        self._retry_queue = [
            tuple(np.asarray(a, np.int32) for a in chunk)
            for chunk in meta.get("retry_queue", [])]
        # so is the health map (A15): the snapshot's down-set and
        # deferred queue replace the live one BEFORE replay — an
        # in-process restore must not replay down-shard records on
        # top of deferrals the snapshot already captured (that would
        # double-apply them on heal), and the deferred batches'
        # original WAL records may be GC'd, so the meta image is
        # authoritative.  Replayed tail records owned by a restored
        # down shard re-defer exactly as they did pre-crash.
        health_image = meta.get("health", {})
        self.health.load(health_image if mode == "exact" else {})
        hstats = self.health.stats()
        counters = mc.counter_stats(state, ranks=self.ranks)
        with self._stats_lock:
            self.stats.update(counters)
            self.stats["shards_down"] = hstats["shards_down"]
            self.stats["deferred_writes"] = hstats["deferred_writes"]
        if mode != "exact":
            # reshard: old shard ids are meaningless under the new
            # topology — start healthy (loaded empty above) and fold
            # the snapshot's deferred batches straight into the state
            # (they precede every tail record in seq order)
            for _, dsrc, ddst, dw in health_image.get("deferred", ()):
                dsrc = np.asarray(dsrc, np.int32)
                self._apply_locked(
                    dsrc, np.asarray(ddst, np.int32),
                    np.ones_like(dsrc) if dw is None
                    else np.asarray(dw, np.int32))
        if replay and self._logs:
            for seq, src, dst, w in self._wal_tail():
                # apply BEFORE advancing: a fault mid-replay must not
                # leave _seq past unapplied records (same contract as
                # observe)
                self._apply_locked(src, dst, w)
                self._seq = seq
                replayed += 1
        if self.wal is not None:
            # snapshot GC may have unlinked every segment: a fresh
            # process's WAL scan then restarts at 0, colliding with
            # seqs the snapshot covers — the meta wal_seq is the
            # durable authority
            self.wal.resume_at(self._seq + 1)
        # restore is the escalation ladder's terminus: snapshot + log
        # agree with the published state again, so writes re-open
        self._poisoned = None
        return {"step": step, "mode": mode, "replayed": replayed,
                "wal_seq": self._seq}

    def _base_of(self, meta: dict) -> mc.MCConfig:
        """A snapshot's chain config; the kernel dispatch is this
        engine's own, not the writer's."""
        return mc.MCConfig(**{**meta["base_cfg"],
                              "impl": self.cfg.sharded.base.impl})

    def _read_ranks(self, directory: str, step: Optional[int]):
        """Restore's read on a rank group (every rank): rank 0 reads the
        step once; at this group's shard count each rank gets its shard
        (``state``), at another every rank gets the snapshot's live edges
        in the one-card (shard, row, slot) order (``edges``).  A read
        that fails on rank 0 raises on every rank.  Returns ``(step,
        meta, state or None, edges or None)``."""
        ranks = self.ranks
        arrays, found, failed = None, None, None
        if ranks.rank == 0:
            try:
                step, meta, arrays = snapshot_io.read_step(directory, step)
                if int(meta["num_shards"]) == ranks.world:
                    snapshot_io.check_shards(
                        self._stacked_like(self._base_of(meta), 1), arrays,
                        ranks.world)
                found = (step, meta, None)
            except (OSError, ValueError, KeyError) as exc:
                failed, found = exc, (None, None, repr(exc))
        step, meta, said = ranks.broadcast_object(found)
        if failed is not None:
            raise failed
        if said is not None:
            raise OSError(f"rank 0 could not restore from {directory}: "
                          f"{said}")
        base_old, n_old = self._base_of(meta), int(meta["num_shards"])
        if n_old == ranks.world:
            return step, meta, snapshot_io.scatter_arrays(
                self._stacked_like(base_old, 1), arrays, ranks,
                self.device), None
        listed = None
        if ranks.rank == 0:
            old = ckpt.place(self._stacked_like(base_old, n_old), arrays,
                             device=self.device)
            del arrays
            listed = torch.from_numpy(np.stack(rs.extract_edges(old), axis=1))
            del old
        got = ranks.broadcast(listed)
        return step, meta, None, tuple(np.ascontiguousarray(got[:, i].numpy())
                                       for i in range(3))

    def _wal_tail(self):
        """The WAL records after ``_seq``: the log's own on one card; on a
        rank group rank 0's, each broadcast to every rank as it is read
        (a read that fails on rank 0 raises on every rank)."""
        if self.ranks is None:
            yield from self.wal.replay(after_seq=self._seq)
            return
        tail = (self.wal.replay(after_seq=self._seq)
                if self.wal is not None else None)
        while True:
            item, failed = None, None
            if tail is not None:
                try:
                    rec = next(tail, None)
                    item = None if rec is None else (
                        int(rec[0]), *(np.asarray(x, np.int32)
                                       for x in rec[1:]))
                except Exception as exc:   # every rank must hear of it
                    failed, item = exc, repr(exc)
            item = self.ranks.broadcast_object(item)
            if failed is not None:
                raise failed
            if isinstance(item, str):
                raise OSError(f"rank 0 could not replay the WAL: {item}")
            if item is None:
                return
            yield item

    def reassign(self, ownership: Ownership) -> dict:
        """Live rebalancing: install a new bucket -> shard assignment and
        migrate by re-routing the live edges — the same machinery as
        elastic restore, at a constant shard count (ROADMAP "cross-shard
        rebalancing").  Readers keep serving the pre-migration snapshot
        until the re-ingested state publishes."""
        scfg = self.cfg.sharded
        if ownership.num_shards != scfg.num_shards:
            raise ValueError(
                f"reassign keeps the shard count: map has "
                f"{ownership.num_shards}, engine has {scfg.num_shards}")
        new_scfg = dataclasses.replace(scfg, ownership=ownership)
        with self._write_lock:
            if self.ranks is not None:
                self._agree_or_lose_locked(
                    "reassign", np.int64(ownership.num_buckets),
                    np.asarray(ownership.resolved_assignment(), np.int64))
            try:
                # migrate FIRST, against local programs for the new map;
                # readers keep pairing the old routing with the old
                # snapshot until the atomic swap below
                snap = self._writer.acquire()
                try:
                    state = self._reingest(snap.state, new_scfg)
                finally:
                    self.store.release(snap)
                with self._route_lock:
                    self._rebind(new_scfg)
                    self.store.publish(state)
                    self._writer = epoch.BackBufferLearner(self.store)
                    self._moved()
                counters = mc.counter_stats(state, ranks=self.ranks)
            except RankGroupLost as exc:
                raise self._lost_locked("reassign", exc) from exc
            with self._stats_lock:
                self.stats.update(counters)
        return {"num_buckets": ownership.num_buckets,
                "version": self.store.version}

    # -- internals ------------------------------------------------------

    @requires_lock("_route_lock")
    def _rebind(self, scfg: sh.ShardedConfig) -> None:
        """Swap the static sharded config and rebuild every routed program
        (ownership/base changes are baked into them as constants)."""
        self.cfg = dataclasses.replace(self.cfg, sharded=scfg)
        self._update = sh.make_update_fn_(scfg, ranks=self.ranks)
        self._maintain = sh.make_maintain_fn_(
            scfg, total_threshold=self.cfg.decay_threshold, ranks=self.ranks)
        with self._compile_lock:
            self._query_fns.clear()
            self._topn_fns.clear()

    def _moved(self) -> None:
        """A swap published a new state: bump the route epoch a rank
        group's reads agree on and wake the reads waiting for it (the
        caller holds ``_route_lock``, the condition's lock)."""
        self._route_epoch += 1
        if self.ranks is not None:
            self._route_moved.notify_all()

    def _stacked_like(self, base: mc.MCConfig, num_shards: int):
        """Template with the stacked [num_shards, ...] shapes a snapshot at
        that config was written with, for ``ckpt.place``: every array
        leaf a broadcast int32 zero (no memory at any width), the scalars
        the columns of one ``[num_shards, 10]`` tensor, so that they restore
        as views of one storage, as the writer's owner calls need them.
        The shapes are :func:`mc.init`'s, read off the config (no chain is
        made: on the meta device its first ``arange`` imports torch's
        Python decompositions, ~11 s in a fresh process)."""
        n, c = base.num_rows, base.capacity
        h = base.resolved_dst_table_size() if base.use_dst_hash else 1
        t = base.resolved_table_size()

        def zeros(*shape):
            return torch.zeros((), dtype=torch.int32,
                               device=self.device).expand(num_shards, *shape)

        scalars = torch.zeros((num_shards, len(mc.SCALAR_FIELDS)),
                              dtype=torch.int32, device=self.device)
        return mc.MCState(
            src_table=HashTable(keys=zeros(t), vals=zeros(t)),
            slabs=Slabs(dst=zeros(n, c), cnt=zeros(n, c), tot=zeros(n),
                        order=zeros(n, c)),
            dh_keys=zeros(n, h), dh_vals=zeros(n, h),
            **{f: scalars[:, i] for i, f in enumerate(mc.SCALAR_FIELDS)})

    def _reingest(self, old_state: mc.MCState,
                  scfg: sh.ShardedConfig) -> mc.MCState:
        """Re-route a state's live edges into a fresh chain under
        ``scfg``'s ownership map, through the routed pre-aggregated update
        path, with drop-free batch planning; settle the order exactly.
        Deliberately independent of the engine's installed routing, so
        callers can migrate before swapping.  The edges are listed on the
        device (only the live triples reach the host); the owner
        ``sh.update_`` writes the fresh state, which no reader holds.  On
        a rank group each rank lists its shard's edges and the lists are
        gathered in rank order, the one-card (shard, row, slot) order
        (every rank calls)."""
        edges = rs.extract_edges(old_state)
        if self.ranks is not None:
            edges = rs.gather_edges(edges, self.ranks)
        return self._ingest(*edges, scfg)

    def _ingest(self, src, dst, cnt, scfg: sh.ShardedConfig) -> mc.MCState:
        """Live edges (the same global lists on every rank of a group) into
        a fresh chain under ``scfg``: :meth:`_reingest`'s plan and
        ingestion, each rank its slice of every planned batch."""
        owner = scfg.resolved_ownership().owner_of(
            torch.from_numpy(src).to(self.device)).cpu().numpy()
        slice_len = max(scfg.num_shards, self.cfg.reingest_slice_len)
        cap = scfg.bucket_capacity(slice_len)
        # every re-ingested item is a new edge; a bounded slow path would
        # defer (= silently drop) everything past the prefix, so ingestion
        # gets its own program with the bound lifted (shapes are identical)
        ingest_scfg = dataclasses.replace(
            scfg, base=dataclasses.replace(scfg.base, max_new_per_batch=0))
        state = sh.init_sharded(scfg, self.device, ranks=self.ranks)
        part = (slice(None) if self.ranks is None else
                slice(self.ranks.rank * slice_len,
                      (self.ranks.rank + 1) * slice_len))
        for bsrc, bdst, bw in rs.plan_batches(
                src, dst, cnt, owner, scfg.num_shards, slice_len, cap):
            sh.update_(state, *(torch.from_numpy(x[part]).to(self.device)
                                for x in (bsrc, bdst, bw)),
                       scfg=ingest_scfg, ranks=self.ranks)
        return rs.settle_order_(state)
